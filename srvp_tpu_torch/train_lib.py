"""Training machinery (counterpart of srvp_tpu/train_lib.py): train state,
the optimisation step, and best-of-N validation.

Adam at torch's defaults (b1 0.9, b2 0.999, eps 1e-8), the learning rate
constant until `lr_burnin` steps and then decayed linearly to 0 over
`lr_decay_iter` steps, as a LambdaLR stepped once per optimisation step.
`compute_dtype` is the encoder's and decoder's dtype in the step and in the
validation (bfloat16 under `--precision bfloat16`); the parameters, Adam's
state, the latent model and the loss stay float32, and no loss is scaled,
as in the JAX package.
"""

import dataclasses

import torch

from srvp_tpu_torch import eval_lib
from srvp_tpu_torch.config import SRVPConfig
from srvp_tpu_torch.data.device_compose import materialize, to_device
from srvp_tpu_torch.metrics.pixel import frame_mse, psnr_from_mse
from srvp_tpu_torch.models.lstm import lstm_apply
from srvp_tpu_torch.models.srvp import SRVP
from srvp_tpu_torch.objectives import elbo_loss
from srvp_tpu_torch.ops.init import init_srvp_


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    """Static training hyperparameters (a subset of the CLI flags)."""
    oversampling: int = 1
    obs_scale: float = 1.0
    beta_y: float = 1.0
    beta_z: float = 1.0
    l2_res: float = 1.0
    lr: float = 3e-4
    lr_burnin: int = 1000000
    lr_decay_iter: int = 100000
    nt_cond: int = 5
    n_samples_test: int = 100
    val_samples_chunk: int = 25
    compute_dtype: torch.dtype = torch.float32
    use_kernel: bool = True  # training rollout through its CUDA kernels


def lr_factor(hp):
    """Multiplier of hp.lr at step `count` (0 for the first step): 1 until
    burn-in, then the k-th post-burn-in step runs at (N - k) / N. The
    LambdaLR of make_train_state applies it."""
    def factor(count):
        k = max(count - (hp.lr_burnin - 1), 0)
        return min(max((hp.lr_decay_iter - k) / hp.lr_decay_iter, 0.0), 1.0)
    return factor


@dataclasses.dataclass
class TrainState:
    """The model, Adam, its schedule, the step and the generator that draws
    the training noise (srvp_tpu/train_lib.py:30 `TrainState`: params,
    bn_state, opt_state, step, rng)."""
    model: SRVP
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0
    generator: torch.Generator | None = None


def make_train_state(model, hp):
    """Adam and its schedule around `model`."""
    optimizer = torch.optim.Adam(model.parameters(), lr=hp.lr)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lr_factor(hp))
    return TrainState(model, optimizer, scheduler)


def state_dict(ts):
    """The whole train state as one nested dict: the model's parameters and
    buffers (batch-norm statistics and counts included), Adam's moments and
    steps, the schedule's position, the step and the generator's state (a
    CPU byte tensor, for a CUDA generator too). Its tensors are the live
    ones, except the generator's: copy them before the next step changes
    them (utils/checkpoint.AsyncCheckpointer.snapshot)."""
    return {"model": ts.model.state_dict(),
            "optimizer": ts.optimizer.state_dict(),
            "scheduler": ts.scheduler.state_dict(), "step": ts.step,
            "generator": (None if ts.generator is None
                          else ts.generator.get_state())}


def load_state_dict(ts, sd):
    """Restores `state_dict`'s output, tensors on any device, into `ts`
    in place. The schedule's lambda is not in it: `ts`'s, made from hp,
    stays."""
    ts.model.load_state_dict(sd["model"])
    ts.optimizer.load_state_dict(sd["optimizer"])
    ts.scheduler.load_state_dict(sd["scheduler"])
    ts.step = int(sd["step"])
    if ts.generator is not None:
        ts.generator.set_state(sd["generator"].cpu())


def init_train_state(cfg: SRVPConfig, hp, device, res_gain=1.41):
    """A freshly initialised model (torch's global generator) in training
    mode on `device`, with its optimiser."""
    model = init_srvp_(SRVP(cfg), res_gain=res_gain).to(device).train()
    return make_train_state(model, hp)


def loss_and_grads(model, x, hp, **noise):
    """ELBO and its parameter gradients (left in .grad) for one batch, the
    model in training mode."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss, aux = elbo_loss(model, x, oversampling=hp.oversampling,
                          obs_scale=hp.obs_scale, beta_y=hp.beta_y,
                          beta_z=hp.beta_z, l2_res=hp.l2_res,
                          use_kernel=hp.use_kernel,
                          compute_dtype=hp.compute_dtype, **noise)
    loss.backward()
    return loss, aux


def train_step(ts, x, hp, **noise):
    """One optimisation step; returns the step's metrics as device
    tensors (loss, nll, kl_y_0, kl_z, l2_res) and its learning rate."""
    lr = ts.scheduler.get_last_lr()[0]
    loss, aux = loss_and_grads(ts.model, x, hp, **noise)
    ts.optimizer.step()
    ts.scheduler.step()
    ts.step += 1
    metrics = {"loss": loss.detach(), "lr": lr}
    metrics.update({k: v.detach() for k, v in aux._asdict().items()})
    return metrics


def make_eval_batch(cfg, hp, nt, n_samples=None):
    """Best-of-N validation (n_samples, default hp.n_samples_test) for
    sequences of length nt: returns a function (model, x, generator, eps)
    -> (B,) prediction PSNR of each video's best sample, the best chosen by
    all-frame PSNR (first sample wins ties). Samples are folded into the
    batch video-major in chunks of hp.val_samples_chunk, each rolled out as
    the evaluation's (eval_lib.sample_rollout: posterior over the nt_cond
    conditioning frames, then the eager prior loop) on `eps`, a list of one
    eval_lib.chunk_noise(...) tuple per chunk, or on draws from
    `generator` in that order. Frames are encoded and decoded in
    hp.compute_dtype, the latent model in the frames' dtype (float32)."""
    n_samples = n_samples or hp.n_samples_test
    chunk = min(hp.val_samples_chunk, n_samples)
    if n_samples % chunk:
        raise ValueError("n_samples_test must be divisible by the chunk")
    o = hp.oversampling

    @torch.no_grad()
    def eval_batch(model, x, generator=None, eps=None):
        model.eval()
        x = materialize(x, cfg.nx)
        bsz = x.shape[1]
        dtype = hp.compute_dtype
        hx, skips = model.encode(x[:hp.nt_cond].to(dtype))
        hx = hx.to(x.dtype)
        w_f = eval_lib.fold(model.infer_w(hx), chunk, 0).to(dtype)
        skips_f = (None if skips is None
                   else [eval_lib.fold(s, chunk, 0) for s in skips])
        hx_z = lstm_apply(model.inf_z, hx)
        x_f = eval_lib.fold(x, chunk, 1)
        all_p, pred_p = [], []
        for c in range(n_samples // chunk):
            e = eps[c] if eps is not None else eval_lib.chunk_noise(
                cfg, bsz, chunk, hp.nt_cond, nt, o, o, generator, x.device)
            y_inf, y_gen = eval_lib.sample_rollout(
                model, hx, hx_z, chunk, nt - hp.nt_cond + 1, o, o, e,
                use_kernel_rollout=False)
            x_ = model.decode(w_f, torch.cat([y_inf, y_gen[1:]]).to(dtype),
                              skips_f)
            psnr = psnr_from_mse(frame_mse(x_, x_f))    # (nt, B*S, C)
            all_p.append(psnr.mean(dim=(0, 2)).reshape(bsz, chunk))
            pred_p.append(psnr[hp.nt_cond:].mean(dim=(0, 2))
                          .reshape(bsz, chunk))
        best = torch.cat(all_p, dim=1).argmax(dim=1)
        return torch.cat(pred_p, dim=1).gather(1, best[:, None])[:, 0]

    return eval_batch


def evaluate(eval_batch_fn, model, val_iter, n_iter_test, generator, device):
    """-mean prediction PSNR over n_iter_test validation batches (lower is
    better; drives the best-model selection). Leaves the model in training
    mode."""
    total, n = 0.0, 0
    for j, batch in enumerate(val_iter):
        if j >= n_iter_test:
            break
        pred_psnr = eval_batch_fn(model, to_device(batch, device), generator)
        total += float(pred_psnr.sum())
        n += pred_psnr.shape[0]
    model.train()
    return -total / max(n, 1)
