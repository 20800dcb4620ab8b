"""Training machinery (counterpart of srvp_tpu/train_lib.py): train state,
the optimisation step, dispatch windows of k steps (WindowStep: on the card
one CUDA graph), and best-of-N validation.

At more than one rank (parallel/) each rank steps on its slice of the
global batch: it draws the global batch's noise, as one process would, and
keeps its rows (`training_draws`), the gradients are averaged over the
ranks before Adam (parallel/mesh.all_reduce_grads; in a process group of
one rank too), and a validation draws the global batch's noise and sums
its PSNR over the ranks, so that every rank reads the same metric.

Adam at torch's defaults (b1 0.9, b2 0.999, eps 1e-8), the learning rate
constant until `lr_burnin` steps and then decayed linearly to 0 over
`lr_decay_iter` steps, as a LambdaLR stepped once per optimisation step.
`compute_dtype` is the encoder's and decoder's dtype in the step and in the
validation (bfloat16 under `--precision bfloat16`); the parameters, Adam's
state, the latent model and the loss stay float32, and no loss is scaled,
as in the JAX package.
"""

import dataclasses
import os
import warnings

import torch

from srvp_tpu_torch import eval_lib
from srvp_tpu_torch.config import SRVPConfig
from srvp_tpu_torch.data.device_compose import (is_parts_batch, materialize,
                                                to_device, window_batch)
from srvp_tpu_torch.kernels import launches
from srvp_tpu_torch.metrics.pixel import frame_mse, psnr_from_mse
from srvp_tpu_torch.models.lstm import lstm_apply
from srvp_tpu_torch.models.srvp import SRVP
from srvp_tpu_torch.objectives import elbo_loss
from srvp_tpu_torch.ops.init import init_srvp_
from srvp_tpu_torch.parallel import mesh, multihost
from srvp_tpu_torch.utils import trace


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


def batch_shape(x):
    """(frames, videos) of a dense batch (T, B, ...) or a parts dict."""
    if is_parts_batch(x):
        return x["pos"].shape[2], x["pos"].shape[0]
    return x.shape[0], x.shape[1]


def training_draws(cfg, nt, bsz, oversampling, generator, device,
                   rows=None):
    """The noise that SRVP.forward draws from `generator` in training for a
    batch of bsz videos of nt frames, drawn as it draws it (the same calls,
    shapes and order: skip_t with skip connections, the infer_w frame keys,
    eps_y, then eps_pos for the posterior rollout's o (nt - 1) substeps),
    as its keyword arguments. `rows` (lo, hi) keeps those videos of the
    batch: a rank's slice of the global batch's draws, so that a video's
    noise does not depend on the rank count."""
    keep = slice(*(rows or (0, bsz)))
    draws = {}
    if cfg.skipco:
        draws["skip_t"] = torch.randint(0, nt, (bsz,), generator=generator,
                                        device=device)[keep]
    keys = torch.rand((bsz, nt), generator=generator, device=device)
    draws["frame_idx"] = keys.argsort(dim=1)[:, :cfg.nt_inf].T[:, keep]
    randn = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=generator, device=device, dtype=torch.float32)
    draws["eps_y"] = randn(bsz, cfg.ny)[keep]
    draws["eps_pos"] = randn(oversampling * (nt - 1), bsz, cfg.nz)[:, keep]
    return draws


def loss_and_grads(model, x, hp, **noise):
    """ELBO and its parameter gradients (left in .grad) for one batch, the
    model in training mode. At more than one rank, noise drawn from a
    generator alone is the global batch's (training_draws), and the
    gradients are averaged over the ranks (in any process group). The
    forward and the backward with the average are the spans
    `srvp.train.forward` and `srvp.train.backward` (utils/trace.py)."""
    with trace.span("srvp.train.forward"):
        model.train()
        model.zero_grad(set_to_none=True)
        count = multihost.process_count()
        if count > 1 and set(noise) == {"generator"}:
            nt, bsz = batch_shape(x)
            rank = multihost.process_index()
            noise = training_draws(model.cfg, nt, bsz * count,
                                   hp.oversampling, noise["generator"],
                                   _leaves(x)[0].device,
                                   rows=(rank * bsz, (rank + 1) * bsz))
        loss, aux = elbo_loss(model, x, oversampling=hp.oversampling,
                              obs_scale=hp.obs_scale, beta_y=hp.beta_y,
                              beta_z=hp.beta_z, l2_res=hp.l2_res,
                              use_kernel=hp.use_kernel,
                              compute_dtype=hp.compute_dtype, **noise)
    with trace.span("srvp.train.backward"):
        loss.backward()
        mesh.all_reduce_grads(model)
    return loss, aux


def train_step(ts, x, hp, **noise):
    """One optimisation step; returns the step's metrics as device
    tensors (loss, nll, kl_y_0, kl_z, l2_res) and its learning rate. The
    step is a `srvp.train.step` span, Adam and the schedule's step within
    it `srvp.train.optimizer`."""
    with trace.span("srvp.train.step"):
        lr = ts.scheduler.get_last_lr()[0]
        loss, aux = loss_and_grads(ts.model, x, hp, **noise)
        with trace.span("srvp.train.optimizer"):
            ts.optimizer.step()
            ts.scheduler.step()
        ts.step += 1
        metrics = {"loss": loss.detach(), "lr": lr}
        metrics.update({k: v.detach() for k, v in aux._asdict().items()})
        return metrics


def _leaves(batch):
    """The tensors of a batch or window (a parts dict's in key order)."""
    if is_parts_batch(batch):
        return [batch[k] for k in sorted(batch)]
    return [batch]


# Adam's options that graph_safe_adam follows: torch's defaults
ADAM_DEFAULTS = dict(amsgrad=False, weight_decay=0, maximize=False,
                     capturable=False, differentiable=False, fused=None)


def adam_scalars(optimizer, lrs):
    """Adam's two host scalars for each of the next len(lrs) steps at those
    learning rates, computed as its step computes them
    (torch/optim/adam.py `_multi_tensor_adam`, not capturable): the step
    size -lr / (1 - beta1^t) and sqrt(1 - beta2^t), t the step's count.
    Every parameter must have taken the same steps."""
    group, = optimizer.param_groups
    beta1, beta2 = group["betas"]
    counts = {float(st["step"]) for st in optimizer.state.values()} or {0.}
    if len(counts) != 1:
        raise ValueError(f"Adam's parameters took different steps {counts}")
    count, = counts
    return [((lr / (1 - beta1 ** t)) * -1, (1 - beta2 ** t) ** 0.5)
            for t, lr in enumerate(lrs, start=int(count) + 1)]


def graph_safe_adam(optimizer, scalars):
    """One step of `optimizer` (torch.optim.Adam at ADAM_DEFAULTS, one
    group) that a CUDA graph can capture: Adam's own foreach operations,
    its two host scalars (adam_scalars) read from `scalars`, a (2,) device
    tensor. On the card it gives optimizer.step()'s bits
    (tests/test_torch_cuda.py), which torch's capturable Adam does not: it
    orders its arithmetic otherwise. The step counts (host tensors) are the
    caller's to advance."""
    group, = optimizer.param_groups
    beta1, beta2 = group["betas"]
    params = list(group["params"])
    if any(p.grad is None for p in params):
        raise ValueError("graph_safe_adam: a parameter has no gradient")
    for p in params:
        if p not in optimizer.state:    # as Adam's first step makes it
            optimizer.state[p] = {
                "step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format)}
    grads = [p.grad for p in params]
    m = [optimizer.state[p]["exp_avg"] for p in params]
    v = [optimizer.state[p]["exp_avg_sq"] for p in params]
    with torch.no_grad():
        torch._foreach_lerp_(m, grads, 1 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, grads, grads, 1 - beta2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, scalars[1])
        torch._foreach_add_(denom, group["eps"])
        # param + step_size * (m / denom), one rounding of the sum, as
        # Adam's _foreach_addcdiv_ with its host step size
        ratio = torch._foreach_div(m, denom)
        torch._foreach_addcmul_(params, ratio,
                                [scalars[0].expand_as(r) for r in ratio])


def expandable_segments():
    """Makes torch's CUDA allocator grow its segments in place (the
    `expandable_segments` setting) from now on, unless
    PYTORCH_CUDA_ALLOC_CONF already names the setting. A capture cannot
    hand cached memory back to the driver, so in a fragmented graph pool
    near the card's size an allocation fails, and cuDNN then runs a
    convolution with another algorithm, on other bits than the eager step
    (KTH fp32 at K = 2: three such failures, PERF.md). Expandable segments
    do not fragment so."""
    if "expandable_segments" not in os.environ.get("PYTORCH_CUDA_ALLOC_CONF",
                                                   ""):
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")


class WindowStep:
    """k optimisation steps in one call: the counterpart of the JAX
    package's make_train_step(steps_per_call=k) (srvp_tpu/train_lib.py:83),
    a jitted lax.scan of the single step over k stacked batches.

    Called on a stacked window on the device (data/device_compose
    `stack_batches`: a (k, T, B, H, W, C) uint8 tensor, or a parts dict
    stacked leaf-wise), it runs train_step's k steps (the same noise draws,
    step count and schedule), advances ts.step and the LambdaLR by k and
    returns the last step's metrics as train_step does: device tensors, and
    that step's lr as a host float.

    On the card every window after the first is one replay of one
    torch.cuda.CUDAGraph captured from the same step code. The first window
    runs eagerly: it fills Adam's state and the first-call caches of the
    kernels' wrappers (a capture must not meet a host copy). Then
    `before_capture` runs (the trainer waits there for its checkpoint
    writer: no other thread may touch the card during a capture) and the
    graph is captured on torch.cuda.graph's side stream, after it has
    synchronised and emptied the allocator's cache; a capture that fails
    raises. Each call copies the window into static input slots on the
    current stream, and Adam's host scalars of its k steps (adam_scalars,
    from the learning rates of the schedule) into a (k, 2) device tensor,
    from which step j's update reads them (graph_safe_adam, eagerly and in
    the graph alike). ts.generator is registered with the graph, so a
    replay draws the noise of k eager steps. A replay adds the capture's
    kernel launches to the launch counts (kernels/launches.py).
    `release()` frees the graph and its memory pool: a graph holds about
    one step's memory, so an eager step or validation beside it would need
    twice a step's. Call `expandable_segments()` before the first window
    on a card that a step nearly fills.

    On the CPU every window runs eagerly through the same code, with
    Adam's own step at each step's learning rate, drawing from
    ts.generator or, given `draws` (a list of k noise dicts, as
    train_step's **noise), on those.
    """

    def __init__(self, ts, hp, k, before_capture=None):
        if k < 2:
            raise ValueError(f"a window has at least 2 steps, got {k}")
        group, = ts.optimizer.param_groups
        if any(group[o] != d for o, d in ADAM_DEFAULTS.items()):
            raise ValueError(f"a window runs Adam at {ADAM_DEFAULTS}")
        self.ts, self.hp, self.k = ts, hp, k
        self.before_capture = before_capture
        self.on_card = group["params"][0].is_cuda
        self.inputs = self.scalars = None     # the static slots
        self.graph = self.outputs = self.per_replay = None
        self.warm = False                 # a window ran on the card

    def _load(self, xs, lrs):
        """Copies the window and its steps' Adam scalars into the
        slots."""
        if _leaves(xs)[0].is_cuda != self.on_card:
            raise ValueError("the window is not on the parameters' device")
        if self.inputs is None:
            self.inputs = ({k: torch.empty_like(v) for k, v in xs.items()}
                           if is_parts_batch(xs) else torch.empty_like(xs))
            self.scalars = torch.empty(self.k, 2,
                                       device=_leaves(xs)[0].device)
        for dst, src in zip(_leaves(self.inputs), _leaves(xs)):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"window of {tuple(src.shape)} {src.dtype}"
                                 f" for slots of {tuple(dst.shape)} "
                                 f"{dst.dtype}")
            dst.copy_(src, non_blocking=True)
        if self.on_card:
            host = torch.tensor(adam_scalars(self.ts.optimizer, lrs))
            self.scalars.copy_(host.pin_memory(), non_blocking=True)

    def _steps(self, lrs, draws=None):
        """The k steps on the slots; returns the last step's (loss, aux)."""
        opt = self.ts.optimizer
        for j in range(self.k):
            noise = (draws[j] if draws is not None
                     else {"generator": self.ts.generator})
            loss, aux = loss_and_grads(self.ts.model,
                                       window_batch(self.inputs, j),
                                       self.hp, **noise)
            if self.on_card:
                graph_safe_adam(opt, self.scalars[j])
            else:
                opt.param_groups[0]["lr"] = lrs[j]
                opt.step()
        return loss, aux

    def _capture(self, lrs):
        if self.before_capture is not None:
            self.before_capture()
        graph = torch.cuda.CUDAGraph()
        if self.ts.generator is not None:
            graph.register_generator_state(self.ts.generator)
        before = launches.counts()
        with torch.cuda.graph(graph):
            outputs = self._steps(lrs)
        # the capture ran nothing: each replay adds what it counted
        self.per_replay = launches.since(before)
        launches.set_counts(before)
        self.graph, self.outputs = graph, outputs

    def release(self):
        """Frees the graph and its memory pool, the gradients that the
        graph left in the parameters with it; the next window on the card
        captures again. The trainer calls it before any eager work on the
        card (a validation, a single step), so that the pool and that
        work's memory never add up."""
        if self.graph is not None:
            self.graph = self.outputs = None
            self.ts.model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()

    def __call__(self, xs, draws=None):
        ts, k = self.ts, self.k
        factor = lr_factor(self.hp)
        lrs = [self.hp.lr * factor(ts.step + j) for j in range(k)]
        if draws is not None and self.on_card:
            raise ValueError("injected draws are for the CPU: on the card "
                             "a window draws from ts.generator")
        self._load(xs, lrs)
        if self.on_card and self.warm:
            if self.graph is None:
                self._capture(lrs)
            self.graph.replay()
            launches.add(self.per_replay)
            loss, aux = self.outputs
        else:
            loss, aux = self._steps(lrs, draws)
            self.warm = self.on_card
        if self.on_card:
            for st in ts.optimizer.state.values():
                st["step"] += k
        ts.step += k
        with warnings.catch_warnings():
            # Adam's own step() did not run on the card
            warnings.filterwarnings("ignore", "Detected call of")
            for _ in range(k):
                ts.scheduler.step()
        # copies: the next replay overwrites the graph's outputs
        metrics = {"loss": loss.detach().clone(), "lr": lrs[-1]}
        metrics.update({n: v.detach().clone()
                        for n, v in aux._asdict().items()})
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
    `generator` in that order; at more than one rank, the chunk's noise
    is the global batch's (x holds this rank's slice of it) and the
    rank's rows are kept. Frames are encoded and decoded in
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
        rank, count = multihost.process_index(), multihost.process_count()
        for c in range(n_samples // chunk):
            e = eps[c] if eps is not None else eval_lib.chunk_noise(
                cfg, bsz * count, chunk, hp.nt_cond, nt, o, o, generator,
                x.device, rows=(rank * bsz, (rank + 1) * bsz))
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
    better; drives the best-model selection), over every rank's videos.
    Leaves the model in training mode."""
    total, n = 0.0, 0
    for j, batch in enumerate(val_iter):
        if j >= n_iter_test:
            break
        pred_psnr = eval_batch_fn(model, to_device(batch, device), generator)
        total += float(pred_psnr.sum())
        n += pred_psnr.shape[0]
    model.train()
    total, n = multihost.host_sum([total, n])
    return -total / max(n, 1)
