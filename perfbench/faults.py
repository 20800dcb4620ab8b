"""Faults planted in the program, for the checks that `correct` catches
them (perfbench/tests/test_perfbench_correct.py on the CPU, and
`calibrate --fault` on the chip at a cell's own size). Each is a context
manager that replaces one function of the program for its body.

- "unchanged": a training step that returns the state unchanged (the
  loss and gradients computed, no update);
- "half_batch": a training step whose forward runs the whole batch and
  whose loss is the mean over its first half of rows alone (the other
  half left out of every term);
- "altered_eval": the evaluation's PSNR of video 0 raised by 0.05 dB in
  every sample, where a chunk produces it;
- "altered_serve": the first video's frames of every serving call raised
  by 16 levels, where the call produces them.
"""

import contextlib

import torch


def _frozen_step(ts, x, hp, **noise):
    from srvp_tpu_torch import train_lib
    loss, aux = train_lib.loss_and_grads(ts.model, x, hp, **noise)
    ts.model.zero_grad(set_to_none=True)
    return {"loss": loss.detach(), "lr": hp.lr,
            **{k: v.detach() for k, v in aux._asdict().items()}}


def _half_rows_elbo(model, x, *, oversampling, obs_scale, beta_y, beta_z,
                    l2_res, use_kernel=False, compute_dtype=None, **noise):
    """The port's objectives.elbo_loss with every term summed over the
    first half of the videos and divided by their number."""
    from srvp_tpu_torch.data.device_compose import materialize
    from srvp_tpu_torch.objectives import LossAux
    from srvp_tpu_torch.ops import dists
    x = materialize(x, model.cfg.nx)
    nt, bsz = x.shape[0], x.shape[1]
    h = bsz // 2
    out = model(x, nt, oversampling, use_kernel=use_kernel,
                compute_dtype=compute_dtype, **noise)
    nll = dists.neg_logprob(out.x_[:, :h], x[:, :h], scale=obs_scale).sum()
    kl_y_0 = dists.kl_raw_vs_std_normal(out.q_y_0_params[:h]).sum()
    kl_z = dists.kl_raw_vs_raw(out.q_z_params[:, :h],
                               out.p_z_params[:, :h]).sum()
    loss = nll + beta_y * kl_y_0 + beta_z * kl_z
    l2 = x.new_zeros(())
    if l2_res > 0:
        l2 = torch.linalg.vector_norm(out.res[:, :h], dim=2).sum()
        loss = loss + l2_res * l2
    return loss / h, LossAux(nll / h, kl_y_0 / h, kl_z / h, l2 / h)


def _altered_chunk(original):
    def chunk(*args, **kwargs):
        x_pred, x_rec, metrics = original(*args, **kwargs)
        metrics["psnr"] = metrics["psnr"].clone()
        metrics["psnr"][:, 0] += 0.05
        return x_pred, x_rec, metrics
    return chunk


def _altered_load(original):
    def load(path, device="cuda"):
        fn, header = original(path, device)

        def call(x, seed):
            y = fn(x, seed).clone()
            y[:, 0] = (y[:, 0].int() + 16).clamp(max=255).to(y.dtype)
            return y
        return call, header
    return load


@contextlib.contextmanager
def planted(name):
    from srvp_tpu_torch import eval_lib, export, train_lib
    target = {"unchanged": (train_lib, "train_step"),
              "half_batch": (train_lib, "elbo_loss"),
              "altered_eval": (eval_lib, "compute_chunk"),
              "altered_serve": (export, "load_serving")}[name]
    original = getattr(*target)
    new = {"unchanged": lambda: _frozen_step,
           "half_batch": lambda: _half_rows_elbo,
           "altered_eval": lambda: _altered_chunk(original),
           "altered_serve": lambda: _altered_load(original)}[name]()
    setattr(*target, new)
    try:
        yield
    finally:
        setattr(*target, original)
