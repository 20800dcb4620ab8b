"""The reference's training steps: the plain model's ELBO, its gradients and
Adam, written out, in float32 with TF32 off (or, with `quant`, the fp8
control or the bf16 witness).

Adam at torch's defaults (b1 0.9, b2 0.999, eps 1e-8) at a constant
learning rate, the port's schedule for its first steps (its burn-in runs
for the whole benchmark).
"""

import torch

from perfbench.reference.model import SRVP, composite, elbo, training_draws

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def frames(batch, nx):
    """A training batch as float32 (T, B, H, W, C) in [0, 1]: uint8 frames,
    or Moving MNIST parts ({"digits", "pos"}) composited here."""
    if isinstance(batch, dict):
        batch = composite(batch["digits"], batch["pos"], nx)
    return batch.float() / 255.0


def steps(cfg, hp, state, batches, noise_seed, device, quant=None):
    """Runs len(batches) training steps from the weights `state` (a
    state_dict) on `batches`, drawing each step's noise from a CUDA (or
    CPU) generator seeded with noise_seed as the port's step draws it.
    Returns a dict: each step's loss, reconstruction term and KL_z term
    ([float], a video's), the first step's gradient of every parameter
    (`grads`) and the difference between its parts from the even and the
    odd videos of the batch (`split`: the batch's own sampling noise, what
    the gradient moves by when the loss takes some of the rows alone),
    each {name: float32 tensor on the host}, the norm of every
    parameter's change over the steps ({name: float}) and the first
    step's reconstructed frames."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = SRVP(cfg).to(device)
    model.load_state_dict(state)
    model.set_quant(quant).train()
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    out = {"losses": [], "nlls": [], "kl_zs": [], "grads": None,
           "split": None, "recon": None}
    for t, batch in enumerate(batches, start=1):
        x = frames(batch, cfg["nx"])
        draws = training_draws(cfg, x.shape[0], x.shape[1],
                               hp["oversampling"], gen, device)
        model.zero_grad(set_to_none=True)
        loss, nll, kl_z, x_, rows = elbo(model, x, hp, draws)
        for key, val in (("losses", loss), ("nlls", nll), ("kl_zs", kl_z)):
            out[key].append(float(val.detach()))
        if t == 1:
            out["recon"] = x_.detach().clone()
            # the gradient in two parts, the even videos' and the odd
            # ones'; their sum is the step's gradient
            rows[0::2].sum().backward(retain_graph=True)
            even = {k: p.grad.detach().clone() for k, p in params.items()}
            rows[1::2].sum().backward()
            out["grads"] = {k: p.grad.detach().float().cpu()
                            for k, p in params.items()}
            out["split"] = {k: (2 * even[k] - p.grad).float().cpu()
                            for k, p in params.items()}
            del even
        else:
            loss.backward()
        with torch.no_grad():
            b1, b2 = BETAS
            for k, p in params.items():
                g = p.grad
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k] / (1 - b2 ** t)).sqrt_().add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-hp["lr"] / (1 - b1 ** t))
        del loss, rows, x, draws
    out["change"] = {k: float((p.detach() - start[k]).norm())
                     for k, p in params.items()}
    return out
