"""SRVP ELBO (counterpart of srvp_tpu/objectives.py):

    loss = [ sum NLL(x_, x; obs_scale) + beta_y * sum KL(q(y_1) || N(0, 1))
           + beta_z * sum KL(q(z) || p(z)) + l2_res * sum ||res_t||_2 ] / B

Sums run over all elements; B is the batch size.
"""

from typing import NamedTuple

import torch

from srvp_tpu_torch.data.device_compose import materialize
from srvp_tpu_torch.ops import dists


class LossAux(NamedTuple):
    nll: torch.Tensor
    kl_y_0: torch.Tensor
    kl_z: torch.Tensor
    l2_res: torch.Tensor


def elbo_loss(model, x, *, oversampling, obs_scale, beta_y, beta_z, l2_res,
              use_kernel=False, compute_dtype=None, **noise):
    """Returns (loss, LossAux). x: (T, B, H, W, C) float in [0, 1], uint8, or
    a Moving MNIST parts dict (composited on the device). `compute_dtype`
    is the encoder's and decoder's (SRVP.forward; x's when None); the
    terms are summed in float32 at least (ops/dists.py). `noise` goes to
    SRVP.forward (skip_t, frame_idx, eps_y, eps_pos, generator); the model
    should be in training mode."""
    x = materialize(x, model.cfg.nx)
    nt, bsz = x.shape[0], x.shape[1]
    out = model(x, nt, oversampling, use_kernel=use_kernel,
                compute_dtype=compute_dtype, **noise)
    nll = dists.neg_logprob(out.x_, x, scale=obs_scale).sum()
    kl_y_0 = dists.kl_raw_vs_std_normal(out.q_y_0_params).sum()
    kl_z = dists.kl_raw_vs_raw(out.q_z_params, out.p_z_params).sum()
    loss = nll + beta_y * kl_y_0 + beta_z * kl_z
    l2 = x.new_zeros(())
    if l2_res > 0:
        l2 = torch.linalg.vector_norm(out.res, dim=2).sum()
        loss = loss + l2_res * l2
    return loss / bsz, LossAux(nll / bsz, kl_y_0 / bsz, kl_z / bsz,
                               l2 / bsz)
