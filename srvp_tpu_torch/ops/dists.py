"""Gaussian raw-parameter math (counterpart of srvp_tpu/ops/dists.py).

Raw params hold the mean in their first half and a raw scale in their second
half along the last axis; scale = softplus(raw) + 1e-8. The ELBO's terms
(fixed-scale Gaussian NLL, analytic KLs) are elementwise, in float32 at
least (float64 stays float64).
"""

import math

import torch
import torch.nn.functional as F

EPS = 1e-8
LOG_2PI = math.log(2.0 * math.pi)


def split_raw_params(raw_params):
    """Splits raw params into (loc, scale). F.softplus returns x above its
    threshold of 20, where log1p(exp(-x)) < 2.1e-9 — below the 1e-8 floor."""
    loc, raw_scale = torch.chunk(raw_params, 2, dim=-1)
    return loc, F.softplus(raw_scale) + EPS


def rsample(raw_params, eps):
    """Reparameterized sample with injected standard-normal noise `eps`."""
    loc, scale = split_raw_params(raw_params)
    return loc + eps * scale


def _wide(x):
    return x if x.dtype == torch.float64 else x.float()


def neg_logprob(loc, data, scale=1.0):
    """Elementwise -log N(data | loc, scale) with a fixed scalar scale."""
    z = (_wide(data) - _wide(loc)) / scale
    return 0.5 * (z * z) + math.log(scale) + 0.5 * LOG_2PI


def kl_normal(loc_q, scale_q, loc_p, scale_p):
    """Elementwise KL(N(loc_q, scale_q) || N(loc_p, scale_p))."""
    var_ratio = (scale_q / scale_p) ** 2
    t1 = ((loc_q - loc_p) / scale_p) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def kl_raw_vs_std_normal(raw_params):
    """Elementwise KL between the raw-param Gaussian and N(0, 1)."""
    loc, scale = split_raw_params(_wide(raw_params))
    return kl_normal(loc, scale, 0.0, 1.0)


def kl_raw_vs_raw(raw_params_q, raw_params_p):
    """Elementwise KL between two raw-param Gaussians."""
    loc_q, scale_q = split_raw_params(_wide(raw_params_q))
    loc_p, scale_p = split_raw_params(_wide(raw_params_p))
    return kl_normal(loc_q, scale_q, loc_p, scale_p)
