"""Gaussian raw-parameter math (counterpart of srvp_tpu/ops/dists.py).

Raw params hold the mean in their first half and a raw scale in their second
half along the last axis; scale = softplus(raw) + 1e-8.
"""

import torch
import torch.nn.functional as F

EPS = 1e-8


def split_raw_params(raw_params):
    """Splits raw params into (loc, scale). F.softplus returns x above its
    threshold of 20, where log1p(exp(-x)) < 2.1e-9 — below the 1e-8 floor."""
    loc, raw_scale = torch.chunk(raw_params, 2, dim=-1)
    return loc, F.softplus(raw_scale) + EPS


def rsample(raw_params, eps):
    """Reparameterized sample with injected standard-normal noise `eps`."""
    loc, scale = split_raw_params(raw_params)
    return loc + eps * scale
