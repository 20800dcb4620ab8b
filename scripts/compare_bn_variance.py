#!/usr/bin/env python
"""How far the port's training-step gradients are from the JAX package's,
with JAX's one-pass batch variance and with a two-pass one, on the CPU.

    JAX_PLATFORMS=cpu python scripts/compare_bn_variance.py [--conv_gain 10]

JAX takes the batch variance of its batch norm as E[x^2] - mean^2 in
float32 (srvp_tpu/models/layers.py `_bn_stats_fwd`); torch takes it in two
passes. On the tiny configuration and JAX draws of
tests/test_torch_train.py, this prints, for each variance form, the worst
|g_port - g_jax| / (5e-5 + 5e-3 |g_jax|) over every parameter and the three
worst parameters, as one JSON line.
"""

import argparse
import json
import os
import sys

import numpy as np

import jax
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from srvp_tpu.models import layers as jlayers  # noqa: E402
from srvp_tpu_torch.objectives import elbo_loss  # noqa: E402
from tests.test_torch_train import (GRAD_ATOL, GRAD_RTOL, LOSS_KW,  # noqa
                                    grads_in_port_layout, jax_value_and_grad,
                                    two_pass_bn_stats)
from tests.torch_port_util import (configs, jax_draws, jax_model,  # noqa
                                   port_model, t)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--conv_gain", type=float, default=10.0)
    args = p.parse_args()
    jcfg, cfg = configs()
    params, state = jax_model(jcfg, seed=1, conv_gain=args.conv_gain)
    nt, bsz = 5, 4
    x = np.random.RandomState(0).rand(nt, bsz, 64, 64, 1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    kw = dict(oversampling=1, **LOSS_KW)

    model = port_model(params, state, cfg).train()
    loss, _ = elbo_loss(model, t(x), **kw, **jax_draws(key, jcfg, nt, bsz, 1))
    loss.backward()
    ours = {k: p.grad.numpy() for k, p in model.named_parameters()}

    out = {"conv_gain": args.conv_gain}
    one_pass = jlayers._bn_stats_fwd
    for name, stats in (("one_pass", one_pass),
                        ("two_pass", two_pass_bn_stats)):
        jlayers._bn_stats_fwd = stats
        try:
            _, grads = jax_value_and_grad(jcfg, **kw)(params, state, x, key)
        finally:
            jlayers._bn_stats_fwd = one_pass
        ref = grads_in_port_layout(grads, state, cfg)
        worst = {k: float(np.max(np.abs(g - ref[k].numpy()) / (
            GRAD_ATOL + GRAD_RTOL * np.abs(ref[k].numpy()))))
            for k, g in ours.items()}
        rel = {k: float(np.max(np.abs(g - ref[k].numpy()))
                        / np.max(np.abs(ref[k].numpy())))
               for k, g in ours.items()}
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
        out[name] = dict(worst_err_over_tol=top[0][1], worst=top,
                         worst_err_over_max_grad=max(rel.values()))
    print(json.dumps(out))


if __name__ == "__main__":
    torch.manual_seed(0)
    main()
