#!/usr/bin/env python
"""Kernel 3's gradients against the plain training rollout over seeds, on
one GPU: how often the element-wise check with the float64 arbiter
(kernels/parity.agreement) fails without a fault, and how the kernel's
error compares with the plain fp32 run's.

    python scripts/train_rollout_seeds.py [--shapes human kth bair]
        [--seeds 6]

For each shape (chip_smoke's Human3.6M, KTH and BAIR training rollouts:
B = 100, K = 30; B = 100, K = 38; B = 192, K = 22; o = 2, ny = nz = 50,
the models of chip_smoke's checks) and each seed: kink-free inputs
(parity.kink_free_inputs at chip_smoke.KTH_KINK_MARGIN), the gradients of
parity.rollout_loss through the kernels, the plain version in fp32 and in
float64; prints one JSON line a seed: the worst leaf's arbitrated error
over the tolerance (rtol 5e-4, atol 5e-6), its raw error, the elements
excused, each leaf's ratio of the kernel's error norm to the plain run's
(both against float64), and the worst element's values. Needs CUDA.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (configurations, seeds, tolerances)
from srvp_tpu_torch.config import model_config, strict_fp32  # noqa: E402
from srvp_tpu_torch.kernels import build as kbuild  # noqa: E402
from srvp_tpu_torch.kernels import parity  # noqa: E402
from srvp_tpu_torch.kernels import rollout_train as krt  # noqa: E402
from srvp_tpu_torch.models.srvp import SRVP  # noqa: E402

# shape: (config, batch, substeps, model seed, first input seed), as
# chip_smoke's checks draw them
SHAPES = {
    "human": (chip_smoke.HUMAN_CONFIG, 100, 30, chip_smoke.SEED + 25, 26),
    "kth": (chip_smoke.KTH_CONFIG, 100, 38, chip_smoke.SEED + 7, 9),
    "bair": (chip_smoke.BAIR_CONFIG, 192, 22, chip_smoke.SEED + 22, 23),
}


def seed_row(name, model, bsz, n_steps, seed):
    q = (model.q_z.weight, model.q_z.bias)
    pz, dyn = model.p_z.linears(), model.dynamics.linears()
    flat = [t.detach() for w, b in [q] + list(pz) + list(dyn)
            for t in (w, b)]
    n_pz = len(pz)
    names = chip_smoke.leaf_names(n_pz, len(dyn))
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + seed)
    y0, hxz, eps, redrawn = parity.kink_free_inputs(
        q, pz, dyn, bsz, n_steps, 2, gen, chip_smoke.KTH_KINK_MARGIN)
    grads = {}
    for route, fn, dtype in (("kernel", krt.train_rollout, torch.float32),
                             ("plain", krt.train_rollout_reference,
                              torch.float32),
                             ("f64", krt.train_rollout_reference,
                              torch.float64)):
        lv = [t.to(dtype, copy=True).requires_grad_()
              for t in [y0, hxz] + flat]
        pairs = [(lv[i], lv[i + 1]) for i in range(2, len(lv), 2)]
        outs = fn(pairs[0], pairs[1:1 + n_pz], pairs[1 + n_pz:], lv[0],
                  lv[1], eps.to(dtype), 2)
        grads[route] = torch.autograd.grad(parity.rollout_loss(outs), lv)
    rtol, atol = chip_smoke.GRAD_RTOL, chip_smoke.GRAD_ATOL
    leaves = []
    for i, (k, p, d) in enumerate(zip(*grads.values())):
        raw, judged, excused = parity.agreement(k, p, d, rtol, atol)
        ratio = ((k.double() - d).norm()
                 / (p.double() - d).norm().clamp_min(1e-30)).item()
        leaves.append((judged, names[i], raw, excused, ratio))
    judged, worst, raw, excused, _ = max(leaves)
    i = names.index(worst)
    k, p, d = (grads[r][i].flatten() for r in grads)
    tol = atol + rtol * d.abs()
    excess = ((k.double() - d).abs() - (p.double() - d).abs()) / tol
    j = int(torch.argmax(torch.minimum(
        ((k - p).abs() / (atol + rtol * p.abs())).double(), excess)))
    return dict(shape=name, seed=seed, rows_redrawn=redrawn, worst=worst,
                err_over_tol_f64=judged, err_over_tol=raw,
                elements_excused=excused,
                norm_err_ratio_kernel_over_plain={
                    leaf[1]: leaf[4] for leaf in leaves},
                worst_element=dict(kernel=float(k[j]), plain=float(p[j]),
                                   f64=float(d[j]),
                                   leaf_max=float(d.abs().max())))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="+", choices=sorted(SHAPES),
                   default=["human", "kth", "bair"])
    p.add_argument("--seeds", type=int, default=6)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("train_rollout_seeds: needs CUDA")
    strict_fp32()
    kbuild.build()
    kbuild.load_library()
    for name in args.shapes:
        cfg, bsz, n_steps, model_seed, first = SHAPES[name]
        torch.manual_seed(model_seed)
        model = SRVP(model_config(cfg)).cuda().eval()
        for seed in range(first, first + args.seeds):
            print(json.dumps(seed_row(name, model, bsz, n_steps, seed)),
                  flush=True)


if __name__ == "__main__":
    main()
