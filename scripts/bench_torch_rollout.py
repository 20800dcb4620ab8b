#!/usr/bin/env python
"""Times the port's latent-rollout kernels (1: prior rollout; 2: training
forward; 3: training backward) at the main paths' shapes, on one GPU.

    python scripts/bench_torch_rollout.py [--root DIR] [--tag NAME]
        [--reps 20] [--kernels 1,2,3] [--plans]

`--root` names the checkout whose `srvp_tpu_torch` is timed (default: this
one), so that two commits can be timed in turns in one process tree on one
card: unpack the other with `git archive` and run this script against
each, A, B, B, A. Shapes, with seeded random weights at the flagship widths
(p_z and dynamics MLPs of 4 layers, 512 hidden units; q 256 -> 2 nz):
kernel 1 at the dcgan evaluation chunk (B = 160, 20 substeps, ny = nz = 20),
a whole dcgan batch (B = 1600) and the KTH evaluation chunk (B = 160, 60
substeps at o = 2, ny = nz = 50); kernels 2 and 3 at the dcgan training
step (B = 128, K = 14) and the KTH one (B = 100, K = 38, o = 2). Each time
is the mean of `--reps` calls after 3 warm-up calls, by CUDA events around
the wrapper (kernel 3: the autograd backward of the rollout's outputs),
and beside it each kernel's own device time a call (`*_device_ms`, by
torch.profiler over another `--reps` calls: the prior rollout, the
forward, the backward's carry pass and weight-gradient pass), which holds
no host time. Where the checkout's wrapper records its backward's parts
(`rollout_train.bwd_events`), the carry pass, the weight-gradient pass and
the rest of the wrapper are also given apart by CUDA events.

`--kernels` picks which to time (2 and 3 go together). `--plans` also
times kernel 1 at B = 160 (dcgan) and kernel 2 at B = 128 (the dcgan
training step) at every cluster plan that fits one wave (one block an SM,
as `kernels/rollout.cluster_plan` requires) and fits each to
t = a + alpha R + beta / C (us a substep, device time) by least squares on
the relative error: the cost model behind that plan, whose WEIGHT_ROWS is
beta / alpha; kernel 3's carry pass at B = 128 at every such plan; and
kernel 3's weight-gradient pass at every split S (blocks of a cluster
sharing a tile's row sum) the card can schedule, at the dcgan step (B =
128) and the KTH one (B = 100, K = 38), beside the plan's cost
(`rollout_train.wgrad_cost`), the card's occupancy and the split
`wgrad_plan` picks; and at each split the pass alone on N(0, 1) sources
of those shapes against float64 (`wgrad_accuracy`): its largest error
norm over cuBLAS's (torch.mm, TF32 off) of any layer, its largest
element error in unit roundoffs of sum |g a|, and the element-wise
reading of parity.agreement at rtol 5e-4 / atol 5e-6 against cuBLAS with
the float64 arbiter.

Prints one JSON line with the card's name and power limit. Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

DCGAN = dict(ny=20, nz=20)
KTH = dict(ny=50, nz=50)
NH, NH_INF, NLAYERS = 512, 256, 4


def cuda_ms(torch, fn, warmup=3, reps=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# the kernels, by a part of their names
KERNELS = {"prior_rollout_kernel": "prior", "train_rollout_fwd_kernel": "fwd",
           "train_rollout_bwd_carry_kernel": "carry",
           "train_rollout_wgrad_kernel": "wgrad"}


def device_ms(torch, fn, reps):
    """Device ms a call of each rollout kernel that `fn` launches, by
    torch.profiler over `reps` calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        for part, short in KERNELS.items():
            if part in ev.name and ev.device_time_total > 0:
                out[short] = out.get(short, 0.0) \
                    + ev.device_time_total / 1e3 / reps
    return out


def plan_fit(rows, n_steps):
    """t (us a substep) = a + alpha R + beta / C over rows of (R, C, device
    ms), least squares on the relative error (each row divided by its t)."""
    a = np.array([[1.0, r, 1.0 / c] for r, c, _ in rows])
    t = np.array([1e3 * dev / n_steps for _, _, dev in rows])
    (c0, alpha, beta), *_ = np.linalg.lstsq(a / t[:, None], t / t,
                                            rcond=None)
    return dict(a=c0, alpha=alpha, beta=beta, weight_rows=beta / alpha)


def one_wave(kr, bsz, resident):
    """The plans of a batch of bsz rows that fit one wave: one block an SM,
    and no more clusters than resident(plan) says the card holds."""
    for c in kr.CLUSTERS:
        for r in kr.ROWS:
            plan = kr.Plan(r, c, -(-bsz // r))
            if plan.tiles * c <= kr.N_SMS and plan.tiles <= resident(plan):
                yield plan


def wgrad_accuracy(torch, krt, parity, shapes, n_rows, plan, gen):
    """The weight-gradient pass at split `plan` on N(0, 1) sources of these
    shapes and n_rows rows, against float64 and cuBLAS in fp32."""
    widths = krt.wgrad_source_widths(shapes, 4)
    a_src, g_src = ([torch.randn(n_rows, w, generator=gen, device="cuda")
                     for w in ws] for ws in widths)
    out = krt.weight_gradients(shapes, 4, a_src, g_src, plan)
    lib = krt.weight_gradients_reference(shapes, 4, a_src, g_src)
    f64 = krt.weight_gradients_reference(
        shapes, 4, [a.double() for a in a_src], [g.double() for g in g_src])
    mag = krt.weight_gradients_reference(
        shapes, 4, [a.double().abs() for a in a_src],
        [g.double().abs() for g in g_src])
    u = 2.0 ** -24
    return dict(
        norm_over_cublas=max((o.double() - r).norm().item()
                             / (c.double() - r).norm().item()
                             for o, c, r in zip(out, lib, f64)),
        bound_units=max(((o.double() - r).abs() / (u * m)).max().item()
                        for o, r, m in zip(out, f64, mag)),
        agreement=max(parity.agreement(o, c, r, 5e-4, 5e-6)[1]
                      for o, c, r in zip(out, lib, f64)))


def layers(torch, MLP, ny, nz, seed):
    torch.manual_seed(seed)
    q = torch.nn.Linear(NH_INF, 2 * nz).cuda()
    pz = MLP(ny, NH, 2 * nz, NLAYERS).cuda().linears()
    dyn = MLP(ny + nz, NH, ny, NLAYERS).cuda().linears()
    return (q.weight, q.bias), pz, dyn


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--tag", default="")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--kernels", default="1,2,3")
    p.add_argument("--plans", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_rollout: needs a CUDA device")
    from srvp_tpu_torch.config import strict_fp32
    from srvp_tpu_torch.kernels import parity
    from srvp_tpu_torch.kernels import rollout as kr
    from srvp_tpu_torch.kernels import rollout_train as krt
    from srvp_tpu_torch.models.mlp import MLP
    strict_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = dict(tag=args.tag, root=os.path.abspath(args.root), device=smi,
               torch=torch.__version__)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def prior(name, dims, bsz, n_steps, o, **kw):
        _, pz, dyn = layers(torch, MLP, dims["ny"], dims["nz"], 0)
        y0 = torch.randn(bsz, dims["ny"], generator=gen, device="cuda")
        eps = torch.randn(n_steps, bsz, dims["nz"], generator=gen,
                          device="cuda")
        call = lambda: kr.prior_rollout(  # noqa: E731
            pz, dyn, y0, eps, dims["ny"], dims["nz"], o, **kw)
        with torch.no_grad():
            ms = cuda_ms(torch, call, reps=args.reps)
            return ms, device_ms(torch, call, args.reps).get("prior")

    kernels = args.kernels.split(",")
    if "1" in kernels:
        for key, dims, bsz, n_steps, o in (
                ("k1_dcgan_B160", DCGAN, 160, 20, 1),
                ("k1_dcgan_B1600", DCGAN, 1600, 20, 1),
                ("k1_kth_B160", KTH, 160, 60, 2)):
            out[f"{key}_ms"], out[f"{key}_device_ms"] = prior(
                key, dims, bsz, n_steps, o)

    train = (("dcgan", DCGAN, 128, 14, 1), ("kth", KTH, 100, 38, 2)) \
        if "2" in kernels or "3" in kernels else ()
    for name, dims, bsz, k_steps, o in train:
        q, pz, dyn = layers(torch, MLP, dims["ny"], dims["nz"], 1)
        y0 = torch.randn(bsz, dims["ny"], generator=gen, device="cuda")
        hxz = torch.randn(k_steps, bsz, NH_INF, generator=gen, device="cuda")
        eps = torch.randn(k_steps, bsz, dims["nz"], generator=gen,
                          device="cuda")
        y0.requires_grad_()
        hxz.requires_grad_()
        leaves = [y0, hxz] + [t for w, b in [q, *pz, *dyn] for t in (w, b)]
        forward = lambda: krt.train_rollout(  # noqa: E731
            q, pz, dyn, y0, hxz, eps, o)
        with torch.no_grad():
            out[f"k2_{name}_ms"] = cuda_ms(torch, forward, reps=args.reps)
            out[f"k2_{name}_device_ms"] = device_ms(torch, forward,
                                                    args.reps).get("fwd")
        outs = krt.train_rollout(q, pz, dyn, y0, hxz, eps, o)
        cots = [torch.ones_like(t) for t in outs]
        backward = lambda: torch.autograd.grad(  # noqa: E731
            outs, leaves, cots, retain_graph=True)
        out[f"k3_{name}_ms"] = cuda_ms(torch, backward, reps=args.reps)
        dev = device_ms(torch, backward, args.reps)
        for part in ("carry", "wgrad"):
            out[f"k3_{name}_{part}_device_ms"] = dev.get(part)
        if hasattr(krt, "bwd_events"):
            krt.bwd_events = []
            for _ in range(args.reps):
                backward()
            torch.cuda.synchronize()
            evs, krt.bwd_events = krt.bwd_events, None
            span = lambda e, k: e[k][0].elapsed_time(e[k][-1])  # noqa
            for part in ("carry", "wgrad"):
                out[f"k3_{name}_{part}_ms"] = float(np.mean(
                    [span(e, part) for e in evs]))
            out[f"k3_{name}_rest_ms"] = float(np.mean(
                [e["start"][0].elapsed_time(e["end"][0]) for e in evs])) \
                - out[f"k3_{name}_carry_ms"] - out[f"k3_{name}_wgrad_ms"]

    if args.plans:
        _, pz, dyn = layers(torch, MLP, 20, 20, 0)
        hmax = NH
        cuda = torch.device("cuda")
        rows = [(p.rows, p.cluster) + prior("dcgan", DCGAN, 160, 20, 1,
                                            plan=p)
                for p in one_wave(kr, 160, lambda p: kr.resident_clusters(
                    20, 20, hmax, p, cuda))]
        out["k1_dcgan_B160_plans"] = [dict(rows=r, cluster=c, ms=ms,
                                           device_ms=dev)
                                      for r, c, ms, dev in rows]
        out["k1_plan_fit_us"] = plan_fit([(r, c, dev)
                                          for r, c, _, dev in rows], 20)
        out["k1_plan_chosen"] = kr.launch_plan(pz, dyn, 160, 20, 20)[0]
        out["clusters_resident_R12"] = {
            c: kr.resident_clusters(20, 20, hmax, kr.Plan(12, c, 1), cuda)
            for c in kr.CLUSTERS}
        # kernel 2 and the carry pass at the dcgan training step, by plan
        q, pz, dyn = layers(torch, MLP, 20, 20, 1)
        y0 = torch.randn(128, 20, generator=gen, device="cuda",
                         requires_grad=True)
        hxz = torch.randn(14, 128, NH_INF, generator=gen, device="cuda",
                          requires_grad=True)
        eps = torch.randn(14, 128, 20, generator=gen, device="cuda")
        lib = kr._lib()
        fwd = []
        for plan in one_wave(kr, 128, lambda p: kr.check_schedulable(
                lib.srvp_train_rollout_fwd_clusters, (20, 20, NH_INF, hmax),
                p, cuda)):
            call = lambda: krt.train_rollout_forward(  # noqa: E731
                q, pz, dyn, y0, hxz, eps, 1, plan)
            fwd.append(dict(rows=plan.rows, cluster=plan.cluster,
                            ms=cuda_ms(torch, call, reps=args.reps),
                            device_ms=device_ms(torch, call,
                                                args.reps).get("fwd")))
        out["k2_dcgan_plans"] = fwd
        out["k2_plan_fit_us"] = plan_fit(
            [(f["rows"], f["cluster"], f["device_ms"]) for f in fwd], 14)
        out["k2_dcgan_plan_chosen"] = krt.fwd_plan(128, 20, 20, NH_INF, hmax,
                                                   cuda)
        leaves = [y0, hxz] + [t for w, b in [q, *pz, *dyn] for t in (w, b)]
        carry = []
        for plan in one_wave(kr, 128, lambda p: kr.check_schedulable(
                lib.srvp_train_rollout_bwd_clusters, (20, 20, hmax), p,
                cuda)):
            outs = krt.train_rollout(q, pz, dyn, y0, hxz, eps, 1,
                                     bwd_plan=plan)
            cots = [torch.ones_like(t) for t in outs]
            dev = device_ms(torch, lambda: torch.autograd.grad(  # noqa
                outs, leaves, cots, retain_graph=True), args.reps)
            carry.append(dict(rows=plan.rows, cluster=plan.cluster,
                              device_ms=dev.get("carry")))
        out["k3_dcgan_carry_plans"] = carry
        out["k3_dcgan_carry_plan_chosen"] = krt.bwd_plan(
            128, 20, 20, hmax, cuda)
        # the weight-gradient pass at every split, dcgan then KTH
        out["k3_wgrad_occupancy"] = {
            split: krt.wgrad_occupancy(split, cuda) for split in kr.CLUSTERS}
        for name, dims, bsz, k_steps, o in (("dcgan", DCGAN, 128, 14, 1),
                                            ("kth", KTH, 100, 38, 2)):
            q, pz, dyn = layers(torch, MLP, dims["ny"], dims["nz"], 1)
            y0 = torch.randn(bsz, dims["ny"], generator=gen, device="cuda",
                             requires_grad=True)
            hxz = torch.randn(k_steps, bsz, NH_INF, generator=gen,
                              device="cuda", requires_grad=True)
            eps = torch.randn(k_steps, bsz, dims["nz"], generator=gen,
                              device="cuda")
            leaves = [y0, hxz] + [t for w, b in [q, *pz, *dyn]
                                  for t in (w, b)]
            shapes = krt._shapes([q, *pz, *dyn])
            n_tiles = krt.wgrad_n_tiles(shapes)
            sweep = []
            for split in kr.CLUSTERS:
                occupancy = krt.wgrad_occupancy(split, cuda)
                if occupancy[0] < 1:
                    continue
                outs = krt.train_rollout(
                    q, pz, dyn, y0, hxz, eps, o,
                    wgrad_plan=split)
                cots = [torch.ones_like(t) for t in outs]
                dev = device_ms(torch, lambda: torch.autograd.grad(  # noqa
                    outs, leaves, cots, retain_graph=True), args.reps)
                sweep.append(dict(
                    split=split, device_ms=dev.get("wgrad"),
                    cost=krt.wgrad_cost(n_tiles, bsz * k_steps, split,
                                        *occupancy),
                    **wgrad_accuracy(torch, krt, parity, shapes,
                                     bsz * k_steps,
                                     split, gen)))
            out[f"k3_{name}_wgrad_plans"] = sweep
            out[f"k3_{name}_wgrad_plan_chosen"] = krt.wgrad_plan(
                shapes, bsz * k_steps, cuda)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
