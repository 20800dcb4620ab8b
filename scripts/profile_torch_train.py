#!/usr/bin/env python
"""Where the time of the port's training step goes, on one GPU.

    python scripts/profile_torch_train.py [--config smmnist-dcgan|kth-vgg]
        [--precision float32|bfloat16] [--steps 5] [--seed 0]
        [--steps_per_dispatch 1]

Runs `srvp_tpu_torch.train_lib.train_step` at the full width of a published
configuration with its seeded training init: `smmnist-dcgan`
(chip_smoke.XP_CONFIG) on batches of 128 synthetic Moving MNIST videos of
15 frames (digits composited on the device), or `kth-vgg`
(chip_smoke.KTH_CONFIG) on batches of 100 windows of 20 frames from a
synthetic packed KTH tree, o = 2; each from the trainer's own loader, with
the training rollout and the vgg pools and upsamples through their CUDA
kernels, the encoder and decoder in `--precision` (the trainer's flag):
three warm-up steps, then `--steps` steps timed by the host clock (ending
in a synchronise) and traced by torch.profiler. With `--steps_per_dispatch
K` > 1 the steps go as the trainer's windows of K (train_lib.WindowStep:
on the card one replay of a CUDA graph of K steps): two warm-up windows
(the eager one and the one that captures), then `--steps` / K windows; the
ATen ops of a replay are not traced, its kernels are. Prints one JSON
line: the card's name and power limit, ms per step and frames/s, the peak
device memory (allocated, and reserved), device-busy ms per step (the sum
of kernel times; one stream, so kernels do not overlap), the device's idle
share, the share of the port's own kernels (rollout, spatial), the device
time by kernel family (FAMILIES), the kernels grouped by name with their
share of device time, and the ATen ops that launched the most device
time. Needs CUDA.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from srvp_tpu_torch import train_lib, train_main  # noqa: E402
from srvp_tpu_torch.config import model_config, strict_fp32  # noqa: E402
from srvp_tpu_torch.data.device_compose import (  # noqa: E402
    stack_batches, to_device)
from srvp_tpu_torch.data.loader import infinite_batches  # noqa: E402

import chip_smoke  # noqa: E402  (configurations, trainer flags, data)

# the kernels and ops listed by name
TOP = 15
# the port's own kernels, by a part of their names
OWN_KERNELS = {"rollout": ("rollout",),
               "spatial": ("maxpool_fwd_kernel", "maxpool_bwd_kernel",
                           "upsample_fwd_kernel", "upsample_bwd_kernel")}


# kernel families by a part of their names, the first that matches: the
# port's kernels; cuDNN's batch norm (fp32) and its NCHW <-> NHWC layout
# transposes; cuDNN's convolutions, FFT ones (complex GEMMs and pointwise
# products) included; the remaining GEMMs; ATen's reductions (the bf16
# batch norm's statistics among them) and elementwise kernels (its
# normalisation, casts and the LeakyReLU among them)
FAMILIES = [
    ("rollout (port)", ("rollout",)),
    ("pool/upsample (port)", OWN_KERNELS["spatial"]),
    ("batch norm (cuDNN, ATen)", ("bn_fw", "bn_bw", "batch_norm",
                                  "batchnorm")),
    ("layout transpose (cuDNN)", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "fft",
                             "winograd", "complex", "cf32", "cudnn")),
    ("GEMM (cuBLAS, cuDNN GEMM convs)", ("gemm", "cutlass", "cublas")),
    ("reduction (ATen)", ("reduce",)),
    ("elementwise (ATen)", ("elementwise", "vectorized", "unrolled")),
    ("copy", ("copy", "memcpy", "memset")),
]


def op_table(prof, n, unit):
    """The TOP ATen ops by the device time of the kernels they launched
    themselves (the profiler's self device time), over n units."""
    ops = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    return [{"op": key, f"ms_per_{unit}": ms, f"calls_per_{unit}": calls}
            for key, ms, calls in sorted(ops, key=lambda t: -t[1])[:TOP]]


def family(name):
    low = name.lower()
    return next((fam for fam, parts in FAMILIES
                 if any(part.lower() in low for part in parts)), "other")


def kernel_table(prof, n, unit):
    """(device-busy ms per unit, the port's kernels' shares, device time by
    family, the TOP kernels by device time) of a torch.profiler run over n
    units."""
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.device_time_total > 0:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values()) / n
    own = {group: sum(v[0] for name, v in kernels.items()
                      if any(part in name for part in parts)) / n / busy_ms
           for group, parts in OWN_KERNELS.items()}
    fams = {}
    for name, v in kernels.items():
        fams[family(name)] = fams.get(family(name), 0.0) + v[0] / n
    fams = {fam: {f"ms_per_{unit}": ms, "share": ms / busy_ms}
            for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1])}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return busy_ms, own, fams, [
        {"name": name[:90], f"ms_per_{unit}": v[0] / n,
         f"calls_per_{unit}": v[1] / n, "share": v[0] / n / busy_ms}
        for name, v in top]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=["smmnist-dcgan", "kth-vgg"],
                   default="smmnist-dcgan")
    p.add_argument("--precision", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    args = p.parse_args()
    if args.steps % args.steps_per_dispatch:
        sys.exit("profile_torch_train: --steps_per_dispatch must divide "
                 "--steps")
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs CUDA")
    strict_fp32()
    with tempfile.TemporaryDirectory() as tmp:
        run(args, tmp)


def run(args, tmp):
    if args.config == "kth-vgg":
        chip_smoke.write_kth_packed_tree(tmp, 64, args.seed)
        opt = chip_smoke.train_args(tmp, tmp, args.steps,
                                    cfg=chip_smoke.KTH_CONFIG,
                                    batch_size=chip_smoke.KTH_TRAIN_BATCH,
                                    precision=args.precision)
    else:
        opt = chip_smoke.train_args(tmp, tmp, args.steps,
                                    precision=args.precision)
    opt.seed = args.seed
    hp = train_main.train_hparams(opt)
    torch.manual_seed(opt.seed)
    if args.steps_per_dispatch > 1:   # as the trainer runs windows
        train_lib.expandable_segments()
    ts = train_lib.init_train_state(model_config(vars(opt)), hp, "cuda",
                                    res_gain=opt.res_gain)
    ts.generator = torch.Generator(device="cuda").manual_seed(opt.seed)
    k = opt.steps_per_dispatch = args.steps_per_dispatch
    batches = infinite_batches(train_main.loaders(opt)[0])
    window = train_lib.WindowStep(ts, hp, k) if k > 1 else None

    def step():
        """One dispatch: a step, or a window of k."""
        if window is None:
            return train_lib.train_step(ts, to_device(next(batches), "cuda"),
                                        hp, generator=ts.generator)
        return window(to_device(stack_batches(
            [next(batches) for _ in range(k)]), "cuda"))

    for _ in range(3 if window is None else 2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps // k):
            metrics = step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    busy_ms, own, fams, top = kernel_table(prof, args.steps, "step")
    frames = opt.seq_len * opt.batch_size
    print(json.dumps({
        "config": args.config, "precision": args.precision,
        "steps_per_dispatch": k, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi_line(),
        "steps": args.steps, "batch": opt.batch_size, "seq_len": opt.seq_len,
        "oversampling": opt.n_euler_steps, "loss": float(metrics["loss"]),
        "wall_ms_per_step": wall_ms, "frames_per_s": frames / wall_ms * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        # a graph's pool, taken at its capture (a warm-up window), shows
        # here and not in the allocated peak
        "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "own_kernel_shares": own, "families": fams, "kernels": top,
        "ops": op_table(prof, args.steps, "step")}))


if __name__ == "__main__":
    main()
