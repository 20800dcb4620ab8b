#!/usr/bin/env python
"""Where the time of the port's training step goes, on one GPU.

    python scripts/profile_torch_train.py [--steps 5] [--seed 0]

Runs `srvp_tpu_torch.train_lib.train_step` at the full width of the
Stochastic Moving MNIST dcgan model (chip_smoke.XP_CONFIG, seeded training
init) on batches of 128 synthetic Moving MNIST videos of 15 frames from the
trainer's own loader (digits composited on the device), with the training
rollout through its CUDA kernels: three warm-up steps, then `--steps` steps
timed by the host clock (ending in a synchronise) and traced by
torch.profiler. Prints one JSON line: the card's name and power limit, ms
per step and frames/s (15 x 128 frames a step), device-busy ms per step (the
sum of kernel times; one stream, so kernels do not overlap), the device's
idle share, and the kernels grouped by name with their share of device
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
from srvp_tpu_torch.data.device_compose import to_device  # noqa: E402
from srvp_tpu_torch.data.loader import infinite_batches  # noqa: E402

import chip_smoke  # noqa: E402  (flagship config and trainer flags)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs CUDA")
    strict_fp32()
    with tempfile.TemporaryDirectory() as tmp:
        opt = chip_smoke.train_args(tmp, tmp, args.steps)
    opt.seed = args.seed
    hp = train_main.train_hparams(opt)
    torch.manual_seed(opt.seed)
    ts = train_lib.init_train_state(model_config(vars(opt)), hp, "cuda",
                                    res_gain=opt.res_gain)
    gen = torch.Generator(device="cuda").manual_seed(opt.seed)
    batches = infinite_batches(train_main.loaders(opt)[0])

    def step():
        return train_lib.train_step(ts, to_device(next(batches), "cuda"), hp,
                                    generator=gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            metrics = step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.device_time_total > 0:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values()) / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    frames = opt.seq_len * opt.batch_size
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi_line(),
        "steps": args.steps, "batch": opt.batch_size, "seq_len": opt.seq_len,
        "loss": float(metrics["loss"]),
        "wall_ms_per_step": wall_ms, "frames_per_s": frames / wall_ms * 1e3,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernels": [dict(name=name[:90], ms_per_step=v[0] / args.steps,
                         calls_per_step=v[1] / args.steps,
                         share=v[0] / args.steps / busy_ms)
                    for name, v in top]}))


if __name__ == "__main__":
    main()
