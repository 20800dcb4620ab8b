#!/usr/bin/env python
"""Where the time of the port's best-of-N evaluation goes, on one GPU.

    python scripts/profile_torch_eval.py [--chunks 5] [--seed 0]

Runs `srvp_tpu_torch.eval_lib.compute_chunk` + selection at the full width
of the Stochastic Moving MNIST dcgan model (seeded random weights) on one
batch of 16 synthetic videos, 10 samples per chunk, 5 conditioning and 20
predicted frames: a warm-up chunk, then `--chunks` chunks under
torch.profiler. Prints one JSON line: the card's name and power limit, wall
ms per chunk, device-busy ms per chunk (the sum of kernel times; one stream,
so kernels do not overlap), the device's idle share, and the kernels grouped
by name with their share of device time. Needs CUDA.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from srvp_tpu_torch import eval_lib  # noqa: E402
from srvp_tpu_torch.config import model_config, strict_fp32  # noqa: E402
from srvp_tpu_torch.models.srvp import SRVP  # noqa: E402

import chip_smoke  # noqa: E402  (flagship config and synthetic videos)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chunks", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_eval: needs CUDA")
    strict_fp32()
    cfg_d = chip_smoke.XP_CONFIG
    torch.manual_seed(args.seed)
    model = SRVP(model_config(cfg_d)).cuda().eval()
    nt_cond, nt_test = cfg_d["nt_cond"], cfg_d["seq_len_test"]
    bsz, chunk = chip_smoke.BATCH, chip_smoke.CHUNK
    seqs = chip_smoke.synthetic_sequences(bsz, nt_test, cfg_d["nx"],
                                          seed=args.seed)
    x = torch.from_numpy(seqs[..., None].astype(np.float32) / 255.0).cuda()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    carry = eval_lib.init_select_carry(
        ["psnr", "ssim"], bsz, nt_test - nt_cond, nt_cond, x.shape[2:], 5,
        "cuda")

    def run_chunk(carry, c):
        eps = eval_lib.chunk_noise(model.cfg, bsz, chunk, nt_cond, nt_test,
                                   1, 1, gen, "cuda")
        return eval_lib.select_chunk(carry, model, x[:nt_cond], x[nt_cond:],
                                     chunk, c * chunk, 1, 1, eps)

    carry = run_chunk(carry, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in range(1, args.chunks + 1):
            carry = run_chunk(carry, c)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.chunks

    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.device_time_total > 0:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values()) / args.chunks
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi_line(),
        "chunks": args.chunks, "videos": bsz, "samples_per_chunk": chunk,
        "wall_ms_per_chunk": wall_ms, "device_busy_ms_per_chunk": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernels": [dict(name=name[:90], ms_per_chunk=v[0] / args.chunks,
                         calls_per_chunk=v[1] / args.chunks,
                         share=v[0] / args.chunks / busy_ms)
                    for name, v in top]}))


if __name__ == "__main__":
    main()
