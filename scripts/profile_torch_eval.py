#!/usr/bin/env python
"""Where the time of the port's best-of-N evaluation goes, on one GPU.

    python scripts/profile_torch_eval.py [--config smmnist-dcgan|kth-vgg]
        [--chunks 5] [--seed 0]

Runs `srvp_tpu_torch.eval_lib.compute_chunk` + selection at the full width
of a published configuration with seeded random weights on one batch of 16
synthetic videos, 10 samples per chunk: `smmnist-dcgan` (chip_smoke.XP_CONFIG;
moving glyphs, 5 conditioning and 20 predicted frames, o = 1) or `kth-vgg`
(chip_smoke.KTH_CONFIG; KTH-like videos, 10 conditioning and 30 predicted
frames, o = 2): a warm-up chunk, then `--chunks` chunks under
torch.profiler. Prints one JSON line: the card's name and power limit, wall
ms per chunk, the peak device memory, device-busy ms per chunk (the sum of
kernel times; one stream, so kernels do not overlap), the device's idle
share, the share of the port's own kernels (rollout, spatial), and the
kernels grouped by name with their share of device time. Needs CUDA.
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

import chip_smoke  # noqa: E402  (configurations and synthetic videos)
from profile_torch_train import kernel_table  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=["smmnist-dcgan", "kth-vgg"],
                   default="smmnist-dcgan")
    p.add_argument("--chunks", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_eval: needs CUDA")
    strict_fp32()
    kth = args.config == "kth-vgg"
    cfg_d = chip_smoke.KTH_CONFIG if kth else chip_smoke.XP_CONFIG
    torch.manual_seed(args.seed)
    model = SRVP(model_config(cfg_d)).cuda().eval()
    nt_cond = cfg_d["nt_cond"]
    nt_test = chip_smoke.KTH_NT_GEN if kth else cfg_d["seq_len_test"]
    o = cfg_d["n_euler_steps"]
    bsz, chunk = chip_smoke.BATCH, chip_smoke.CHUNK
    if kth:   # (N, T, H, W) -> (T, N, H, W)
        seqs = chip_smoke.synthetic_kth_videos(
            bsz, nt_test, cfg_d["nx"], np.random.RandomState(args.seed)) \
            .transpose(1, 0, 2, 3)
    else:
        seqs = chip_smoke.synthetic_sequences(bsz, nt_test, cfg_d["nx"],
                                              seed=args.seed)
    x = torch.from_numpy(seqs[..., None].astype(np.float32) / 255.0).cuda()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    carry = eval_lib.init_select_carry(
        ["psnr", "ssim"], bsz, nt_test - nt_cond, nt_cond, x.shape[2:], 5,
        "cuda")

    def run_chunk(carry, c):
        eps = eval_lib.chunk_noise(model.cfg, bsz, chunk, nt_cond, nt_test,
                                   o, o, gen, "cuda")
        return eval_lib.select_chunk(carry, model, x[:nt_cond], x[nt_cond:],
                                     chunk, c * chunk, o, o, eps)

    carry = run_chunk(carry, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in range(1, args.chunks + 1):
            carry = run_chunk(carry, c)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.chunks

    busy_ms, own, _, top = kernel_table(prof, args.chunks, "chunk")
    print(json.dumps({
        "config": args.config, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi_line(),
        "chunks": args.chunks, "videos": bsz, "samples_per_chunk": chunk,
        "nt_cond": nt_cond, "nt_test": nt_test, "oversampling": o,
        "wall_ms_per_chunk": wall_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device_busy_ms_per_chunk": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "own_kernel_shares": own, "kernels": top}))


if __name__ == "__main__":
    main()
