#!/usr/bin/env python
"""Why a dispatch-window run of the port's trainer uses expandable segments:
the KTH fp32 trainer at K = 1 and K = 2 under torch's default CUDA
allocator and under expandable segments, on one GPU.

    python scripts/dispatch_allocator.py

Runs `python -m srvp_tpu_torch.train_main` as chip_smoke.py's phase 15 runs
its KTH fp32 arm (full width, batch 100 x 20 frames, 4 steps, cuDNN
deterministic), four times: K = 1 and K = 2 with PYTORCH_CUDA_ALLOC_CONF
set to expandable_segments:False (the default allocator; the trainer keeps
a setting the environment names), then both with expandable_segments:True.
Prints one JSON line a run (its peak reserved and allocated memory, the
allocations that failed and the retries that freed the cache first) and
one a pair (K = 2 against K = 1 under each allocator, and K = 1 under the
two, by chip_smoke.model_distance: 0 tensors differ is bit-equal), with the
card's name and power limit. Needs CUDA.
"""

import json
import os
import shutil
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the phase 15 arm, its trainer child)

SETTINGS = {"default": "expandable_segments:False",
            "expandable": "expandable_segments:True"}


def main():
    if not torch.cuda.is_available():
        sys.exit("dispatch_allocator: needs CUDA")
    name, cfg, batch, n_steps, k, precision, val, chkpt, _ = next(
        arm for arm in chip_smoke.DISPATCH_ARMS if arm[0] == "kth-vgg float32")
    data_dir = chip_smoke.WORK_DIR / "data_kth-vgg"
    if not (data_dir / "packed_64").exists():
        chip_smoke.write_kth_packed_tree(data_dir, cfg["nx"],
                                         chip_smoke.SEED + 4)
    models = {}
    for setting, conf in SETTINGS.items():
        for kk in (1, k):
            xp = chip_smoke.WORK_DIR / f"allocator_{setting}_k{kk}"
            shutil.rmtree(xp, ignore_errors=True)
            argv = (chip_smoke.train_argv(str(xp), str(data_dir), n_steps,
                                          cfg=cfg, batch_size=batch,
                                          precision=precision)
                    + chip_smoke.DISPATCH_FLAGS
                    + ["--val_interval", str(val), "--chkpt_interval",
                       str(chkpt), "--steps_per_dispatch", str(kk)])
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
            try:
                rc, lines, counts, seconds = chip_smoke.TrainerChild(
                    argv).result()
            finally:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            if rc != 0:
                print("\n".join(lines[-30:]))
                sys.exit(f"{name} k={kk} {setting}: exit code {rc}")
            models[setting, kk] = xp / "model.pt"
            print(json.dumps({
                "run": f"{name} K={kk}", "allocator": conf,
                "seconds": seconds,
                **{key: counts[key] for key in (
                    "peak_reserved_gb", "peak_allocated_gb", "ooms",
                    "alloc_retries")}}), flush=True)
    for a, b in ((("default", 1), ("default", k)),
                 (("expandable", 1), ("expandable", k)),
                 (("default", 1), ("expandable", 1))):
        print(json.dumps({
            "pair": f"{a} against {b}",
            "distance": chip_smoke.model_distance(models[a], models[b]),
            "nvidia_smi": chip_smoke.nvidia_smi_line()}), flush=True)


if __name__ == "__main__":
    main()
