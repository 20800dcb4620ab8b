#!/usr/bin/env python
"""The port's trainer CLI's logged bf16 frames/s on one GPU, for this
checkout or another one (a parent commit unpacked with `git archive`), in
turns.

    python scripts/trainer_cli_fps.py [--config smmnist-dcgan|kth-vgg]
        [--root DIR ...]

Runs `python -m srvp_tpu_torch.train_main` of each `--root` (default: this
checkout; give several, such as parent, change, change, parent) in a child
process, in the order given, with chip_smoke's flags for the configuration
in bfloat16: full width, batch 128 x 15 frames (smmnist-dcgan, synthetic
digits) or 100 x 20 (kth-vgg, a synthetic packed tree written once by this
checkout), STEPS steps, `--log_interval 1`, one validation after the last
step, `--n_workers` at its default. Each step's frames/s is what the trainer
logs (its metrics.jsonl; the step synchronises when it is logged, so a
logged step holds the loader's share). Prints one JSON line per run: the
root, the card's name and power limit, the median and range of the logged
frames/s after WARMUP steps and the ms per step of the median. Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (configurations, trainer flags, data)

STEPS, WARMUP = 30, 5


def run(root, argv, save_path):
    """The logged frames/s of one trainer run of the checkout at root."""
    proc = subprocess.run(
        [sys.executable, "-m", "srvp_tpu_torch.train_main", *argv,
         f"--save_path={save_path}"], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=1200)
    if proc.returncode != 0:
        sys.exit(f"trainer of {root} exited with {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(save_path, "metrics.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "fps" in r]
    # rows carry "step" (or "itr", before the JAX row schema)
    rows.sort(key=lambda r: r.get("step", r.get("itr")))
    return [r["fps"] for r in rows]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=["smmnist-dcgan", "kth-vgg"],
                   default="smmnist-dcgan")
    p.add_argument("--root", action="append", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("trainer_cli_fps: needs CUDA")
    roots = [os.path.abspath(r) for r in (args.root or [ROOT])]
    kth = args.config == "kth-vgg"
    cfg = chip_smoke.KTH_CONFIG if kth else chip_smoke.XP_CONFIG
    batch = chip_smoke.KTH_TRAIN_BATCH if kth else chip_smoke.TRAIN_BATCH
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        if kth:
            chip_smoke.write_kth_packed_tree(data_dir, cfg["nx"], 0)
        for k, root in enumerate(roots):
            argv = [a for a in chip_smoke.train_argv(
                "unused", data_dir, STEPS, cfg=cfg, batch_size=batch,
                precision="bfloat16") if not a.startswith("--save_path")]
            fps = run(root, argv, os.path.join(tmp, f"xp{k}"))
            timed = np.array(fps[WARMUP:])
            frames = cfg["seq_len"] * batch
            print(json.dumps({
                "root": root, "config": args.config, "precision": "bfloat16",
                "device": torch.cuda.get_device_name(0),
                "nvidia_smi": chip_smoke.nvidia_smi_line(),
                "steps": STEPS, "warmup": WARMUP,
                "fps_median": float(np.median(timed)),
                "fps_min": float(timed.min()), "fps_max": float(timed.max()),
                "ms_per_step_median": 1e3 * frames / float(np.median(timed)),
                "fps": fps}), flush=True)


if __name__ == "__main__":
    main()
