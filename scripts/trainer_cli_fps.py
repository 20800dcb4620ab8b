#!/usr/bin/env python
"""The port's trainer CLI's logged bf16 frames/s on one GPU, for this
checkout or another one (a parent commit unpacked with `git archive`), in
turns.

    python scripts/trainer_cli_fps.py [--config smmnist-dcgan|kth-vgg]
        [--root DIR ...] [--steps_per_dispatch K ...] [--log_interval N]
        [--steps 30] [--warmup 5]

Runs `python -m srvp_tpu_torch.train_main` of each `--root` (default: this
checkout; give several, such as parent, change, change, parent) at each
`--steps_per_dispatch` (default 1; give several, such as 1 4 4 1), root by
root, in a child process each, with chip_smoke's flags for the
configuration in bfloat16: full width, batch 128 x 15 frames
(smmnist-dcgan, synthetic digits) or 100 x 20 (kth-vgg, a synthetic packed
tree written once by this checkout), `--steps` steps, `--log_interval`
(default 1; compare dispatch widths at one interval, such as 4, so that
their runs synchronise equally often), one validation after the last step,
`--n_workers` at its default. Each logged row's frames/s is what the
trainer logs (its metrics.jsonl; a logged step synchronises, so the row
holds the loader's share). Prints one JSON line per run: the root, the
dispatch width, the card's name and power limit, the median and range of
the rows' frames/s after `--warmup` steps (at K > 1 past the window that
captures the graph, the second) and the ms per step of the median. Needs
CUDA.
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
    p.add_argument("--steps_per_dispatch", type=int, nargs="+", default=[1])
    p.add_argument("--log_interval", type=int, default=1)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
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
        runs = [(root, k) for root in roots
                for k in args.steps_per_dispatch]
        for i, (root, k) in enumerate(runs):
            argv = [a for a in chip_smoke.train_argv(
                "unused", data_dir, args.steps, cfg=cfg, batch_size=batch,
                precision="bfloat16") if not a.startswith("--save_path")]
            argv += ["--log_interval", str(args.log_interval)]
            if k > 1:   # the flag is newer than some parents
                argv += ["--steps_per_dispatch", str(k)]
            fps = run(root, argv, os.path.join(tmp, f"xp{i}"))
            timed = np.array(fps[args.warmup // args.log_interval:])
            frames = cfg["seq_len"] * batch
            print(json.dumps({
                "root": root, "config": args.config, "precision": "bfloat16",
                "steps_per_dispatch": k, "log_interval": args.log_interval,
                "device": torch.cuda.get_device_name(0),
                "nvidia_smi": chip_smoke.nvidia_smi_line(),
                "steps": args.steps, "warmup": args.warmup,
                "fps_median": float(np.median(timed)),
                "fps_min": float(timed.min()), "fps_max": float(timed.max()),
                "ms_per_step_median": 1e3 * frames / float(np.median(timed)),
                "fps": fps}), flush=True)


if __name__ == "__main__":
    main()
