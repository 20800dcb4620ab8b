"""Loader bench of the port: can the host's loader feed the card's training
step? (counterpart of scripts/bench_loader.py, which asks it of a TPU).

    python -m srvp_tpu_torch.bench_loader [--root DIR] [--n_batches 8]
        [--workers 1,4] [--noise_amp 0] [--device_rate_kth R]
        [--device_rate_bair R] [--device cuda|cpu]
        [--precision bfloat16|float32] [--steps 10] [--warmup 5] [--tiny]

It writes synthetic datasets under `--root` (suffixed `_n<noise_amp>`
where noise_amp > 0, `_tiny` with --tiny; kept for the next run), with
numpy and the stdlib PNG writer (data/synthetic.py): KTH's training PNG
tree (120 gray videos of 120 frames) and BAIR's (256 RGB videos of 30), each
packed by data/pack.py beside it, a Human3.6M tree (24 videos of 130-199
frames) and, for Moving MNIST, MNIST's IDX digits under --root where they
are, else the procedural glyphs. `--noise_amp` adds per-pixel noise: about
14 gives natural video's PNG sizes (BAIR's 6-8 KB a frame from PIL; 10.6
KB from this writer, whose row filters are forced), 0 compresses like
clean rendered frames. The PNG trees are written by one spawned process a
core.

Rows, at the training shapes of configs/*.yaml (batch x frames): KTH 100 x
20, BAIR 192 x 12 (the JAX script read 30-frame BAIR windows,
scripts/bench_loader.py:171,176), Human3.6M 100 x 16 at --subsampling 8,
Moving MNIST 128 x 15. Each leg drives the port's DataLoader
(data/loader.py, seed 0, collate_uint8, `threads` workers) for one warm-up
batch and then --n_batches timed ones (host clock), at every thread count
of --workers:
  - value: KTH and BAIR from the PNG tree (prefer_packed=False) through
    the native decoder, Human3.6M from its videos in memory, Moving MNIST
    whole videos from the native generator;
  - plain_value (KTH, BAIR): the plain decoder (data/png.py), an item at a
    time, as the JAX script's NoNative; one batch, timed, because the
    plain decoder is slow;
  - packed_value (KTH, BAIR): the packed tree;
  - parts_value (Moving MNIST): digits and trajectories, the trainer's
    default batches, composited on the device.
Before a leg is timed its first batch must equal every other leg's first
batch bit for bit (a parts batch composited on the host), and each leg
must have gone through its path (native decoder or generator batches
counted, none on the packed and plain legs); before the legs, the native
decoder must agree with the plain one on a sample of the tree's frames.
Any failure raises.

The step's rate: train_lib.train_step at the configuration's full width
(configs/*.yaml, as bench.py builds its step: seeded weights, random
frames) in --precision, --warmup steps then --steps timed ones, the window
closed by reading the last loss (bench.timed_steps), in frames/s; or the
rate given by --device_rate_kth / --device_rate_bair (a card's, so not
with --device cpu). With --device cpu --tiny the step runs at bench.TINY's
widths and the loader at small batches, and every rate in the line is the
CPU's.

Prints one JSON line per dataset: metric loader_frames_per_sec_<dataset>,
unit, batch, seq_len, `legs` {threads: {leg: frames/s}} and each leg's
rate at the highest thread count, device_rate and device_rate_source
(measured or flag), the step's ms, its kernel launches, vs_device_rate
and feeds_device_1.2x from the best leg at the highest thread count,
host_cpus, png_bytes_per_frame_mean, the device (the card's name and
nvidia-smi's name and power limit, or cpu).
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from srvp_tpu_torch import bench
from srvp_tpu_torch.args import create_args as trainer_args
from srvp_tpu_torch.config import SRVPConfig, resolve_device, strict_fp32
from srvp_tpu_torch.data import native, png, synthetic
from srvp_tpu_torch.data.bair import BAIR
from srvp_tpu_torch.data.base import collate_uint8
from srvp_tpu_torch.data.device_compose import composite_mmnist, parts_collate
from srvp_tpu_torch.data.human import Human
from srvp_tpu_torch.data.kth import KTH
from srvp_tpu_torch.data.loader import DataLoader, PartsView, infinite_batches
from srvp_tpu_torch.data.mmnist import MovingMNIST
from srvp_tpu_torch.data.pack import pack_bair_fold, pack_kth
from srvp_tpu_torch.kernels import launches as klaunches
from srvp_tpu_torch.kernels import peaks

ROOT = Path(__file__).resolve().parents[1]
CONFIG_FILES = {"kth": "kth.yaml", "bair": "bair.yaml", "human": "human.yaml",
                "smmnist": "smmnist-stochastic.yaml"}
HEADROOM = 1.2   # the loader must feed the step with this margin
# trees: (KTH videos, frames), BAIR videos, (Human3.6M videos, (shortest,
# longest + 1) frames); --tiny: loader batches of TINY_LOADER
TREES = dict(kth=(synthetic.BENCH_KTH_VIDEOS, synthetic.BENCH_KTH_FRAMES),
             bair=synthetic.BENCH_BAIR_VIDEOS, human=(24, (130, 200)))
TINY_TREES = dict(kth=(12, 12), bair=8, human=(4, (45, 60)))
TINY_LOADER = dict(batch=4, seq_len=6)
TINY_STEPS = dict(warmup=1, steps=2)
DECODER_SAMPLE = 256   # frames of a tree decoded by both decoders


def step_config(name, tiny=False):
    """bench.py's configuration dict for dataset `name`, from its
    configs/*.yaml through the trainer's flags: model widths, batch,
    seq_len, n_euler_steps, subsampling, and Moving MNIST's digits; at
    bench.TINY's widths and batch with `tiny`."""
    opt = trainer_args().parse_args(
        ["--config", str(ROOT / "configs" / CONFIG_FILES[name]),
         "--save_path", "unused", "--data_dir", "unused"])
    c = dict(kwargs={f.name: getattr(opt, f.name)
                     for f in dataclasses.fields(SRVPConfig)},
             nt_cond=opt.nt_cond, seq_len=opt.seq_len, batch=opt.batch_size,
             oversampling=opt.n_euler_steps, subsampling=opt.subsampling,
             max_speed=opt.max_speed, deterministic=opt.deterministic,
             ndigits=opt.ndigits)
    if tiny:
        c["kwargs"].update(bench.TINY["kwargs"])
        c.update(batch=bench.TINY["batch"], seq_len=bench.TINY["seq_len"])
    return c


def step_rate(name, c, device, dtype, warmup, steps):
    """The training step's frames/s for configuration c, its ms and the
    kernel launches it made."""
    before = klaunches.counts()
    ts, hp = bench.train_state(c, dtype, device)
    x = torch.from_numpy(bench.make_batch(c)).to(device)
    sec, _ = bench.timed_steps(name, ts, x, hp, warmup, steps, device)
    del ts, x
    if device.type == "cuda":
        torch.cuda.empty_cache()
    counted = {k: v for k, v in klaunches.since(before).items() if v}
    return c["seq_len"] * c["batch"] / sec, 1e3 * sec, counted


class PlainDecoded:
    """A PNG tree's dataset whose items are decoded one at a time by the
    plain decoder (data/png.py): the same windows as the dataset's own
    get_item, none of its native batch hooks (the JAX script's
    NoNative)."""

    def __init__(self, dataset):
        self._dataset = dataset

    def __len__(self):
        return len(self._dataset)

    def get_item(self, index, rng):
        ds = self._dataset
        return png.decode_png_batch(ds.frame_paths(index, rng), ds.nx, ds.nx,
                                    getattr(ds, "nc", 1))


def run_leg(dataset, batch, seq_len, n_batches, threads,
            collate=collate_uint8, warmup=True):
    """(first batch, frames/s) of the DataLoader over `dataset`: one
    warm-up batch (thread pool, page cache) then n_batches timed; without
    warmup the first batch is the one timed."""
    loader = DataLoader(dataset, batch, seed=0, collate_fn=collate,
                        num_workers=threads)
    it = infinite_batches(loader)
    try:
        t0 = time.perf_counter()
        first = next(it)
        if warmup:
            t0 = time.perf_counter()
            for _ in range(n_batches):
                next(it)
        else:
            n_batches = 1
        dt = time.perf_counter() - t0
    finally:
        it.close()     # ends the producer: nothing runs past the leg
    return first, batch * seq_len * n_batches / dt


def counted_batches():
    return dict(decoded=native.decoded["frames"], **native.served)


def check_decoders(paths, nx, channels):
    """The native decoder against the plain one on DECODER_SAMPLE of the
    tree's frames, spread over it: raises unless bit-equal."""
    sample = [str(p) for p in paths[::max(1, len(paths) // DECODER_SAMPLE)]]
    got = native.decode_png_batch(sample, nx, nx, channels)
    if not np.array_equal(got, png.decode_png_batch(sample, nx, nx,
                                                    channels)):
        raise RuntimeError(f"the native PNG decoder disagrees with "
                           f"data/png.py on the frames under "
                           f"{Path(sample[0]).parents[2]}")
    return len(sample)


def build_trees(root, noise_amp, tiny):
    """Writes and packs the synthetic datasets under `root` unless a
    finished earlier run left them; returns the seconds it took."""
    done = root / ".done"
    if done.exists():
        return 0.0
    t0 = time.perf_counter()
    trees = TINY_TREES if tiny else TREES
    (n_kth, kth_frames), (n_human, human_len) = trees["kth"], trees["human"]
    print(f"bench_loader: writing synthetic trees under {root} (KTH "
          f"{n_kth} x {kth_frames} frames, BAIR {trees['bair']} x "
          f"{synthetic.BAIR_FRAMES}, Human3.6M {n_human}, noise_amp "
          f"{noise_amp})", file=sys.stderr, flush=True)
    # PNG writing is the interpreter's work: one spawned process a core
    procs = 1 if tiny else len(os.sched_getaffinity(0))
    synthetic.write_bench_kth_tree(root, n_kth, kth_frames, noise_amp,
                                   processes=procs)
    synthetic.write_bench_bair_tree(root, trees["bair"], noise_amp,
                                    processes=procs)
    c = step_config("human", tiny)
    synthetic.write_human_tree(root / "human", n_human, human_len,
                               human_len[1], 0, c["seq_len"],
                               c["subsampling"], 0)
    pack_kth(str(root))
    pack_bair_fold(str(root), "train")
    done.write_text(json.dumps({"noise_amp": noise_amp, "tiny": tiny}))
    return time.perf_counter() - t0


def datasets(root, name, c, seq_len):
    """{leg: (dataset, collate, warmup)} of dataset `name` and its PNG
    frame paths (KTH, BAIR)."""
    if name == "kth":
        png_ds = KTH.make_dataset(str(root), 64, seq_len, True,
                                  prefer_packed=False)
        packed = KTH.make_dataset(str(root), 64, seq_len, True)
        paths = sorted(root.glob("processed_64/*/*/*.png"))
    elif name == "bair":
        png_ds = BAIR.make_dataset(str(root), seq_len, True,
                                   prefer_packed=False)
        packed = BAIR.make_dataset(str(root), seq_len, True)
        paths = sorted(root.glob("processed_data/train/*/*/*.png"))
    elif name == "human":
        return {"value": (Human.make_dataset(
            str(root / "human"), 64, seq_len, c["subsampling"], True),
            collate_uint8, True)}, []
    else:
        mm = MovingMNIST.make_dataset(
            str(root), 64, seq_len, c["max_speed"], c["deterministic"],
            c["ndigits"], allow_synthetic=True)
        return {"value": (mm, collate_uint8, True),
                "parts_value": (PartsView(mm), parts_collate, True)}, []
    if png_ds.packed or not packed.packed:
        raise RuntimeError(f"{name}: the PNG leg read a packed tree, or the "
                           f"packed leg did not find one ({png_ds.packed}, "
                           f"{packed.packed})")
    return {"value": (png_ds, collate_uint8, True),
            "plain_value": (PlainDecoded(png_ds), collate_uint8, False),
            "packed_value": (packed, collate_uint8, True)}, paths


def as_frames(batch):
    """A first batch as uint8 (T, B, H, W, C) frames: a parts batch
    composited on the host."""
    if isinstance(batch, dict):
        return composite_mmnist(torch.from_numpy(batch["digits"]),
                                torch.from_numpy(batch["pos"])).numpy()
    return batch


# the counter each leg must advance (and the others must not)
LEG_COUNTER = {("kth", "value"): "decoded", ("bair", "value"): "decoded",
               ("smmnist", "value"): "videos",
               ("smmnist", "parts_value"): "parts"}


def bench_row(name, root, args, device, dtype):
    c = step_config(name, args.tiny)
    batch, seq_len = ((TINY_LOADER["batch"], TINY_LOADER["seq_len"])
                      if args.tiny else (c["batch"], c["seq_len"]))
    legs, paths = datasets(root, name, c, seq_len)
    row = {"metric": f"loader_frames_per_sec_{name}", "unit": "frames/s",
           "batch": batch, "seq_len": seq_len, "threads": args.workers,
           "noise_amp": args.noise_amp if paths else None}
    if paths:
        row["decoder_frames_checked"] = check_decoders(
            paths, 64, 3 if name == "bair" else 1)
        row["png_frames"] = len(paths)
        row["png_bytes_per_frame_mean"] = float(np.mean(
            [os.path.getsize(p) for p in paths]))
    else:
        row["png_bytes_per_frame_mean"] = None
    reference, row["legs"] = None, {}
    for threads in args.workers:
        rates = row["legs"][str(threads)] = {}
        for leg, (ds, collate, warmup) in legs.items():
            before = counted_batches()
            first, rates[leg] = run_leg(ds, batch, seq_len, args.n_batches,
                                        threads, collate, warmup)
            grew = {k: v - before[k] for k, v in counted_batches().items()}
            want = LEG_COUNTER.get((name, leg))
            if any(v for k, v in grew.items() if k != want) or (
                    want and not grew[want]):
                raise RuntimeError(f"{name} {leg} at {threads} threads did "
                                   f"not go through its path: {grew}")
            frames = as_frames(first)
            if reference is None:
                reference = frames
            elif not np.array_equal(frames, reference):
                raise RuntimeError(f"{name}: the first batch of {leg} at "
                                   f"{threads} threads differs from the "
                                   "first leg's")
    row["batches_agree"] = True
    top = row["legs"][str(max(args.workers))]
    row.update(top)
    flag = getattr(args, f"device_rate_{name}", None)
    if flag is not None:
        row.update(device_rate=flag, device_rate_source="flag",
                   step_ms=None, step_launches=None)
    else:
        steps = (TINY_STEPS if args.tiny
                 else dict(warmup=args.warmup, steps=args.steps))
        rate, ms, counted = step_rate(name, c, device, dtype, **steps)
        row.update(device_rate=rate, device_rate_source="measured",
                   step_ms=ms, step_launches=counted,
                   step_shape=[c["batch"], c["seq_len"]])
    best = max((leg for leg in top if leg != "plain_value"), key=top.get)
    row.update(best_leg=best, vs_device_rate=top[best] / row["device_rate"])
    row["feeds_device_1.2x"] = top[best] >= HEADROOM * row["device_rate"]
    return row


def create_args():
    p = argparse.ArgumentParser(
        prog="python -m srvp_tpu_torch.bench_loader",
        description="Loader frames/s of each dataset beside the training "
                    "step's; one JSON line per dataset.")
    p.add_argument("--root", default=str(ROOT / "build" / "loader_bench"),
                   help="Where the synthetic datasets are written.")
    p.add_argument("--n_batches", type=int, default=8,
                   help="Timed batches a leg, after one warm-up batch.")
    p.add_argument("--workers", default=[1, 4],
                   type=lambda s: sorted({int(v) for v in s.split(",")}),
                   help="Comma-separated loader thread counts.")
    p.add_argument("--noise_amp", type=int, default=0,
                   help="Per-pixel noise of the synthetic frames; about 14 "
                        "matches natural video's PNG sizes, 0 is clean "
                        "rendered content.")
    for name in ("kth", "bair"):
        p.add_argument(f"--device_rate_{name}", type=float, default=None,
                       help=f"{name.upper()} training step rate of the "
                            "card, frames/s; measured when not given.")
    p.add_argument("--device", default="cuda",
                   help="torch device of the step; 'cpu' only when asked.")
    p.add_argument("--precision", choices=sorted(bench.DTYPES),
                   default="bfloat16", help="Compute dtype of the step.")
    p.add_argument("--steps", type=int, default=10,
                   help="Timed training steps.")
    p.add_argument("--warmup", type=int, default=bench.WARMUP,
                   help="Training steps before the timed ones.")
    p.add_argument("--tiny", action="store_true",
                   help="Small trees and batches, the step at bench.TINY "
                        "(a test on the CPU).")
    return p


def main(argv=None):
    p = create_args()
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if not on_card and (args.device_rate_kth or args.device_rate_bair):
        p.error("--device_rate_* is a card's rate: on the CPU the step is "
                "measured")
    strict_fp32()
    root = Path(args.root + (f"_n{args.noise_amp}" if args.noise_amp else "")
                + ("_tiny" if args.tiny else ""))
    root.mkdir(parents=True, exist_ok=True)
    setup_s = build_trees(root, args.noise_amp, args.tiny)
    device_info = dict(
        device=torch.cuda.get_device_name(device) if on_card else "cpu",
        nvidia_smi=peaks.nvidia_smi_line() if on_card else None,
        precision=args.precision, host_cpus=os.cpu_count(),
        host_cpus_usable=len(os.sched_getaffinity(0)), setup_s=setup_s,
        root=str(root))
    rows = []
    for name in CONFIG_FILES:
        row = bench_row(name, root, args, device, bench.DTYPES[args.precision])
        row.update(device_info)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
