"""Packs KTH's and BAIR's PNG frame trees into one raw uint8 .npy file a
video (counterpart of preprocessing/kth/pack.py and
preprocessing/bair/pack.py, which decode through PIL).

    python -m srvp_tpu_torch.data.pack --dataset kth --data_dir DIR
        [--nx 64] [--delete_png] [--threads 4] [--plain]
    python -m srvp_tpu_torch.data.pack --dataset bair --data_dir DIR
        [--fold train|test] [--delete_png] [--threads 4] [--plain]

KTH reads `DIR/processed_{nx}/<class>/<video>/*.png` and writes
`DIR/packed_{nx}/<class>/<video>.npy`, uint8 (T, nx, nx): the first
channel of each frame, which is what training reads. BAIR reads
`DIR/processed_data/<fold>/<traj>/<video>/*.png` and writes
`DIR/packed_data/<fold>/<traj>/<video>.npy`, uint8 (T, 64, 64, 3), both
folds unless `--fold` names one. data/kth.py and data/bair.py prefer a
packed tree whose marker counts its videos: windows become memory-mapped
copies with no decode, of the same pixels, in the same video order.

The JAX packers' rules, and byte for byte their output on the same tree:
- KTH's videos are those of its six class directories, each sorted; a
  stray directory beside them is not packed and not counted;
- a video directory without a frame raises: the packed tree would
  enumerate otherwise than the PNG tree (another fold split);
- each video is written under a `.tmp` name, which the datasets do not
  enumerate (it does not end in `.npy`), and then renamed into place;
- `COMPLETE.json` = {"videos": n} is written last, through its own `.tmp`;
- `--delete_png` removes a video's frames only once its array is in place.

Frames go through the native PNG decoder (data/native.py), `--threads`
threads a video; a decoder that does not build, or a file it rejects,
raises. `--plain` decodes with the plain version (data/png.py) instead.
"""

import argparse
import json
import os
from os.path import join

import numpy as np

from srvp_tpu_torch.data import native, png
from srvp_tpu_torch.data.kth import CLASSES

BAIR_NX = 64


def decode_frames(paths, nx, channels, threads=4, plain=False):
    """uint8 (N, nx, nx) or (N, nx, nx, 3) frames of `paths`, through the
    native decoder, or the plain one where the caller asks for it."""
    if plain:
        return png.decode_png_batch(paths, nx, nx, channels)
    return native.decode_png_batch(paths, nx, nx, channels, threads)


def _pack_video(vdir, out, nx, channels, delete_png, threads, plain):
    frames = sorted(f for f in os.listdir(vdir)
                    if os.path.splitext(f)[1] == ".png")
    if not frames:
        raise ValueError(f"no PNG frames in {vdir}; source tree is "
                         "incomplete, refusing to pack")
    video = decode_frames([join(vdir, f) for f in frames], nx, channels,
                          threads, plain)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # np.save appends .npy to a bare name: write through a file object
    with open(out + ".tmp", "wb") as f:
        np.save(f, np.ascontiguousarray(video))
    os.replace(out + ".tmp", out)
    if delete_png:
        for f in frames:
            os.remove(join(vdir, f))


def write_marker(dst, n):
    """The completion marker the datasets trust a packed tree by: its
    video count, written last and through a `.tmp` name."""
    tmp = join(dst, "COMPLETE.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"videos": n}, f)
    os.replace(tmp, join(dst, "COMPLETE.json"))


def pack_kth(data_dir, nx=64, delete_png=False, threads=4, plain=False):
    """Packs KTH's PNG tree at size nx; returns the number of videos."""
    src, dst = join(data_dir, f"processed_{nx}"), join(data_dir,
                                                       f"packed_{nx}")
    n = 0
    for c in CLASSES:
        cdir = join(src, c)
        if not os.path.isdir(cdir):
            continue
        os.makedirs(join(dst, c), exist_ok=True)
        for vid in sorted(os.listdir(cdir)):
            vdir = join(cdir, vid)
            if not os.path.isdir(vdir):
                continue
            _pack_video(vdir, join(dst, c, f"{vid}.npy"), nx, 1,
                        delete_png, threads, plain)
            n += 1
            if n % 100 == 0:
                print(f"  {n} videos packed", flush=True)
    if n:
        write_marker(dst, n)
    return n


def pack_bair_fold(data_dir, fold, delete_png=False, threads=4, plain=False):
    """Packs one fold of BAIR's PNG tree; returns the number of videos (0
    where the fold has no tree)."""
    src = join(data_dir, "processed_data", fold)
    dst = join(data_dir, "packed_data", fold)
    if not os.path.isdir(src):
        return 0
    os.makedirs(dst, exist_ok=True)
    n = 0
    for d1 in sorted(os.listdir(src)):
        for d2 in sorted(os.listdir(join(src, d1))):
            _pack_video(join(src, d1, d2), join(dst, d1, f"{d2}.npy"),
                        BAIR_NX, 3, delete_png, threads, plain)
            n += 1
            if n % 200 == 0:
                print(f"  {fold}: {n} videos packed", flush=True)
    if n:
        write_marker(dst, n)
    return n


def create_args():
    p = argparse.ArgumentParser(
        prog="python -m srvp_tpu_torch.data.pack",
        description="Packs KTH's or BAIR's PNG frames into one raw .npy "
                    "file a video.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--dataset", choices=["kth", "bair"], required=True)
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True,
                   help="Folder of processed_{nx} (KTH) or processed_data "
                        "(BAIR).")
    p.add_argument("--nx", type=int, default=64, metavar="SIZE",
                   help="KTH's frame size (BAIR's frames are 64).")
    p.add_argument("--fold", choices=["train", "test"], default=None,
                   help="BAIR: pack this fold only (both by default).")
    p.add_argument("--delete_png", action="store_true",
                   help="Remove the source PNGs after packing each video.")
    p.add_argument("--threads", type=int, default=4,
                   help="Decoder threads.")
    p.add_argument("--plain", action="store_true",
                   help="Decode with the plain numpy decoder (data/png.py) "
                        "instead of the native one.")
    return p


def main(argv=None):
    p = create_args()
    args = p.parse_args(argv)
    opts = dict(delete_png=args.delete_png, threads=args.threads,
                plain=args.plain)
    if args.dataset == "kth":
        if args.fold is not None:
            p.error("--fold is BAIR's: KTH has one training tree")
        n = pack_kth(args.data_dir, args.nx, **opts)
        print(f"packed {n} videos into "
              f"{join(args.data_dir, f'packed_{args.nx}')}", flush=True)
        return
    if args.nx != BAIR_NX:
        p.error(f"BAIR's frames are {BAIR_NX} pixels, not {args.nx}")
    for fold in [args.fold] if args.fold else ["train", "test"]:
        n = pack_bair_fold(args.data_dir, fold, **opts)
        print(f"{fold}: packed {n} videos into "
              f"{join(args.data_dir, 'packed_data', fold)}", flush=True)


if __name__ == "__main__":
    main()
