"""Datasets from their downloads to the frame trees the port reads (the
counterpart of preprocessing/bair/convert.py), without TensorFlow or PIL.

    python -m srvp_tpu_torch.data.convert bair --data_dir DIR

BAIR: the softmotion30_44k TFRecords under `DIR/softmotion30_44k/{train,
test}/`, each file in sorted order, record k (counted from 1) of file f a
video of 30 frames, feature `{i}/image_aux1/encoded` raw 64 x 64 RGB bytes
(data/tfrecord.py). Frame i goes to `DIR/processed_data/{split}/{f without
its extension}/{k:03d}/{i:03d}.png`, written by data/png.py with libpng's
choice of row filters; the frames decode to the record's bytes. A video's
directory is made anew: a second run onto an existing tree raises
FileExistsError. data/bair.py reads the tree, and `python -m
srvp_tpu_torch.data.pack --dataset bair` packs it.
"""

import argparse
import glob
import os

import numpy as np

from srvp_tpu_torch.data.bair import NC, NX, VIDEO_LEN
from srvp_tpu_torch.data.png import ADAPTIVE, png_bytes
from srvp_tpu_torch.data.tfrecord import parse_example, tfrecord_iterator


def bair_videos(data_dir, fold):
    """Yields (TFRecord file, k counted from 1, uint8 (30, 64, 64, 3)) over
    the fold's records."""
    filenames = sorted(glob.glob(os.path.join(data_dir, "softmotion30_44k",
                                              fold, "*")))
    if not filenames:
        raise RuntimeError("No data files found.")
    shape = (NX, NX, NC)
    for f in filenames:
        for k, payload in enumerate(tfrecord_iterator(f), start=1):
            example = parse_example(payload)
            frames = []
            for i in range(VIDEO_LEN):
                raw = example[f"{i}/image_aux1/encoded"][0]
                if len(raw) != np.prod(shape):
                    raise ValueError(f"{f}, record {k}: frame {i} holds "
                                     f"{len(raw)} bytes, not 64 x 64 x 3")
                frames.append(np.frombuffer(raw, np.uint8).reshape(shape))
            yield f, k, np.stack(frames)


def convert_bair(data_dir, fold):
    """Writes the fold's PNG tree; returns the number of videos."""
    n = 0
    for f, k, video in bair_videos(data_dir, fold):
        f = os.path.splitext(os.path.basename(f))[0]
        dirname = os.path.join(data_dir, "processed_data", fold, f, f"{k:03d}")
        os.makedirs(dirname)
        for i, frame in enumerate(video):
            with open(os.path.join(dirname, f"{i:03d}.png"), "wb") as out:
                out.write(png_bytes(frame, ADAPTIVE))
        n += 1
        print(f"{dirname} ({n})", flush=True)
    return n


def create_args():
    p = argparse.ArgumentParser(
        prog="python -m srvp_tpu_torch.data.convert",
        description="Converts a dataset's download into the frame tree the "
                    "port reads.")
    sub = p.add_subparsers(dest="dataset", required=True)
    bair = sub.add_parser(
        "bair", formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        help="BAIR: 64x64 PNG frames from the softmotion30_44k TFRecords.")
    bair.add_argument("--data_dir", type=str, metavar="DIR", required=True,
                      help="Folder where videos from the original dataset "
                           "are stored.")
    return p


def main(argv=None):
    """Returns {fold: videos converted}."""
    args = create_args().parse_args(argv)
    print("Train sequences...")
    done = {"train": convert_bair(args.data_dir, "train")}
    print(os.linesep)
    print("Test sequences...")
    done["test"] = convert_bair(args.data_dir, "test")
    return done


if __name__ == "__main__":
    main()
