"""The test sets the port's evaluation reads (counterpart of
preprocessing/kth/make_test_set.py and preprocessing/mmnist/
make_test_set.py), with those scripts' flags, defaults, draw order and
arrays.

    python -m srvp_tpu_torch.data.test_sets kth --data_dir DIR
        [--size 1000] [--seq_len 40] [--image_size 64] [--seed 42]
        [--threads 4] [--plain]
    python -m srvp_tpu_torch.data.test_sets mmnist --data_dir DIR
        [--seq_len 100] [--seed 42] [--deterministic] [--digits 2]
        [--frame_size 64] [--max_speed 4]

KTH: `size` windows of `seq_len` frames, each of a video drawn from a
RandomState(seed) in the reference order (action, person 21-25, trial 1-4,
start frame) from `DIR/processed_{image_size}`, its frames' first channel
decoded by the native PNG decoder (`--plain`: data/png.py); written to
`DIR/svg_test_set_{seq_len}.npz` as `sequences` uint8 (size, seq_len, H,
W), `persons` and `actions`.

Moving MNIST: the MNIST test digits (IDX files under DIR) in a seeded
permutation, `digits` a video, each moving along a trajectory of
data/mmnist.MovingMNIST drawn from the same generator; written to
`DIR/{s}mmnist_test_{digits}digits_{frame_size}.npz` (`s` unless
--deterministic) as `sequences` uint8 (T, N, H, W), `latents` (T, N,
digits, 4: rounded position and speed), `labels` uint8 (N, digits) and
`digits` uint8 (N, digits, 28, 28).
"""

import argparse
import os
from os.path import join

import numpy as np

from srvp_tpu_torch.data.kth import CLASSES
from srvp_tpu_torch.data.mmnist import (MovingMNIST, load_mnist_images,
                                        load_mnist_labels)
from srvp_tpu_torch.data.pack import decode_frames


def make_kth_test_set(data_dir, size=1000, seq_len=40, image_size=64,
                      seed=42, threads=4, plain=False):
    """Writes svg_test_set_{seq_len}.npz; returns its path."""
    rng = np.random.RandomState(seed)
    processed_dir = join(data_dir, f"processed_{image_size}")
    sequences, persons, actions = [], [], []
    for i in range(size):
        action = CLASSES[rng.randint(len(CLASSES))]
        person = rng.randint(21, 26)
        trial = rng.randint(1, 5)
        vdir = join(processed_dir, action,
                    f"person{person:02d}_{action}_d{trial}")
        frames = sorted(os.listdir(vdir))
        t_0 = rng.randint(len(frames) - seq_len + 1)
        sequences.append(decode_frames(
            [join(vdir, f) for f in frames[t_0:t_0 + seq_len]], image_size,
            1, threads, plain))
        persons.append(person)
        actions.append(action)
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{size}", flush=True)
    save_file = join(data_dir, f"svg_test_set_{seq_len}.npz")
    print(f"Saving testset at {save_file}", flush=True)
    np.savez_compressed(save_file, sequences=np.array(sequences),
                        persons=persons, actions=actions)
    return save_file


def make_mmnist_test_set(data_dir, seq_len=100, seed=42, deterministic=False,
                         digits=2, frame_size=64, max_speed=4):
    """Writes {s}mmnist_test_{digits}digits_{frame_size}.npz; returns its
    path."""
    rng = np.random.RandomState(seed)
    images = load_mnist_images(data_dir, train=False)
    labels = load_mnist_labels(data_dir, train=False)
    digits_idx = rng.permutation(len(images))
    sampler = MovingMNIST([], frame_size, seq_len, max_speed, deterministic,
                          digits, True)
    videos, latents, labs, objects = [], [], [], []
    n_seqs = len(images) // digits
    for i in range(n_seqs):
        x = np.zeros((seq_len, frame_size, frame_size), np.float32)
        lat, lab, obj = [], [], []
        for n in range(digits):
            idx = digits_idx[i * digits + n]
            img = np.asarray(images[idx], dtype=np.uint8)
            trajectory = sampler._compute_trajectory(rng, *img.shape)
            lat.append(np.array(trajectory))
            lab.append(labels[idx])
            obj.append(img)
            for t in range(seq_len):
                sx, sy, _, _ = trajectory[t]
                x[t, sx:sx + img.shape[0], sy:sy + img.shape[1]] += img
        x[x > 255] = 255
        videos.append(x.astype(np.uint8))
        latents.append(np.array(lat))
        labs.append(np.array(lab).astype(np.uint8))
        objects.append(np.array(obj))
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{n_seqs}", flush=True)
    fname = f"mmnist_test_{digits}digits_{frame_size}.npz"
    if not deterministic:
        fname = f"s{fname}"
    os.makedirs(data_dir, exist_ok=True)
    save_file = join(data_dir, fname)
    print(f"Saving testset at {save_file}", flush=True)
    np.savez_compressed(
        save_file,
        sequences=np.array(videos, dtype=np.uint8).transpose(1, 0, 2, 3),
        latents=np.array(latents).transpose(2, 0, 1, 3),
        labels=np.array(labs, dtype=np.uint8), digits=np.array(objects))
    return save_file


def create_args():
    p = argparse.ArgumentParser(
        prog="python -m srvp_tpu_torch.data.test_sets",
        description="Writes the KTH or Moving MNIST testing set as an npz "
                    "file.")
    sub = p.add_subparsers(dest="dataset", required=True)
    fmt = argparse.ArgumentDefaultsHelpFormatter
    kth = sub.add_parser("kth", formatter_class=fmt,
                         help="KTH: fixed-length windows of the test "
                              "persons' videos.")
    kth.add_argument("--data_dir", type=str, metavar="DIR", required=True,
                     help="Folder where the dataset is stored and the "
                          "testing set will be saved.")
    kth.add_argument("--size", type=int, metavar="SIZE", default=1000,
                     help="Number of sequences to extract.")
    kth.add_argument("--seq_len", type=int, metavar="LEN", default=40,
                     help="Number of frames per testing sequence.")
    kth.add_argument("--image_size", type=int, metavar="SIZE", default=64,
                     help="Width and height of videos.")
    kth.add_argument("--seed", type=int, metavar="SEED", default=42,
                     help="Fixed NumPy seed to produce the same dataset "
                          "each run.")
    kth.add_argument("--threads", type=int, default=4,
                     help="Decoder threads.")
    kth.add_argument("--plain", action="store_true",
                     help="Decode with the plain numpy decoder "
                          "(data/png.py) instead of the native one.")
    mm = sub.add_parser("mmnist", formatter_class=fmt,
                        help="Moving MNIST: videos and their latents.")
    mm.add_argument("--data_dir", type=str, metavar="DIR", required=True,
                    help="Folder of the MNIST IDX files, where the testing "
                         "set will be saved.")
    mm.add_argument("--seq_len", type=int, metavar="LEN", default=100,
                    help="Number of frames per testing sequence.")
    mm.add_argument("--seed", type=int, metavar="SEED", default=42,
                    help="Fixed NumPy seed to produce the same dataset "
                         "each run.")
    mm.add_argument("--deterministic", action="store_true",
                    help="Generate the deterministic variant of the "
                         "dataset.")
    mm.add_argument("--digits", type=int, metavar="NUM", default=2,
                    help="Number of digits per video.")
    mm.add_argument("--frame_size", type=int, metavar="SIZE", default=64,
                    help="Size of generated frames.")
    mm.add_argument("--max_speed", type=int, metavar="SPEED", default=4,
                    help="Maximum speed of generated trajectories.")
    return p


def main(argv=None):
    args = vars(create_args().parse_args(argv))
    if args.pop("dataset") == "kth":
        return make_kth_test_set(**args)
    return make_mmnist_test_set(**args)


if __name__ == "__main__":
    main()
