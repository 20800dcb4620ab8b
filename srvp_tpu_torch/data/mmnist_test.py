"""Moving MNIST test fold (the part of srvp_tpu/data/mmnist.py, base.py and
loader.py that evaluation reads).

The test fold is a precomputed archive `{s}mmnist_test_{n}digits_{nx}.npz`
whose `sequences` array is uint8 (T, N, H, W). Batches are taken in order,
the last one ragged, and collated as the JAX loader does: uint8 videos
stacked on axis 1 with a channel axis appended, then float32 / 255.
"""

import os

import numpy as np

from srvp_tpu_torch.data.base import collate_uint8


def archive_path(data_dir, nx, num_digits, deterministic):
    prefix = "" if deterministic else "s"
    return os.path.join(data_dir,
                        f"{prefix}mmnist_test_{num_digits}digits_{nx}.npz")


def load_test_sequences(data_dir, nx, num_digits, deterministic):
    """uint8 (T, N, H, W) test sequences."""
    path = archive_path(data_dir, nx, num_digits, deterministic)
    with np.load(path, allow_pickle=False) as arc:
        return arc["sequences"]


def collate(videos):
    """uint8 videos [(T, H, W) or (T, H, W, C)] -> float32 (T, B, H, W, C)
    in [0, 1]."""
    return collate_uint8(videos).astype(np.float32) / 255.0


def iterate_batches(sequences, batch_size):
    """Yields collated (T, B, H, W, 1) float32 batches in order; the last
    batch holds the remainder."""
    n = sequences.shape[1]
    for lo in range(0, n, batch_size):
        yield collate([sequences[:, i] for i in range(lo, min(lo + batch_size,
                                                              n))])
