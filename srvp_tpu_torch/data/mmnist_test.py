"""Moving MNIST test fold (the part of srvp_tpu/data/mmnist.py, base.py and
loader.py that evaluation reads).

The test fold is a precomputed archive `{s}mmnist_test_{n}digits_{nx}.npz`
whose `sequences` array is uint8 (T, N, H, W). Batches are taken in order,
the last one ragged, and collated as the JAX loader does: uint8 videos
stacked on axis 1 with a channel axis appended, then float32 / 255.
"""

import os

import numpy as np

from srvp_tpu_torch.data.loader import batches_in_order


def archive_path(data_dir, nx, num_digits, deterministic):
    prefix = "" if deterministic else "s"
    return os.path.join(data_dir,
                        f"{prefix}mmnist_test_{num_digits}digits_{nx}.npz")


def load_test_sequences(data_dir, nx, num_digits, deterministic):
    """uint8 (T, N, H, W) test sequences."""
    path = archive_path(data_dir, nx, num_digits, deterministic)
    with np.load(path, allow_pickle=False) as arc:
        return arc["sequences"]


def iterate_batches(sequences, batch_size):
    """Yields collated (T, B, H, W, 1) float32 batches in order; the last
    batch holds the remainder."""
    return batches_in_order([sequences[:, i]
                             for i in range(sequences.shape[1])], batch_size)
