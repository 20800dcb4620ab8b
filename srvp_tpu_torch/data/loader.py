"""Seeded single-process batch loader (counterpart of the JAX package's
srvp_tpu/data/loader.py, without its worker threads).

The epoch order is a permutation seeded by (seed, epoch) and item i of the
epoch gets its own RandomState(item_seed(i)), so a batch depends only on
(seed, epoch, position): the same batches as the JAX loader for the same
seed, whatever its thread count.
"""

import numpy as np

from srvp_tpu_torch.data.base import collate_uint8


def epoch_order(n, seed, epoch):
    return np.random.RandomState(
        (seed + 0x9E3779B1 * epoch) % (2**31 - 1)).permutation(n)


def item_seed(seed, epoch, pos):
    return (seed * 1_000_003 + epoch * 7_777_777 + pos) % (2**31 - 1)


class DataLoader:
    """Shuffled batches of whole size (the JAX loader's shuffle=True,
    drop_last=True), one epoch per iteration."""

    def __init__(self, dataset, batch_size, seed=0,
                 collate_fn=collate_uint8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.collate_fn = collate_fn
        self.epoch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        epoch = self.epoch
        self.epoch += 1
        order = epoch_order(len(self.dataset), self.seed, epoch)
        for b in range(len(self)):
            lo = b * self.batch_size
            hi = lo + self.batch_size
            yield self.collate_fn([
                self.dataset.get_item(int(order[pos]), np.random.RandomState(
                    item_seed(self.seed, epoch, pos)))
                for pos in range(lo, hi)])


def batches_in_order(videos, batch_size):
    """A test fold's uint8 videos [(T, H, W[, C])] as float32 (T, B, H, W,
    C) batches in [0, 1], in order; the last batch holds the remainder."""
    for lo in range(0, len(videos), batch_size):
        yield collate_uint8(videos[lo:lo + batch_size]).astype(
            np.float32) / 255.0


def infinite_batches(loader):
    """Cycles a DataLoader forever, one epoch after another."""
    while True:
        yield from loader


class PartsView:
    """A dataset's `get_item_parts` as `get_item`, for loaders that feed the
    on-device compositor (data/device_compose.py)."""

    def __init__(self, dataset):
        self._dataset = dataset

    def __len__(self):
        return len(self._dataset)

    def get_item(self, index, rng):
        return self._dataset.get_item_parts(index, rng)
