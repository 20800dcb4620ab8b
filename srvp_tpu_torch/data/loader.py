"""Seeded, threaded, prefetching batch loader (counterpart of
srvp_tpu/data/loader.py).

The epoch order is a permutation seeded by (seed, epoch) and item i of the
epoch gets its own RandomState(item_seed(i)), so a batch depends only on
(seed, epoch, position): the same batches as the JAX loader for the same
seed, whatever the worker count, and `fast_forward` skips batches without
making them. A producer thread builds the batches ahead of the consumer
(`prefetch` of them, PREFETCH by default), each from the dataset's batch
hooks where it has them, or from `num_workers` threads calling `get_item`:
`get_batch_timemajor_u8` gives the collated uint8 batch itself (KTH's and
BAIR's frames decoded straight into it, srvp_tpu/data/loader.py:113-118)
where the collation is collate_uint8, and `get_batch_seeded` the items of
a batch in one call (Moving MNIST's generator, the PNG decoder; data/
native.py), each hook `num_workers` threads wide. An exception in the
producer is raised in the consumer, and closing an iteration ends its
producer. With `shard_rank` and `shard_count` a loader feeds one rank of a
data-parallel run (parallel/multihost.py): the batch size, the epoch order
and the item seeds stay the global batch's, and the rank makes only its
contiguous slice of every batch (`rows`), whose global positions reach the
item seeds and the batch hooks; so the ranks' slices concatenate bit for
bit to the unsharded batch.

While tracing is on in the iterating thread (utils/trace.py), each take
is a `srvp.data.wait` span around the queue's get and adds to the
counters `srvp.data.takes` and `srvp.data.ready` (the batches already
queued); the take hands that state to the producer, whose next batches
are `srvp.data.produce` spans.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from srvp_tpu_torch.data.base import collate_uint8
from srvp_tpu_torch.utils import trace

PREFETCH = 2   # batches made ahead of the consumer


def epoch_order(n, seed, epoch):
    return np.random.RandomState(
        (seed + 0x9E3779B1 * epoch) % (2**31 - 1)).permutation(n)


def item_seed(seed, epoch, pos):
    return (seed * 1_000_003 + epoch * 7_777_777 + pos) % (2**31 - 1)


class _ProducerError:
    """Carries the producer's exception to the consumer, which would
    otherwise wait forever for the end of an epoch."""

    def __init__(self, exc):
        self.exc = exc


class DataLoader:
    """Shuffled batches of whole size (the JAX loader's shuffle=True,
    drop_last=True), one epoch per iteration."""

    def __init__(self, dataset, batch_size, seed=0,
                 collate_fn=collate_uint8, num_workers=4, prefetch=PREFETCH,
                 shard_rank=0, shard_count=1):
        if not 0 <= shard_rank < shard_count:
            raise ValueError(f"shard_rank {shard_rank} out of range for "
                             f"shard_count {shard_count}")
        if batch_size % shard_count:
            raise ValueError(f"batch_size {batch_size} must divide evenly "
                             f"over shard_count {shard_count}")
        self.shard_rank, self.shard_count = shard_rank, shard_count
        self.dataset = dataset
        self.prefetch = prefetch
        self.batch_size = batch_size
        self.seed = seed
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        self._start_batch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def fast_forward(self, n_batches):
        """Skips the next n_batches of the stream without making them, across
        epoch boundaries (srvp_tpu/data/loader.py:70): a resumed run then
        reads the batches that an uninterrupted one would."""
        per_epoch = max(len(self), 1)
        self.epoch += n_batches // per_epoch
        self._start_batch = n_batches % per_epoch

    def rows(self, b):
        """(start, stop) positions in the epoch order of this loader's
        slice of batch b."""
        per = self.batch_size // self.shard_count
        lo = b * self.batch_size + self.shard_rank * per
        return lo, lo + per

    def _batch(self, order, epoch, b, pool):
        lo, hi = self.rows(b)
        seeds = [item_seed(self.seed, epoch, pos) for pos in range(lo, hi)]
        indices = [int(order[pos]) for pos in range(lo, hi)]
        if self.collate_fn is collate_uint8:
            timemajor = getattr(self.dataset, "get_batch_timemajor_u8", None)
            if timemajor is not None:
                return timemajor(indices, seeds, self.num_workers)
        native = getattr(self.dataset, "get_batch_seeded", None)
        if native is not None:
            out = native(indices, seeds, self.num_workers)
            return out if isinstance(out, dict) else self.collate_fn(list(out))
        return self.collate_fn(list(pool.map(
            lambda k: self.dataset.get_item(
                int(order[lo + k]), np.random.RandomState(seeds[k])),
            range(hi - lo))))

    def __iter__(self):
        epoch = self.epoch
        self.epoch += 1
        start, self._start_batch = self._start_batch, 0
        order = epoch_order(len(self.dataset), self.seed, epoch)
        out_q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        traced = [False]    # the consumer's tracing state, at its last take

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(start, len(self)):
                        if stop.is_set():
                            return
                        with trace.span("srvp.data.produce", on=traced[0]):
                            batch = self._batch(order, epoch, b, pool)
                        out_q.put(batch)
                out_q.put(None)
            except BaseException as e:   # raised again in the consumer
                out_q.put(_ProducerError(e))

        thread = threading.Thread(target=producer, name="srvp-loader",
                                  daemon=True)
        thread.start()
        try:
            while True:
                traced[0] = trace.active()
                if traced[0]:
                    trace.count("srvp.data.takes")
                    trace.count("srvp.data.ready", out_q.qsize())
                with trace.span("srvp.data.wait"):
                    batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, _ProducerError):
                    raise batch.exc
                yield batch
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, and let it end:
            # no batch is made after the iteration closes
            while thread.is_alive():
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass
            thread.join()


def batches_in_order(videos, batch_size):
    """A test fold's uint8 videos [(T, H, W[, C])] as float32 (T, B, H, W,
    C) batches in [0, 1], in order; the last batch holds the remainder."""
    for lo in range(0, len(videos), batch_size):
        yield collate_uint8(videos[lo:lo + batch_size]).astype(
            np.float32) / 255.0


def dataset_batches(dataset, batch_size):
    """batches_in_order of a test fold's items (`get_item(i)`, i = 0, 1,
    ...), each batch's items read when it is taken: the JAX evaluation's
    unshuffled loader (test.py:90-95)."""
    n = len(dataset)
    for lo in range(0, n, batch_size):
        yield from batches_in_order(
            [dataset.get_item(i) for i in range(lo, min(lo + batch_size, n))],
            batch_size)


def infinite_batches(loader):
    """Cycles a DataLoader forever, one epoch after another."""
    while True:
        yield from loader


class PartsView:
    """A dataset's `get_item_parts` as `get_item`, and its native
    `get_parts_batch_seeded` as `get_batch_seeded`, for loaders that feed
    the on-device compositor (data/device_compose.py)."""

    def __init__(self, dataset):
        self._dataset = dataset

    def __len__(self):
        return len(self._dataset)

    def get_item(self, index, rng):
        return self._dataset.get_item_parts(index, rng)

    def get_batch_seeded(self, indices, seeds, n_threads=4):
        return self._dataset.get_parts_batch_seeded(indices, seeds,
                                                    n_threads)
