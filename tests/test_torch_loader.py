"""The port's threaded, prefetching loader and its native Moving MNIST
generator against the JAX package: the same batches bit for bit for any
worker count and after `fast_forward` (inside the first epoch and past
it), a producer's error raised in the consumer, the native generator equal
to the port's numpy generator and to `srvp_tpu.native`, and the trainer's
host-composited batches (`--no_device_compose`) equal to the composited
parts batches."""

import sys
import threading

import numpy as np
import pytest

import torch

from srvp_tpu import native as jnative
from srvp_tpu.data import device_compose as jcompose
from srvp_tpu.data import mmnist as jmmnist
from srvp_tpu.data.base import collate_uint8 as jcollate_uint8
from srvp_tpu.data.loader import DataLoader as JaxLoader
from srvp_tpu_torch import train_main
from srvp_tpu_torch.data import device_compose, mmnist, native
from srvp_tpu_torch.data.base import collate_uint8
from srvp_tpu_torch.data.loader import DataLoader, PartsView, infinite_batches

from test_torch_train_cli import parse

SEQ_LEN = 7
N_ITEMS, BATCH = 12, 4   # 3 batches an epoch


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class FewItems:
    """A training dataset cut to N_ITEMS items an epoch, its native hooks
    kept (native=False: get_item alone, the JAX loader's numpy path)."""

    def __init__(self, dataset, native=True):
        self.dataset = dataset
        if native:
            self.get_batch_seeded = dataset.get_batch_seeded
            self.get_parts_batch_seeded = dataset.get_parts_batch_seeded

    def __len__(self):
        return N_ITEMS

    def get_item(self, index, rng):
        return self.dataset.get_item(index, rng)

    def get_item_parts(self, index, rng):
        return self.dataset.get_item_parts(index, rng)


class Parts:
    """get_item_parts as get_item, for the JAX loader's numpy path."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def get_item(self, index, rng):
        return self.dataset.get_item_parts(index, rng)


def datasets(deterministic=False):
    digits = mmnist.synthetic_digits(40, np.random.RandomState(3))
    args = (64, SEQ_LEN, 4, deterministic, 2, True)
    return mmnist.MovingMNIST(digits, *args), jmmnist.MovingMNIST(digits,
                                                                  *args)


@pytest.mark.parametrize("skip", [2, 7])      # inside epoch 0; in epoch 2
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("parts", [False, True])
def test_batches_match_the_jax_loader(parts, seed, workers, skip):
    ours, ref = datasets()
    ours, ref = FewItems(ours), FewItems(ref, native=False)
    if parts:
        loader = DataLoader(PartsView(ours), BATCH, seed=seed,
                            collate_fn=device_compose.parts_collate,
                            num_workers=workers)
        jloader = JaxLoader(Parts(ref), BATCH, seed=seed, num_workers=2,
                            collate_fn=jcompose.parts_collate)
    else:
        loader = DataLoader(ours, BATCH, seed=seed, collate_fn=collate_uint8,
                            num_workers=workers)
        jloader = JaxLoader(ref, BATCH, seed=seed, num_workers=2,
                            collate_fn=jcollate_uint8)
    loader.fast_forward(skip)
    jloader.fast_forward(skip)
    ours_it, ref_it = infinite_batches(loader), infinite_batches(jloader)
    for _ in range(4):       # across the next epoch boundary
        a, b = next(ours_it), next(ref_it)
        if parts:
            assert set(a) == set(b) == {"digits", "pos"}
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a.dtype == np.uint8 and a.shape == (SEQ_LEN, BATCH, 64,
                                                       64, 1)
            np.testing.assert_array_equal(a, b)
    assert loader.epoch == jloader.epoch


class Broken:
    def __len__(self):
        return N_ITEMS

    def get_item(self, index, rng):
        if index % 2:
            raise ValueError("corrupt item")
        return np.zeros((SEQ_LEN, 8, 8), np.uint8)


def test_a_producer_error_is_raised_in_the_consumer():
    caught = []

    def consume():
        try:
            for _ in DataLoader(Broken(), BATCH, num_workers=2):
                pass
        except ValueError as e:
            caught.append(e)

    thread = threading.Thread(target=consume, daemon=True)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive(), "the consumer hangs"
    assert len(caught) == 1 and "corrupt item" in str(caught[0])


@pytest.mark.parametrize("deterministic", [False, True])
def test_native_generator_matches_numpy_and_the_jax_engine(deterministic):
    ours, _ = datasets(deterministic)
    seeds = [1, 42, 1234, 999983, 2**31 - 2]
    before = dict(native.served)
    videos = ours.get_batch_seeded(range(5), seeds, n_threads=3)
    parts = ours.get_parts_batch_seeded(range(5), seeds, n_threads=3)
    assert native.served == {"parts": before["parts"] + 1,
                             "videos": before["videos"] + 1}
    assert videos.shape == (5, SEQ_LEN, 64, 64) and videos.dtype == np.uint8
    for i, seed in enumerate(seeds):
        np.testing.assert_array_equal(
            videos[i], ours.get_item(0, np.random.RandomState(seed)))
        digits, pos = ours.get_item_parts(0, np.random.RandomState(seed))
        np.testing.assert_array_equal(parts["digits"][i], digits)
        np.testing.assert_array_equal(parts["pos"][i], pos)
    args = (ours.data, 64, SEQ_LEN, 4, deterministic, 2, seeds)
    jvideos = jnative.mmnist_generate_batch(*args)
    jdigits, jpos = jnative.mmnist_parts_batch(*args)
    assert jvideos is not None, "the JAX package's native engine is missing"
    np.testing.assert_array_equal(videos, jvideos)
    np.testing.assert_array_equal(parts["digits"], jdigits)
    np.testing.assert_array_equal(parts["pos"], jpos)


def test_native_library_is_keyed_on_the_host_and_rejects_big_digits():
    path = native.build()
    assert path == native.library_path() and path.exists()
    assert path.parent == native.ROOT / "build" / "native"
    big = [np.zeros((70, 70), np.uint8)]
    with pytest.raises(ValueError, match="do not fit"):
        native.DigitPack(big, 64)


def test_host_composited_batches_equal_the_composited_parts(tmp_path):
    """--no_device_compose: the trainer's loader gives uint8 frames that
    equal the device compositor's frames of the parts batches of the same
    seed; a trainer run on them takes the same steps, whatever its
    --n_workers."""
    host, _ = train_main.loaders(parse(tmp_path, "--no_device_compose",
                                       "--n_workers", "1"))
    parts, _ = train_main.loaders(parse(tmp_path))
    for a, b in zip(infinite_batches(host), infinite_batches(parts)):
        frames = device_compose.composite_mmnist(
            torch.from_numpy(b["digits"]), torch.from_numpy(b["pos"]))
        assert a.dtype == np.uint8 and a.shape == frames.shape
        np.testing.assert_array_equal(a, frames.numpy())
        break
    for flags, xp in ((["--no_device_compose", "--n_workers", "1"], "a"),
                      (["--n_workers", "8"], "b")):
        assert train_main.main(parse(tmp_path / xp, "--device", "cpu",
                                     "--n_iter", "2", "--val_interval", "2",
                                     *flags)) == 0
    sd = [torch.load(tmp_path / xp / "xp" / "model.pt") for xp in "ab"]
    for k in sd[0]:
        assert torch.equal(sd[0][k], sd[1][k]), k


def test_served_counts_survive_concurrent_batches():
    """More threads than cores call the generator at once, with a short
    switch interval: no count is lost."""
    ours, _ = datasets()
    before = native.served["videos"]
    n_threads, calls = 16, 20
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            ours.get_batch_seeded([0], [7], n_threads=1)
            for _ in range(calls)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert native.served["videos"] == before + n_threads * calls
