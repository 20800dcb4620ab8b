"""The port's Moving MNIST training data against the JAX package's numpy
path: the same seeds give bit-equal digits, items, parts, folds and loader
batches, and the on-device compositor gives the frames of get_item. The JAX
loader is fed through adapters that expose only `get_item`, so it takes its
per-item numpy path and never its native engine; the port's loader takes
its batches from the port's native generator (data/native.py)."""

import numpy as np
import pytest

import torch

from srvp_tpu.data import device_compose as jcompose
from srvp_tpu.data import mmnist as jmmnist
from srvp_tpu.data.base import collate_uint8 as jcollate_uint8
from srvp_tpu.data.loader import DataLoader as JaxLoader
from srvp_tpu_torch.data import device_compose, mmnist
from srvp_tpu_torch.data.base import collate_uint8
from srvp_tpu_torch.data.loader import DataLoader, PartsView

SEQ_LEN = 7


class ItemsOnly:
    """A dataset seen through get_item alone (parts=True: get_item_parts)."""

    def __init__(self, dataset, parts=False):
        self.dataset, self.parts = dataset, parts

    def __len__(self):
        return len(self.dataset)

    def get_item(self, index, rng):
        if self.parts:
            return self.dataset.get_item_parts(index, rng)
        return self.dataset.get_item(index, rng)


def datasets(deterministic=False, n_digits=2):
    digits = mmnist.synthetic_digits(40, np.random.RandomState(3))
    args = (64, SEQ_LEN, 4, deterministic, n_digits, True)
    return mmnist.MovingMNIST(digits, *args), jmmnist.MovingMNIST(digits,
                                                                  *args)


def test_synthetic_digits_match():
    ours = mmnist.synthetic_digits(12, np.random.RandomState(0))
    ref = jmmnist.synthetic_digits(12, np.random.RandomState(0))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("deterministic,n_digits", [(False, 2), (True, 2),
                                                    (False, 3)])
def test_items_and_parts_match(deterministic, n_digits):
    ours, ref = datasets(deterministic, n_digits)
    for seed in range(12):
        rs = lambda: np.random.RandomState(seed)  # noqa: E731
        np.testing.assert_array_equal(ours.get_item(seed, rs()),
                                      ref.get_item(seed, rs()))
        for a, b in zip(ours.get_item_parts(seed, rs()),
                        ref.get_item_parts(seed, rs())):
            np.testing.assert_array_equal(a, b)


def test_folds_match():
    ours, ref = datasets()
    for fold in ("train", "val"):
        a, b = ours.get_fold(fold), ref.get_fold(fold)
        assert len(a.data) == len(b.data) and len(a) == len(b)
        for x, y in zip(a.data, b.data):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        ours.get_fold("test")


@pytest.mark.parametrize("parts", [False, True])
def test_loader_batches_match(parts):
    ours, ref = datasets()
    ours, ref = ours.get_fold("train"), ref.get_fold("train")
    if parts:
        loader = DataLoader(PartsView(ours), 5, seed=9,
                            collate_fn=device_compose.parts_collate)
        jloader = JaxLoader(ItemsOnly(ref, parts=True), 5, seed=9,
                            num_workers=2,
                            collate_fn=jcompose.parts_collate)
    else:
        loader = DataLoader(ours, 5, seed=9, collate_fn=collate_uint8)
        jloader = JaxLoader(ItemsOnly(ref), 5, seed=9, num_workers=2,
                            collate_fn=jcollate_uint8)
    for _ in range(2):   # two epochs: the order and item seeds move on
        for j, (a, b) in enumerate(zip(loader, jloader)):
            if j == 2:
                break
            if parts:
                assert set(a) == set(b) == {"digits", "pos"}
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a.dtype == b.dtype == np.uint8
                assert a.shape == (SEQ_LEN, 5, 64, 64, 1)
                np.testing.assert_array_equal(a, b)


def test_composite_matches_jax_and_get_item():
    ours, _ = datasets(n_digits=3)
    items = [ours.get_item_parts(i, np.random.RandomState(i))
             for i in range(4)]
    batch = device_compose.parts_collate(items)
    frames = device_compose.composite_mmnist(
        torch.from_numpy(batch["digits"]), torch.from_numpy(batch["pos"]))
    ref = jcompose.composite_mmnist(batch["digits"], batch["pos"])
    assert frames.dtype == torch.uint8
    np.testing.assert_array_equal(frames.numpy(), np.asarray(ref))
    direct = collate_uint8([ours.get_item(i, np.random.RandomState(i))
                            for i in range(4)])
    np.testing.assert_array_equal(frames.numpy(), direct)
    x = device_compose.materialize(device_compose.to_device(batch, "cpu"))
    assert x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), direct / np.float32(255.0))


def test_make_dataset_needs_mnist_or_synthetic(tmp_path):
    with pytest.raises(FileNotFoundError):
        mmnist.MovingMNIST.make_dataset(str(tmp_path), 64, 5, 4, False, 2)
    ds = mmnist.MovingMNIST.make_dataset(str(tmp_path), 64, 5, 4, False, 2,
                                         allow_synthetic=True)
    ref = jmmnist.MovingMNIST.make_dataset(str(tmp_path), 64, 5, 4, False,
                                           2, True, allow_synthetic=True)
    assert len(ds.data) == len(ref.data) == 1000
    np.testing.assert_array_equal(ds.data[17], ref.data[17])
