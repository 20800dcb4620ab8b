"""The port's Moving MNIST test-fold reader against the JAX loader: the same
archive gives bit-equal batches."""

import numpy as np
import pytest

from srvp_tpu.data.base import load_dataset
from srvp_tpu.data.loader import DataLoader
from srvp_tpu.helper import DotDict
from srvp_tpu_torch.data import mmnist_test


@pytest.mark.parametrize("deterministic", [False, True])
def test_test_fold_batches_match_jax_loader(tmp_path, deterministic):
    seqs = np.random.RandomState(0).randint(0, 256, (9, 7, 64, 64)) \
        .astype(np.uint8)
    path = mmnist_test.archive_path(str(tmp_path), 64, 2, deterministic)
    np.savez_compressed(path, sequences=seqs)
    config = DotDict(dataset="smmnist", data_dir=str(tmp_path), nx=64,
                     seq_len=9, max_speed=4, deterministic=deterministic,
                     ndigits=2)
    testset = load_dataset(config, train=False).get_fold("test")
    ref = list(DataLoader(testset, 3, shuffle=False, drop_last=False,
                          num_workers=1))
    ours = list(mmnist_test.iterate_batches(
        mmnist_test.load_test_sequences(str(tmp_path), 64, 2, deterministic),
        3))
    assert [b.shape for b in ours] == [(9, 3, 64, 64, 1)] * 2 \
        + [(9, 1, 64, 64, 1)]
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
