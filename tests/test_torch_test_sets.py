"""The port's test-set makers (srvp_tpu_torch/data/test_sets.py) against
preprocessing/{kth,mmnist}/make_test_set.py on the CPU: for the same seed
and inputs (a tiny KTH PNG tree of the test persons, written by PIL and by
the port's writer; MNIST IDX files of 20 digits written here) the npz
arrays are equal bit for bit, through the native decoder and `--plain`;
the port's evaluation datasets read what the port's makers write."""

import argparse
import gzip
import struct

import numpy as np
import pytest
from PIL import Image

import torch

from preprocessing.kth import make_test_set as jax_kth_test_set
from preprocessing.mmnist import make_test_set as jax_mmnist_test_set
from srvp_tpu_torch.data import mmnist_test, native, test_sets
from srvp_tpu_torch.data.kth import CLASSES, KTH
from srvp_tpu_torch.data.mmnist import load_mnist_labels
from srvp_tpu_torch.data.png import write_png_video

NX, N_FRAMES = 16, 8


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def kth_trees(tmp_path_factory):
    """{writer: a KTH tree of persons 21-25, every class, trials 1-4, RGB
    frames at 16 pixels (the JAX maker reads the first channel of a colour
    file)}, the same frames by PIL and by the port's writer."""
    out = {}
    for writer in ("pil", "port"):
        rng = np.random.RandomState(0)
        root = tmp_path_factory.mktemp(writer)
        for c in CLASSES:
            for person in range(21, 26):
                for trial in range(1, 5):
                    vdir = (root / f"processed_{NX}" / c
                            / f"person{person:02d}_{c}_d{trial}")
                    video = rng.randint(0, 256, (N_FRAMES, NX, NX, 3)
                                        ).astype(np.uint8)
                    if writer == "port":
                        write_png_video(vdir, video, "image-{:03d}.png")
                        continue
                    vdir.mkdir(parents=True)
                    for t, frame in enumerate(video):
                        Image.fromarray(frame).save(
                            vdir / f"image-{t:03d}.png")
        out[writer] = root
    return out


def load(path):
    with np.load(path, allow_pickle=False) as arc:
        return {k: arc[k] for k in arc.files}


def assert_same_arrays(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("decoder", ["native", "plain"])
@pytest.mark.parametrize("writer", ["pil", "port"])
def test_kth_test_set_matches_jax(kth_trees, writer, decoder, tmp_path):
    root = kth_trees[writer]
    jax_kth_test_set.main(argparse.Namespace(
        data_dir=str(root), size=20, seq_len=5, image_size=NX, seed=42))
    ref = load(root / "svg_test_set_5.npz")
    # both makers write into data_dir: move the JAX one's file away
    (root / "svg_test_set_5.npz").rename(tmp_path / "jax.npz")
    before = native.decoded["frames"]
    path = test_sets.main(["kth", "--data_dir", str(root), "--size", "20",
                           "--seq_len", "5", "--image_size", str(NX),
                           "--threads", "2"]
                          + (["--plain"] if decoder == "plain" else []))
    assert (native.decoded["frames"] > before) == (decoder == "native")
    ours = load(path)
    assert ours["sequences"].shape == (20, 5, NX, NX)
    assert_same_arrays(ours, ref)
    # the port's evaluation reads it: KTH's test fold, in order
    fold = KTH.make_dataset(str(root), NX, 5, train=False)
    assert len(fold) == 20
    for i in (0, 19):
        np.testing.assert_array_equal(fold.get_item(i), ref["sequences"][i])


def write_idx(root, images, labels, gz):
    """MNIST's test files, IDX images and labels."""
    opener = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    with opener(root / f"t10k-images-idx3-ubyte{sfx}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
    with opener(root / f"t10k-labels-idx1-ubyte{sfx}", "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())


@pytest.mark.parametrize("deterministic", [False, True])
def test_mmnist_test_set_matches_jax(tmp_path, deterministic):
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (20, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 20).astype(np.uint8)
    ref_dir, our_dir = tmp_path / "jax", tmp_path / "port"
    for d in (ref_dir, our_dir):
        d.mkdir()
        write_idx(d, images, labels, gz=deterministic)
    np.testing.assert_array_equal(load_mnist_labels(str(our_dir), False),
                                  labels)
    jax_mmnist_test_set.main(argparse.Namespace(
        data_dir=str(ref_dir), seq_len=10, seed=42,
        deterministic=deterministic, digits=2, frame_size=64, max_speed=4))
    path = test_sets.main(["mmnist", "--data_dir", str(our_dir), "--seq_len",
                           "10"] + (["--deterministic"] if deterministic
                                    else []))
    name = ("" if deterministic else "s") + "mmnist_test_2digits_64.npz"
    assert path.endswith(name)
    ref, ours = load(ref_dir / name), load(path)
    assert ours["sequences"].shape == (10, 10, 64, 64)
    assert ours["latents"].shape == (10, 10, 2, 4)
    assert_same_arrays(ours, ref)
    # the port's evaluation reads it
    seqs = mmnist_test.load_test_sequences(str(our_dir), 64, 2,
                                           deterministic)
    np.testing.assert_array_equal(seqs, ref["sequences"])
    batches = list(mmnist_test.iterate_batches(seqs, 4))
    assert [b.shape for b in batches] == [(10, 4, 64, 64, 1)] * 2 + [
        (10, 2, 64, 64, 1)]
