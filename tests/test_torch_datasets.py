"""BAIR, Human3.6M and KTH's PNG tree in the port, against the JAX package
on the CPU: on trees written by scripts/make_synthetic_{bair,human}.py and
a KTH PNG tree (gray and RGB frames, as tests/test_kth_pipeline.py writes
it), and on the packed trees that preprocessing/{bair,kth}/pack.py make of
them, the port's datasets enumerate the same videos, split the same
seed-42 folds, draw the same items and give `DataLoader` batches (through
the native decoder's time-major and per-item hooks) equal to
srvp_tpu.data.{bair,human,kth} and srvp_tpu.data.loader for the same
seeds, and the PNG tree's batches equal the packed tree's; Human's
`change_seq_len` keeps its stride; the test folds come in the JAX
evaluation's order. Then the trainer and test_main end to end on each
dataset at tiny widths. Data are bit-equal."""

import json
import shutil
import subprocess
import sys
from itertools import islice
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import torch

from preprocessing.bair.pack import pack_fold
from preprocessing.kth.pack import pack_tree
from srvp_tpu.data.bair import BAIR as JaxBAIR
from srvp_tpu.data.base import collate as jcollate
from srvp_tpu.data.base import collate_uint8 as jcollate_uint8
from srvp_tpu.data.human import Human as JaxHuman
from srvp_tpu.data.kth import KTH as JaxKTH
from srvp_tpu.data.loader import DataLoader as JaxLoader
from srvp_tpu.data.loader import infinite_batches as jax_infinite_batches
from srvp_tpu_torch import test_main
from srvp_tpu_torch.args import create_args
from srvp_tpu_torch.data import native
from srvp_tpu_torch.data.bair import BAIR
from srvp_tpu_torch.data.base import collate_uint8
from srvp_tpu_torch.data.human import Human
from srvp_tpu_torch.data.kth import KTH
from srvp_tpu_torch.data.loader import (DataLoader, dataset_batches,
                                         infinite_batches)
from tests.test_torch_train_cli import train

ROOT = Path(__file__).resolve().parents[1]
SEEDS = [0, 7, 12345, 2**31 - 2]


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def script(name, *args):
    subprocess.run([sys.executable, str(ROOT / "scripts" / name), *args],
                   check=True, capture_output=True)


def move_packed(src, dst, name):
    """Moves src/name (a packed tree) to dst/name: a tree of its own."""
    dst.mkdir(exist_ok=True)
    shutil.move(str(src / name), str(dst / name))
    return dst


@pytest.fixture(scope="module")
def bair(tmp_path_factory):
    """(PNG tree, packed tree) of 24 train and 3 test videos."""
    root = tmp_path_factory.mktemp("bair")
    script("make_synthetic_bair.py", "--out", str(root / "png"),
           "--n_train", "24", "--n_test", "3")
    for fold in ("train", "test"):
        pack_fold(str(root / "png"), fold)
    return root / "png", move_packed(root / "png", root / "packed",
                                     "packed_data")


@pytest.fixture(scope="module")
def human(tmp_path_factory):
    """Train videos of 60 frames and one of 12 (shorter than a window at
    stride 4, so the loader draws again); test clips of 5 frames at
    stride 4 (test_set_5_4, preprocessing/human/make_test_set.py)."""
    root = tmp_path_factory.mktemp("human")
    script("make_synthetic_human.py", "--out", str(root), "--n_train", "5",
           "--n_test", "2", "--train_len", "60", "--test_len", "40")
    short = np.random.RandomState(0).randint(0, 256, (12, 64, 64, 3),
                                             np.uint8)
    np.savez(root / "train" / "S1_Short_0.npz", image=short,
             filename="S1_Short_0", subject=1)
    subprocess.run([sys.executable, str(ROOT / "preprocessing" / "human" /
                                        "make_test_set.py"),
                    "--data_dir", str(root), "--size", "5", "--seq_len", "5",
                    "--subsampling", "4"], check=True, capture_output=True)
    return root


@pytest.fixture(scope="module")
def kth(tmp_path_factory):
    """(PNG tree, packed tree): 2 classes x persons 1, 2, 3 and 21 (left
    out), 14 frames each but 5 for person 3 (drawn again), RGB files for
    person 1 and gray ones for the others; and svg_test_set_8.npz."""
    root = tmp_path_factory.mktemp("kth")
    rng = np.random.RandomState(0)
    for c in KTH.classes:
        (root / "png" / "processed_64" / c).mkdir(parents=True)
    for c in ("boxing", "walking"):
        for person in (1, 2, 3, 21):
            d = root / "png" / "processed_64" / c / \
                f"person{person:02d}_{c}_d1"
            d.mkdir()
            for t in range(5 if person == 3 else 14):
                shape = (64, 64, 3) if person == 1 else (64, 64)
                Image.fromarray(rng.randint(0, 256, shape).astype(
                    np.uint8)).save(d / f"image-{t + 1:03d}.png")
    pack_tree(str(root / "png"))
    seqs = rng.randint(0, 256, (3, 8, 64, 64)).astype(np.uint8)
    np.savez_compressed(root / "png" / "svg_test_set_8.npz", sequences=seqs)
    return root / "png", move_packed(root / "png", root / "packed",
                                     "packed_64")


def loader_batches(dataset, n, seed=3, per_item_hook=False):
    """The first n batches of 4 of the port's loader, epoch after epoch:
    through the time-major hook (collate_uint8), or with another collation
    through the per-item hook get_batch_seeded."""
    collate = (lambda items: collate_uint8(items)) if per_item_hook \
        else collate_uint8
    return list(islice(infinite_batches(DataLoader(
        dataset, 4, seed=seed, collate_fn=collate, num_workers=2)), n))


def jax_batches(dataset, n, seed=3):
    return list(islice(jax_infinite_batches(JaxLoader(
        dataset, 4, shuffle=True, drop_last=True, seed=seed, num_workers=1,
        collate_fn=jcollate_uint8)), n))


def assert_batches_equal(ours, ref, shape):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == np.uint8 and a.shape == shape
        np.testing.assert_array_equal(a, b)


def assert_test_fold_matches_jax(ours, ref, n, bsz=2):
    """The port's test batches against the JAX evaluation's loader
    (test.py:90-95: unshuffled, the last batch ragged, float32)."""
    batches = list(dataset_batches(ours, bsz))
    assert [b.shape[1] for b in batches] == [bsz] * (n // bsz) + (
        [n % bsz] if n % bsz else [])
    jbatches = list(JaxLoader(ref.get_fold("test"), bsz, shuffle=False,
                              drop_last=False, num_workers=1,
                              collate_fn=jcollate))
    assert len(batches) == len(jbatches)
    for a, b in zip(batches, jbatches):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tree", ["png", "packed"])
def test_bair_matches_jax(bair, tree):
    root = str(bair[tree == "packed"])
    ours = BAIR.make_dataset(root, 6, train=True)
    ref = JaxBAIR.make_dataset(root, 6, train=True)
    assert ours.packed == ref.packed == (tree == "packed")
    assert ours.data == ref.data and len(ours) == 24
    for fold in ("train", "val"):
        a, b = ours.get_fold(fold), ref.get_fold(fold)
        assert a.data == b.data
        for seed in SEEDS:
            np.testing.assert_array_equal(
                a.get_item(0, np.random.RandomState(seed)),
                b.get_item(0, np.random.RandomState(seed)))
    a, b = ours.get_fold("train"), ref.get_fold("train")
    ref_batches = jax_batches(b, 10)      # two epochs of 5
    shape = (6, 4, 64, 64, 3)
    assert_batches_equal(loader_batches(a, 10), ref_batches, shape)
    assert_batches_equal(loader_batches(a, 3, per_item_hook=True),
                         ref_batches[:3], shape)
    assert_test_fold_matches_jax(BAIR.make_dataset(root, 30, train=False),
                                 JaxBAIR.make_dataset(root, 30, train=False),
                                 3)


def test_bair_png_and_packed_trees_give_the_same_batches(bair):
    png, packed = (BAIR.make_dataset(str(d), 12, train=True).get_fold("train")
                   for d in bair)
    assert not png.packed and packed.packed
    before = native.decoded["frames"]
    assert_batches_equal(loader_batches(png, 5), loader_batches(packed, 5),
                         (12, 4, 64, 64, 3))
    assert native.decoded["frames"] == before + 5 * 4 * 12


def test_human_matches_jax(human):
    ours = Human.make_dataset(str(human), 64, 5, 4, train=True)
    ref = JaxHuman.make_dataset(str(human), 64, 5, 4, train=True)
    assert len(ours.data) == 6 and ours.actual_seq_len == 17
    for a, b in zip(ours.data, ref.data):
        np.testing.assert_array_equal(a, b)
    for fold in ("train", "val"):
        a, b = ours.get_fold(fold), ref.get_fold(fold)
        assert len(a.data) == len(b.data)
        for seed in SEEDS:
            x = a.get_item(0, np.random.RandomState(seed))
            assert x.shape == (5, 64, 64, 3)
            np.testing.assert_array_equal(
                x, b.get_item(0, np.random.RandomState(seed)))
    a, b = ours.get_fold("train"), ref.get_fold("train")
    assert_batches_equal(loader_batches(a, 3), jax_batches(b, 3),
                         (5, 4, 64, 64, 3))
    assert_test_fold_matches_jax(
        Human.make_dataset(str(human), 64, 5, 4, train=False),
        JaxHuman.make_dataset(str(human), 64, 5, 4, train=False), 5)


def test_human_change_seq_len_keeps_the_stride(human):
    """Validation at seq_len_test: a window of (seq_len - 1) * subsampling
    + 1 frames read every subsampling, the 12-frame video drawn again."""
    ours = Human.make_dataset(str(human), 64, 5, 4, train=True)
    ref = JaxHuman.make_dataset(str(human), 64, 5, 4, train=True)
    for ds in (ours, ref):
        ds.change_seq_len(14)
    assert ours.actual_seq_len == ref.actual_seq_len == 53
    for seed in SEEDS:
        rng = np.random.RandomState(seed)
        x = ours.get_item(0, rng)
        np.testing.assert_array_equal(
            x, ref.get_item(0, np.random.RandomState(seed)))
        assert x.shape == (14, 64, 64, 3)
        # the window: 14 frames 4 apart, within one video
        start = [(v, t) for v, vid in enumerate(ours.data)
                 for t in range(len(vid) - 52)
                 if np.array_equal(vid[t], x[0])]
        assert any(np.array_equal(ours.data[v][t:t + 53:4], x)
                   for v, t in start)


@pytest.mark.parametrize("tree", ["png", "packed"])
def test_kth_matches_jax(kth, tree):
    root = str(kth[tree == "packed"])
    ours = KTH.make_dataset(root, 64, 6, train=True)
    ref = JaxKTH.make_dataset(root, 64, 6, train=True)
    assert ours.packed == ref.packed == (tree == "packed")
    assert ours.data == ref.data and len(ours.data) == 6  # persons 21 out
    for fold in ("train", "val"):
        a, b = ours.get_fold(fold), ref.get_fold(fold)
        assert a.data == b.data
        for seed in SEEDS:
            np.testing.assert_array_equal(
                a.get_item(0, np.random.RandomState(seed)),
                b.get_item(0, np.random.RandomState(seed)))
    a, b = ours.get_fold("train"), ref.get_fold("train")
    ref_batches = jax_batches(b, 3)
    shape = (6, 4, 64, 64, 1)
    assert_batches_equal(loader_batches(a, 3), ref_batches, shape)
    assert_batches_equal(loader_batches(a, 3, per_item_hook=True),
                         ref_batches, shape)


def test_kth_png_and_packed_trees_give_the_same_batches(kth):
    png, packed = (KTH.make_dataset(str(d), 64, 10, train=True)
                   .get_fold("train") for d in kth)
    assert not png.packed and packed.packed
    assert_batches_equal(loader_batches(png, 4), loader_batches(packed, 4),
                         (10, 4, 64, 64, 1))


TINY = ["--device", "cpu", "--archi", "vgg", "--skipco", "--ny", "4",
        "--nz", "4", "--nf", "4", "--nhx", "8", "--nh_inf", "8",
        "--nlayers_inf", "2", "--nh_res", "16", "--nlayers_res", "2",
        "--nt_inf", "2", "--n_euler_steps", "2", "--batch_size", "3",
        "--n_iter", "2", "--log_interval", "1", "--val_interval", "2",
        "--n_iter_test", "1", "--n_samples_test", "2",
        "--val_samples_chunk", "2", "--batch_size_test", "1", "--seed", "3"]
# per dataset: the trainer's flags, test_main's --nt_gen, and the test
# fold's videos and channels
CLI_CASES = {
    "bair": (["--dataset", "bair", "--nc", "3", "--seq_len", "5",
              "--nt_cond", "2"], 8, 3, 3),
    "human": (["--dataset", "human", "--subsampling", "4", "--nc", "3",
               "--seq_len", "4", "--seq_len_test", "5", "--nt_cond", "3",
               "--obs_scale", "0.2", "--res_gain", "1.2"], 5, 5, 3),
    "kth": (["--dataset", "kth", "--nc", "1", "--seq_len", "6",
             "--seq_len_test", "8", "--nt_cond", "4"], 8, 3, 1),
}


@pytest.mark.parametrize("dataset", sorted(CLI_CASES))
def test_cli_trains_and_serves(dataset, bair, human, kth, tmp_path):
    """train_main for two steps (a validation included) from BAIR's and
    KTH's PNG trees and Human3.6M at --subsampling 4, then test_main on its
    model.pt and the dataset's test fold, on the CPU at tiny widths."""
    flags, nt_gen, n_test, nc = CLI_CASES[dataset]
    data = {"bair": bair[0], "human": human, "kth": kth[0]}[dataset]
    xp = tmp_path / "xp"
    before = native.decoded["frames"]
    history = train(create_args().parse_args(
        TINY + flags + ["--data_dir", str(data), "--save_path", str(xp)]))
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    if dataset != "human":      # frames through the native decoder
        assert native.decoded["frames"] > before
    config = json.load(open(xp / "config.json"))
    assert (config["dataset"], config["nc"], config["subsampling"]) == (
        dataset, nc, 4 if dataset == "human" else 8)

    nt_cond = config["nt_cond"]
    test_main.main(test_main.create_test_args().parse_args([
        "--xp_dir", str(xp), "--data_dir", str(data), "--device", "cpu",
        "--batch_size", "2", "--n_samples", "2", "--samples_chunk", "2",
        "--nt_gen", str(nt_gen), "--model_name", "model.pt"]))
    results = np.load(xp / "results.npz")
    assert results["psnr"].shape == results["ssim"].shape == (n_test,)
    assert np.all(np.isfinite(results["psnr"]))
    assert np.load(xp / "cond_rec.npz")["samples"].shape == (
        n_test, nt_cond, 64, 64, nc)
    random_1 = np.load(xp / "random_1.npz")["samples"]
    assert random_1.shape == (n_test, nt_gen - nt_cond, 64, 64, nc)
    assert random_1.dtype == np.uint8
