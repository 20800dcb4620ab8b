"""The port's packers (srvp_tpu_torch/data/pack.py) against
preprocessing/{kth,bair}/pack.py on the CPU: on the same frame trees,
written once with PIL and once with the port's PNG writer so that both
decoders meet both kinds of file, they write the same .npy bytes and the
same COMPLETE.json, through the native decoder and through `--plain`. Each
rule of the JAX packers holds: a frameless video directory raises, a
`.tmp` leftover is not enumerated, `--delete_png` removes the frames once
the arrays are in place, a stray directory beside KTH's classes is
ignored. `prefer_packed=False` reads the PNG tree beside a complete packed
tree, and the port's loader gives the same batches from the PNG tree, from
the tree it packed and as the JAX loader (prefer_packed=False) for the
same seed."""

import json
import shutil
from itertools import islice
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import torch

from preprocessing.bair.pack import pack_fold as jax_pack_fold
from preprocessing.kth.pack import pack_tree as jax_pack_tree
from srvp_tpu.data.bair import BAIR as JaxBAIR
from srvp_tpu.data.base import collate_uint8 as jcollate_uint8
from srvp_tpu.data.kth import KTH as JaxKTH
from srvp_tpu.data.loader import DataLoader as JaxLoader
from srvp_tpu.data.loader import infinite_batches as jax_infinite_batches
from srvp_tpu_torch.data import native, pack
from srvp_tpu_torch.data.bair import BAIR
from srvp_tpu_torch.data.kth import KTH
from srvp_tpu_torch.data.loader import DataLoader, infinite_batches
from srvp_tpu_torch.data.png import write_png_video

KTH_NX = 16
WRITERS = ["pil", "port"]
DECODERS = ["native", "plain"]


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def write_video(vdir, video, writer):
    """uint8 (T, H, W[, 3]) as vdir/image-{t:03d}.png, by PIL or by the
    port's writer."""
    if writer == "port":
        return write_png_video(vdir, video, "image-{:03d}.png")
    vdir.mkdir(parents=True)
    for t, frame in enumerate(video):
        Image.fromarray(frame).save(vdir / f"image-{t:03d}.png")


def write_kth(root, writer):
    """KTH at 16 pixels: boxing and walking x persons 1, 2, 3 and 21, 14
    frames each but 5 for person 3, RGB files for person 1 and gray ones
    for the others, and a stray directory that is not a class."""
    rng = np.random.RandomState(0)
    src = root / f"processed_{KTH_NX}"
    for c in KTH.classes:
        (src / c).mkdir(parents=True)
    for c in ("boxing", "walking"):
        for person in (1, 2, 3, 21):
            shape = (5 if person == 3 else 14, KTH_NX, KTH_NX) + (
                (3,) if person == 1 else ())
            write_video(src / c / f"person{person:02d}_{c}_d1",
                        rng.randint(0, 256, shape).astype(np.uint8), writer)
    write_video(src / "not_a_class" / "person01_not_a_class_d1",
                rng.randint(0, 256, (3, KTH_NX, KTH_NX)).astype(np.uint8),
                writer)
    return root


def write_bair(root, writer):
    """BAIR: 5 training videos (traj_0/0-2, traj_1/0-1) and 2 test videos
    of 30 RGB frames."""
    rng = np.random.RandomState(1)
    for fold, videos in (("train", ["traj_0/0", "traj_0/1", "traj_0/2",
                                    "traj_1/0", "traj_1/1"]),
                         ("test", ["traj_0/0", "traj_0/1"])):
        for v in videos:
            write_video(root / "processed_data" / fold / v,
                        rng.randint(0, 256, (30, 64, 64, 3)).astype(
                            np.uint8), writer)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{(dataset, writer): the PNG tree}."""
    out = {}
    for writer in WRITERS:
        base = tmp_path_factory.mktemp(writer)
        out["kth", writer] = write_kth(base / "kth", writer)
        out["bair", writer] = write_bair(base / "bair", writer)
    return out


def copy_tree(src, dst):
    shutil.copytree(src, dst)
    return dst


def packed_root(dataset):
    return f"packed_{KTH_NX}" if dataset == "kth" else "packed_data"


def jax_pack(dataset, root):
    if dataset == "kth":
        return jax_pack_tree(str(root), KTH_NX)
    return sum(jax_pack_fold(str(root), fold) for fold in ("train", "test"))


def port_pack(dataset, root, **kw):
    if dataset == "kth":
        return pack.pack_kth(str(root), KTH_NX, **kw)
    return sum(pack.pack_bair_fold(str(root), fold, **kw)
               for fold in ("train", "test"))


def files(root):
    """{relative path: bytes} of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("dataset", ["kth", "bair"])
def test_packers_write_the_jax_packers_bytes(trees, tmp_path, dataset,
                                             writer, decoder):
    ref = copy_tree(trees[dataset, writer], tmp_path / "jax")
    ours = copy_tree(trees[dataset, writer], tmp_path / "port")
    n = jax_pack(dataset, ref)
    before = native.decoded["frames"]
    assert port_pack(dataset, ours, plain=decoder == "plain") == n
    assert (native.decoded["frames"] > before) == (decoder == "native")
    want = files(ref / packed_root(dataset))
    assert files(ours / packed_root(dataset)) == want
    assert not any(name.endswith(".tmp") for name in want)
    if dataset == "kth":
        # the stray directory is neither packed nor counted
        assert json.loads(want["COMPLETE.json"]) == {"videos": 8}
        assert not any(name.startswith("not_a_class") for name in want)
    else:
        assert json.loads(want["train/COMPLETE.json"]) == {"videos": 5}
        assert json.loads(want["test/COMPLETE.json"]) == {"videos": 2}


@pytest.mark.parametrize("dataset", ["kth", "bair"])
def test_frameless_video_directory_raises(trees, tmp_path, dataset):
    ref = copy_tree(trees[dataset, "port"], tmp_path / "jax")
    ours = copy_tree(trees[dataset, "port"], tmp_path / "port")
    empty = (Path(f"processed_{KTH_NX}/walking/person02_walking_d2")
             if dataset == "kth" else Path("processed_data/train/traj_1/2"))
    for root in (ref, ours):
        (root / empty).mkdir()
    with pytest.raises(ValueError, match="no PNG frames"):
        jax_pack(dataset, ref)
    with pytest.raises(ValueError, match="no PNG frames"):
        port_pack(dataset, ours)


@pytest.mark.parametrize("dataset", ["kth", "bair"])
def test_tmp_leftover_is_not_enumerated(trees, tmp_path, dataset):
    root = copy_tree(trees[dataset, "port"], tmp_path / "tree")
    port_pack(dataset, root)
    leftover = (Path(f"packed_{KTH_NX}/boxing/person02_boxing_d1.npy.tmp")
                if dataset == "kth" else Path("packed_data/train/traj_0/"
                                              "1.npy.tmp"))
    (root / leftover).write_bytes(b"a crashed write")
    ds = (KTH.make_dataset(str(root), KTH_NX, 4, True) if dataset == "kth"
          else BAIR.make_dataset(str(root), 4, True))
    assert ds.packed     # the marker's count still matches
    assert len(ds.data) == (6 if dataset == "kth" else 5)
    assert not any(str(p).endswith(".tmp") for p in (
        ds.data if dataset == "bair" else [path for path, _ in ds.data]))


@pytest.mark.parametrize("dataset", ["kth", "bair"])
def test_delete_png_removes_frames_after_packing(trees, tmp_path, dataset):
    ref = copy_tree(trees[dataset, "port"], tmp_path / "jax")
    ours = copy_tree(trees[dataset, "port"], tmp_path / "port")
    jax_pack(dataset, ref)
    port_pack(dataset, ours, delete_png=True)
    assert files(ours / packed_root(dataset)) == files(
        ref / packed_root(dataset))
    src = f"processed_{KTH_NX}" if dataset == "kth" else "processed_data"
    left = sorted(p.relative_to(ours / src)
                  for p in (ours / src).rglob("*.png"))
    # KTH's stray directory is not a video of the dataset: kept
    assert left == ([Path(f"not_a_class/person01_not_a_class_d1/"
                          f"image-00{t}.png") for t in range(3)]
                    if dataset == "kth" else [])
    ds = (KTH.make_dataset(str(ours), KTH_NX, 4, True) if dataset == "kth"
          else BAIR.make_dataset(str(ours), 4, True))
    assert ds.packed


def loader_batches(dataset, n, seed=3):
    return list(islice(infinite_batches(DataLoader(
        dataset, 2, seed=seed, num_workers=2)), n))


def jax_batches(dataset, n, seed=3):
    return list(islice(jax_infinite_batches(JaxLoader(
        dataset, 2, shuffle=True, drop_last=True, seed=seed, num_workers=1,
        collate_fn=jcollate_uint8)), n))


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("dataset", ["kth", "bair"])
def test_loader_batches_from_png_and_packed_trees_match_jax(
        trees, tmp_path, dataset, writer):
    root = copy_tree(trees[dataset, writer], tmp_path / "tree")
    port_pack(dataset, root)     # a complete packed tree beside the PNGs
    if dataset == "kth":
        png, packed, ref = (
            KTH.make_dataset(str(root), KTH_NX, 4, True, prefer_packed=False),
            KTH.make_dataset(str(root), KTH_NX, 4, True),
            JaxKTH.make_dataset(str(root), KTH_NX, 4, True,
                                prefer_packed=False))
    else:
        png, packed, ref = (
            BAIR.make_dataset(str(root), 4, True, prefer_packed=False),
            BAIR.make_dataset(str(root), 4, True),
            JaxBAIR.make_dataset(str(root), 4, True, prefer_packed=False))
    assert not png.packed and packed.packed and not ref.packed
    before = native.decoded["frames"]
    png_batches = loader_batches(png, 4)
    assert native.decoded["frames"] >= before + 4 * 2 * 4
    before = native.decoded["frames"]
    packed_batches = loader_batches(packed, 4)
    assert native.decoded["frames"] == before
    jax = jax_batches(ref, 4)
    shape = (4, 2, KTH_NX, KTH_NX, 1) if dataset == "kth" else (
        4, 2, 64, 64, 3)
    for a, b, c in zip(png_batches, packed_batches, jax):
        assert a.shape == shape and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("dataset", ["kth", "bair"])
def test_cli_packs_as_the_function_does(trees, tmp_path, dataset):
    ref = copy_tree(trees[dataset, "pil"], tmp_path / "fn")
    ours = copy_tree(trees[dataset, "pil"], tmp_path / "cli")
    port_pack(dataset, ref)
    pack.main(["--dataset", dataset, "--data_dir", str(ours), "--threads",
               "2"] + (["--nx", str(KTH_NX)] if dataset == "kth" else []))
    assert files(ours / packed_root(dataset)) == files(
        ref / packed_root(dataset))
    with pytest.raises(SystemExit):
        pack.main(["--dataset", dataset, "--data_dir", str(ours)]
                  + (["--fold", "train"] if dataset == "kth"
                     else ["--nx", "32"]))
