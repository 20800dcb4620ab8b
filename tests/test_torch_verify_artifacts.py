"""The port's drop checker (srvp_tpu_torch/verify_artifacts.py) against
scripts/verify_artifacts.py on the CPU: on one fake drop in the official
layouts (LPIPS heads and AlexNet backbone, the I3D inventory, MNIST IDX,
tiny dcgan and vgg checkpoints exported from JAX params, the test sets, a
Human3.6M directory, a BAIR PNG tree) and on each corrupted variant, both
give the same rows in the same order, with the same artifact, path, status
and sha256; a manifest written by either tool is accepted by the other's
--check_manifest, which reports CHANGED, MISSING and INVALID alike. The
port's CLI runs in-process.

The JAX tool compares the shapes of its converted params with those of
srvp.init; here srvp.init is its jax.eval_shape (`abstract_init`): the same
shapes, without the ~20 s of XLA compiles an architecture that its eager
random draws cost on the CPU. The checkpoints hold seeded numpy draws of
those shapes."""

import gzip
import json
import os
import shutil
import struct
import sys

import jax
import numpy as np
import pytest
import torch

from scripts import verify_artifacts as jax_verify
from scripts.convert_i3d import expected_variable_specs
from srvp_tpu.models import srvp as jax_srvp
from srvp_tpu.models.srvp import SRVPConfig as JaxConfig
from srvp_tpu.utils.torch_export import export_state_dict
from srvp_tpu_torch import verify_artifacts
from srvp_tpu_torch.config import model_config
from srvp_tpu_torch.data.png import write_png_video
from srvp_tpu_torch.metrics.i3d import variable_specs
from srvp_tpu_torch.models.srvp import SRVP

TINY = dict(nx=16, nc=1, nf=4, nhx=8, ny=4, nz=4, skipco=False, nt_inf=2,
            nh_inf=8, nlayers_inf=2, nh_res=8, nlayers_res=2, archi="dcgan")
TINY_VGG = dict(TINY, nx=64, archi="vgg", skipco=True)
KEYS = ("artifact", "path", "status", "sha256")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def save_pt(path, sd):
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)


def lpips_heads(rng, channels=(64, 192, 384, 256, 256)):
    return {f"lin{i}.model.1.weight": rng.rand(1, c, 1, 1).astype("f")
            for i, c in enumerate(channels)}


INIT = jax_srvp.init


def abstract_init(key, cfg):
    return jax.eval_shape(lambda k: INIT(k, cfg), key)


@pytest.fixture(autouse=True)
def shapes_only_init(monkeypatch):
    monkeypatch.setattr(jax_srvp, "init", abstract_init)


def write_checkpoint(xp, cfg, seed):
    """model.pt of JAX params and batch-norm state (seeded draws of
    srvp.init's shapes, variances positive) through export_state_dict."""
    jcfg = JaxConfig(**cfg)
    rng = np.random.RandomState(seed)
    params, state = jax.tree_util.tree_map(
        lambda a: np.abs(rng.randn(*a.shape)).astype(a.dtype),
        abstract_init(jax.random.PRNGKey(seed), jcfg))
    save_pt(xp / "model.pt", export_state_dict(params, state, jcfg))
    (xp / "config.json").write_text(json.dumps(cfg))


def write_idx(path, magic=2051):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">IIII", magic, 3, 28, 28) + bytes(3 * 28 * 28))


def write_bair(root, n_frames, rng):
    for v in range(2):
        write_png_video(root / "processed_data" / "test" / "traj_0" / str(v),
                        rng.randint(0, 256, (n_frames, 8, 8, 3),
                                    dtype=np.uint8), "{:02d}.png")


@pytest.fixture(scope="module")
def drop(tmp_path_factory):
    """A complete fake drop in the official formats, no checkpoint."""
    root = tmp_path_factory.mktemp("drop")
    rng = np.random.RandomState(0)
    save_pt(root / "lpips" / "weights" / "v0.1" / "alex.pth",
            lpips_heads(rng))
    backbone = {}
    for i, (o, c, k) in {0: (64, 3, 11), 3: (192, 64, 5), 6: (384, 192, 3),
                         8: (256, 384, 3), 10: (256, 256, 3)}.items():
        backbone[f"features.{i}.weight"] = rng.rand(o, c, k, k).astype("f")
        backbone[f"features.{i}.bias"] = rng.rand(o).astype("f")
    save_pt(root / "lpips" / "alexnet-owt-7be5be79.pth", backbone)
    (root / "i3d").mkdir()
    np.savez(root / "i3d" / "i3d_kinetics400.npz",
             **{p: np.zeros(s, np.float32) for p, s in variable_specs()})
    write_idx(root / "mnist" / "train-images-idx3-ubyte.gz")
    ds = root / "datasets"
    ds.mkdir()
    np.savez(ds / "smmnist_test_2digits_64.npz",
             sequences=rng.randint(0, 255, (25, 6, 64, 64), dtype=np.uint8))
    np.savez(ds / "mmnist_test_2digits_64.npz",
             sequences=rng.randint(0, 255, (100, 2, 64, 64), dtype=np.uint8))
    np.savez(ds / "svg_test_set_40.npz",
             sequences=rng.randint(0, 255, (3, 40, 64, 64, 1),
                                   dtype=np.uint8))
    (ds / "human" / "test_set_53_8").mkdir(parents=True)
    np.savez(ds / "human" / "test_set_53_8" / "vid0.npz",
             image=rng.randint(0, 255, (53, 64, 64, 3), dtype=np.uint8))
    write_bair(ds / "bair", 30, rng)
    return root


@pytest.fixture(scope="module")
def full_drop(drop, tmp_path_factory):
    """The drop with a tiny dcgan and a tiny vgg checkpoint."""
    root = tmp_path_factory.mktemp("full") / "drop"
    shutil.copytree(drop, root)
    write_checkpoint(root / "checkpoints" / "smmnist", TINY, 0)
    write_checkpoint(root / "checkpoints" / "kth", TINY_VGG, 1)
    return root


def both(drop):
    """(the port's rows, the JAX tool's rows), each with its ok, after
    checking that they agree."""
    ours, ok = verify_artifacts.verify_drop(str(drop), "cpu")
    ref, ref_ok = jax_verify.verify_drop(str(drop))
    assert ok == ref_ok
    assert [[r.get(k) for k in KEYS] for r in ours] == \
        [[r.get(k) for k in KEYS] for r in ref], (ours, ref)
    return ours, ok


def test_i3d_inventory_matches_jax():
    assert [(k, tuple(s)) for k, s in variable_specs()] == \
        [(k, tuple(s)) for k, s in expected_variable_specs()]


def test_valid_drop_matches_jax(full_drop):
    rows, ok = both(full_drop)
    assert ok, rows
    assert [r["artifact"] for r in rows] == [
        "lpips-linear-heads", "i3d-kinetics400", "smmnist-test-set",
        "mmnist-det-test-set", "kth-test-set", "alexnet-backbone",
        "mnist-idx", "checkpoint:kth", "checkpoint:smmnist",
        "human-test-set", "bair-test-set"]
    assert all(("sha256" in r) == os.path.isfile(full_drop / r["path"])
               for r in rows)
    # the checkpoints load into the port's model, strictly
    for name, cfg in (("smmnist", TINY), ("kth", TINY_VGG)):
        model = SRVP(model_config(cfg))
        sd = torch.load(full_drop / "checkpoints" / name / "model.pt",
                        weights_only=True)
        model.load_state_dict(sd, strict=True)


def corrupt_lpips_shape(root, src, rng):
    save_pt(root / "lpips" / "alex.pth",
            lpips_heads(rng, (64, 192, 999, 256, 256)))


def corrupt_lpips_nan(root, src, rng):
    heads = lpips_heads(rng)
    heads["lin3.model.1.weight"][0, 5] = np.nan
    save_pt(root / "lpips" / "alex.pth", heads)


def corrupt_i3d_missing(root, src, rng):
    (root / "i3d").mkdir()
    np.savez(root / "i3d" / "i3d_kinetics400.npz",
             **{p: np.zeros(s, np.float32) for p, s in variable_specs()[:-1]})


def corrupt_i3d_extra(root, src, rng):
    (root / "i3d").mkdir()
    arrays = {p: np.zeros(s, np.float32) for p, s in variable_specs()}
    np.savez(root / "i3d" / "i3d_kinetics400.npz", extra=np.zeros(3),
             **arrays)


def corrupt_pt_truncated(root, src, rng):
    ck = root / "checkpoints" / "smmnist"
    ck.mkdir(parents=True)
    data = (src / "checkpoints" / "smmnist" / "model.pt").read_bytes()
    (ck / "model.pt").write_bytes(data[:len(data) // 2])
    (ck / "config.json").write_text(json.dumps(TINY))


def corrupt_wrong_config(root, src, rng):
    ck = root / "checkpoints" / "smmnist"
    shutil.copytree(src / "checkpoints" / "smmnist", ck)
    (ck / "config.json").write_text(json.dumps(dict(TINY, archi="vgg",
                                                    skipco=True)))


def corrupt_pickled_module(root, src, rng):
    ck = root / "checkpoints" / "smmnist"
    ck.mkdir(parents=True)
    torch.save(SRVP(model_config(TINY)), ck / "model.pt")
    (ck / "config.json").write_text(json.dumps(TINY))


def corrupt_test_set_dtype(root, src, rng):
    (root / "datasets").mkdir()
    np.savez(root / "datasets" / "svg_test_set_40.npz",
             sequences=np.zeros((4, 40, 64, 64), np.float32))


def corrupt_short_time_axis(root, src, rng):
    # more videos than the protocol's 40 frames, each of 20 frames
    (root / "datasets").mkdir()
    np.savez(root / "datasets" / "svg_test_set_40.npz",
             sequences=np.zeros((100, 20, 64, 64), np.uint8))


def corrupt_idx_magic(root, src, rng):
    write_idx(root / "mnist" / "t10k-images-idx3-ubyte.gz", magic=1234)


def corrupt_bair_29_frames(root, src, rng):
    write_bair(root / "datasets" / "bair", 29, rng)


def corrupt_human_dtype(root, src, rng):
    (root / "datasets" / "human" / "test_set_53_8").mkdir(parents=True)
    np.savez(root / "datasets" / "human" / "test_set_53_8" / "v.npz",
             image=np.zeros((53, 64, 64, 3), np.float32))


CORRUPTIONS = [corrupt_lpips_shape, corrupt_lpips_nan, corrupt_i3d_missing,
               corrupt_i3d_extra, corrupt_pt_truncated, corrupt_wrong_config,
               corrupt_pickled_module, corrupt_test_set_dtype,
               corrupt_short_time_axis, corrupt_idx_magic,
               corrupt_bair_29_frames, corrupt_human_dtype]


@pytest.mark.parametrize("corrupt", CORRUPTIONS,
                         ids=[c.__name__[8:] for c in CORRUPTIONS])
def test_corrupt_drop_matches_jax(corrupt, full_drop, tmp_path):
    corrupt(tmp_path, full_drop, np.random.RandomState(1))
    rows, ok = both(tmp_path)
    assert not ok and len(rows) == 1 and rows[0]["status"] == "INVALID"


def test_empty_drop(tmp_path, capsys):
    assert both(tmp_path) == ([], False)
    assert verify_artifacts.main(["--drop", str(tmp_path)]) == 1
    assert json.loads(capsys.readouterr().out.splitlines()[0])["status"] \
        == "EMPTY"


def jax_main(argv, monkeypatch):
    """scripts/verify_artifacts.py's main in-process; returns its exit
    code."""
    monkeypatch.setattr(sys, "argv", ["verify_artifacts.py", *argv])
    with pytest.raises(SystemExit) as e:
        jax_verify.main()
    return e.value.code


def manifest_rows(out):
    return {r["manifest_check"]["path"]: r["manifest_check"]["status"]
            for r in map(json.loads, out.splitlines())
            if "manifest_check" in r}


def test_manifests_cross_accepted(full_drop, tmp_path, monkeypatch, capsys):
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    assert verify_artifacts.main(["--drop", str(full_drop), "--manifest",
                                  str(ours), "--device", "cpu"]) == 0
    assert jax_main(["--drop", str(full_drop), "--manifest", str(theirs)],
                    monkeypatch) == 0
    a, b = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert a["drop"] == b["drop"] and a["ok"] and b["ok"]
    assert [[r.get(k) for k in KEYS] for r in a["artifacts"]] == \
        [[r.get(k) for k in KEYS] for r in b["artifacts"]]
    assert len(a["artifacts"]) == 11
    capsys.readouterr()
    assert verify_artifacts.main(["--drop", str(full_drop),
                                  "--check_manifest", str(theirs),
                                  "--device", "cpu"]) == 0
    assert set(manifest_rows(capsys.readouterr().out).values()) == {"ok"}
    assert jax_main(["--drop", str(full_drop), "--check_manifest",
                     str(ours)], monkeypatch) == 0


def test_manifest_rejections_match_jax(drop, tmp_path, monkeypatch, capsys):
    """One accepted manifest (the JAX tool's, of the drop without
    checkpoints); a clone with a changed idx byte, no I3D and a corrupt
    test set gives CHANGED, MISSING and INVALID rows from both tools."""
    manifest = tmp_path / "accepted.json"
    assert jax_main(["--drop", str(drop), "--manifest", str(manifest)],
                    monkeypatch) == 0
    clone = tmp_path / "clone"
    shutil.copytree(drop, clone)
    with gzip.open(clone / "mnist" / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 3, 28, 28) + b"\x01"
                + bytes(3 * 28 * 28 - 1))
    os.remove(clone / "i3d" / "i3d_kinetics400.npz")
    np.savez(clone / "datasets" / "svg_test_set_40.npz",
             sequences=np.zeros((3, 40, 64, 64), np.float32))
    capsys.readouterr()
    argv = ["--drop", str(clone), "--check_manifest", str(manifest)]
    assert verify_artifacts.main(argv + ["--device", "cpu"]) == 1
    ours = manifest_rows(capsys.readouterr().out)
    assert jax_main(argv, monkeypatch) == 1
    assert manifest_rows(capsys.readouterr().out) == ours
    assert {ours["mnist/train-images-idx3-ubyte.gz"],
            ours["i3d/i3d_kinetics400.npz"],
            ours["datasets/svg_test_set_40.npz"]} == {"CHANGED", "MISSING",
                                                       "INVALID"}
    assert list(ours.values()).count("ok") == len(ours) - 3
    # a manifest recorded from an invalid drop is refused
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"ok": False, "artifacts": []}))
    rows, ok = verify_artifacts.check_against_manifest([], str(bad))
    assert not ok and rows[0]["status"] == "REJECTED"


def test_checkpoint_needs_a_card_or_cpu(full_drop, drop):
    if torch.cuda.is_available():
        assert verify_artifacts.verify_drop(str(full_drop))[1]
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        verify_artifacts.verify_drop(str(full_drop))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        verify_artifacts.main(["--drop", str(full_drop)])
    # a drop without a checkpoint needs no device
    assert verify_artifacts.verify_drop(str(drop))[1]
