"""The port's loader bench (srvp_tpu_torch/bench_loader.py) on the CPU:
`--device cpu --tiny` prints one parseable line per dataset with its keys,
every leg's batches agreeing; its synthetic trees are the JAX bench's
(scripts/bench_loader.py) frames in its layouts; its step configurations
are configs/*.yaml's, KTH's bench.CONFIGS' own; a decoder that does not
build makes the bench, the packer and the test-set maker raise (no
fallback to the plain decoder)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import torch

from scripts import bench_loader as jax_bench_loader
from srvp_tpu_torch import bench, bench_loader
from srvp_tpu_torch.data import native, pack, synthetic, test_sets

ROOT = Path(__file__).resolve().parents[1]
LEG_KEYS = {"kth": {"value", "plain_value", "packed_value"},
            "bair": {"value", "plain_value", "packed_value"},
            "human": {"value"}, "smmnist": {"value", "parts_value"}}
ROW_KEYS = {"metric", "unit", "batch", "seq_len", "legs", "device_rate",
            "device_rate_source", "vs_device_rate", "feeds_device_1.2x",
            "host_cpus", "png_bytes_per_frame_mean", "device", "nvidia_smi",
            "step_ms", "step_launches", "batches_agree", "best_leg"}


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_tiny_cpu_run_prints_a_line_per_dataset(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "srvp_tpu_torch.bench_loader", "--device",
         "cpu", "--tiny", "--n_batches", "1", "--workers", "1,2", "--root",
         str(tmp_path / "bench")], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["metric"] for r in rows] == [
        f"loader_frames_per_sec_{n}" for n in LEG_KEYS]
    for row, (name, legs) in zip(rows, LEG_KEYS.items()):
        assert ROW_KEYS <= set(row), ROW_KEYS - set(row)
        assert row["batches_agree"] is True
        assert (row["batch"], row["seq_len"]) == (4, 6)
        assert set(row["legs"]) == {"1", "2"}
        for rates in row["legs"].values():
            assert set(rates) == legs
            assert all(np.isfinite(v) and v > 0 for v in rates.values())
        assert {k: row[k] for k in legs} == row["legs"]["2"]
        # the step measured on the CPU, and labelled so
        assert row["device"] == "cpu" and row["nvidia_smi"] is None
        assert row["device_rate_source"] == "measured"
        assert row["device_rate"] > 0 and row["step_ms"] > 0
        assert row["step_launches"] == {}
        best = max(row[k] for k in legs - {"plain_value"})
        assert row["vs_device_rate"] == best / row["device_rate"]
        assert row["feeds_device_1.2x"] == (best >= 1.2 * row["device_rate"])
        assert (row["png_bytes_per_frame_mean"] is None) == (
            name in ("human", "smmnist"))
    assert not (tmp_path / "bench_tiny" / "packed_64" / "COMPLETE.json.tmp"
                ).exists()
    assert json.loads((tmp_path / "bench_tiny" / "packed_64" /
                       "COMPLETE.json").read_text()) == {"videos": 12}


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("noise_amp", [0, 14])
def test_bench_frames_are_the_jax_bench_frames(noise_amp, rgb):
    for i, t in ((0, 0), (3, 7), (119, 29)):
        np.testing.assert_array_equal(
            synthetic.bench_frame(i, t, rgb, noise_amp),
            jax_bench_loader._frame(i, t, rgb, noise_amp))


@pytest.mark.parametrize("noise_amp", [0, 14])
def test_bench_trees_are_the_jax_bench_layouts(tmp_path, noise_amp):
    """The same files, frame for frame, as the JAX bench's trees (which PIL
    writes) at a few videos."""
    ref, ours = tmp_path / "jax", tmp_path / "port"
    jax_bench_loader.build_kth_tree(str(ref), n_videos=7, frames_per_video=3,
                                    noise_amp=noise_amp)
    jax_bench_loader.build_bair_tree(str(ref), n_videos=34,
                                     noise_amp=noise_amp)
    paths = synthetic.write_bench_kth_tree(ours, 7, 3, noise_amp) \
        + synthetic.write_bench_bair_tree(ours, 34, noise_amp)
    want = sorted(p.relative_to(ref) for p in ref.rglob("*.png"))
    assert sorted(p.relative_to(ours) for p in paths) == want
    for rel in want[::7]:
        np.testing.assert_array_equal(np.array(Image.open(ours / rel)),
                                      np.array(Image.open(ref / rel)))


@pytest.mark.parametrize("name, ref", [("kth", "kth-vgg"),
                                       ("smmnist", "smmnist-dcgan")])
def test_step_configurations_are_the_bench_s(name, ref):
    c, want = bench_loader.step_config(name), bench.CONFIGS[ref]
    assert c["kwargs"] == want["kwargs"]
    assert {k: c[k] for k in ("nt_cond", "seq_len", "batch",
                              "oversampling")} == {
        k: want[k] for k in ("nt_cond", "seq_len", "batch", "oversampling")}


def test_bair_and_human_step_configurations():
    bair, human = (bench_loader.step_config(n) for n in ("bair", "human"))
    assert (bair["batch"], bair["seq_len"], bair["kwargs"]["nc"]) == (192, 12,
                                                                      3)
    assert (human["batch"], human["seq_len"], human["subsampling"]) == (
        100, 16, 8)
    assert bair["kwargs"]["archi"] == human["kwargs"]["archi"] == "vgg"


ENTRY_POINTS = {
    "bench_loader": lambda d: bench_loader.main(
        ["--device", "cpu", "--tiny", "--n_batches", "1", "--workers", "1",
         "--root", str(d / "bench")]),
    "pack": lambda d: pack.main(["--dataset", "kth", "--data_dir",
                                 str(d / "tree")]),
    "test_sets": lambda d: test_sets.main(["kth", "--data_dir",
                                           str(d / "tree"), "--size", "2",
                                           "--seq_len", "2"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_unbuildable_decoder_raises(tmp_path, monkeypatch, entry):
    synthetic.write_bench_kth_tree(tmp_path / "tree", 2, 3)
    synthetic.write_kth_test_videos(tmp_path / "tree", 3)
    bad = tmp_path / "png_decode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "PNG_SOURCE", bad)
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ENTRY_POINTS[entry](tmp_path)
    assert not (tmp_path / "tree" / "packed_64" / "COMPLETE.json").exists()


def test_tree_writer_processes_write_the_same_files(tmp_path):
    serial = synthetic.write_kth_test_videos(tmp_path / "one", 2)
    pooled = synthetic.write_kth_test_videos(tmp_path / "two", 2,
                                             processes=2)
    assert [p.relative_to(tmp_path / "one") for p in serial] == [
        p.relative_to(tmp_path / "two") for p in pooled]
    assert all(a.read_bytes() == b.read_bytes()
               for a, b in zip(serial, pooled))
