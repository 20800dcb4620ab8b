"""The port's GPU benchmark (srvp_tpu_torch/bench.py) on the CPU at tiny
widths: one parsable JSON line with bench.py's keys, each configuration's
keys, finite numbers, no device metric off the card, the golden record
written once and then compared; and its configurations and batch are those
of the repository's bench.py. No time is asserted."""

import json

import numpy as np
import pytest
import torch

import bench as jax_bench
from srvp_tpu_torch import bench

TINY = ["--device", "cpu", "--tiny", "--steps", "1", "--warmup", "1",
        "--rollout_iters", "1"]
CONFIG_KEYS = {"backend", "chips", "steps", "sec_per_step", "ms_per_step",
               "frames_per_sec", "loss", "model_flops_per_step",
               "model_flops_per_sec_per_chip", "mfu", "peak_memory_gb",
               "device_kind", "compute_dtype", "loss_step2_fp32",
               "golden_loss_step2"}


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (restored after it): the tier-1
    run shares the CPU among its workers, and timing tests elsewhere in the
    suite read host time."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(capsys, *argv):
    bench.main(list(argv))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_one_json_line_with_the_bench_keys(tmp_path, capsys, precision):
    golden = tmp_path / "golden.json"
    line = run(capsys, *TINY, "--precision", precision, "--golden",
               str(golden))
    assert line["metric"] == "train_frames_per_sec_per_chip"
    assert line["unit"] == "frames/s/chip"
    assert line["precision"] == precision and line["device"] == "cpu"
    assert set(line["configs"]) == {"smmnist-dcgan", "kth-vgg"}
    assert line["value"] == line["configs"]["smmnist-dcgan"][
        "frames_per_sec"]
    assert np.isfinite(line["rollout_frames_per_sec_per_chip"])
    for name, info in line["configs"].items():
        assert CONFIG_KEYS <= set(info), name
        assert info["compute_dtype"] == precision
        assert (info["batch"], info["seq_len"]) == (
            bench.TINY["batch"], bench.TINY["seq_len"])
        for k in ("sec_per_step", "frames_per_sec", "loss",
                  "model_flops_per_step", "loss_step2_fp32"):
            assert np.isfinite(info[k]) and info[k] > 0, (name, k)
        # no device metric from a CPU run
        assert info["mfu"] is None and info["peak_memory_gb"] is None
        assert "golden_loss_note" not in info
    record = json.loads(golden.read_text())
    assert set(record) == {"smmnist-dcgan|cpu", "kth-vgg|cpu"}
    # a second run compares with the record instead of writing it
    record["kth-vgg|cpu"] *= 2
    golden.write_text(json.dumps(record))
    again = run(capsys, *TINY, "--precision", precision, "--golden",
                str(golden))
    info = again["configs"]["kth-vgg"]
    assert info["golden_loss_step2"] == record["kth-vgg|cpu"]
    assert "deviates" in info["golden_loss_note"]
    assert "golden_loss_note" not in again["configs"]["smmnist-dcgan"]


def test_configs_and_batch_are_bench_pys():
    assert {k: {**v} for k, v in bench.CONFIGS.items()} == {
        k: {**v} for k, v in jax_bench.CONFIGS.items()}
    for name in bench.CONFIGS:
        np.testing.assert_array_equal(
            bench.make_batch(bench.config(name)), jax_bench.make_batch(name))


def test_the_card_is_not_replaced_by_the_cpu():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--steps", "1"])
