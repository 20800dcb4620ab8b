"""The port's trainer CLI on the CPU at tiny widths: it trains, logs finite
losses as the JAX package's {"step", "wall_s", ...} rows, validates,
writes a model.pt that the port's test_main evaluates, refuses CUDA where
there is none, trains in bfloat16 under the JAX trainer's mixed-precision
flags, and rejects the flags of parts that are not ported yet."""

import json

import numpy as np
import pytest

import torch

from srvp_tpu_torch import test_main, train_main
from srvp_tpu_torch.args import create_args
from srvp_tpu_torch.data import mmnist_test

TINY = ["--dataset", "smmnist", "--allow_synthetic", "--nc", "1",
        "--ny", "4", "--nz", "4", "--nf", "4", "--nhx", "8", "--nh_inf", "8",
        "--nlayers_inf", "2", "--nh_res", "16", "--nlayers_res", "2",
        "--nt_inf", "2", "--batch_size", "4", "--seq_len", "6",
        "--nt_cond", "3", "--log_interval", "1", "--n_iter_test", "1",
        "--n_samples_test", "2", "--val_samples_chunk", "2",
        "--batch_size_test", "2", "--seed", "3"]


def parse(tmp_path, *extra):
    return create_args().parse_args(
        TINY + ["--data_dir", str(tmp_path / "data"),
                "--save_path", str(tmp_path / "xp"), *extra])


def train(opt):
    """Runs the trainer to its end; returns its metrics.jsonl rows of
    training steps (the validation rows apart)."""
    assert train_main.main(opt) == 0
    with open(f"{opt.save_path}/metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if "loss" in r]


def test_trains_and_test_main_serves_the_checkpoint(tmp_path):
    xp = tmp_path / "xp"
    assert train_main.main(parse(tmp_path, "--device", "cpu", "--n_iter",
                                 "4", "--val_interval", "2",
                                 "--chkpt_interval", "4")) == 0
    logged = [json.loads(line)
              for line in (xp / "metrics.jsonl").read_text().splitlines()]
    history = [r for r in logged if "loss" in r]
    assert [h["step"] for h in history] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) and h["lr"] == 3e-4 for h in history)
    assert all(set(h) == {"step", "wall_s", "fps", "loss", "lr", "nll",
                          "kl_y_0", "kl_z", "l2_res"} for h in history)
    val = [r for r in logged if "val_metric" in r]
    assert [(r["step"], set(r)) for r in val] == [
        (s, {"step", "wall_s", "val_metric"}) for s in (2, 4)]
    for name in ("model.pt", "model_best.pt", "model_4.pt", "config.json"):
        assert (xp / name).exists(), name
    config = json.load(open(xp / "config.json"))
    assert config["n_iter"] == 4 and config["ny"] == 4

    seqs = np.random.RandomState(0).randint(0, 256, (6, 3, 64, 64)) \
        .astype(np.uint8)
    (tmp_path / "data").mkdir()
    np.savez_compressed(
        mmnist_test.archive_path(str(tmp_path / "data"), 64, 2, False),
        sequences=seqs)
    opt = test_main.create_test_args().parse_args([
        "--xp_dir", str(xp), "--data_dir", str(tmp_path / "data"),
        "--device", "cpu", "--batch_size", "2", "--n_samples", "2",
        "--samples_chunk", "2", "--nt_gen", "6", "--model_name", "model.pt"])
    test_main.main(opt)
    results = np.load(xp / "results.npz")
    assert results["psnr"].shape == (3,)
    assert np.all(np.isfinite(results["psnr"]))


def test_kernel_and_eager_rollout_train_alike(tmp_path):
    """--fused_rollout on (the kernel wrapper, on the CPU its plain
    version) and off (the eager loop) take the same steps."""
    runs = [train(parse(tmp_path / f, "--device", "cpu", "--n_iter", "2",
                        "--fused_rollout", f))
            for f in ("on", "off")]
    for a, b in zip(*runs):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    sd = [torch.load(tmp_path / f / "xp" / "model.pt") for f in ("on",
                                                                 "off")]
    for k in sd[0]:
        torch.testing.assert_close(sd[0][k], sd[1][k], rtol=1e-4, atol=1e-6)


def test_cuda_is_not_replaced_by_the_cpu(tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main.main(parse(tmp_path, "--n_iter", "1"))


@pytest.mark.parametrize("flags,dtype", [
    (["--precision", "bfloat16"], torch.bfloat16),
    (["--torch_amp"], torch.bfloat16),
    (["--apex_amp"], torch.bfloat16),
    (["--apex_amp", "--amp_opt_lvl", "O2", "--keep_batchnorm_fp32"],
     torch.bfloat16),
    (["--amp_opt_lvl", "O2"], torch.float32),
    (["--keep_batchnorm_fp32"], torch.float32),
    (["--apex_verbose"], torch.float32),
    (["--precision", "float32"], torch.float32)])
def test_mixed_precision_flags_train(tmp_path, flags, dtype, capsys):
    """--precision bfloat16, --torch_amp and --apex_amp train in bfloat16
    (srvp_tpu/train_main.py `train_hparams`); the apex options are accepted
    and ignored. Two steps, finite losses, float32 checkpoints."""
    opt = parse(tmp_path, "--device", "cpu", "--n_iter", "2",
                "--val_interval", "2", *flags)
    assert train_main.train_hparams(opt).compute_dtype == dtype
    history = train(opt)
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    name = str(dtype).split(".")[-1]
    assert f"compute dtype {name}" in capsys.readouterr().out
    for ckpt in ("model.pt", "model_best.pt"):
        sd = torch.load(tmp_path / "xp" / ckpt)
        assert all(v.dtype in (torch.float32, torch.int64)
                   for v in sd.values()), ckpt


@pytest.mark.parametrize("flags", [
    ["--n_devices", "2"], ["--dataset", "human"], ["--dataset", "bair"]])
def test_flags_of_unported_parts_raise(tmp_path, flags):
    opt = parse(tmp_path, "--device", "cpu", *flags)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_main.main(opt)
