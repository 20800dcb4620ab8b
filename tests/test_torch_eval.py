"""The PyTorch port's best-of-N evaluation against the JAX package on the
CPU: the whole per-chunk compute, the on-device selection over two chunks,
and the evaluation CLI end to end.

The JAX side runs `use_fused_rollout=False` (its scan equals its Pallas
kernel by tests/test_pallas.py). Tolerances: u8 frames within one level
(frames are truncated to u8, so an fp32 difference of 1e-6 can flip a
level; at most 0.1% of pixels may differ), PSNR within 1e-3 dB, SSIM
within 1e-4."""

import json
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu import eval_lib as jeval
from srvp_tpu.data.mmnist import MovingMNIST, synthetic_digits
from srvp_tpu.helper import DotDict
from srvp_tpu.utils import checkpoint as ckpt
from srvp_tpu_torch import eval_lib, test_main
from tests.torch_port_util import (chunk_noise, configs, jax_model,
                                   port_model, t)

NT_COND, NT_TEST, O_INF, O_GEN = 4, 7, 1, 2
BSZ, CHUNK = 3, 4
PSNR_ATOL, SSIM_ATOL = 1e-3, 1e-4
NAMES = ["psnr", "ssim"]


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = configs()
    # conv_gain 10 makes the decoded frames span the u8 range, so that the
    # frame comparison sees the latent rollouts
    params, state = jax_model(jcfg, seed=6, res_gain=1.2, conv_gain=10.0)
    model = port_model(params, state, cfg)
    x = np.random.RandomState(3).rand(NT_TEST, BSZ, 64, 64, 1) \
        .astype(np.float32)
    return jcfg, cfg, params, state, model, x


def assert_u8_close(a, b):
    """Within one level everywhere, and off by one on few pixels."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff > 0) <= 1e-3


def test_compute_chunk_matches_jax(setup):
    jcfg, cfg, params, state, model, x = setup
    fn = jeval.make_test_chunk(jcfg, NT_COND, NT_TEST, O_INF, O_GEN,
                               use_fused_rollout=False)
    keys = jax.random.split(jax.random.PRNGKey(5), CHUNK)
    x_pred, x_rec, metrics = fn(params, state, jnp.asarray(x[:NT_COND]),
                                jnp.asarray(x[NT_COND:]), keys)
    eps = chunk_noise(keys[0], cfg, BSZ * CHUNK, NT_COND, NT_TEST - NT_COND,
                      O_INF, O_GEN)
    tx_pred, tx_rec, tmetrics = eval_lib.compute_chunk(
        model, t(x[:NT_COND]), t(x[NT_COND:]), CHUNK, O_INF, O_GEN, eps)
    assert tx_pred.shape == (CHUNK, BSZ, NT_TEST - NT_COND, 64, 64, 1)
    assert np.asarray(x_pred).std() > 10   # frames are not flat
    assert_u8_close(tx_pred.numpy(), x_pred)
    assert_u8_close(tx_rec.numpy(), x_rec)
    np.testing.assert_allclose(tmetrics["psnr"].numpy(),
                               np.asarray(metrics["psnr"]), atol=PSNR_ATOL)
    np.testing.assert_allclose(tmetrics["ssim"].numpy(),
                               np.asarray(metrics["ssim"]), atol=SSIM_ATOL)


def test_selection_over_two_chunks_matches_jax(setup):
    jcfg, cfg, params, state, model, x = setup
    sel = jeval.make_select_chunk(jcfg, NT_COND, NT_TEST, O_INF, O_GEN, NAMES,
                                  use_fused_rollout=False)
    t_pred, hw_c = NT_TEST - NT_COND, (64, 64, 1)
    carry = jeval.init_select_carry(NAMES, BSZ, t_pred, NT_COND, hw_c, 5)
    tcarry = eval_lib.init_select_carry(NAMES, BSZ, t_pred, NT_COND, hw_c, 5,
                                        "cpu")
    base = jax.random.PRNGKey(8)
    for c in range(2):
        keys = jax.random.split(jax.random.fold_in(base, c), CHUNK)
        carry = sel(carry, params, state, jnp.asarray(x[:NT_COND]),
                    jnp.asarray(x[NT_COND:]), keys, jnp.int32(c * CHUNK))
        eps = chunk_noise(keys[0], cfg, BSZ * CHUNK, NT_COND, t_pred, O_INF,
                          O_GEN)
        tcarry = eval_lib.select_chunk(tcarry, model, t(x[:NT_COND]),
                                       t(x[NT_COND:]), CHUNK, c * CHUNK,
                                       O_INF, O_GEN, eps)
    carry = jax.device_get(carry)
    assert set(tcarry) == set(carry)
    for k, v in carry.items():
        if k.endswith("_val"):
            atol = PSNR_ATOL if k.startswith("psnr") else SSIM_ATOL
            np.testing.assert_allclose(tcarry[k].numpy(), v, atol=atol,
                                       err_msg=k)
        else:
            assert_u8_close(tcarry[k].numpy(), v)


def test_first_sample_wins_ties():
    carry = eval_lib.init_select_carry(NAMES, 2, 1, 1, (1, 1, 1), 2, "cpu")
    frames = torch.arange(3 * 2, dtype=torch.uint8).reshape(3, 2, 1, 1, 1, 1)
    metrics = {"psnr": torch.tensor([[5.0, 1.0], [5.0, 2.0], [4.0, 2.0]]),
               "ssim": torch.tensor([[0.5, 0.1], [0.5, 0.1], [0.5, 0.1]])}
    carry = eval_lib.select_update(carry, frames, torch.zeros(2, 1, 1, 1, 1,
                                                              dtype=torch.uint8),
                                   metrics, 0)
    # psnr: video 0 best is sample 0 (tie with 1), worst sample 2;
    # video 1 best is sample 1 (tie with 2), worst sample 0
    assert carry["psnr_best_frm"].flatten().tolist() == [0, 3]
    assert carry["psnr_worst_frm"].flatten().tolist() == [4, 1]
    assert carry["ssim_best_frm"].flatten().tolist() == [0, 1]
    assert carry["ssim_worst_frm"].flatten().tolist() == [0, 1]
    assert carry["random"].flatten().tolist() == [0, 1, 2, 3]


def _xp_dirs(tmp_path):
    """A tiny experiment (JAX model.npz + config.json) and test set, built
    as tests/test_eval.py builds them."""
    xp_dir, data_dir = tmp_path / "xp", tmp_path / "data"
    xp_dir.mkdir()
    data_dir.mkdir()
    kw = dict(nx=64, nc=1, nf=4, nhx=8, ny=4, nz=4, skipco=False, nt_inf=2,
              nh_inf=8, nlayers_inf=2, nh_res=16, nlayers_res=2,
              archi="dcgan")
    xp_config = dict(dataset="smmnist", data_dir=str(data_dir), seq_len=6,
                     seq_len_test=6, nt_cond=3, n_euler_steps=1, ndigits=2,
                     max_speed=4, deterministic=False, subsampling=8, **kw)
    with open(xp_dir / "config.json", "w") as f:
        json.dump(xp_config, f)
    jcfg, _ = configs(**kw)
    params, bn_state = jax_model(jcfg, seed=0)
    ckpt.save_model(str(xp_dir), "model", params, bn_state)
    gen = MovingMNIST(synthetic_digits(5, np.random.RandomState(0)),
                      64, 6, 4, False, 2, True)
    vids = np.stack([gen.get_item(0, np.random.RandomState(i))
                     for i in range(5)])
    np.savez_compressed(data_dir / "smmnist_test_2digits_64.npz",
                        sequences=np.transpose(vids, (1, 0, 2, 3)))
    return xp_dir, data_dir


def _artifacts(xp_dir):
    out = {}
    for path in sorted(xp_dir.glob("*.npz")):
        if path.name == "model.npz":
            continue
        with np.load(path) as arc:
            out[path.stem] = {k: (arc[k].dtype, arc[k].shape)
                              for k in arc.files}
    return out


def test_cli_end_to_end_matches_test_py_artifacts(tmp_path):
    import test as jax_cli

    xp_dir, data_dir = _xp_dirs(tmp_path)
    jax_xp = tmp_path / "xp_jax"
    shutil.copytree(xp_dir, jax_xp)

    opt = test_main.create_test_args().parse_args([
        "--xp_dir", str(xp_dir), "--data_dir", str(data_dir),
        "--batch_size", "4", "--n_samples", "4", "--samples_chunk", "2",
        "--device", "cpu"])
    batch_seconds = test_main.main(opt)
    assert len(batch_seconds) == 2       # 5 videos: a full batch + 1 padded

    jax_cli.main(DotDict(xp_dir=str(jax_xp), data_dir=str(data_dir),
                         lpips_dir=None, n_euler_steps=None, nt_cond=None,
                         nt_gen=None, batch_size=4, n_samples=4,
                         samples_chunk=2, model_name="model.npz",
                         device=None, fvd=False, test_seed=1,
                         fused_rollout="off", n_devices=1))
    ours, ref = _artifacts(xp_dir), _artifacts(jax_xp)
    assert ours == ref
    assert ours["results"] == {"psnr": (np.float32, (5,)),
                               "ssim": (np.float32, (5,))}
    assert ours["cond_rec"] == {"samples": (np.uint8, (5, 3, 64, 64, 1))}
    res = np.load(xp_dir / "results.npz")
    assert np.all(np.isfinite(res["psnr"])) and np.all(np.isfinite(res["ssim"]))


def test_cli_refuses_missing_cuda_and_unported_metrics(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    base = ["--xp_dir", str(tmp_path), "--data_dir", str(tmp_path)]
    parse = test_main.create_test_args().parse_args
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_main.main(parse(base))
    with pytest.raises(NotImplementedError, match="LPIPS"):
        test_main.main(parse(base + ["--lpips_dir", str(tmp_path)]))
    with pytest.raises(NotImplementedError, match="FVD"):
        test_main.main(parse(base + ["--fvd"]))
