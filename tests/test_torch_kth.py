"""KTH with the vgg encoder and decoder in the port, against the JAX package
on the CPU: the training data (packed tree, folds, windows, loader batches,
test fold), the ELBO training step at the KTH configuration's shape (vgg,
skip connections, o = 2, nt_inf 3, obs_scale 0.2) on frames with flat
regions, the evaluation chunk at the KTH protocol (10 conditioning frames,
o = 2, cut to 4 predicted frames), and the trainer and evaluator CLIs end
to end.

Tolerances are those of tests/test_torch_train.py (forward atol 2e-4, loss
rtol 1e-4, gradients rtol 5e-3 / atol 5e-5, batch-norm statistics; see
test_train_step_matches_jax for which JAX run each is held against) and
of
tests/test_torch_eval.py (u8 frames within one level on at most 0.1% of
pixels, PSNR 1e-3 dB, SSIM 1e-4). Data are bit-equal."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from srvp_tpu import eval_lib as jeval
from srvp_tpu.data.base import collate as jcollate
from srvp_tpu.data.base import collate_uint8 as jcollate_uint8
from srvp_tpu.data.kth import KTH as JaxKTH
from srvp_tpu.data.loader import DataLoader as JaxLoader
from srvp_tpu.models import layers as jlayers
from srvp_tpu.models import srvp as jsrvp
from srvp_tpu.objectives import elbo_loss as jelbo
from srvp_tpu_torch import eval_lib, test_main
from srvp_tpu_torch.args import create_args
from srvp_tpu_torch.data.base import collate_uint8
from srvp_tpu_torch.data.kth import KTH
from srvp_tpu_torch.data.loader import DataLoader, batches_in_order
from srvp_tpu_torch.kernels.spatial import use_kernels
from srvp_tpu_torch.objectives import elbo_loss
from srvp_tpu_torch.utils.weights import bn_state_from_port, state_dict_from_jax
from tests.test_torch_eval import PSNR_ATOL, SSIM_ATOL, assert_u8_close
from tests.test_torch_train_cli import train
from tests.test_torch_train import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL,
                                    assert_bn_close, grads_in_port_layout,
                                    jax_value_and_grad, two_pass_bn_stats)
from tests.torch_port_util import (ATOL, chunk_noise, configs, jax_draws,
                                   jax_model, port_model, t)

TINY = dict(nf=4, nhx=8, ny=4, nz=4, nh_inf=16, nh_res=16, nlayers_inf=2,
            nlayers_res=2, archi="vgg", skipco=True, nt_inf=3)
LOSS_KW = dict(obs_scale=0.2, beta_y=1.0, beta_z=1.0, l2_res=1.0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A packed KTH tree (6 classes x persons 1-25, person 1's videos
    shorter than a window) and a test set of 5 videos of 8 frames."""
    root = tmp_path_factory.mktemp("kth")
    chip_smoke.write_kth_packed_tree(root, 64, seed=0)
    seqs = chip_smoke.synthetic_kth_videos(5, 8, 64,
                                           np.random.RandomState(1))
    np.savez_compressed(root / "svg_test_set_8.npz", sequences=seqs)
    return root


def kth_frames(nt, bsz, seed):
    """float32 (T, B, 64, 64, 1) KTH-like frames in [0, 1], flat regions
    included."""
    v = chip_smoke.synthetic_kth_videos(bsz, nt, 64,
                                        np.random.RandomState(seed))
    return (v.transpose(1, 0, 2, 3)[..., None] / 255.0).astype(np.float32)


class FewItems:
    """A training dataset seen through get_item alone, with 8 items, so the
    JAX loader takes its per-item path over a short epoch."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return 8

    def get_item(self, index, rng):
        return self.dataset.get_item(index, rng)


def test_folds_and_windows_match_jax(tree):
    ours = KTH.make_dataset(str(tree), 64, 20, train=True)
    ref = JaxKTH.make_dataset(str(tree), 64, 20, train=True)
    assert ref.packed and len(ours.data) == 120     # persons 21-25 left out
    assert ours.data == ref.data and len(ours) == len(ref)
    for fold in ("train", "val"):
        a, b = ours.get_fold(fold), ref.get_fold(fold)
        assert a.data == b.data
        a.change_seq_len(24)
        b.change_seq_len(24)
        for seed in range(12):     # person 1's 16 frames are drawn again
            np.testing.assert_array_equal(
                a.get_item(0, np.random.RandomState(seed)),
                b.get_item(0, np.random.RandomState(seed)))


def test_loader_batches_match_jax(tree):
    ours = KTH.make_dataset(str(tree), 64, 6, True).get_fold("train")
    ref = JaxKTH.make_dataset(str(tree), 64, 6, True).get_fold("train")
    a = DataLoader(FewItems(ours), 4, seed=3, collate_fn=collate_uint8)
    b = JaxLoader(FewItems(ref), 4, shuffle=True, drop_last=True, seed=3,
                  num_workers=1, collate_fn=jcollate_uint8)
    for _ in range(2):
        for x, y in zip(a, b):
            assert x.dtype == np.uint8 and x.shape == (6, 4, 64, 64, 1)
            np.testing.assert_array_equal(x, y)


def test_test_fold_matches_jax(tree):
    ours = KTH.make_dataset(str(tree), 64, 8, train=False)
    ref = JaxKTH.make_dataset(str(tree), 64, 8, train=False).get_fold("test")
    assert len(ours) == len(ref) == 5
    loader = JaxLoader(ref, 2, shuffle=False, drop_last=False, num_workers=1,
                       collate_fn=jcollate)
    batches = list(batches_in_order(ours.data, 2))
    assert [b.shape[1] for b in batches] == [2, 2, 1]
    for x, y in zip(batches, loader):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_needs_a_complete_packed_tree(tmp_path):
    """A packed tree whose COMPLETE.json miscounts its videos is not read;
    without a PNG tree to read instead (tests/test_torch_datasets.py),
    make_dataset raises."""
    with pytest.raises(FileNotFoundError, match="no KTH PNG tree"):
        KTH.make_dataset(str(tmp_path), 64, 6, train=True)
    chip_smoke.write_kth_packed_tree(tmp_path, 64, seed=0)
    assert KTH.make_dataset(str(tmp_path), 64, 6, train=True).packed
    marker = tmp_path / "packed_64" / "COMPLETE.json"
    marker.write_text(json.dumps({"videos": 149}))
    with pytest.raises(FileNotFoundError, match="COMPLETE.json must count "
                                                "the 150 videos found"):
        KTH.make_dataset(str(tmp_path), 64, 6, train=True)


def float64_jax_grads(jcfg, params, state, x, key, nt, bsz, kw):
    """The JAX package's ELBO gradients in float64, with the draws of that
    run (as port tensors): its code under jax.enable_x64, with its float32
    pins (jnp.float32, the compute dtype) widened to float64."""
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            draws = jax_draws(key, jcfg, nt, bsz, kw["oversampling"])
            p64, s64 = (jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), tree)
                for tree in (params, state))
            grads = jax.jit(jax.grad(lambda p: jelbo(
                jcfg, p, s64, x.astype(np.float64), key,
                compute_dtype=jnp.float64, **kw)[0]))(p64)
            grads = jax.tree_util.tree_map(np.asarray, grads)
        finally:
            jnp.float32 = f32
    return grads, draws


def test_train_step_matches_jax(monkeypatch):
    """The ELBO step at the KTH configuration's shape on frames with flat
    regions, whose pools hold many tied windows.

    The loss is held against the JAX step as it is; the forward tensors and
    the batch-norm statistics against it with its batch variance in two
    passes: the vgg encoder stacks 12 batch norms, and JAX's one-pass
    variance alone moves y by 7.7e-4 here (4.8e-5 with two passes), past
    the forward tolerance. The gradients are held in float64 on both sides
    (float64_jax_grads, and the port in float64 with the plain pools and
    upsamples, which its CPU wrappers run), where every element agrees far
    inside the tolerance. In float32 these gradients are not resolved to
    rtol 5e-3 / atol 5e-5 by either side: the test asserts, as a control,
    that JAX's own float32 gradients (two-pass variance) miss the float64
    ones by more than the tolerance."""
    jcfg, cfg = configs(**TINY)
    params, state = jax_model(jcfg, seed=1, conv_gain=10.0)
    nt, bsz, o = 6, 3, 2
    x = kth_frames(nt, bsz, seed=2)
    key = jax.random.PRNGKey(11)
    kw = dict(oversampling=o, **LOSS_KW)

    loss_j, _ = jax.jit(lambda p: jelbo(jcfg, p, state, jnp.asarray(x), key,
                                        **kw))(params)
    grads_j, draws64 = float64_jax_grads(jcfg, params, state, x, key, nt,
                                         bsz, kw)
    monkeypatch.setattr(jlayers, "_bn_stats_fwd", two_pass_bn_stats)
    ref_out = jax.jit(lambda p: jsrvp.forward(
        jcfg, p, state, jnp.asarray(x), nt, oversampling=o, rng=key,
        train=True))(params)
    (_, aux_j), grads32_j = jax_value_and_grad(jcfg, **kw)(params, state, x,
                                                           key)

    model = port_model(params, state, cfg).train()
    draws = jax_draws(key, jcfg, nt, bsz, o)
    with torch.no_grad():
        out = model(t(x), nt, o, **draws)
    model.load_state_dict(state_dict_from_jax(params, state, cfg))
    loss, aux = elbo_loss(model, t(x), use_kernel=True, **kw, **draws)
    for name in ("x_", "y", "z", "w", "q_y_0_params", "q_z_params",
                 "p_z_params", "res"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref_out, name)),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    assert_bn_close(bn_state_from_port(model.state_dict(), cfg), aux_j.state)

    model64 = port_model(params, state, cfg).train().double()
    use_kernels(model64, False)
    loss64, _ = elbo_loss(
        model64, t(x).double(), use_kernel=True, **kw,
        **{k: v.double() if v.is_floating_point() else v
           for k, v in draws64.items()})
    loss64.backward()
    ref_grads = grads_in_port_layout(grads_j, state, cfg)
    named = dict(model64.named_parameters())
    assert set(named) <= set(ref_grads)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_grads[name].numpy().astype(np.float64),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    # the control: float32 does not resolve these gradients
    grads32 = grads_in_port_layout(grads32_j, state, cfg)
    assert max(float(((grads32[n] - ref_grads[n]).abs()
                      / (GRAD_ATOL + GRAD_RTOL * ref_grads[n].abs())).max())
               for n in named) > 1


def test_eval_chunk_matches_jax():
    nt_cond, nt_test, o, bsz, chunk = 10, 14, 2, 2, 3
    jcfg, cfg = configs(**TINY)
    params, state = jax_model(jcfg, seed=6, res_gain=1.2, conv_gain=10.0)
    model = port_model(params, state, cfg)
    x = kth_frames(nt_test, bsz, seed=3)
    fn = jeval.make_test_chunk(jcfg, nt_cond, nt_test, o, o,
                               use_fused_rollout=False)
    keys = jax.random.split(jax.random.PRNGKey(5), chunk)
    x_pred, x_rec, metrics = fn(params, state, jnp.asarray(x[:nt_cond]),
                                jnp.asarray(x[nt_cond:]), keys)
    eps = chunk_noise(keys[0], cfg, bsz * chunk, nt_cond, nt_test - nt_cond,
                      o, o)
    tx_pred, tx_rec, tmetrics = eval_lib.compute_chunk(
        model, t(x[:nt_cond]), t(x[nt_cond:]), chunk, o, o, eps)
    assert tx_pred.shape == (chunk, bsz, nt_test - nt_cond, 64, 64, 1)
    assert np.asarray(x_pred).std() > 10   # frames are not flat
    assert_u8_close(tx_pred.numpy(), x_pred)
    assert_u8_close(tx_rec.numpy(), x_rec)
    np.testing.assert_allclose(tmetrics["psnr"].numpy(),
                               np.asarray(metrics["psnr"]), atol=PSNR_ATOL)
    np.testing.assert_allclose(tmetrics["ssim"].numpy(),
                               np.asarray(metrics["ssim"]), atol=SSIM_ATOL)


def test_cli_trains_kth_vgg_in_bfloat16(tree, tmp_path):
    """train_main --precision bfloat16 on the packed tree (o = 2, skip
    connections, the pools and upsamples in bfloat16): finite losses and
    float32 checkpoints, on the CPU at tiny widths."""
    xp = tmp_path / "xp"
    opt = create_args().parse_args([
        "--dataset", "kth", "--archi", "vgg", "--skipco", "--device", "cpu",
        "--precision", "bfloat16",
        "--data_dir", str(tree), "--save_path", str(xp), "--nc", "1",
        "--ny", "4", "--nz", "4", "--nf", "4", "--nhx", "8", "--nh_inf", "8",
        "--nlayers_inf", "2", "--nh_res", "16", "--nlayers_res", "2",
        "--nt_inf", "3", "--n_euler_steps", "2", "--obs_scale", "0.2",
        "--res_gain", "1.2", "--batch_size", "3", "--seq_len", "6",
        "--seq_len_test", "8", "--nt_cond", "4", "--n_iter", "2",
        "--log_interval", "1", "--val_interval", "2", "--n_iter_test", "1",
        "--n_samples_test", "2", "--val_samples_chunk", "2",
        "--batch_size_test", "2", "--seed", "3"])
    history = train(opt)
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    sd = torch.load(xp / "model.pt")
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())


def test_cli_trains_and_serves_kth_vgg(tree, tmp_path):
    """train_main on the packed tree, then test_main on its model.pt and
    the svg_test_set_8 fold, on the CPU at tiny widths."""
    xp = tmp_path / "xp"
    opt = create_args().parse_args([
        "--dataset", "kth", "--archi", "vgg", "--skipco", "--device", "cpu",
        "--data_dir", str(tree), "--save_path", str(xp), "--nc", "1",
        "--ny", "4", "--nz", "4", "--nf", "4", "--nhx", "8", "--nh_inf", "8",
        "--nlayers_inf", "2", "--nh_res", "16", "--nlayers_res", "2",
        "--nt_inf", "3", "--n_euler_steps", "2", "--obs_scale", "0.2",
        "--res_gain", "1.2", "--batch_size", "3", "--seq_len", "6",
        "--seq_len_test", "8", "--nt_cond", "4", "--n_iter", "3",
        "--log_interval", "1", "--val_interval", "3", "--n_iter_test", "1",
        "--n_samples_test", "2", "--val_samples_chunk", "2",
        "--batch_size_test", "2", "--seed", "3"])
    history = train(opt)
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert (xp / "model_best.pt").exists()
    config = json.load(open(xp / "config.json"))
    assert (config["dataset"], config["archi"], config["skipco"]) == (
        "kth", "vgg", True)

    test_main.main(test_main.create_test_args().parse_args([
        "--xp_dir", str(xp), "--data_dir", str(tree), "--device", "cpu",
        "--batch_size", "2", "--n_samples", "2", "--samples_chunk", "2",
        "--nt_gen", "8", "--model_name", "model.pt"]))
    results = np.load(xp / "results.npz")
    assert results["psnr"].shape == results["ssim"].shape == (5,)
    assert np.all(np.isfinite(results["psnr"]))
    assert np.load(xp / "cond_rec.npz")["samples"].shape == (5, 4, 64, 64, 1)
    assert np.load(xp / "random_1.npz")["samples"].shape == (5, 4, 64, 64, 1)
