"""Three colour channels (BAIR and Human3.6M, nc = 3) through the port's
model and evaluation, against the JAX package on the CPU: a tiny vgg model
with skip connections, its JAX weights carried over by
utils/weights.state_dict_from_jax. The training forward at atol 2e-4 and
the ELBO at rtol 1e-4 (tests/test_model_parity.py:16) and the batch-norm
statistics, against the JAX step with its batch variance in two passes
(tests/test_torch_train.py), and the gradients at rtol 5e-3 / atol 5e-5
(tests/test_grad_parity.py:100) in float64 on both sides; then the
evaluation's PSNR, SSIM and selected u8 artifacts (best and worst frames,
random samples, the conditioning reconstruction) of (64, 64, 3) frames
over two chunks, at the tolerances of tests/test_torch_eval.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu import eval_lib as jeval
from srvp_tpu.models import layers as jlayers
from srvp_tpu.models import srvp as jsrvp
from srvp_tpu_torch import eval_lib
from srvp_tpu_torch.kernels.spatial import use_kernels
from srvp_tpu_torch.objectives import elbo_loss
from srvp_tpu_torch.utils.weights import bn_state_from_port
from tests.test_torch_eval import PSNR_ATOL, SSIM_ATOL, assert_u8_close
from tests.test_torch_kth import float64_jax_grads
from tests.test_torch_train import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL,
                                    assert_bn_close, grads_in_port_layout,
                                    jax_value_and_grad, two_pass_bn_stats)
from tests.torch_port_util import (ATOL, chunk_noise, configs, jax_draws,
                                   jax_model, port_model, t)

TINY = dict(nc=3, nf=4, nhx=8, ny=4, nz=4, nh_inf=16, nh_res=16,
            nlayers_inf=2, nlayers_res=2, archi="vgg", skipco=True,
            nt_inf=2)
LOSS_KW = dict(obs_scale=0.71, beta_y=1.0, beta_z=1.0, l2_res=1.0)
NAMES = ["psnr", "ssim"]


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rgb_frames(nt, bsz, seed):
    """float32 (T, B, 64, 64, 3) in [0, 1]: a colour ramp a video and a
    moving disc, each channel its own."""
    yy, xx = np.mgrid[0:64, 0:64] / 63.0
    rng = np.random.RandomState(seed)
    out = np.empty((nt, bsz, 64, 64, 3), np.float32)
    for b in range(bsz):
        c0, c1, disc = rng.rand(3, 3)
        ramp = (xx + rng.rand() * yy)[..., None] / 2
        for k in range(nt):
            cx, cy = 0.3 + 0.05 * k, rng.uniform(0.3, 0.7)
            inside = (xx - cx) ** 2 + (yy - cy) ** 2 < 0.03
            out[k, b] = np.where(inside[..., None], disc,
                                 c0 + ramp * (c1 - c0))
    return out


def test_train_step_matches_jax(monkeypatch):
    """As tests/test_torch_kth.py holds the KTH step: the gradients in
    float64 on both sides (the JAX package's code under jax.enable_x64, the
    port in float64 with its plain pools and upsamples), where every
    element agrees far inside the tolerance; neither side resolves them to
    it in float32, which the test asserts as a control."""
    jcfg, cfg = configs(**TINY)
    params, state = jax_model(jcfg, seed=1)
    nt, bsz, o = 5, 3, 2
    x = rgb_frames(nt, bsz, seed=0)
    key = jax.random.PRNGKey(11)
    kw = dict(oversampling=o, **LOSS_KW)

    grads_j, draws64 = float64_jax_grads(jcfg, params, state, x, key, nt,
                                         bsz, kw)
    monkeypatch.setattr(jlayers, "_bn_stats_fwd", two_pass_bn_stats)
    ref_out = jax.jit(lambda p: jsrvp.forward(
        jcfg, p, state, jnp.asarray(x), nt, oversampling=o, rng=key,
        train=True))(params)
    (loss_j, aux_j), grads32_j = jax_value_and_grad(jcfg, **kw)(
        params, state, x, key)

    model = port_model(params, state, cfg).train()
    draws = jax_draws(key, jcfg, nt, bsz, o)
    with torch.no_grad():
        out = model(t(x), nt, o, **draws)
    assert out.x_.shape == (nt, bsz, 64, 64, 3)
    model = port_model(params, state, cfg).train()
    loss, aux = elbo_loss(model, t(x), use_kernel=True, **kw, **draws)
    for name in ("x_", "y", "z", "w", "q_y_0_params", "q_z_params",
                 "p_z_params", "res"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref_out, name)),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    for name in ("nll", "kl_y_0", "kl_z", "l2_res"):
        np.testing.assert_allclose(getattr(aux, name).item(),
                                   float(getattr(aux_j, name)),
                                   rtol=LOSS_RTOL, err_msg=name)
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
    assert named["encoder.conv.0.0.0.weight"].shape[1] == 3
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


def test_evaluation_matches_jax():
    """Two chunks of the best-of-N selection over RGB videos: every carry
    entry (metrics, selected frames, random samples, the conditioning
    reconstruction) against the JAX evaluation's."""
    nt_cond, nt_test, o, bsz, chunk = 3, 6, 2, 2, 3
    jcfg, cfg = configs(**TINY)
    params, state = jax_model(jcfg, seed=6, res_gain=1.2, conv_gain=10.0)
    model = port_model(params, state, cfg)
    x = rgb_frames(nt_test, bsz, seed=3)
    sel = jeval.make_select_chunk(jcfg, nt_cond, nt_test, o, o, NAMES,
                                  use_fused_rollout=False)
    t_pred, hw_c = nt_test - nt_cond, (64, 64, 3)
    carry = jeval.init_select_carry(NAMES, bsz, t_pred, nt_cond, hw_c, 5)
    tcarry = eval_lib.init_select_carry(NAMES, bsz, t_pred, nt_cond, hw_c, 5,
                                        "cpu")
    base = jax.random.PRNGKey(8)
    for c in range(2):
        keys = jax.random.split(jax.random.fold_in(base, c), chunk)
        carry = sel(carry, params, state, jnp.asarray(x[:nt_cond]),
                    jnp.asarray(x[nt_cond:]), keys, jnp.int32(c * chunk))
        eps = chunk_noise(keys[0], cfg, bsz * chunk, nt_cond, t_pred, o, o)
        tcarry = eval_lib.select_chunk(tcarry, model, t(x[:nt_cond]),
                                       t(x[nt_cond:]), chunk, c * chunk, o,
                                       o, eps)
    carry = jax.device_get(carry)
    assert set(tcarry) == set(carry)
    assert tcarry["psnr_best_frm"].shape == (bsz, t_pred, 64, 64, 3)
    assert np.asarray(carry["random"]).std() > 10   # frames are not flat
    for k, v in carry.items():
        if k.endswith("_val"):
            atol = PSNR_ATOL if k.startswith("psnr") else SSIM_ATOL
            np.testing.assert_allclose(tcarry[k].numpy(), v, atol=atol,
                                       err_msg=k)
        else:
            assert_u8_close(tcarry[k].numpy(), v)
