"""Module parity of the PyTorch port against the JAX package on the CPU:
dists, MLP, LSTM, encoder, decoder (eval batch norm with non-trivial
running stats), infer_w and infer_y, all with the same weights and noise.

Tolerance: atol 2e-4 for modules (tests/test_model_parity.py). The dists
agree to float32 rounding only: XLA's and torch's exp/log1p differ by an
ulp, so softplus cannot be bit-equal across the frameworks."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu.models import lstm as jlstm
from srvp_tpu.models import mlp as jmlp
from srvp_tpu.models import srvp as jsrvp
from srvp_tpu.ops import dists as jdists
from srvp_tpu_torch.models.lstm import lstm_apply
from srvp_tpu_torch.ops import dists
from tests.torch_port_util import ATOL, configs, jax_model, port_model, t

TIME, BSZ = 5, 3


@pytest.fixture(scope="module", params=[False, True], ids=["noskip", "skip"])
def models(request):
    jcfg, cfg = configs(skipco=request.param)
    params, state = jax_model(jcfg, seed=1)
    return jcfg, params, state, port_model(params, state, cfg)


def frames(seed=7):
    return np.random.RandomState(seed).rand(TIME, BSZ, 64, 64, 1) \
        .astype(np.float32)


def test_dists_match():
    raw = np.random.RandomState(0).randn(64, 10).astype(np.float32) * 6
    loc, scale = jdists.split_raw_params(jnp.asarray(raw))
    tloc, tscale = dists.split_raw_params(t(raw))
    np.testing.assert_array_equal(tloc.numpy(), np.asarray(loc))
    np.testing.assert_allclose(tscale.numpy(), np.asarray(scale), rtol=1e-6,
                               atol=0)
    key = jax.random.PRNGKey(3)
    z = jdists.rsample(jnp.asarray(raw), key)
    eps = jax.random.normal(key, (64, 5))
    np.testing.assert_allclose(dists.rsample(t(raw), t(eps)).numpy(),
                               np.asarray(z), rtol=1e-6, atol=1e-6)


def test_mlp_and_lstm(models):
    jcfg, params, _, model = models
    rng = np.random.RandomState(2)
    y = rng.randn(BSZ, jcfg.ny).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            model.p_z(t(y)).numpy(),
            np.asarray(jmlp.mlp_apply(params["p_z"], y)), atol=ATOL)
        hx = rng.randn(TIME, BSZ, jcfg.nhx).astype(np.float32)
        np.testing.assert_allclose(
            lstm_apply(model.inf_z, t(hx)).numpy(),
            np.asarray(jlstm.lstm_apply(params["inf_z"], hx)), atol=ATOL)


def test_encoder_and_inference(models):
    jcfg, params, state, model = models
    x = frames()
    hx, skips, _ = jsrvp.encode(jcfg, params, state, x, train=False)
    with torch.no_grad():
        thx, tskips = model.encode(t(x))
    np.testing.assert_allclose(thx.numpy(), np.asarray(hx), atol=ATOL)
    if jcfg.skipco:
        assert len(tskips) == len(skips)
        for ts, s in zip(tskips, skips):
            np.testing.assert_allclose(ts.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(s), atol=ATOL)
    else:
        assert tskips is None and skips is None

    hx = np.asarray(hx)
    w = jsrvp.infer_w(jcfg, params, hx, train=False)
    key = jax.random.PRNGKey(11)
    y0, q = jsrvp.infer_y(jcfg, params, hx[:jcfg.nt_inf], key)
    eps_y = jax.random.normal(key, (BSZ, jcfg.ny))
    with torch.no_grad():
        tw = model.infer_w(t(hx))
        ty0, tq = model.infer_y(t(hx[:jcfg.nt_inf]), t(eps_y))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), atol=ATOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(q), atol=ATOL)
    np.testing.assert_allclose(ty0.numpy(), np.asarray(y0), atol=ATOL)


def test_decoder(models):
    jcfg, params, state, model = models
    x = frames(seed=9)
    _, skips, _ = jsrvp.encode(jcfg, params, state, x, train=False)
    rng = np.random.RandomState(4)
    w = np.tanh(rng.randn(BSZ, jcfg.nh_inf)).astype(np.float32)
    y = rng.randn(4, BSZ, jcfg.ny).astype(np.float32)
    x_, _ = jsrvp.decode(jcfg, params, state, w, y, skips, train=False)
    with torch.no_grad():
        tskips = None if skips is None else \
            [t(s).permute(0, 3, 1, 2).contiguous() for s in skips]
        tx = model.decode(t(w), t(y), tskips)
    assert tx.shape == (4, BSZ, 64, 64, 1)
    np.testing.assert_allclose(tx.numpy(), np.asarray(x_), atol=ATOL)
