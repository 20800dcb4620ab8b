"""The port's vgg encoder and decoder against the JAX package on the CPU:
`encoder_apply` / `decoder_apply` of srvp_tpu/models/conv.py with the same
weights, skip connections on and off, in evaluation mode (batch norm with
non-trivial running statistics) and in training mode (batch statistics),
at atol 2e-4 (tests/test_model_parity.py); and the vgg weights' layout:
state_dict_from_jax equals the JAX package's export_state_dict, the
batch-norm state maps back, and the state_dicts of tests/torch_ref.py's
vgg modules (the reference checkpoint's keys) load strictly."""

import numpy as np
import pytest

import jax
import torch

from srvp_tpu.models import conv as jconv
from srvp_tpu.models import layers as jlayers
from srvp_tpu.utils.torch_export import export_state_dict
from srvp_tpu_torch.kernels.spatial import use_kernels
from srvp_tpu_torch.models.conv import Decoder, Encoder
from srvp_tpu_torch.models.srvp import SRVP
from srvp_tpu_torch.utils.weights import bn_state_from_port
from tests.test_torch_train import two_pass_bn_stats
from tests.torch_port_util import ATOL, configs, jax_model, port_model, t
from tests.torch_ref import TorchDecoder, TorchEncoder

TINY = dict(nf=4, nhx=8, ny=4, nz=4, nh_inf=16, nh_res=16, nlayers_inf=2,
            nlayers_res=2, archi="vgg", nt_inf=3)
N = 4


@pytest.fixture(scope="module", params=[False, True], ids=["noskip", "skip"])
def setup(request):
    jcfg, cfg = configs(skipco=request.param, **TINY)
    params, state = jax_model(jcfg, seed=3)
    return jcfg, cfg, params, state


@pytest.fixture
def model(setup):
    """A fresh port model holding the JAX weights (training-mode runs move
    its batch-norm statistics)."""
    _, cfg, params, state = setup
    return port_model(params, state, cfg)


def frames(seed):
    """(N, 64, 64, 1) frames with flat 8x8 blocks, so pools hold ties."""
    rng = np.random.RandomState(seed)
    blocks = np.kron(rng.rand(N, 8, 8), np.ones((8, 8)))
    return np.round(blocks * 16).astype(np.float32)[..., None] / 16


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_matches_jax(setup, model, train, monkeypatch):
    jcfg, _, params, state = setup
    if train:   # batch statistics, variance in two passes (test_torch_train)
        monkeypatch.setattr(jlayers, "_bn_stats_fwd", two_pass_bn_stats)
    stages, last = jconv.encoder_spec("vgg", jcfg.nc, jcfg.nhx, jcfg.nf)
    x = frames(seed=1)
    h, skips, _ = jax.jit(lambda p: jconv.encoder_apply(
        p, state["encoder"], stages, last, x, train))(params["encoder"])
    model.encoder.train(train)
    with torch.no_grad():
        th, tskips = model.encoder(t(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=ATOL)
    assert [s.shape[1:] for s in tskips] == [(32, 8, 8), (16, 16, 16),
                                             (8, 32, 32), (4, 64, 64)]
    for ts, s in zip(tskips, skips):
        np.testing.assert_allclose(ts.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(s), atol=ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_decoder_matches_jax(setup, model, train, monkeypatch):
    jcfg, _, params, state = setup
    if train:
        monkeypatch.setattr(jlayers, "_bn_stats_fwd", two_pass_bn_stats)
    first, stages = jconv.decoder_spec("vgg", jcfg.nc, jcfg.nh_inf + jcfg.ny,
                                       jcfg.nf, jcfg.skipco)
    rng = np.random.RandomState(2)
    z = rng.randn(N, jcfg.nh_inf + jcfg.ny).astype(np.float32)
    skips = None
    if jcfg.skipco:
        skips = [np.maximum(rng.randn(N, s, s, c), 0).astype(np.float32)
                 for s, c in ((8, 32), (16, 16), (32, 8), (64, 4))]
    x_, _ = jax.jit(lambda p: jconv.decoder_apply(
        p, state["decoder"], first, stages, z, skips, train))(
            params["decoder"])
    model.decoder.train(train)
    with torch.no_grad():
        tx = model.decoder(t(z), None if skips is None else [
            t(s).permute(0, 3, 1, 2).contiguous() for s in skips])
    assert tx.shape == (N, 1, 64, 64)
    np.testing.assert_allclose(tx.permute(0, 2, 3, 1).numpy(), np.asarray(x_),
                               atol=ATOL)


def test_plain_spatial_route_is_the_cpu_wrappers(model):
    """use_kernels(model, False) (the plain versions under autograd, as the
    one-step check on the card runs them) computes what the CPU wrappers
    compute: the forward bit for bit, the gradients to fp32 rounding (the
    upsample's autograd backward sums each window in torch's order, the
    wrappers in the TPU kernel's; 1e-4 of each tensor's largest value)."""
    x = t(frames(seed=4)).permute(0, 3, 1, 2).contiguous()
    runs = []
    for kernels in (True, False):
        model.zero_grad()
        model.train()
        use_kernels(model, kernels)
        h, skips = model.encoder(x)
        y = model.decoder(torch.cat([h, h, h[:, :4]], 1),
                          skips if model.cfg.skipco else None)
        y.square().sum().backward()
        runs.append([y.detach()] + [p.grad.clone() for p in
                                    model.parameters() if p.grad is not None])
    use_kernels(model, True)
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1:], runs[1][1:]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


def test_weights_match_the_jax_export(setup, model):
    jcfg, cfg, params, state = setup
    ours = model.state_dict()
    ref = export_state_dict(params, state, jcfg)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    back = bn_state_from_port(ours, cfg)
    flat = jax.tree_util.tree_leaves_with_path(state["encoder"])
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back["encoder"]))
    assert len(flat) == len(flat_back) > 0
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, state)) == \
        jax.tree_util.tree_structure(back)


def test_reference_vgg_state_dicts_load_strictly(setup):
    jcfg, cfg, _, _ = setup
    torch.manual_seed(0)
    ref_enc, ref_dec = TorchEncoder(jcfg), TorchDecoder(jcfg)
    enc = Encoder(cfg.archi, cfg.nc, cfg.nhx, cfg.nf)
    dec = Decoder(cfg.archi, cfg.nc, cfg.nh_inf + cfg.ny, cfg.nf, cfg.skipco)
    enc.load_state_dict(ref_enc.state_dict(), strict=True)
    dec.load_state_dict(ref_dec.state_dict(), strict=True)
    for key in ("conv.1.1.0.weight", "last_conv.1.0.weight"):
        assert key in enc.state_dict()
    for key in ("first_upconv.0.0.weight", "conv.3.1.weight"):
        assert key in dec.state_dict()
    # the reference modules and the port compute the same eval forward
    # (MaxPool2d and the pool agree off ties in the forward)
    ref_enc.eval()
    enc.eval()
    x = torch.rand(2, 1, 64, 64)
    with torch.no_grad():
        torch.testing.assert_close(enc(x)[0], ref_enc(x)[0], rtol=0,
                                   atol=1e-6)
    assert SRVP(cfg).state_dict().keys() >= {
        f"encoder.{k}" for k in ref_enc.state_dict()}
