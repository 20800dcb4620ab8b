"""JAX checkpoints into the PyTorch port: state_dict conversion and the
model.npz reader, held against srvp_tpu.utils.torch_export."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu.objectives import elbo_loss as jelbo
from srvp_tpu.utils import checkpoint as ckpt
from srvp_tpu.utils.torch_export import export_state_dict
from srvp_tpu_torch.models.srvp import SRVP
from srvp_tpu_torch.objectives import elbo_loss
from srvp_tpu_torch.utils import weights
from tests.torch_port_util import (_jit_init, configs, jax_draws, jax_model,
                                   port_model, t, to_np)


@pytest.mark.parametrize("skipco", [False, True])
def test_state_dict_matches_export(skipco):
    jcfg, cfg = configs(skipco=skipco)
    params, state = jax_model(jcfg)
    sd = weights.state_dict_from_jax(params, state, cfg)
    ref = export_state_dict(params, state, jcfg)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    model = SRVP(cfg)
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(ref)
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == ref[k].shape, k


def test_model_npz_roundtrip(tmp_path):
    jcfg, cfg = configs()
    params, state = jax_model(jcfg, seed=3)
    ckpt.save_model(str(tmp_path), "model", params, state)
    p2, s2 = weights.load_jax_model_npz(tmp_path / "model.npz")
    flat = jax.tree_util.tree_leaves_with_path((params, state))
    flat2 = dict(jax.tree_util.tree_leaves_with_path((p2, s2)))
    assert len(flat) == len(flat2)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat2[path], leaf)
    model = weights.load_checkpoint(SRVP(cfg), tmp_path / "model.npz")
    ref = export_state_dict(params, state, jcfg)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_reference_pt_state_dict_loads(tmp_path):
    _, cfg = configs()
    torch.manual_seed(0)
    src = SRVP(cfg)
    torch.save(src.state_dict(), tmp_path / "model.pt")
    model = weights.load_checkpoint(SRVP(cfg), tmp_path / "model.pt")
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_keypath_parser():
    tree = weights.unflatten_keypaths({
        "['a'][0]['k']": 1, "['a'][2]['k']": 2, "['b']": 3})
    assert tree == {"a": [{"k": 1}, {}, {"k": 2}], "b": 3}
    with pytest.raises(ValueError):
        weights.unflatten_keypaths({"a.b": 1})


def test_vgg_builds_with_reference_keys():
    """vgg builds, its pools and upsamples holding the reference
    checkpoint's key positions (tests/test_torch_vgg.py holds it against
    JAX); an unknown network still raises."""
    _, cfg = configs(archi="vgg")
    keys = SRVP(cfg).state_dict()
    assert "encoder.conv.1.1.0.weight" in keys
    assert "encoder.conv.1.0.weight" not in keys     # the pool, index 0
    _, cfg = configs(archi="resnet")
    with pytest.raises(ValueError, match="resnet"):
        SRVP(cfg)


def test_bn_state_round_trip():
    jcfg, cfg = configs(skipco=True)
    params, state = jax_model(jcfg, seed=5)
    back = weights.bn_state_from_port(
        weights.state_dict_from_jax(params, state, cfg), cfg)
    flat = jax.tree_util.tree_leaves_with_path(state)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_jax_initialised_model_gives_the_same_elbo():
    """The JAX training init carried into the port: the same ELBO and terms
    on the same batch and draws, in training mode."""
    jcfg, cfg = configs()
    params, state = to_np(_jit_init(jax.random.PRNGKey(4), jcfg, 1.41))
    x = np.random.RandomState(1).rand(4, 3, 64, 64, 1).astype(np.float32)
    key = jax.random.PRNGKey(2)
    kw = dict(oversampling=1, obs_scale=1.0, beta_y=1.0, beta_z=1.0,
              l2_res=1.0)
    loss_j, aux_j = jax.jit(lambda p: jelbo(jcfg, p, state, jnp.asarray(x),
                                            key, **kw))(params)
    model = port_model(params, state, cfg).train()
    with torch.no_grad():
        loss, aux = elbo_loss(model, t(x), **kw,
                              **jax_draws(key, jcfg, 4, 3, 1))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    for name in aux._fields:
        np.testing.assert_allclose(getattr(aux, name).item(),
                                   float(getattr(aux_j, name)), rtol=1e-4,
                                   err_msg=name)
