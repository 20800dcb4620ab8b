"""Latent rollouts of the PyTorch port against the JAX package on the CPU.

The port's prior rollout (`SRVP.generate_prior`, which on CPU tensors runs
the plain version of the CUDA kernel) is held against the Pallas kernel in
interpret mode (`generate_prior_fused(..., interpret=True)`) and against the
`srvp.generate` scan, at rtol 1e-4 / atol 1e-5 (tests/test_pallas.py), on
the same weights and the same JAX noise draws."""

import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu.models import lstm as jlstm
from srvp_tpu.models import srvp as jsrvp
from srvp_tpu_torch.kernels import build as kbuild
from srvp_tpu_torch.kernels import rollout as krollout
from srvp_tpu_torch.models.lstm import lstm_apply
from srvp_tpu_torch.models.srvp import SRVP
from tests.torch_port_util import (ATOL, ROLLOUT_ATOL, ROLLOUT_RTOL, configs,
                                   jax_model, port_model, step_noise, t)


def close(a, b):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                               rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)


def rollout_models(ny, nz, seed=0):
    jcfg, cfg = configs(nf=4, nhx=16, ny=ny, nz=nz, nt_inf=3, nh_inf=24,
                        nlayers_inf=2, nh_res=64, nlayers_res=4)
    params, state = jax_model(jcfg, seed=seed, res_gain=1.2)
    return jcfg, params, port_model(params, state, cfg)


@pytest.mark.parametrize("oversampling,nt,ny,nz", [
    (1, 8, 20, 20),
    (2, 6, 50, 50),
    (2, 5, 20, 12),   # ny != nz
])
def test_prior_rollout_matches_pallas_and_scan(oversampling, nt, ny, nz):
    jcfg, params, model = rollout_models(ny, nz)
    bsz = 5
    y_0 = np.random.RandomState(1).randn(bsz, ny).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    ref = jsrvp.generate(jcfg, params, jnp.asarray(y_0), None, nt,
                         oversampling=oversampling, rng=rng, train=False)
    fused = jsrvp.generate_prior_fused(jcfg, params, jnp.asarray(y_0), nt,
                                       oversampling=oversampling, rng=rng,
                                       interpret=True)
    eps_pri, _ = step_noise(rng, oversampling * (nt - 1), bsz, nz)
    with torch.no_grad():
        out = model.generate_prior(t(y_0), nt, oversampling, eps=eps_pri)
        eager = model.generate(t(y_0), None, nt, oversampling,
                               eps_pri=eps_pri)
    assert out.y.shape == (nt, bsz, ny)
    for jax_out in (fused, ref):
        close(out.y, jax_out.y)
        close(out.res, jax_out.res)
    close(eager.y, ref.y)
    close(eager.res, ref.res)
    close(eager.z, ref.z)
    close(eager.p_z_params, ref.p_z_params)
    assert eager.q_z_params is None and ref.q_z_params is None


def test_prior_rollout_keeps_intermediate_states():
    jcfg, params, model = rollout_models(20, 20, seed=2)
    y_0 = np.zeros((3, jcfg.ny), np.float32)
    rng = jax.random.PRNGKey(0)
    fused = jsrvp.generate_prior_fused(jcfg, params, jnp.asarray(y_0), 4,
                                       oversampling=3, rng=rng,
                                       remove_intermediate=False,
                                       interpret=True)
    ref = jsrvp.generate(jcfg, params, jnp.asarray(y_0), None, 4,
                         oversampling=3, rng=rng, train=False,
                         remove_intermediate=False)
    eps_pri, _ = step_noise(rng, 9, 3, jcfg.nz)
    with torch.no_grad():
        out = model.generate_prior(t(y_0), 4, 3, eps=eps_pri,
                                   remove_intermediate=False)
    assert out.y.shape == (10, 3, jcfg.ny)  # 1 + 3 * (4 - 1)
    close(out.y, fused.y)
    close(out.y, ref.y)


@pytest.mark.parametrize("precomputed_lstm", [False, True])
def test_posterior_generate_matches_jax(precomputed_lstm):
    jcfg, cfg = configs()
    params, state = jax_model(jcfg, seed=4)
    model = port_model(params, state, cfg)
    bsz, nt, nt_hx, o = 3, 7, 4, 2
    rng_np = np.random.RandomState(5)
    y_0 = rng_np.randn(bsz, jcfg.ny).astype(np.float32)
    hx = rng_np.randn(nt_hx, bsz, jcfg.nhx).astype(np.float32)
    key = jax.random.PRNGKey(9)
    if precomputed_lstm:
        hx_z = np.asarray(jlstm.lstm_apply(params["inf_z"], hx))
        ref = jsrvp.generate(jcfg, params, y_0, None, nt, oversampling=o,
                             rng=key, train=False, hx_z=hx_z)
    else:
        ref = jsrvp.generate(jcfg, params, y_0, hx, nt, oversampling=o,
                             rng=key, train=False)
    eps_pri, eps_pos = step_noise(key, o * (nt - 1), bsz, jcfg.nz)
    with torch.no_grad():
        if precomputed_lstm:
            out = model.generate(t(y_0), None, nt, o, eps_pri=eps_pri,
                                 eps_pos=eps_pos,
                                 hx_z=lstm_apply(model.inf_z, t(hx)))
        else:
            out = model.generate(t(y_0), t(hx), nt, o, eps_pri=eps_pri,
                                 eps_pos=eps_pos)
    for name in ("y", "z", "q_z_params", "p_z_params", "res"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=ATOL,
                                   err_msg=name)
    assert out.q_z_params.shape[0] == nt_hx - 1


def test_cpu_wrapper_never_builds(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: no nvcc, no
    build directory, no launch counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path must not build the kernels")
    for name in ("build", "load_library", "nvcc_path"):
        monkeypatch.setattr(kbuild, name, refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)
    existed = kbuild.BUILD_DIR.exists()
    before = krollout.launches

    gen = torch.Generator().manual_seed(0)
    pz = [(torch.randn(8, 4, generator=gen), torch.randn(8, generator=gen)),
          (torch.randn(6, 8, generator=gen), torch.randn(6, generator=gen))]
    dyn = [(torch.randn(8, 7, generator=gen), torch.randn(8, generator=gen)),
           (torch.randn(4, 8, generator=gen), torch.randn(4, generator=gen))]
    y0 = torch.randn(5, 4, generator=gen)
    eps = torch.randn(6, 5, 3, generator=gen)
    out = krollout.prior_rollout(pz, dyn, y0, eps, 4, 3, 2)
    ref = krollout.prior_rollout_reference(pz, dyn, y0, eps, 4, 3, 2)
    assert out.shape == (6, 5, 4)
    assert torch.equal(out, ref)
    assert krollout.launches == before
    assert kbuild.BUILD_DIR.exists() == existed

    with pytest.raises(ValueError, match="unsupported device"):
        krollout.prior_rollout(pz, dyn, y0.to("meta"), eps.to("meta"), 4, 3,
                               2)


def test_noise_from_generator_matches_injected_noise():
    """Without injected eps the rollouts draw it from the generator, in the
    shapes the injected noise has."""
    _, cfg = configs()
    torch.manual_seed(0)
    model = SRVP(cfg).eval()
    y_0 = torch.randn(3, cfg.ny)
    hx = torch.randn(3, 3, cfg.nhx)
    with torch.no_grad():
        out = model.generate_prior(y_0, 4, 2,
                                   generator=torch.Generator().manual_seed(1))
        eps = torch.randn(6, 3, cfg.nz,
                          generator=torch.Generator().manual_seed(1))
        ref = model.generate_prior(y_0, 4, 2, eps=eps)
        torch.testing.assert_close(out.y, ref.y, rtol=0, atol=0)

        out = model.generate(y_0, hx, 5, 1,
                             generator=torch.Generator().manual_seed(2))
        gen = torch.Generator().manual_seed(2)
        eps_pri = torch.randn(4, 3, cfg.nz, generator=gen)
        eps_pos = torch.randn(4, 3, cfg.nz, generator=gen)
        ref = model.generate(y_0, hx, 5, 1, eps_pri=eps_pri, eps_pos=eps_pos)
        torch.testing.assert_close(out.y, ref.y, rtol=0, atol=0)
