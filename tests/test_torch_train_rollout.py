"""The port's training rollout against the JAX package on the CPU.

`kernels.rollout_train.train_rollout` (on CPU tensors: its plain version,
differentiated by autograd) is held against the Pallas training-rollout
kernels in interpret mode (`make_train_rollout(..., interpret=True)`, with
their custom VJP) and against the JAX scan of tests/test_pallas_train.py:
forward at rtol 2e-5 / atol 1e-6, the gradients of every input and weight
of a loss that touches every output at rtol 5e-4 / atol 5e-6 (the JAX
suite's tolerances for this kernel), on the same weights and noise."""

import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu.models import mlp as mlplib
from srvp_tpu.ops import init as winit
from srvp_tpu.ops.pallas.rollout_train import make_train_rollout
from srvp_tpu_torch.kernels import build as kbuild
from srvp_tpu_torch.kernels import rollout_train as krt
from srvp_tpu_torch.models.srvp import SRVP
from tests.test_pallas_train import _scan_reference
from tests.torch_port_util import configs, t

FWD_RTOL, FWD_ATOL = 2e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-6


def _jax_loss(outs):
    ys, res, qp, pp, zs = outs
    return (jnp.sum(ys * 0.3) + jnp.sum(res ** 2) + jnp.sum(jnp.tanh(qp))
            + jnp.sum(pp * 0.1) + jnp.sum(zs * 0.05))


def _torch_loss(outs):
    ys, res, qp, pp, zs = outs
    return ((ys * 0.3).sum() + (res ** 2).sum() + torch.tanh(qp).sum()
            + (pp * 0.1).sum() + (zs * 0.05).sum())


def _torch_layer(p):
    return (t(np.asarray(p["kernel"]).T).requires_grad_(),
            t(p["bias"]).requires_grad_())


@pytest.mark.parametrize("o,nt,ny,nz,bsz", [
    (1, 6, 20, 20, 5),
    (2, 4, 12, 20, 9),    # reused z, ny != nz
])
def test_train_rollout_matches_pallas_and_scan(o, nt, ny, nz, bsz):
    nh_inf, nh_res, nlayers = 24, 64, 3
    n_steps = o * (nt - 1)
    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    q_params = winit.linear_default(ks[0], nh_inf, 2 * nz)
    pz_params = mlplib.mlp_init(ks[1], ny, nh_res, 2 * nz, nlayers)
    dyn_params = mlplib.mlp_init(ks[2], ny + nz, nh_res, ny, nlayers,
                                 init_type="orthogonal", init_gain=1.2)
    y_0 = 0.1 * jax.random.normal(ks[3], (bsz, ny))
    hxz = jax.random.normal(ks[4], (n_steps, bsz, nh_inf))
    eps = jax.random.normal(ks[5], (n_steps, bsz, nz))

    fused = make_train_rollout(ny, nz, nh_inf, nh_res, n_steps, o,
                               interpret=True)
    scan = lambda *a: _scan_reference(*a, o)  # noqa: E731
    jargs = (q_params, pz_params, dyn_params, y_0, hxz)
    jax_runs = []
    for fn in (fused, scan):
        outs = fn(*jargs, eps)
        grads = jax.grad(lambda *a, fn=fn: _jax_loss(fn(*a, eps)),
                         argnums=(0, 1, 2, 3, 4))(*jargs)
        jax_runs.append((outs, grads))

    q = _torch_layer(q_params)
    pz = [_torch_layer(p) for p in pz_params]
    dyn = [_torch_layer(p) for p in dyn_params]
    y0_t = t(y_0).requires_grad_()
    hxz_t = t(hxz).requires_grad_()
    outs = krt.train_rollout(q, pz, dyn, y0_t, hxz_t, t(eps), o)
    leaves = [*q, *[x for p in pz for x in p], *[x for p in dyn for x in p],
              y0_t, hxz_t]
    grads = torch.autograd.grad(_torch_loss(outs), leaves)
    # JAX layout: kernels (in, out), leaves in (q, pz, dyn, y0, hxz) order
    ours = [g.numpy().T if g.ndim == 2 and i < len(leaves) - 2
            else g.numpy() for i, g in enumerate(grads)]

    for (j_outs, j_grads), route in zip(jax_runs, ("pallas", "scan")):
        for a, b, name in zip(outs, j_outs, ["ys", "res", "q", "p", "z"]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=FWD_RTOL, atol=FWD_ATOL,
                                       err_msg=f"{route} {name}")
        g_q, g_pz, g_dyn, g_y0, g_hxz = j_grads
        ref = [g[k] for g in [g_q, *g_pz, *g_dyn] for k in ("kernel", "bias")]
        ref += [g_y0, g_hxz]
        assert len(ref) == len(ours)
        for i, (a, b) in enumerate(zip(ours, ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL,
                                       err_msg=f"{route} grad {i}")


@pytest.mark.parametrize("oversampling", [1, 2])
def test_generate_kernel_route_matches_eager_loop(oversampling):
    """In training mode `generate(use_kernel=True)` (the kernel wrapper; on
    the CPU its plain version) gives the eager loop's outputs and
    gradients on the same noise."""
    _, cfg = configs()
    torch.manual_seed(0)
    model = SRVP(cfg).train()
    bsz, nt = 3, 5
    y_0 = torch.randn(bsz, cfg.ny)
    hx = torch.randn(nt, bsz, cfg.nhx)
    eps = torch.randn(oversampling * (nt - 1), bsz, cfg.nz)
    runs = []
    for use_kernel in (False, True):
        model.zero_grad()
        out = model.generate(y_0, hx, nt, oversampling, eps_pos=eps,
                             use_kernel=use_kernel)
        (out.y.sum() + out.z.sum() + out.q_z_params.sum()
         + out.p_z_params.sum() + out.res.square().sum()).backward()
        runs.append((out, {k: p.grad.clone()
                           for k, p in model.named_parameters()
                           if p.grad is not None}))
    (eager, g_eager), (fused, g_fused) = runs
    for name in ("y", "z", "q_z_params", "p_z_params", "res"):
        torch.testing.assert_close(getattr(fused, name), getattr(eager, name),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
    assert set(g_eager) == set(g_fused)
    for k in g_eager:
        torch.testing.assert_close(g_fused[k], g_eager[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, msg=k)


def test_training_rollout_needs_observations():
    _, cfg = configs()
    model = SRVP(cfg).train()
    with pytest.raises(ValueError, match="observation"):
        model.generate(torch.zeros(2, cfg.ny), torch.zeros(3, 2, cfg.nhx), 5)


def test_cpu_wrapper_never_builds(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: no nvcc, no build
    directory, no launch counted; other devices raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path must not build the kernels")
    for name in ("build", "load_library", "nvcc_path"):
        monkeypatch.setattr(kbuild, name, refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)
    existed = kbuild.BUILD_DIR.exists()
    before = (krt.fwd_launches, krt.bwd_launches)

    gen = torch.Generator().manual_seed(0)
    lin = lambda o, i: (torch.randn(o, i, generator=gen),  # noqa: E731
                        torch.randn(o, generator=gen))
    q, pz, dyn = lin(6, 5), [lin(8, 4), lin(6, 8)], [lin(8, 7), lin(4, 8)]
    y0 = torch.randn(3, 4, generator=gen).requires_grad_()
    hxz = torch.randn(4, 3, 5, generator=gen)
    eps = torch.randn(4, 3, 3, generator=gen)
    outs = krt.train_rollout(q, pz, dyn, y0, hxz, eps, 2)
    ref = krt.train_rollout_reference(q, pz, dyn, y0, hxz, eps, 2)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    assert [o.shape for o in outs] == [(4, 3, 4), (4, 3, 4), (4, 3, 6),
                                      (4, 3, 6), (4, 3, 3)]
    sum(o.sum() for o in outs).backward()
    assert y0.grad is not None
    assert (krt.fwd_launches, krt.bwd_launches) == before
    assert kbuild.BUILD_DIR.exists() == existed

    with pytest.raises(ValueError, match="unsupported device"):
        krt.train_rollout(q, pz, dyn, y0.detach().to("meta"),
                          hxz.to("meta"), eps.to("meta"), 2)
