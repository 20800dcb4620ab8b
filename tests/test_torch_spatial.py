"""The plain versions of the vgg pool and upsample kernels (the port's
kernels/spatial.py, which the CPU wrappers run) against the JAX package on
the CPU: the Pallas kernels of srvp_tpu/ops/pallas/spatial.py in interpret
mode, forward and VJP, and the jnp paths of srvp_tpu/ops/convops.py that
the JAX model runs off the TPU. Inputs come from numpy seeds; tie-heavy
inputs (a few integer levels) and planted NaNs included.

Tolerance 0: bit-equal, a NaN matching a NaN, with two exceptions that
come from XLA, not from the port:
  * the upsample backward against XLA's reduction of the jnp path, which
    sums the four cotangents of a window in its own order. Two orders of
    three fp32 additions differ by at most 6 unit roundoffs of the sum of
    the magnitudes, so it is held within 3 ulps of that sum (2 measured on
    seeded inputs; the Pallas order is held bit for bit, and the plain
    version and the kernels keep it);
  * the pool backward against the Pallas kernel in interpret mode. The
    kernel computes mask * up(g / cnt); on the CPU, XLA rewrites that
    product by a 0/1 mask as a select, which gives +0 where the product
    gives -0 (g < 0 at a position that is not a maximum) and 0 in a window
    holding a NaN (cnt 0, so the product is NaN). The port computes the
    product as written, as the jnp path of the JAX model (what its CPU and
    GPU runs differentiate) and torch.amax's autograd do: bit-equal to
    those. Against the interpret mode it is equal as numbers (-0 == +0)
    outside the windows that hold a NaN."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu.ops import convops
from srvp_tpu.ops.pallas import spatial as pallas
from srvp_tpu_torch.kernels import spatial

SHAPES = [(3, 5, 8, 8), (2, 3, 16, 12), (1, 130, 4, 4)]   # N, C, H, W


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def assert_bits_equal(ours, ref):
    """Same shape, NaNs at the same places, the same bits elsewhere."""
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.float32
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(ours), nan)
    np.testing.assert_array_equal(ours[~nan].view(np.int32),
                                  ref[~nan].view(np.int32))


def inputs(shape, kind, seed):
    """float32 NCHW: 'normal', 'ties' (three integer levels, so most 2x2
    windows hold tied maxima) or 'nan' (normal with NaNs planted, one in a
    window of ties)."""
    rng = np.random.RandomState(seed)
    if kind == "ties":
        return rng.randint(0, 3, shape).astype(np.float32)
    x = rng.randn(*shape).astype(np.float32)
    if kind == "nan":
        x[0, 0, 0, :2] = 1.5
        x[0, 0, 1, 0] = np.nan
        x[-1, -1, -1, -1] = np.nan
    return x


@pytest.mark.parametrize("kind", ["normal", "ties", "nan"])
@pytest.mark.parametrize("shape", SHAPES)
def test_pool_forward_and_vjp_match_jax(shape, kind):
    x = inputs(shape, kind, seed=0)
    g = np.random.RandomState(1).randn(
        shape[0], shape[1], shape[2] // 2, shape[3] // 2).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: pallas.max_pool2x2(v, True), nhwc(x))
    ref_gx = nchw(vjp(nhwc(g))[0]).numpy()
    xt = torch.from_numpy(x).requires_grad_()
    m = spatial.max_pool2x2(xt)
    gx, = torch.autograd.grad(m, xt, torch.from_numpy(g))
    assert_bits_equal(m, nchw(ref))
    # equal as numbers outside NaN windows (module docstring)
    nan_window = np.isnan(spatial.upsample2x_reference(m.detach()).numpy())
    np.testing.assert_array_equal(gx.numpy()[~nan_window],
                                  ref_gx[~nan_window])
    assert np.isnan(gx.numpy()[nan_window]).all()
    # bit-equal to the jnp path of the JAX model
    jnp_ref, jnp_vjp = jax.vjp(convops.max_pool2d, nhwc(x))
    assert_bits_equal(m, nchw(jnp_ref))
    assert_bits_equal(gx, nchw(jnp_vjp(nhwc(g))[0]))


@pytest.mark.parametrize("kind", ["normal", "ties", "nan"])
def test_pool_backward_is_amax_autograd(kind):
    """The plain backward (mask * up(g / cnt)) is bit for bit what
    torch.amax's autograd gives the reshape-and-amax forward: tied maxima
    share the gradient equally, where F.max_pool2d picks one winner."""
    x = inputs((4, 6, 16, 16), kind, seed=2)
    g = torch.from_numpy(np.random.RandomState(3).randn(4, 6, 8, 8)
                         .astype(np.float32))
    xt = torch.from_numpy(x).requires_grad_()
    m = spatial.max_pool2x2_reference(xt)
    gx, = torch.autograd.grad(m, xt, g)
    assert_bits_equal(spatial.max_pool2x2_bwd_reference(
        xt.detach(), m.detach(), g), gx)
    if kind == "ties":
        window = gx[0, 0, :2, :2]
        tied = (xt[0, 0, :2, :2] == m[0, 0, 0, 0]).sum()
        assert tied > 1 and torch.all(
            window[xt[0, 0, :2, :2] == m[0, 0, 0, 0]] == g[0, 0, 0, 0] / tied)
        xt2 = torch.from_numpy(x).requires_grad_()
        one, = torch.autograd.grad(torch.nn.functional.max_pool2d(xt2, 2),
                                   xt2, g)
        assert not torch.equal(one, gx)


@pytest.mark.parametrize("kind", ["normal", "nan"])
@pytest.mark.parametrize("shape", SHAPES)
def test_upsample_forward_and_vjp_match_pallas(shape, kind):
    x = inputs(shape, kind, seed=4)
    g = np.random.RandomState(5).randn(
        shape[0], shape[1], 2 * shape[2], 2 * shape[3]).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: pallas.upsample2x(v, True), nhwc(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = spatial.upsample2x(xt)
    gx, = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert_bits_equal(y, nchw(ref))
    assert_bits_equal(gx, nchw(vjp(nhwc(g))[0]))
    assert_bits_equal(spatial.upsample2x_bwd_reference(torch.from_numpy(g)),
                      nchw(vjp(nhwc(g))[0]))
    # the jnp path: the same forward; its backward is XLA's reduction
    jnp_ref, jnp_vjp = jax.vjp(convops.upsample_nearest2x, nhwc(x))
    assert_bits_equal(y, nchw(jnp_ref))
    xla = nchw(jnp_vjp(nhwc(g))[0]).numpy()
    magnitude = spatial.upsample2x_bwd_reference(
        torch.from_numpy(np.abs(g))).numpy()
    assert np.all(np.abs(gx.numpy() - xla) <= 3 * np.spacing(magnitude))


def test_wrappers_reject_what_the_kernels_do_not_take():
    ok = torch.zeros(2, 3, 4, 4)
    bad = [ok[:, :, :3], ok[:, :, :, :3], ok.double(), ok.half(), ok[0],
           ok[None], torch.zeros(2, 3, 4, 4, device="meta")]
    for x in bad:
        with pytest.raises(ValueError):
            spatial.max_pool2x2(x)
    for x in bad[2:]:
        with pytest.raises(ValueError):
            spatial.upsample2x(x)
    with pytest.raises(ValueError):
        spatial.upsample2x_bwd(ok[:, :, :3])
    with pytest.raises(ValueError):
        spatial.max_pool2x2_bwd(ok, torch.zeros(2, 3, 2, 2),
                                torch.zeros(2, 3, 2, 3))


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    before = (spatial.pool_fwd_launches, spatial.pool_bwd_launches,
              spatial.up_fwd_launches, spatial.up_bwd_launches)
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    (spatial.max_pool2x2(x).sum() + spatial.upsample2x(x).sum()).backward()
    assert (spatial.pool_fwd_launches, spatial.pool_bwd_launches,
            spatial.up_fwd_launches, spatial.up_bwd_launches) == before
