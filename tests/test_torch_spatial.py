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
    outside the windows that hold a NaN.

In bfloat16 (the trainer's `--precision bfloat16`) the plain versions are
bit-equal to the Pallas kernels in interpret mode (forward; the pool
backward as above; the upsample backward bit for bit), and to the jnp
paths in the forward and the pool backward. The jnp path's upsample
backward is XLA:CPU's bfloat16 reduction, which chains three bfloat16
additions ((g00 + g01) + g10) + g11; the TPU kernel, the plain version and
the CUDA kernel add in float32 and round once, so the two are held within
2 bfloat16 ulps of the sum of the magnitudes (three roundings of at most
half an ulp each, plus the final one)."""

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
    before = dict(spatial.launches)
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    (spatial.max_pool2x2(x).sum() + spatial.upsample2x(x).sum()).backward()
    assert spatial.launches == before


BF16 = [(3, 5, 8, 8), (2, 3, 16, 12), (1, 130, 4, 4)]


def bf16_pair(x):
    """(torch bfloat16 NCHW, jnp bfloat16 NHWC) holding the same values."""
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return xt, jnp.asarray(xt.float().numpy().transpose(0, 2, 3, 1),
                           jnp.bfloat16)


def assert_bf16_bits_equal(ours, ref, nan_windows=None):
    """bfloat16 NCHW `ours` against jnp bfloat16 NHWC `ref`: NaNs at the
    same places and the same bits elsewhere (outside `nan_windows`, where
    only the NaNs are compared)."""
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    ours = ours.detach()
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert tuple(ours.shape) == ref.shape
    bits = ours.view(torch.int16).numpy()
    ref_bits = np.ascontiguousarray(ref).view(np.int16)
    nan, ref_nan = torch.isnan(ours).numpy(), np.isnan(ref.astype(np.float32))
    keep = ~ref_nan if nan_windows is None else ~(ref_nan | nan_windows)
    np.testing.assert_array_equal(nan[keep], ref_nan[keep])
    np.testing.assert_array_equal(bits[keep & ~ref_nan],
                                  ref_bits[keep & ~ref_nan])
    if nan_windows is not None:
        assert nan[nan_windows].all()


@pytest.mark.parametrize("kind", ["normal", "ties", "nan"])
@pytest.mark.parametrize("shape", BF16)
def test_pool_bfloat16_matches_jax(shape, kind):
    """Kernels 4 and 5 in bfloat16: the plain versions (what the CPU
    wrappers run) against the Pallas kernels in interpret mode and the jnp
    path, forward and VJP."""
    x, xj = bf16_pair(inputs(shape, kind, seed=6))
    g, gj = bf16_pair(np.random.RandomState(7).randn(
        shape[0], shape[1], shape[2] // 2, shape[3] // 2).astype(np.float32))
    ref, vjp = jax.vjp(lambda v: pallas.max_pool2x2(v, True), xj)
    jnp_ref, jnp_vjp = jax.vjp(convops.max_pool2d, xj)
    xt = x.clone().requires_grad_()
    m = spatial.max_pool2x2(xt)
    gx, = torch.autograd.grad(m, xt, g)
    assert gx.dtype == torch.bfloat16
    assert_bf16_bits_equal(m, ref)
    assert_bf16_bits_equal(m, jnp_ref)
    assert_bf16_bits_equal(gx, jnp_vjp(gj)[0])
    # the Pallas backward: equal as numbers outside NaN windows
    nan_window = torch.isnan(spatial.upsample2x_reference(m.detach()))
    pallas_gx = nchw(np.asarray(vjp(gj)[0]).astype(np.float32)).numpy()
    np.testing.assert_array_equal(gx.float().numpy()[~nan_window.numpy()],
                                  pallas_gx[~nan_window.numpy()])
    assert torch.isnan(gx[nan_window]).all()
    assert torch.equal(gx.view(torch.int16), spatial.max_pool2x2_bwd_reference(
        x, m.detach(), g).view(torch.int16))


@pytest.mark.parametrize("kind", ["normal", "nan"])
@pytest.mark.parametrize("shape", BF16)
def test_upsample_bfloat16_matches_jax(shape, kind):
    """Kernels 6 and 7 in bfloat16: the plain versions against the Pallas
    kernels in interpret mode (bit for bit) and the jnp path (forward bit
    for bit, backward within 2 ulps of the sum of magnitudes)."""
    x, xj = bf16_pair(inputs(shape, kind, seed=8))
    g, gj = bf16_pair(np.random.RandomState(9).randn(
        shape[0], shape[1], 2 * shape[2], 2 * shape[3]).astype(np.float32))
    ref, vjp = jax.vjp(lambda v: pallas.upsample2x(v, True), xj)
    jnp_ref, jnp_vjp = jax.vjp(convops.upsample_nearest2x, xj)
    xt = x.clone().requires_grad_()
    y = spatial.upsample2x(xt)
    gx, = torch.autograd.grad(y, xt, g)
    assert_bf16_bits_equal(y, ref)
    assert_bf16_bits_equal(y, jnp_ref)
    assert_bf16_bits_equal(gx, vjp(gj)[0])
    xla = np.asarray(jnp_vjp(gj)[0]).astype(np.float32).transpose(0, 3, 1, 2)
    magnitude = spatial.upsample2x_bwd_reference(g.float().abs()).numpy()
    ulp = np.spacing(magnitude.astype(np.float32)) * 2.0 ** 16  # bf16 ulp
    assert np.all(np.abs(gx.float().numpy() - xla) <= 2 * ulp)


def test_bfloat16_backward_rounds_once():
    """The pool backward's g / cnt and the upsample backward's window sum
    are taken in float32 and rounded once: against the bfloat16 chain
    (which rounds after every operation) they differ, against float32
    arithmetic on the same values rounded at the end they do not."""
    rng = np.random.RandomState(10)
    g = torch.from_numpy(rng.randn(64, 32, 8, 8).astype(np.float32)).to(
        torch.bfloat16)
    once = spatial.upsample2x_bwd_reference(g)
    g6 = g.reshape(64, 32, 4, 2, 4, 2)
    chain = (g6[:, :, :, 0, :, 0] + g6[:, :, :, 1, :, 0]) \
        + (g6[:, :, :, 0, :, 1] + g6[:, :, :, 1, :, 1])
    assert torch.equal(once, spatial.upsample2x_bwd_reference(
        g.float()).to(torch.bfloat16))
    assert not torch.equal(once, chain)
    x = torch.from_numpy(rng.randint(0, 2, (8, 8, 8, 8)).astype(
        np.float32)).to(torch.bfloat16)        # 0/1: most windows tied
    m = spatial.max_pool2x2_reference(x)
    gm = torch.from_numpy(rng.randn(8, 8, 4, 4).astype(np.float32)).to(
        torch.bfloat16)
    assert torch.equal(
        spatial.max_pool2x2_bwd_reference(x, m, gm),
        spatial.max_pool2x2_bwd_reference(x.float(), m.float(),
                                          gm.float()).to(torch.bfloat16))


def test_cpu_wrappers_count_no_bfloat16_launch():
    """bfloat16 CPU tensors take the plain versions too: no launch of
    either type is counted, and outputs keep the input's dtype."""
    before = dict(spatial.launches)
    x = torch.randn(2, 3, 4, 4, dtype=torch.bfloat16, requires_grad=True)
    m, y = spatial.max_pool2x2(x), spatial.upsample2x(x)
    assert m.dtype == y.dtype == torch.bfloat16
    (m.float().sum() + y.float().sum()).backward()
    assert x.grad.dtype == torch.bfloat16
    assert spatial.launches == before
