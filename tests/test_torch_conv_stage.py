"""The plain versions of the conv-stage kernels (the port's
kernels/conv_stage.py, which the wrappers run on CPU tensors) against the
JAX package on the CPU: kernel 8, srvp_tpu/ops/pallas/conv_stage.py
`conv3x3_block_fwd`, and kernel 9, scripts/microbench_conv.py
`fused_conv_bn`, both in interpret mode, edge rows included.

Inputs are drawn with numpy in the JAX layouts (x channel-major (cin, H, W,
N), w HWIO) and carried into the port by a permute and the port's own
weight converter (utils/weights.conv_w). Tolerances are the JAX suite's
own (tests/test_conv_stage.py): y atol 2e-5, statistics rtol 1e-5 /
atol 1e-3, the two-block chain atol 3e-4.
"""

import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from scripts import microbench_conv
from srvp_tpu.ops.pallas import conv_stage as pallas
from srvp_tpu_torch import bench_conv_stage
from srvp_tpu_torch.kernels import conv_stage, parity
from srvp_tpu_torch.utils.weights import conv_w

Y_ATOL, ST_RTOL, ST_ATOL = 2e-5, 1e-5, 1e-3
N, N_VALID = 128, 100        # the Pallas kernel's lane block; padded frames


def nchw(a):
    """JAX channel-major (C, H, W, N) -> the port's (N, C, H, W)."""
    return torch.from_numpy(np.array(a)).permute(3, 0, 1, 2)


def draw(cin, cout, h, w, seed, garbage=True):
    """x (cin, h, w, N) with garbage in the frames >= N_VALID, w HWIO."""
    rng = np.random.RandomState(seed)
    x = rng.randn(cin, h, w, N).astype(np.float32)
    if garbage:
        x[..., N_VALID:] = 7.7
    wgt = (0.3 * rng.randn(3, 3, cin, cout)).astype(np.float32)
    return x, wgt, rng


def assert_same(ours, ref, atol=Y_ATOL):
    y, st = ours
    y_ref, st_ref = ref
    np.testing.assert_allclose(y.numpy(), nchw(y_ref).numpy(), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=ST_RTOL,
                               atol=ST_ATOL)


@pytest.mark.parametrize("transform", [False, True])
@pytest.mark.parametrize("act", ["none", "leaky_relu", "tanh"])
@pytest.mark.parametrize("hwb", [(16, 8, 2), (16, 8, 4), (8, 16, 2)])
def test_block_fwd_matches_pallas(hwb, act, transform):
    """Kernel 8's plain version against the Pallas kernel, every row and
    column; the statistics leave out the garbage frames (except with
    act='none' and no transform, which runs without n_valid, as the first
    vgg block does)."""
    h, w, bh = hwb
    cin, cout = 8, 16
    x, wgt, rng = draw(cin, cout, h, w, seed=h + w + bh)
    n_valid = None if act == "none" and not transform else N_VALID
    scale = (rng.rand(cin) + 0.5).astype(np.float32) if transform else None
    shift = (0.3 * rng.randn(cin)).astype(np.float32) if transform else None
    ref = pallas.conv3x3_block_fwd(
        jnp.asarray(x), jnp.asarray(wgt),
        None if scale is None else jnp.asarray(scale),
        None if shift is None else jnp.asarray(shift), act=act,
        n_valid=n_valid, bh=bh, bn=128, interpret=True)
    ours = conv_stage.conv3x3_block_fwd(
        nchw(x), conv_w(wgt),
        None if scale is None else torch.from_numpy(scale),
        None if shift is None else torch.from_numpy(shift), act=act,
        n_valid=n_valid)
    assert ours[0].dtype == torch.float32 and ours[0].shape == (N, cout, h, w)
    assert ours[1].dtype == torch.float32 and ours[1].shape == (cout, 2)
    assert_same(ours, ref)


def test_two_block_chain_matches_pallas():
    """conv -> bn_scale_shift -> conv with the normalize and LeakyReLU on
    the load, as tests/test_conv_stage.py:51-91 chains the Pallas kernel,
    with garbage in the padded frames."""
    cin, cmid, cout, h, w = 4, 8, 8, 8, 8
    x, w1, rng = draw(cin, cmid, h, w, seed=1)
    w2 = (0.4 * rng.randn(3, 3, cmid, cout)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(cmid)).astype(np.float32)
    beta = (0.1 * rng.randn(cmid)).astype(np.float32)

    y1, st1 = pallas.conv3x3_block_fwd(jnp.asarray(x), jnp.asarray(w1),
                                       n_valid=N_VALID, bh=2, bn=128,
                                       interpret=True)
    sc, sh = pallas.bn_scale_shift(st1, jnp.asarray(gamma),
                                   jnp.asarray(beta), N_VALID, h * w)
    ref2 = pallas.conv3x3_block_fwd(y1, jnp.asarray(w2), scale=sc, shift=sh,
                                    n_valid=N_VALID, bh=2, bn=128,
                                    interpret=True)

    o1, ost1 = conv_stage.conv3x3_block_fwd(nchw(x), conv_w(w1),
                                            n_valid=N_VALID)
    osc, osh = conv_stage.bn_scale_shift(ost1, torch.from_numpy(gamma),
                                         torch.from_numpy(beta), N_VALID,
                                         h * w)
    ours2 = conv_stage.conv3x3_block_fwd(o1, conv_w(w2), osc, osh,
                                         n_valid=N_VALID)
    assert_same((o1, ost1), (y1, st1))
    y2, st2 = ours2
    np.testing.assert_allclose(y2.numpy(), nchw(ref2[0]).numpy(), atol=3e-4,
                               rtol=0)
    np.testing.assert_allclose(st2.numpy(), np.asarray(ref2[1]), rtol=1e-4,
                               atol=1e-2)


@pytest.mark.parametrize("bh", [2, 4])
def test_clamped_matches_prototype(bh):
    """Kernel 9's plain version against the microbenchmark's Pallas kernel
    on every row, the clamped edge row blocks included (they differ from
    the exact conv there, which the test also shows)."""
    cin, cout, h, w = 4, 8, 16, 8
    x, wgt, _ = draw(cin, cout, h, w, seed=10 + bh, garbage=False)
    ref = microbench_conv.fused_conv_bn(jnp.asarray(x), jnp.asarray(wgt),
                                        bh=bh, bn=128, interpret=True)
    ours = conv_stage.fused_conv_bn(nchw(x), conv_w(wgt), bh=bh)
    assert_same(ours, ref)
    exact, _ = conv_stage.conv3x3_block_fwd(nchw(x), conv_w(wgt), act="none")
    edge = (ours[0] - exact).abs().amax(dim=(0, 1, 3))
    assert (edge[:bh] > 1e-3).all() and (edge[-bh:] > 1e-3).all()
    assert float(edge[bh:-bh].max()) <= Y_ATOL


def test_clamped_rows():
    """The centre row of each output row's taps, as conv_bn_kernel's
    row0 = clip(i*bh - 1, 0, h - bh - 2) places its (bh + 2)-row slab."""
    for h, bh in ((16, 2), (16, 4), (16, 8), (8, 4), (3, 1)):
        rows = conv_stage.clamped_rows(h, bh).tolist()
        for r in range(h):
            i = r // bh
            row0 = min(max(i * bh - 1, 0), h - bh - 2)
            assert rows[r] == row0 + 1 + r - i * bh
            assert 1 <= rows[r] <= h - 2


def test_bn_scale_shift_matches_pallas():
    rng = np.random.RandomState(3)
    c, count = 12, 100 * 64
    mean = rng.randn(c).astype(np.float32)
    var = (rng.rand(c) + 0.2).astype(np.float32)
    stats = np.stack([count * mean, count * (var + mean * mean)],
                     1).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    ref = pallas.bn_scale_shift(jnp.asarray(stats), jnp.asarray(gamma),
                                jnp.asarray(beta), 100, 64)
    ours = conv_stage.bn_scale_shift(torch.from_numpy(stats),
                                     torch.from_numpy(gamma),
                                     torch.from_numpy(beta), 100, 64)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("act", ["leaky_relu", "none"])
def test_bfloat16_rounds_before_the_products(act):
    """bf16 storage: the transform and activation in fp32, rounded to bf16
    before the products, fp32 accumulation, y rounded to bf16 and the
    statistics from the fp32 accumulator, as the Pallas kernel does. y
    within one bf16 ulp (two fp32 sums in another order can round to
    neighbouring bf16 values)."""
    cin, cout, h, w = 8, 16, 16, 8
    x, wgt, rng = draw(cin, cout, h, w, seed=21)
    scale = (rng.rand(cin) + 0.5).astype(np.float32)
    shift = (0.3 * rng.randn(cin)).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wgt, jnp.bfloat16)
    y_ref, st_ref = pallas.conv3x3_block_fwd(
        xb, wb, jnp.asarray(scale), jnp.asarray(shift), act=act,
        n_valid=N_VALID, bh=2, bn=128, interpret=True)
    y, st = conv_stage.conv3x3_block_fwd(
        nchw(np.asarray(xb.astype(jnp.float32))).bfloat16(),
        conv_w(np.asarray(wb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(shift), act=act,
        n_valid=N_VALID)
    assert y.dtype == torch.bfloat16
    ref = nchw(np.asarray(y_ref.astype(jnp.float32)))
    assert parity.bf16_ulp_err(y, ref, 1e-6).max() <= 1.0
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=ST_RTOL,
                               atol=ST_ATOL)


def test_float64_plain_run():
    """The plain versions in float64 (the card checks' arbiter) give the
    float32 results within fp32 rounding."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 6, 8, 5).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.randn(7, 6, 3, 3)).astype(np.float32))
    for fn, kw in ((conv_stage.conv3x3_block_fwd_reference,
                    dict(act="tanh", n_valid=2)),
                   (conv_stage.fused_conv_bn_reference, dict(bh=2))):
        y32, st32 = fn(x, w, **kw)
        y64, st64 = fn(x.double(), w.double(), **kw)
        assert y64.dtype == st64.dtype == torch.float64
        np.testing.assert_allclose(y32.numpy(), y64.numpy(), atol=1e-5)
        np.testing.assert_allclose(st32.numpy(), st64.numpy(), rtol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 3, 8, 8)
    w = torch.zeros(4, 3, 3, 3)
    s = torch.ones(3)
    bad = [
        (x.double(), w.double(), {}), (x.half(), w.half(), {}),
        (x[0], w, {}), (x, w[:, :2], {}), (x, w.bfloat16(), {}),
        (x, w[..., :2], {}),
        (x.to("meta"), w.to("meta"), {}),
        (x, w, dict(scale=s)), (x, w, dict(scale=s[:2], shift=s[:2])),
        (x, w, dict(n_valid=3)), (x, w, dict(n_valid=-1)),
        (x, w, dict(act="relu")),
    ]
    for xb, wb, kw in bad:
        with pytest.raises(ValueError):
            conv_stage.conv3x3_block_fwd(xb, wb, **kw)
    for xb, wb, bh in ((x, w, 3), (x, w, 8), (x[:, :, :2], w, 1),
                       (x.double(), w.double(), 2), (x, w[:, :1], 2)):
        with pytest.raises(ValueError):
            conv_stage.fused_conv_bn(xb, wb, bh)


def test_cpu_wrappers_launch_nothing():
    before = (conv_stage.block_launches, conv_stage.clamped_launches)
    x, w = torch.randn(2, 3, 8, 8), torch.randn(4, 3, 3, 3)
    conv_stage.conv3x3_block_fwd(x, w)
    conv_stage.fused_conv_bn(x, w, 2)
    assert (conv_stage.block_launches, conv_stage.clamped_launches) == before


def test_bench_on_the_cpu(capsys):
    """The bench's CLI at tiny dims on the CPU (kernel 8 and cuDNN's
    counterpart, then the library leg profiled and kernel 9 in bf16), and
    its refusal of CUDA where there is none."""
    tiny = ["--device", "cpu", "--c", "4", "--hw", "8", "--n", "3",
            "--inner", "2", "--reps", "1"]
    proc = subprocess.run(
        [sys.executable, "-m", "srvp_tpu_torch.bench_conv_stage", *tiny,
         "--transform", "--act", "tanh", "--cudnn"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 2 and lines[0].startswith("kernel8[T act=tanh]")
    assert lines[1].startswith("cudnn") and "host CPU time" in lines[1]
    out = bench_conv_stage.run(bench_conv_stage.create_args().parse_args(
        tiny + ["--clamped", "--bh", "2", "--dtype", "bfloat16",
                "--cudnn_only", "--profile"]))
    assert list(out) == ["cudnn"]
    assert "aten::" in capsys.readouterr().out     # the profiler's table
    out = bench_conv_stage.run(bench_conv_stage.create_args().parse_args(
        tiny + ["--clamped", "--bh", "4", "--dtype", "bfloat16"]))
    assert list(out) == ["kernel9[clamped bh=4]"] and out[
        "kernel9[clamped bh=4]"] > 0
    capsys.readouterr()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench_conv_stage.main(tiny[2:])


# --- the tensor-core design of csrc/conv_stage.cu, emulated on the CPU ---

def tf32(a):
    """float32 -> TF32 (10 explicit mantissa bits), rounded to nearest with
    ties away from zero, as cvt.rna.tf32.f32; returned as float32."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (sign | mag).astype(np.uint32).view(np.float32)


def test_tf32_rounding_of_the_emulation():
    one_ulp = np.float32(2.0 ** -10)
    assert tf32(np.float32(1 + one_ulp)) == 1 + one_ulp
    assert tf32(np.float32(1 + one_ulp / 2)) == 1 + one_ulp   # tie: away
    assert tf32(np.float32(1 + one_ulp / 2 - 2 ** -23)) == 1
    assert tf32(np.float32(-(1 + one_ulp / 2))) == -(1 + one_ulp)


def three_term_sums(a, w, terms):
    """(M,) sums over K of a (M, K) times w (K,) from the TF32 split: with
    3 terms a_s w_b + a_b w_s + a_b w_b, with 1 term a_b w_b; each product
    of TF32 values exact in float64 and summed in float64."""
    ab, wb = tf32(a), tf32(w)
    as_, ws = tf32(a - ab), tf32(w - wb)
    f = lambda u, v: u.astype(np.float64) @ v.astype(np.float64)  # noqa
    if terms == 1:
        return f(ab, wb)
    return f(as_, wb) + f(ab, ws) + f(ab, wb)


def test_three_tf32_terms_hold_fp32_accuracy_at_k_9216():
    """At the 1024-channel vgg site K = 9 * 1024: activations after
    LeakyReLU against He-scaled weights. The 3xTF32 product is within a
    small part of the card checks' rtol 1e-4 / atol 1e-5 of float64; one
    TF32 term (the small ones dropped) is not within it. (This draw reads
    0.011 and 63.)"""
    rng = np.random.RandomState(0)
    k = 9 * 1024
    a = rng.randn(256, k).astype(np.float32)
    a = np.maximum(a, np.float32(0.2) * a)
    w = (rng.randn(k) * np.sqrt(2.0 / k)).astype(np.float32)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    tol = 1e-5 + 1e-4 * np.abs(exact)
    err3 = np.abs(three_term_sums(a, w, 3) - exact) / tol
    err1 = np.abs(three_term_sums(a, w, 1) - exact) / tol
    assert err3.max() < 0.1
    assert err1.max() > 1.0


def test_every_bfloat16_value_is_exact_in_tf32():
    bits = np.arange(2 ** 16, dtype=np.uint32) << 16
    v = bits.view(np.float32)
    v = v[np.isfinite(v)]
    np.testing.assert_array_equal(tf32(v), v)
    as_torch = torch.from_numpy(v).bfloat16().float().numpy()
    np.testing.assert_array_equal(as_torch, v)


def emulate_tiles(x, w, scale=None, shift=None, act="none", bh=None):
    """y as csrc/conv_stage.cu computes it, tile by tile, from the
    wrapper's tile plan and packed weights: each tile stages its halo
    [F][cin][R + 2][WT + 2] (rows from in_row0, exact or clamped; zero
    outside the image, after the activation) and sums the 9 taps of
    shifted slices times the packed (cin, 3, 3, cout) weights. Checks
    that the tiles cover every output once."""
    n, cin, h, ww = x.shape
    rows, frames, cols, n_tiles = conv_stage.tile_plan(n, h, ww, bh,
                                                       x.dtype)
    assert rows * frames * cols <= conv_stage.TILE_M
    assert frames == 1 or rows == h
    if bh is not None:
        assert bh % rows == 0 and frames == 1
    wt = conv_stage.packed_weights(w).double()
    v = conv_stage.activated_input(x, scale, shift, act).double()
    fgs, rbs, cbs = -(-n // frames), -(-h // rows), -(-ww // cols)
    assert n_tiles == fgs * rbs * cbs
    y = torch.zeros(n, w.shape[0], h, ww, dtype=torch.float64)
    cover = torch.zeros(n, h, ww, dtype=torch.int64)
    for tile in range(n_tiles):
        cb, rb, fg = tile % cbs, (tile // cbs) % rbs, tile // (cbs * rbs)
        f0, r0, c0 = fg * frames, rb * rows, cb * cols
        in_row0 = r0 - 1
        if bh is not None:
            b = r0 // bh
            in_row0 = min(max(b * bh - 1, 0), h - bh - 2) + r0 - b * bh
        stage = torch.zeros(frames, cin, rows + 2, cols + 2,
                            dtype=torch.float64)
        for f in range(frames):
            for rr in range(rows + 2):
                row = in_row0 + rr
                if f0 + f >= n or not 0 <= row < h:
                    continue
                for cc in range(cols + 2):
                    col = c0 - 1 + cc
                    if 0 <= col < ww:
                        stage[f, :, rr, cc] = v[f0 + f, :, row, col]
        out = sum(torch.einsum("fcrw,co->forw",
                               stage[:, :, dy:dy + rows, dx:dx + cols],
                               wt[:, dy, dx, :])
                  for dy in range(3) for dx in range(3))
        nf, nr, nc = min(frames, n - f0), min(rows, h - r0), min(cols,
                                                                  ww - c0)
        y[f0:f0 + nf, :, r0:r0 + nr, c0:c0 + nc] = out[:nf, :, :nr, :nc]
        cover[f0:f0 + nf, r0:r0 + nr, c0:c0 + nc] += 1
    assert bool((cover == 1).all())
    return y


@pytest.mark.parametrize("shape", [(5, 3, 9, 13), (3, 1, 2, 5),
                                   (130, 2, 1, 1), (2, 3, 8, 40),
                                   (3, 2, 8, 8), (2, 2, 3, 150),
                                   (2, 4, 16, 16)])
def test_tile_plan_and_weight_packing_reproduce_kernel_8(shape):
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(*shape))
    # float32 weights (packed_weights gives the kernels float32)
    w = torch.from_numpy(0.3 * rng.randn(5, shape[1], 3, 3)).float().double()
    scale = torch.from_numpy(rng.rand(shape[1]) + 0.5)
    shift = torch.from_numpy(0.3 * rng.randn(shape[1]))
    ref, _ = conv_stage.conv3x3_block_fwd_reference(x, w, scale, shift,
                                                    "leaky_relu")
    got = emulate_tiles(x, w, scale, shift, "leaky_relu")
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bh", [2, 4, 8])
@pytest.mark.parametrize("hw", [(16, 13), (32, 32), (16, 64)])
def test_tile_plan_and_weight_packing_reproduce_kernel_9(bh, hw):
    rng = np.random.RandomState(bh + hw[1])
    x = torch.from_numpy(rng.randn(2, 3, *hw))
    w = torch.from_numpy(0.3 * rng.randn(4, 3, 3, 3)).float().double()
    ref, _ = conv_stage.fused_conv_bn_reference(x, w, bh)
    torch.testing.assert_close(emulate_tiles(x, w, bh=bh), ref, rtol=1e-12,
                               atol=1e-12)


def test_tile_plan_at_the_vgg_sites():
    """The tiles of the KTH vgg sites (N = 2000): 128 pixels each, as
    whole rows (W 64, 32, 16) or two whole 8 x 8 frames; kernel 9 at bh 8
    takes 2 rows of 64, which divide bh."""
    for hw, want in ((64, (2, 1, 64)), (32, (4, 1, 32)), (16, (8, 1, 16)),
                     (8, (8, 2, 8))):
        for dt in (torch.float32, torch.bfloat16):
            plan = conv_stage.tile_plan(2000, hw, hw, dtype=dt)
            assert plan[:3] == want
            assert plan[3] == 2000 * hw * hw // 128
    assert conv_stage.tile_plan(2000, 64, 64, 8)[:3] == (2, 1, 64)
    assert conv_stage.tile_plan(3, 16, 13, 2)[:3] == (2, 1, 13)
    # a channel's staged pitch is 8 modulo 32 (bank-conflict-free loads)
    for args in ((2, 1, 64, 4), (8, 2, 8, 4), (2, 1, 64, 2), (3, 1, 13, 2)):
        assert conv_stage.staged_pitch(*args) % 32 == 8
