"""The CUDA kernels against their plain versions, on the card: the prior
rollout, the training rollout's forward and backward (inputs drawn away
from ReLU kinks by kernels.parity.kink_free_inputs, a float64 run of the
plain version as the arbiter of elements fp32 cannot resolve), each at the
dcgan and KTH shapes and at cluster plans of 1, 2, 8 and 16 blocks, the
same bits on a second launch, and a plan the card cannot hold raising; the
weight-gradient pass alone at every split of its plan (dcgan, KTH, ragged
widths and N, unaligned rows) against a float64 run of the same products;
the vgg pool and upsample, forward and backward, bit for bit (ties, a NaN, a
non-contiguous input, a tensor past 2^31 elements), and the conv stage,
kernels 8 and 9 (sizes that are no tile multiple, every row on an edge,
one input channel, n_valid < N, bf16, the same bits on every run, an input
past 2^31 elements); the smoke's one-step check on the KTH model, which
must fail on a planted fault in the upsample backward; dispatch windows,
a CUDA graph of training steps against the same steps run singly; and the
offline-drop tools on the card's machine: the drop checker loading a seeded
KTH model.pt on the card (a wrong config refused), and a BAIR tree converted
from TFRecords decoded by the native PNG decoder to the records' bytes.

These tests need an NVIDIA GPU with nvcc (sm_90a); elsewhere they skip.
Run them on the card with:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import functools
import json
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from srvp_tpu_torch import train_lib, train_main
from srvp_tpu_torch.config import SRVPConfig, model_config, strict_fp32
from srvp_tpu_torch.data.device_compose import stack_batches, to_device
from srvp_tpu_torch.kernels import build as kbuild
from srvp_tpu_torch.kernels import conv_stage as kcs
from srvp_tpu_torch.kernels import launches
from srvp_tpu_torch.kernels import parity
from srvp_tpu_torch.kernels import rollout as krollout
from srvp_tpu_torch.kernels import rollout_train as krt
from srvp_tpu_torch.kernels import spatial as ksp
from srvp_tpu_torch.models.mlp import MLP
from srvp_tpu_torch.models.srvp import SRVP

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    strict_fp32()
    return torch.device("cuda")


P = krollout.Plan


@pytest.mark.parametrize("bsz,n_steps,o,ny,nz,nh,plan", [
    (160, 20, 1, 20, 20, 512, None),   # the main path's chunk (C = 8)
    (1600, 20, 1, 20, 20, 512, None),  # a whole batch (C = 1, 16-row tiles)
    (160, 60, 2, 50, 50, 512, None),   # the KTH evaluation chunk
    (600, 6, 2, 20, 12, 64, None),     # ny != nz
    (37, 10, 2, 6, 4, 24, None),       # ragged tile, narrow layers
    (5, 9, 3, 7, 5, 30, None),         # widths that are not multiples of 4
    (160, 20, 1, 20, 20, 512, P(16, 1, 10)),
    (160, 20, 1, 20, 20, 512, P(16, 2, 10)),
    (128, 20, 1, 20, 20, 512, P(16, 16, 8)),
    (37, 9, 3, 7, 5, 30, P(8, 8, 5)),   # ragged last tile, C > 1
    (37, 9, 3, 7, 5, 30, P(12, 16, 4)),  # ranks with no columns
])
def test_kernel_matches_plain(cuda, bsz, n_steps, o, ny, nz, nh, plan):
    torch.manual_seed(0)
    pz = MLP(ny, nh, 2 * nz, 4).to(cuda).linears()
    dyn = MLP(ny + nz, nh, ny, 4).to(cuda).linears()
    y0 = torch.randn(bsz, ny, device=cuda)
    eps = torch.randn(n_steps, bsz, nz, device=cuda)
    before = krollout.launches
    with torch.no_grad():
        out = krollout.prior_rollout(pz, dyn, y0, eps, ny, nz, o, plan=plan)
        again = krollout.prior_rollout(pz, dyn, y0, eps, ny, nz, o,
                                       plan=plan)
        ref = krollout.prior_rollout_reference(pz, dyn, y0, eps, ny, nz, o)
    torch.cuda.synchronize()
    assert krollout.launches == before + 2
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    assert _bits_equal(out, again)


def test_unschedulable_plan_raises(cuda):
    """A cluster the card cannot hold (32 blocks, past Hopper's 16; 16
    blocks of more shared memory than a block may have) raises before any
    launch; the plan is never quietly replaced."""
    torch.manual_seed(0)
    y0 = torch.randn(8, 4, device=cuda)
    eps = torch.randn(3, 8, 3, device=cuda)
    for nh, plan in ((8, P(4, 32, 2)), (2048, P(16, 16, 1))):
        pz = MLP(4, nh, 6, 2).to(cuda).linears()
        dyn = MLP(7, nh, 4, 2).to(cuda).linears()
        before = krollout.launches
        with pytest.raises(RuntimeError):
            krollout.prior_rollout(pz, dyn, y0, eps, 4, 3, 1, plan=plan)
        assert krollout.launches == before


def test_kernel_rejects_bad_inputs(cuda):
    pz = MLP(4, 8, 6, 2).to(cuda).linears()
    dyn = MLP(7, 8, 4, 2).to(cuda).linears()
    y0 = torch.zeros(3, 4, device=cuda)
    eps = torch.zeros(2, 3, 3, device=cuda)
    with pytest.raises(ValueError):
        krollout.prior_rollout(pz, dyn, y0.double(), eps, 4, 3)
    with pytest.raises(ValueError):
        krollout.prior_rollout(pz, dyn, y0, eps[:, :2], 4, 3)
    with pytest.raises(ValueError):
        krollout.prior_rollout(pz, dyn, y0.t().contiguous().t(), eps, 4, 3)
    with pytest.raises(ValueError):
        krollout.prior_rollout(pz, dyn, y0, eps, 4, 3, 0)


def _train_layers(cuda, nh_inf, nh, ny, nz):
    q = torch.nn.Linear(nh_inf, 2 * nz).to(cuda)
    return ((q.weight, q.bias), MLP(ny, nh, 2 * nz, 4).to(cuda).linears(),
            MLP(ny + nz, nh, ny, 4).to(cuda).linears())


@pytest.mark.parametrize("bsz,n_steps,o,ny,nz,nh_inf,nh,plan", [
    (128, 14, 1, 20, 20, 256, 512, None),   # the training step (C = 8)
    (100, 38, 2, 50, 50, 256, 512, None),   # the KTH training step
    (37, 10, 2, 20, 12, 24, 64, None),      # reused z, ny != nz
    (130, 6, 3, 7, 5, 30, 30, None),        # widths not multiples of 4
    (128, 14, 1, 20, 20, 256, 512, P(16, 1, 8)),
    (128, 14, 1, 20, 20, 256, 512, P(16, 2, 8)),
    (128, 14, 1, 20, 20, 256, 512, P(16, 8, 8)),
    (130, 6, 3, 7, 5, 30, 30, P(12, 16, 11)),  # ragged tile, empty ranks
    (37, 10, 2, 20, 12, 24, 64, P(8, 8, 5)),   # ragged last tile, C > 1
])
def test_train_kernels_match_plain(cuda, bsz, n_steps, o, ny, nz, nh_inf,
                                   nh, plan):
    """The forward and the carry pass at `plan` (both; None: each pass's
    own planner): outputs, stashed pre-activations and gradients against
    the plain version, the same bits on a second launch."""
    torch.manual_seed(0)
    q, pz, dyn = _train_layers(cuda, nh_inf, nh, ny, nz)
    gen = torch.Generator(device=cuda).manual_seed(1)
    margin = chip_smoke.KTH_KINK_MARGIN if ny == 50 else parity.KINK_MARGIN
    y0, hxz, eps, _ = parity.kink_free_inputs(q, pz, dyn, bsz, n_steps, o,
                                              gen, margin)
    flat = [t.detach() for w, b in [q, *pz, *dyn] for t in (w, b)]
    kernel = functools.partial(krt.train_rollout, fwd_plan=plan,
                               bwd_plan=plan)
    runs = []
    for fn, dtype in ((kernel, torch.float32), (kernel, torch.float32),
                      (krt.train_rollout_reference, torch.float32),
                      (krt.train_rollout_reference, torch.float64)):
        leaves = [t.to(dtype, copy=True).requires_grad_()
                  for t in [y0, hxz, *flat]]
        pairs = [(leaves[i], leaves[i + 1]) for i in range(2, len(leaves), 2)]
        before = (krt.fwd_launches, krt.bwd_launches)
        outs = fn(pairs[0], pairs[1:5], pairs[5:], leaves[0], leaves[1],
                  eps.to(dtype), o)
        grads = torch.autograd.grad(parity.rollout_loss(outs), leaves)
        runs.append((outs, grads))
        if fn is kernel:
            assert (krt.fwd_launches, krt.bwd_launches) == (
                before[0] + 1, before[1] + 2)
    # the forward alone, with its stashes: twice on the kernel, then the
    # plain version in float32 and float64
    stashed = [krt.train_rollout_forward(q, pz, dyn, y0, hxz, eps, o, plan)
               for _ in range(2)]
    for dtype in (torch.float32, torch.float64):
        lv = [t.to(dtype) for t in flat]
        pairs = [(lv[i], lv[i + 1]) for i in range(0, len(lv), 2)]
        stashed.append(krt.train_rollout_reference(
            pairs[0], pairs[1:5], pairs[5:], y0.to(dtype), hxz.to(dtype),
            eps.to(dtype), o, stash=True))
    torch.cuda.synchronize()
    # a second launch gives the same bits, forward (outputs and stashes)
    # and backward
    for a, b in zip(runs[0][0] + runs[0][1] + stashed[0],
                    runs[1][0] + runs[1][1] + stashed[1]):
        assert _bits_equal(a, b)
    for a, b in zip(runs[0][0], stashed[0]):
        assert _bits_equal(a, b)
    # each element within the tolerance of the fp32 plain result, or no
    # farther from the float64 one than that is (parity.agreement)
    for results, rtol, atol in (([r[0] for r in runs[1:]], 2e-5, 1e-6),
                                (stashed[1:], 2e-5, 1e-6),
                                ([r[1] for r in runs[1:]], 5e-4, 5e-6)):
        for i, (a, b, c) in enumerate(zip(*results)):
            assert torch.isfinite(a).all()
            worst = parity.agreement(a, b, c, rtol, atol)[1]
            assert worst <= 1.0, (rtol, i, worst)


def test_train_unschedulable_plan_raises(cuda):
    """A forward or carry-pass cluster the card cannot hold (32 blocks,
    past Hopper's 16) raises before that pass launches; the plan is never
    quietly replaced."""
    q, pz, dyn = _train_layers(cuda, 6, 8, 4, 3)
    y0 = torch.randn(8, 4, device=cuda, requires_grad=True)
    hxz = torch.randn(3, 8, 6, device=cuda)
    eps = torch.randn(3, 8, 3, device=cuda)
    bad = P(4, 32, 2)
    before = (krt.fwd_launches, krt.bwd_launches)
    with pytest.raises(RuntimeError):
        krt.train_rollout(q, pz, dyn, y0, hxz, eps, 1, fwd_plan=bad)
    with pytest.raises(RuntimeError):
        krt.train_rollout_forward(q, pz, dyn, y0, hxz, eps, 1, bad)
    assert (krt.fwd_launches, krt.bwd_launches) == before
    outs = krt.train_rollout(q, pz, dyn, y0, hxz, eps, 1, bwd_plan=bad)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(parity.rollout_loss(outs), [y0])
    assert (krt.fwd_launches, krt.bwd_launches) == (before[0] + 1, before[1])


def test_train_kernels_reject_bad_inputs(cuda):
    q, pz, dyn = _train_layers(cuda, 6, 8, 4, 3)
    y0 = torch.zeros(3, 4, device=cuda)
    hxz = torch.zeros(2, 3, 6, device=cuda)
    eps = torch.zeros(2, 3, 3, device=cuda)
    bad = [
        (y0.double(), hxz, eps, 1),
        (y0, hxz[:, :2], eps, 1),
        (y0, hxz, eps[..., :2], 1),
        (y0, hxz.cpu(), eps, 1),
        (y0, hxz, eps, 0),
        (y0[:, :3], hxz, eps, 1),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            krt.train_rollout(q, pz, dyn, *args)


# the weight-gradient pass's per-element error bound in unit roundoffs of
# sum |g a|: 16 for a chunk's FMA chain, 2 for each Kahan sum (the chunks,
# then the ranks), 1 for the final rounding, and room for the second-order
# terms (N u^2, under 1e-11 at N = 3,800)
WGRAD_BOUND_U = 24


def _shapes(ny, nz, nh_inf, nh):
    """(out, in) of q, p_z's 4 layers and the dynamics' 4 layers."""
    def mlp(din, dout):
        dims = [din, nh, nh, nh, dout]
        return [(b, a) for a, b in zip(dims, dims[1:])]
    return tuple([(2 * nz, nh_inf)] + mlp(ny, 2 * nz) + mlp(ny + nz, ny))


def _wgrad_sources(shapes, n_steps, bsz, gen, device, offset):
    """The weight-gradient pass's A sources (hxz, [y, z], the two stashes)
    and G sources (q, p_z, dynamics cotangents) for these (out, in) shapes,
    N(0, 1) (the stashes' negative values meet the ReLU); with `offset`,
    each a view one float into a larger buffer (rows not 16-byte
    aligned)."""
    widths_a, widths_g = krt.wgrad_source_widths(shapes, 4)

    def draw(w):
        n = n_steps * bsz * w
        buf = torch.randn(n + 1, generator=gen, device=device)
        return (buf[1:] if offset else buf[:n]).view(n_steps, bsz, w)
    return [draw(w) for w in widths_a], [draw(w) for w in widths_g]


@pytest.mark.parametrize("shapes,n_steps,bsz,offset", [
    (_shapes(20, 20, 256, 512), 14, 128, False),    # the dcgan step
    (_shapes(50, 50, 256, 512), 38, 100, False),    # KTH (G rows unaligned)
    (_shapes(7, 5, 30, 70), 3, 37, True),   # ragged widths and N, 4-byte
    (_shapes(20, 12, 24, 300), 2, 5, False),  # fewer chunks than ranks
], ids=["dcgan", "kth", "ragged", "short"])
@pytest.mark.parametrize("split", krollout.CLUSTERS)
def test_wgrad_kernel_matches_plain(cuda, shapes, n_steps, bsz, offset,
                                    split):
    """The weight-gradient pass at every split wgrad_plan can choose (and
    its tiles), against a float64 run of the same products, the same bits
    on a second launch. Each element within its summation's fp32 error
    bound, WGRAD_BOUND_U unit roundoffs of sum |g| |a| (float64): 16
    FMAs a chunk, the chunks, then the ranks' partials Kahan-summed, a
    final rounding; any lost or doubled row or column, or a wrong ReLU,
    is far outside it. Each layer's error at most cuBLAS's on the same
    products in fp32 (TF32 off) in L2 norm, plus one unit roundoff of the
    result's norm (short sums, where both are rounding). On N(0, 1) data an
    element-wise comparison with cuBLAS arbitrated by float64
    (parity.agreement) fails where cuBLAS lands within 1e-6 of a near-zero
    sum, though the kernel's error is the smaller in every layer's norm:
    the element-wise check runs on a model's gradients
    (test_train_kernels_match_plain, chip_smoke)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    a_src, g_src = _wgrad_sources(shapes, n_steps, bsz, gen, cuda, offset)
    before = krt.bwd_launches
    out = krt.weight_gradients(shapes, 4, a_src, g_src, split)
    again = krt.weight_gradients(shapes, 4, a_src, g_src, split)
    assert krt.bwd_launches == before + 2
    lib = krt.weight_gradients_reference(shapes, 4, a_src, g_src)
    f64 = [a.double() for a in a_src], [g.double() for g in g_src]
    ref64 = krt.weight_gradients_reference(shapes, 4, *f64)
    # the plain products of the absolute values: sum |g| |a|, at least
    # sum |g| |act(a)| (act is a ReLU or the identity)
    a_abs = [a.abs() for a in f64[0]]
    mag = krt.weight_gradients_reference(shapes, 4, a_abs,
                                         [g.abs() for g in f64[1]])
    u = 2.0 ** -24
    torch.cuda.synchronize()
    assert len(out) == 2 * len(shapes)
    for i, (a, b, c, r64, m) in enumerate(zip(out, again, lib, ref64, mag)):
        assert a.shape == r64.shape and _bits_equal(a, b)
        assert torch.isfinite(a).all()
        err = (a.double() - r64).abs()
        assert (err <= WGRAD_BOUND_U * u * m).all(), \
            (i, (err / (u * m).clamp_min(1e-300)).max().item())
        norm = err.norm().item()
        assert norm <= (c.double() - r64).norm().item() \
            + u * r64.norm().item(), (i, norm)


def test_wgrad_unschedulable_plan_raises(cuda):
    """A weight-gradient cluster the card cannot hold (32 blocks, past
    Hopper's 16) raises before the pass launches, alone or in the
    backward; the plan is never quietly replaced."""
    shapes = _shapes(4, 3, 6, 8)
    gen = torch.Generator(device=cuda).manual_seed(3)
    a_src, g_src = _wgrad_sources(shapes, 3, 8, gen, cuda, False)
    bad = 32
    before = krt.bwd_launches
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        krt.weight_gradients(shapes, 4, a_src, g_src, bad)
    assert krt.bwd_launches == before
    q, pz, dyn = _train_layers(cuda, 6, 8, 4, 3)
    y0 = torch.randn(8, 4, device=cuda, requires_grad=True)
    hxz = torch.randn(3, 8, 6, device=cuda)
    eps = torch.randn(3, 8, 3, device=cuda)
    outs = krt.train_rollout(q, pz, dyn, y0, hxz, eps, 1, wgrad_plan=bad)
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        torch.autograd.grad(parity.rollout_loss(outs), [y0])
    # the carry pass ran, the weight-gradient pass did not
    assert krt.bwd_launches == before + 1


def _bits_equal(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    same = (a.view(view) == b.view(view)) \
        | (torch.isnan(a) & torch.isnan(b))
    return bool(same.all())


def _tied(shape, gen, device, dtype=torch.float32):
    """NCHW on the card with three integer levels (most 2x2 windows tie)
    and a planted NaN."""
    x = torch.randint(0, 3, shape, generator=gen, device=device).to(dtype)
    x[0, 0, 0, 1] = float("nan")
    return x


def _spatial_counts(dtype=torch.float32):
    return tuple(ksp.launches[k, dtype] for k in ksp.KERNELS)


@pytest.mark.parametrize("shape", [
    (2000, 64, 64, 64),   # the KTH step's first pool
    (37, 5, 6, 10),       # odd counts, W not a multiple of 4
    (1, 1, 2, 2),
])
def test_spatial_kernels_match_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = _tied(shape, gen, cuda)
    before = _spatial_counts()
    m = ksp.max_pool2x2(x)
    g = torch.randn(m.shape, generator=gen, device=cuda)
    gx = ksp.max_pool2x2_bwd(x, m, g)
    y = ksp.upsample2x(x)
    gy = torch.randn(y.shape, generator=gen, device=cuda)
    gu = ksp.upsample2x_bwd(gy)
    torch.cuda.synchronize()
    assert _spatial_counts() == tuple(b + 1 for b in before)
    assert torch.isnan(m).any() and torch.isnan(gx).any()
    assert _bits_equal(m, ksp.max_pool2x2_reference(x))
    assert _bits_equal(gx, ksp.max_pool2x2_bwd_reference(x, m, g))
    assert _bits_equal(y, ksp.upsample2x_reference(x))
    assert _bits_equal(gu, ksp.upsample2x_bwd_reference(gy))


@pytest.mark.parametrize("shape", [
    (2000, 64, 64, 64),   # the KTH step's first pool
    (2000, 512, 8, 8),    # its last
    (37, 5, 6, 10),       # odd counts, W not a multiple of 4
    (1, 1, 2, 2),
])
def test_spatial_bf16_kernels_match_plain(cuda, shape):
    """Kernels 4-7 in bfloat16 (the trainer's --precision bfloat16): the
    bfloat16 entry points launch, never the float32 ones, and each output
    is bit-equal to the bfloat16 plain version (float32 inside, one
    rounding), ties and a NaN included."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _tied(shape, gen, cuda, torch.bfloat16)
    x[-1] += torch.randn(x[-1].shape, generator=gen, device=cuda).to(x.dtype)
    before, before32 = _spatial_counts(torch.bfloat16), _spatial_counts()
    m = ksp.max_pool2x2(x)
    g = torch.randn(m.shape, generator=gen, device=cuda).to(torch.bfloat16)
    gx = ksp.max_pool2x2_bwd(x, m, g)
    y = ksp.upsample2x(x)
    gy = torch.randn(y.shape, generator=gen, device=cuda).to(torch.bfloat16)
    gu = ksp.upsample2x_bwd(gy)
    torch.cuda.synchronize()
    assert _spatial_counts(torch.bfloat16) == tuple(b + 1 for b in before)
    assert _spatial_counts() == before32
    assert m.dtype == gx.dtype == y.dtype == gu.dtype == torch.bfloat16
    assert torch.isnan(m).any() and torch.isnan(gx).any()
    assert _bits_equal(m, ksp.max_pool2x2_reference(x))
    assert _bits_equal(gx, ksp.max_pool2x2_bwd_reference(x, m, g))
    assert _bits_equal(y, ksp.upsample2x_reference(x))
    assert _bits_equal(gu, ksp.upsample2x_bwd_reference(gy))


def test_spatial_bf16_autograd_through_kernels(cuda):
    """A bfloat16 vgg stage's pool and upsample under autograd go through
    the bfloat16 kernels, forward and backward, with bfloat16 gradients."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(8, 6, 16, 20, generator=gen, device=cuda).to(
        torch.bfloat16).requires_grad_()
    before = _spatial_counts(torch.bfloat16)
    y = ksp.upsample2x(ksp.max_pool2x2(x))
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert _spatial_counts(torch.bfloat16) == tuple(b + 1 for b in before)
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(
        x.grad.float()).all()


def test_spatial_autograd_matches_plain(cuda):
    """The autograd.Functions on a non-contiguous input, against the plain
    versions under autograd: torch.amax shares tied gradients as kernel 5
    does, and the upsample's autograd sums each window of N(0, 1)
    cotangents in torch's order (a few ulps of 4, so atol 2e-6)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    base = _tied((8, 6, 16, 20), gen, cuda)
    x = base.transpose(2, 3)                 # (8, 6, 20, 16), strided
    assert not x.is_contiguous()
    outs = []
    for pool, up in ((ksp.max_pool2x2, ksp.upsample2x),
                     (ksp.max_pool2x2_reference, ksp.upsample2x_reference)):
        leaf = x.detach().clone().requires_grad_()
        y = up(pool(leaf))
        g = torch.randn(y.shape, generator=torch.Generator(
            device=cuda).manual_seed(2), device=cuda)
        outs.append((y.detach(),) + torch.autograd.grad(y, leaf, g))
    assert _bits_equal(outs[0][0], outs[1][0])
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=2e-6,
                               equal_nan=True)


def test_spatial_pool_past_2_31_elements(cuda):
    """(8200, 64, 64, 64) fp32, 2.15e9 elements: 64-bit indexing, checked
    on the last frame against the plain version on that frame."""
    x = torch.randn(8200, 64, 64, 64, device=cuda)
    x[-1, -1, -2:, -2:] = 7.0
    m = ksp.max_pool2x2(x)
    assert x.numel() > 2 ** 31
    assert float(m[-1, -1, -1, -1]) == 7.0
    assert _bits_equal(m[-2:], ksp.max_pool2x2_reference(x[-2:]))
    gx = ksp.max_pool2x2_bwd(x, m, torch.ones_like(m))
    torch.cuda.synchronize()
    assert gx[-1, -1, -2:, -2:].eq(0.25).all()
    assert _bits_equal(gx[-2:], ksp.max_pool2x2_bwd_reference(
        x[-2:], m[-2:], torch.ones_like(m[-2:])))
    del gx
    y = ksp.upsample2x(m)
    assert _bits_equal(y[-2:], ksp.upsample2x_reference(m[-2:]))


def test_spatial_kernels_reject_bad_inputs(cuda):
    ok = torch.zeros(2, 3, 4, 4, device=cuda)
    for bad in (ok[:, :, :3], ok[:, :, :, :3], ok.half(), ok.double(),
                ok[0]):
        with pytest.raises(ValueError):
            ksp.max_pool2x2(bad)
    with pytest.raises(ValueError):
        ksp.upsample2x(ok.half())
    with pytest.raises(ValueError):
        ksp.max_pool2x2_bwd(ok, torch.zeros(2, 3, 2, 2, device=cuda),
                            torch.zeros(2, 3, 2, 2))


def _conv_inputs(shape, cout, gen, device, transform):
    n, cin, h, w = shape
    x = torch.randn(shape, generator=gen, device=device)
    wt = torch.randn(cout, cin, 3, 3, generator=gen, device=device) \
        * (2.0 / (9 * cin)) ** 0.5
    if not transform:
        return x, wt, None, None
    return (x, wt, 1 + 0.1 * torch.randn(cin, generator=gen, device=device),
            0.1 * torch.randn(cin, generator=gen, device=device))


def _assert_conv_matches(y, st, ref, ref64):
    """fp32: y at the rollout tolerance with the float64 plain run as
    arbiter; bf16: within one bf16 ulp (+ 1e-5) of the plain version on the
    same rounded inputs; the statistics at rtol 1e-5 / atol 1e-3 of the
    float64 sums."""
    y_ref = ref[0]
    assert y.dtype == y_ref.dtype and y.shape == y_ref.shape
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    if y.dtype == torch.float32:
        assert parity.agreement(y, y_ref, ref64[0], 1e-4, 1e-5)[1] <= 1.0
    else:
        assert parity.bf16_ulp_err(y, y_ref, 1e-5).max() <= 1.0
    torch.testing.assert_close(st.double(), ref64[1], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,act,transform,n_valid", [
    ((5, 7, 9, 13), 70, "leaky_relu", True, 3),   # no size a tile multiple
    ((3, 1, 2, 5), 64, "none", False, None),      # H = 2, cin = 1
    ((4, 64, 16, 16), 128, "tanh", True, 2),      # 128-channel tiles
    ((2, 24, 8, 40), 200, "leaky_relu", False, 1),
    ((130, 3, 1, 1), 5, "tanh", True, 129),       # 1x1 frames, ragged pixels
])
def test_conv_stage_kernel_matches_plain(cuda, dtype, shape, cout, act,
                                         transform, n_valid):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, w, scale, shift = _conv_inputs(shape, cout, gen, cuda, transform)
    x, w = x.to(dtype), w.to(dtype)
    args = (x, w, scale, shift, act, n_valid)
    before = kcs.block_launches
    y, st = kcs.conv3x3_block_fwd(*args)
    y2, st2 = kcs.conv3x3_block_fwd(*args)
    torch.cuda.synchronize()
    assert kcs.block_launches == before + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)   # deterministic
    _assert_conv_matches(y, st, kcs.conv3x3_block_fwd_reference(*args),
                         parity.conv_stage_f64(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh", [2, 8])
@pytest.mark.parametrize("shape,cout", [((3, 5, 16, 13), 70),
                                        ((2, 64, 32, 32), 64)])
def test_clamped_kernel_matches_plain(cuda, dtype, bh, shape, cout):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x, w, _, _ = _conv_inputs(shape, cout, gen, cuda, False)
    x, w = x.to(dtype), w.to(dtype)
    before = kcs.clamped_launches
    y, st = kcs.fused_conv_bn(x, w, bh)
    y2, st2 = kcs.fused_conv_bn(x, w, bh)
    torch.cuda.synchronize()
    assert kcs.clamped_launches == before + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)
    _assert_conv_matches(y, st, kcs.fused_conv_bn_reference(x, w, bh),
                         parity.conv_stage_f64(x, w, bh=bh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,n_valid", [
    ((3, 20, 16, 16), 40, 2),      # cout not a multiple of the 64 of a block
    ((4, 3, 10, 12), 64, 3),       # W = 12: no 16-byte rows in bf16
    ((2, 1, 64, 64), 64, None),    # cin = 1, the first vgg conv
    ((3, 20, 7, 13), 130, 1),      # W = 13: no 16-byte rows at all
    ((2, 1024, 8, 8), 512, 1),     # K = 9 * 1024, the 1024 -> 512 site
])
def test_conv_stage_tensor_core_tiles(cuda, dtype, shape, cout, n_valid):
    """Kernel 8's tiles at the edges of its design: ragged cout and W,
    narrow and wide cin, the longest K, n_valid < N; repeats give the same
    bits."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, w, scale, shift = _conv_inputs(shape, cout, gen, cuda, True)
    x, w = x.to(dtype), w.to(dtype)
    args = (x, w, scale, shift, "leaky_relu", n_valid)
    y, st = kcs.conv3x3_block_fwd(*args)
    y2, st2 = kcs.conv3x3_block_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)
    _assert_conv_matches(y, st, kcs.conv3x3_block_fwd_reference(*args),
                         parity.conv_stage_f64(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh", [2, 4, 8])
def test_clamped_kernel_tiles_divide_bh(cuda, dtype, bh):
    """Kernel 9 at bh 2, 4 and 8 on 64-wide frames (2-row tiles) and
    12-wide ones (bh-row tiles or their divisors)."""
    for shape in ((2, 8, 32, 64), (3, 5, 16, 12)):
        gen = torch.Generator(device=cuda).manual_seed(bh)
        x, w, _, _ = _conv_inputs(shape, 72, gen, cuda, False)
        x, w = x.to(dtype), w.to(dtype)
        y, st = kcs.fused_conv_bn(x, w, bh)
        y2, st2 = kcs.fused_conv_bn(x, w, bh)
        torch.cuda.synchronize()
        assert torch.equal(y, y2) and torch.equal(st, st2)
        _assert_conv_matches(y, st, kcs.fused_conv_bn_reference(x, w, bh),
                             parity.conv_stage_f64(x, w, bh=bh))


def test_conv_stage_past_2_31_elements(cuda):
    """(8200, 64, 64, 64) fp32 in and out, 2.15e9 elements each: 64-bit
    indexing, checked on the last frames against the plain version there
    (frames are independent; the statistics against float64 sums of y)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(8200, 64, 64, 64, generator=gen, device=cuda)
    w = torch.randn(64, 64, 3, 3, generator=gen, device=cuda) / 24
    y, st = kcs.conv3x3_block_fwd(x, w, act="none")
    torch.cuda.synchronize()
    assert x.numel() > 2 ** 31 and y.numel() > 2 ** 31
    tail = (x[-2:], w, None, None, "none")
    _assert_conv_matches(y[-2:], kcs.batch_stats(y[-2:], 2),
                         kcs.conv3x3_block_fwd_reference(*tail),
                         parity.conv_stage_f64(*tail))
    st64 = sum(kcs.batch_stats(y[i:i + 1000].double(), 1000)
               for i in range(0, 8200, 1000))
    torch.testing.assert_close(st.double(), st64, rtol=1e-5, atol=1e-3)


def test_conv_stage_kernels_reject_bad_inputs(cuda):
    x = torch.zeros(2, 3, 8, 8, device=cuda)
    w = torch.zeros(4, 3, 3, 3, device=cuda)
    s = torch.ones(3, device=cuda)
    for args, kw in (((x, w.cpu()), {}), ((x.double(), w.double()), {}),
                     ((x, w), dict(scale=s.cpu(), shift=s)),
                     ((x, w.bfloat16()), {}), ((x[0], w), {})):
        with pytest.raises(ValueError):
            kcs.conv3x3_block_fwd(*args, **kw)
    with pytest.raises(ValueError):
        kcs.fused_conv_bn(x, w, 3)


UP_BWD_SUM = "gx[o] = narrow<T>((a.x + b.x) + (a.y + b.y));"


def test_kth_step_check_fails_on_a_planted_fault(cuda, tmp_path, monkeypatch):
    """chip_smoke.check_step as the smoke runs it on the KTH model (full
    width, 25 videos of a batch of the synthetic packed tree, every gradient
    in L2 norm), from seeded random weights: it passes with the kernels as
    built, and fails once kernel 7's window sum is scaled by 1 + 1e-3, a
    fault far below the TF32 control's error. Both readings are printed."""
    cfg = chip_smoke.KTH_CONFIG
    chip_smoke.write_kth_packed_tree(tmp_path, cfg["nx"], chip_smoke.SEED + 4)
    opt = chip_smoke.train_args(str(tmp_path / "xp"), str(tmp_path), 1,
                                cfg=cfg,
                                batch_size=chip_smoke.KTH_TRAIN_BATCH)
    state = chip_smoke.seeded_state(opt)
    batch = next(iter(train_main.loaders(opt)[0]))
    batch = to_device(batch[:, :chip_smoke.KTH_CHECK_VIDEOS], "cuda")

    def check():
        return chip_smoke.check_step(opt, state, batch,
                                     chip_smoke.KTH_KINK_MARGIN,
                                     chip_smoke.KTH_STEP_HELD)

    print("sound", check())
    csrc = tmp_path / "csrc"
    shutil.copytree(kbuild.CSRC_DIR, csrc)
    src = csrc / "spatial.cu"
    text = src.read_text()
    assert text.count(UP_BWD_SUM) == 1
    src.write_text(text.replace(UP_BWD_SUM, "gx[o] = narrow<T>(((a.x + b.x) "
                                            "+ (a.y + b.y)) * 1.001f);"))
    monkeypatch.setattr(kbuild, "CSRC_DIR", csrc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kbuild, "LIB_PATH", tmp_path / "build" / "lib.so")
    monkeypatch.setattr(kbuild, "_lib", None)
    with pytest.raises(SystemExit, match="disagrees") as fault:
        check()
    print("planted", fault.value)


def _window_run(cfg, hp, batches, k, seed):
    """A train state from `seed` trained on `batches`: as windows of k
    steps (k > 1: the first eager, then one CUDA graph replayed) or as
    single steps (k = 1). Returns the state, the last step's metrics and
    the launches counted."""
    torch.manual_seed(seed)
    ts = train_lib.init_train_state(cfg, hp, "cuda")
    ts.generator = torch.Generator(device="cuda").manual_seed(seed)
    launches.reset()
    if k == 1:
        for b in batches:
            m = train_lib.train_step(ts, to_device(b, "cuda"), hp,
                                     generator=ts.generator)
    else:
        window = train_lib.WindowStep(ts, hp, k)
        for j in range(0, len(batches), k):
            m = window(to_device(stack_batches(batches[j:j + k]), "cuda"))
        assert window.graph is not None
    torch.cuda.synchronize()
    return ts, m, launches.counts()


@pytest.mark.parametrize("archi,dtype", [("dcgan", torch.float32),
                                         ("vgg", torch.bfloat16)])
def test_window_graph_matches_single_steps(cuda, archi, dtype, monkeypatch):
    """Three windows of two steps (the first eager, then one CUDA graph
    captured and replayed twice) against six single steps from the same
    state and generator, at small widths: parameters, batch-norm
    statistics, Adam's state and the last loss bit for bit, the generator
    advanced alike (the graph draws from it: registered, not frozen), and
    the kernels' launches counted per replay exactly as six steps launch
    them (kernels 2-3; on vgg 4-7 in the compute dtype). cuDNN runs its
    deterministic algorithms, as the trainer's resume needs."""
    cfg = SRVPConfig(archi=archi, skipco=archi == "vgg", nf=4, nhx=8, ny=4,
                     nz=4, nt_inf=2, nh_inf=8, nlayers_inf=2, nh_res=16,
                     nlayers_res=2)
    hp = train_lib.TrainHParams(nt_cond=3, lr=1e-3, lr_burnin=3,
                                lr_decay_iter=6, compute_dtype=dtype,
                                oversampling=2 if archi == "vgg" else 1)
    batches = [np.random.RandomState(j).randint(
        0, 256, (6, 3, 64, 64, 1)).astype(np.uint8) for j in range(6)]
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    ref, m_ref, n_ref = _window_run(cfg, hp, batches, 1, 7)
    got, m_got, n_got = _window_run(cfg, hp, batches, 2, 7)
    assert got.step == ref.step == 6 and m_got["lr"] == m_ref["lr"]
    assert torch.equal(got.generator.get_state(), ref.generator.get_state())
    assert torch.equal(m_got["loss"], m_ref["loss"])
    sd_ref = {**ref.model.state_dict(),
              **_adam_tensors(ref.optimizer.state_dict())}
    sd_got = {**got.model.state_dict(),
              **_adam_tensors(got.optimizer.state_dict())}
    differ = {n: float((sd_got[n].double() - sd_ref[n].double()).abs().max())
              for n in sd_ref if not torch.equal(sd_got[n], sd_ref[n])}
    print(f"{archi} {dtype}: {len(differ)} of {len(sd_ref)} tensors differ, "
          f"max |diff| {max(differ.values(), default=0.0):.3e}")
    assert not differ
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    vgg = 4 if archi == "vgg" else 0
    expected = {"train_rollout_fwd": 6, "train_rollout_bwd": 12,
                **{f"{k}{sfx}": 6 * vgg for k in (
                    "maxpool_fwd", "maxpool_bwd", "upsample_fwd",
                    "upsample_bwd")}}
    for counts in (n_ref, n_got):
        assert {k: v for k, v in counts.items() if v} == \
            {k: v for k, v in expected.items() if v}


def _adam_tensors(sd):
    return {f"adam/{i}/{k}": v for i, st in sd["state"].items()
            for k, v in st.items()}


def test_graph_safe_adam_is_adam_bit_for_bit(cuda):
    """train_lib.graph_safe_adam, Adam's step with its host scalars read
    from the device (what a window's graph captures), against
    torch.optim.Adam's own step on the card: the same bits over steps of
    changing learning rate and gradients of every scale, from a fresh
    state; torch's capturable Adam, the control, lands elsewhere."""
    shapes = [(64, 1, 4, 4), (64,), (128, 64, 4, 4), (512, 512), (40, 256),
              (7,)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    init = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
    runs = {k: [p.clone().requires_grad_() for p in init]
            for k in ("adam", "safe", "capturable")}
    opts = {"adam": torch.optim.Adam(runs["adam"]),
            "safe": torch.optim.Adam(runs["safe"]),
            "capturable": torch.optim.Adam(runs["capturable"],
                                           capturable=True)}
    for step, lr in enumerate([3e-4, 3e-4, 2.9e-4, 1.7e-4, 1e-3]):
        grads = [torch.randn(s, device="cuda", generator=gen)
                 * 10.0 ** (step % 4 * -3) for s in shapes]
        for kind, opt in opts.items():
            for p, g in zip(runs[kind], grads):
                p.grad = g.clone()
            if kind == "safe":
                scalars = train_lib.adam_scalars(opt, [lr])
                train_lib.graph_safe_adam(
                    opt, torch.tensor(scalars[0], device="cuda"))
                for st in opt.state.values():
                    st["step"] += 1
            else:
                opt.param_groups[0]["lr"] = lr
                opt.step()
    differ = {kind: sum(int((p != q).sum()) for p, q in zip(
        runs[kind], runs["adam"])) for kind in ("safe", "capturable")}
    print(f"elements that differ from Adam's step: {differ} of "
          f"{sum(p.numel() for p in init)}")
    assert differ["safe"] == 0 and differ["capturable"] > 0
    for a, b in zip(opts["adam"].state.values(), opts["safe"].state.values()):
        assert all(torch.equal(a[k], b[k])
                   for k in ("step", "exp_avg", "exp_avg_sq"))


def test_verify_artifacts_loads_checkpoint_on_the_card(cuda, tmp_path):
    from srvp_tpu_torch import verify_artifacts
    xp = tmp_path / "checkpoints" / "kth"
    xp.mkdir(parents=True)
    cfg = chip_smoke.KTH_CONFIG
    (xp / "config.json").write_text(json.dumps(cfg))
    torch.manual_seed(0)
    torch.save(SRVP(model_config(cfg)).state_dict(), xp / "model.pt")
    rows, ok = verify_artifacts.verify_drop(str(tmp_path))
    assert ok and rows[0]["detail"].endswith("loaded on cuda"), rows
    (xp / "config.json").write_text(json.dumps(dict(cfg, archi="dcgan",
                                                    skipco=False)))
    rows, ok = verify_artifacts.verify_drop(str(tmp_path))
    assert not ok and rows[0]["status"] == "INVALID", rows


def test_converted_bair_tree_decodes_natively(cuda, tmp_path):
    from srvp_tpu_torch.data import convert, native, synthetic
    from srvp_tpu_torch.data.bair import BAIR
    videos = synthetic.write_bair_download(tmp_path, 1, 5)
    convert.main(["bair", "--data_dir", str(tmp_path)])
    fold = BAIR.make_dataset(str(tmp_path), 30, train=False)
    before = native.decoded["frames"]
    got = fold.get_batch_seeded(list(range(5)), [0] * 5)
    assert native.decoded["frames"] - before == 5 * 30
    want = [videos[k] for k in sorted(k for k in videos if k[0] == "test")]
    np.testing.assert_array_equal(got, np.stack(want))
