"""Holding a kernel against its plain version on the card, at full size.

Two things make an elementwise comparison of two fp32 results fail there
without a fault of either: a ReLU input within rounding of 0, where the
gradient jumps and two summation orders can land on different sides, and a
long sum that cancels, which fp32 does not resolve. `kink_free_inputs` (with
`redraw_rows`) draws inputs away from the first; `agreement` takes a float64
run of the plain version as the arbiter of the second (`conv_stage_f64`
gives the conv stage's). A bf16 result is held in its own ulps
(`bf16_ulp_err`). chip_smoke.py and tests/test_torch_cuda.py use them.
"""

import torch
import torch.nn.functional as F

from srvp_tpu_torch.kernels import conv_stage as kcs
from srvp_tpu_torch.ops.dists import rsample

KINK_MARGIN, KINK_ROUNDS = 1e-5, 200


def rollout_loss(outs):
    """A loss that touches every output of the training rollout
    (tests/test_pallas_train.py)."""
    ys, res, qp, pp, zs = outs
    return ((ys * 0.3).sum() + (res ** 2).sum() + torch.tanh(qp).sum()
            + (pp * 0.1).sum() + (zs * 0.05).sum())


def agreement(out, ref, ref64, rtol, atol, others=()):
    """Elementwise agreement of `out` with the fp32 plain result `ref`, as
    (worst raw error over tolerance, worst arbitrated error over tolerance,
    elements excused). An element also agrees if it is no farther from the
    float64 plain result `ref64` than `ref` is, beyond the same tolerance:
    an element fp32 cannot resolve does not count against `out`, an error of
    its own does. `others` are more fp32 plain results of the same function
    in other summation orders (a batch in another row order): an element
    also agrees if it is no farther from `ref64` than one of them is. The
    excused elements are those over the tolerance raw and within it
    arbitrated."""
    raw = ((out - ref).abs() / (atol + rtol * ref.abs())).double()
    fp32_err = (ref.double() - ref64).abs()
    for other in others:
        fp32_err = torch.maximum(fp32_err, (other.double() - ref64).abs())
    excess = ((out.double() - ref64).abs() - fp32_err) \
        / (atol + rtol * ref64.abs())
    judged = torch.minimum(raw, excess)
    return (raw.max().item(), judged.max().item(),
            int(((raw > 1) & (judged <= 1)).sum()))


@torch.no_grad()
def rows_near_kink(q_layer, pz_layers, dyn_layers, y0, hxz, eps,
                   oversampling, margin=KINK_MARGIN):
    """(B,) bool: the rows whose plain training-rollout forward puts a hidden
    pre-activation within `margin` of the ReLU kink, relative to that
    layer's largest magnitude at that substep."""
    near = torch.zeros(y0.shape[0], dtype=torch.bool, device=y0.device)
    y, z = y0, None
    for k in range(eps.shape[0]):
        if k % oversampling == 0:
            z = rsample(F.linear(hxz[k], *q_layer), eps[k])
        for layers, h in ((pz_layers, y), (dyn_layers, torch.cat([y, z], -1))):
            for il, (w, b) in enumerate(layers):
                if il > 0:
                    near |= (h.abs() < margin * h.abs().max()).any(1)
                    h = torch.relu(h)
                h = F.linear(h, w, b)
        y = y + h / oversampling
    return near


def redraw_rows(fill, near, bsz, device):
    """Draws all `bsz` rows with fill(mask, n), then draws again the rows
    that near() flags, until it flags none. Returns the number of rows drawn
    again."""
    redraw = torch.ones(bsz, dtype=torch.bool, device=device)
    redrawn = -bsz
    for _ in range(KINK_ROUNDS):
        if not redraw.any():
            return redrawn
        n = int(redraw.sum())
        redrawn += n
        fill(redraw, n)
        redraw = near()
    raise RuntimeError(f"rows still near a ReLU kink after {KINK_ROUNDS} "
                       "rounds of drawing")


def kink_free_inputs(q_layer, pz_layers, dyn_layers, bsz, n_steps,
                     oversampling, gen, margin=KINK_MARGIN):
    """y0 (0.1 N(0, 1)), hxz and eps (N(0, 1)) for the training rollout, on
    the generator's device, with no row near a kink (rows_near_kink at
    `margin`). Returns them and the number of rows drawn again."""
    nh_inf, ny = q_layer[0].shape[1], pz_layers[0][0].shape[1]
    nz = q_layer[0].shape[0] // 2
    dev = gen.device
    y0 = torch.empty(bsz, ny, device=dev)
    hxz = torch.empty(n_steps, bsz, nh_inf, device=dev)
    eps = torch.empty(n_steps, bsz, nz, device=dev)

    def fill(mask, n):
        y0[mask] = 0.1 * torch.randn(n, ny, generator=gen, device=dev)
        hxz[:, mask] = torch.randn(n_steps, n, nh_inf, generator=gen,
                                   device=dev)
        eps[:, mask] = torch.randn(n_steps, n, nz, generator=gen, device=dev)

    redrawn = redraw_rows(
        fill, lambda: rows_near_kink(q_layer, pz_layers, dyn_layers, y0, hxz,
                                     eps, oversampling, margin), bsz, dev)
    return y0, hxz, eps, redrawn


def bf16_ulp_err(out, ref, atol):
    """Elementwise |out - ref| over (one bf16 ulp of the larger magnitude
    + atol), for two bf16 tensors rounded from fp32 sums taken in different
    orders: each may round to a neighbouring bf16 value, and near 0 the
    sums' own fp32 error (atol) exceeds a bf16 ulp."""
    a, b = out.float(), ref.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)   # 8 significant bits
    return (a - b).abs() / (ulp + atol)


@torch.no_grad()
def conv_stage_f64(x, w, scale=None, shift=None, act="none", n_valid=None,
                   bh=None, chunk_bytes=2 ** 30):
    """The float64 plain run of kernel 8 (kernel 9 with `bh`) on the values
    the kernel multiplies: x transformed, activated and rounded to its dtype
    as the kernel does, then widened, so that it differs from the kernel by
    the fp32 sums alone. Frame chunks of about chunk_bytes of input bound
    its memory. Returns (y, stats) in float64."""
    n = x.shape[0]
    n_valid = n if n_valid is None else n_valid
    per = max(1, chunk_bytes // (8 * max(1, x[0].numel())))
    ys, stats = [], 0
    for i in range(0, n, per):
        v = kcs.activated_input(x[i:i + per], scale, shift, act).double()
        if bh is None:
            y, st = kcs.conv3x3_block_fwd_reference(
                v, w.double(), act="none",
                n_valid=min(max(n_valid - i, 0), v.shape[0]))
        else:
            y, st = kcs.fused_conv_bn_reference(v, w.double(), bh)
        ys.append(y)
        stats = stats + st
    return torch.cat(ys), stats
