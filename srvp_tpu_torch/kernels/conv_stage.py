"""The fused conv stage of the vgg blocks: y = conv3x3(act(x * scale +
shift)) with the batch statistics of y. The CUDA kernels' wrappers, their
plain versions and the batch-norm (scale, shift) of the next block.

Replaces two Pallas TPU kernels with csrc/conv_stage.cu, in the port's
NCHW layout (x (N, cin, H, W), w (cout, cin, 3, 3) as torch's convs hold
it):
  * kernel 8, `conv3x3_block_fwd` <- srvp_tpu/ops/pallas/conv_stage.py
    `_fwd_kernel` (its `conv3x3_block_fwd`), exact zero padding;
  * kernel 9, `fused_conv_bn` <- scripts/microbench_conv.py
    `conv_bn_kernel` (its `fused_conv_bn`), the prototype with clamped halo
    rows: output row r of row block b = r // bh reads input rows c-1..c+1,
    c = clip(b*bh - 1, 0, H - bh - 2) + (r - b*bh) + 1, so the first and
    last row block read shifted rows; no transform, no activation.
Neither is routed into the model (the JAX package left it out too,
conv_stage.py:27-34): their path is srvp_tpu_torch/bench_conv_stage.py.

Numerics, as the TPU kernel (conv_stage.py:122-183):
  * the transform and the activation run in fp32 (a multiply, then an add)
    and are rounded to x's dtype before the products; the zero padding comes
    after them, so a tap outside the image reads 0, not act(shift). (Given
    bf16 input and no transform, the JAX kernel takes the activation in
    bf16; the port always takes it in fp32.)
  * products accumulate in fp32; y is the accumulator rounded to x's dtype;
    the statistics [sum y, sum y^2] per output channel come from the fp32
    accumulator before that rounding, over the frames < n_valid only (the
    frames past it still get y).
  * act: 'leaky_relu' (max(v, 0.2 v)), 'tanh' or 'none'.

The wrappers run the kernels for CUDA tensors and the plain versions for
CPU tensors. Any other input raises: another device, a dtype other than
float32 or bfloat16, a non-4-D x, a w that does not match x. The plain
versions (`*_reference`) take float64 too, which is how the card checks
arbitrate fp32 sums of up to 9 * 1024 terms.
"""

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.2   # reference LeakyReLU slope, module/conv.py
ACTS = {"none": 0, "leaky_relu": 1, "tanh": 2}
# the output pixels of a block of csrc/conv_stage.cu (kBM)
TILE_M = 128
# the most values a channel of the staged halo tile may take (its pitch in
# shared memory) when several frames share a tile
STAGED_MAX = 512

# Launches of each kernel (one a call: the conv pass and its statistics
# pass). Reset them before a run to count that run's.
block_launches = 0      # kernel 8
clamped_launches = 0    # kernel 9


def activated_input(x, scale=None, shift=None, act="leaky_relu"):
    """act(x * scale + shift) in fp32 (float64 for float64 x), rounded to
    x's dtype and returned in the accumulation dtype: the values the taps
    multiply."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    v = x.to(acc)
    if scale is not None:
        v = v * scale.to(acc)[:, None, None] + shift.to(acc)[:, None, None]
    if act == "leaky_relu":
        v = torch.maximum(v, LEAKY_SLOPE * v)
    elif act == "tanh":
        v = torch.tanh(v)
    return v.to(x.dtype).to(acc)


def tap_sum(v, w, crow):
    """The 9-tap sum of shifted slices of v (N, cin, H, W) times the weight
    taps of w (cout, cin, 3, 3), one matmul a tap, in v's dtype. crow (H,)
    long: the input row each output row's taps centre on; rows outside
    [0, H) and the columns beyond the edges read 0."""
    n, cin, h, ww = v.shape
    vp = F.pad(v, (1, 1, 1, 1))
    acc = None
    for dy in range(3):
        rows = vp.index_select(2, crow + dy)           # (N, cin, H, W + 2)
        for dx in range(3):
            xs = rows[..., dx:dx + ww].reshape(n, cin, h * ww)
            term = torch.matmul(w[:, :, dy, dx].to(v.dtype), xs)
            acc = term if acc is None else acc + term
    return acc.reshape(n, w.shape[0], h, ww)


def clamped_rows(h, bh, device=None):
    """(H,) the centre row of each output row's taps in kernel 9."""
    r = torch.arange(h, device=device)
    b = r // bh
    return (b * bh - 1).clamp(0, h - bh - 2) + (r - b * bh) + 1


def batch_stats(acc, n_valid):
    """(cout, 2) [sum, sum of squares] of acc over frames < n_valid and all
    pixels, summed in float64; float32 unless acc is float64."""
    a = acc[:n_valid].double()
    st = torch.stack([a.sum((0, 2, 3)), (a * a).sum((0, 2, 3))], 1)
    return st if acc.dtype == torch.float64 else st.float()


def conv3x3_block_fwd_reference(x, w, scale=None, shift=None,
                                act="leaky_relu", n_valid=None):
    """Plain kernel 8: (y in x.dtype, stats)."""
    n = x.shape[0]
    acc = tap_sum(activated_input(x, scale, shift, act), w,
                  torch.arange(x.shape[2], device=x.device))
    return acc.to(x.dtype), batch_stats(acc, n if n_valid is None
                                        else n_valid)


def fused_conv_bn_reference(x, w, bh=8):
    """Plain kernel 9: (y in x.dtype, stats over every frame)."""
    acc = tap_sum(activated_input(x, act="none"), w,
                  clamped_rows(x.shape[2], bh, x.device))
    return acc.to(x.dtype), batch_stats(acc, x.shape[0])


def bn_scale_shift(stats, gamma, beta, n_valid, hw, eps=1e-5):
    """Train-mode batch norm of the next block's input as (scale, shift),
    fp32, y_norm = y * scale + shift, from stats (c, 2) [sum, sum of
    squares] over n_valid * hw values: the one-pass biased variance
    E[y^2] - mean^2 of conv_stage.py:261-271 (torch's BatchNorm2d takes two
    passes)."""
    count = n_valid * hw
    mean = stats[:, 0] / count
    var = stats[:, 1] / count - mean * mean
    inv = gamma.float() * torch.rsqrt(var + eps)
    return inv, beta.float() - mean * inv


def staged_pitch(rows, frames, cols, elem_bytes):
    """The channel pitch, in values, of a tile's staged halo in
    csrc/conv_stage.cu: rows of a 16-byte left pad, cols + 1 values and
    padding to 16 bytes, rows + 2 of them a frame, rounded up to 8 modulo
    32 (so that a fragment load meets 32 banks)."""
    vec = 16 // elem_bytes
    wp = -(-(vec + cols + 1) // vec) * vec
    chp = frames * (rows + 2) * wp
    return chp + (8 - chp % 32) % 32


def tile_plan(n, h, w, bh=None, dtype=torch.float32):
    """(rows, frames, cols, n_tiles) of the blocks of csrc/conv_stage.cu
    for N = n frames of h x w: a block takes `frames` frames x `rows` rows
    x `cols` columns, at most TILE_M pixels. cols = min(w, TILE_M); kernel
    8 (bh None) takes TILE_M // cols rows, and whole frames, as many as fit
    (within STAGED_MAX), when a frame fits twice; kernel 9 takes the most
    rows that divide bh, one frame, so that no tile crosses a block of bh
    rows."""
    cols = min(w, TILE_M)
    es = torch.empty((), dtype=dtype).element_size()
    if bh is None:
        rows = min(h, max(1, TILE_M // cols))
        frames = max(1, TILE_M // (h * cols)) if rows == h else 1
        while frames > 1 and staged_pitch(rows, frames, cols, es) \
                > STAGED_MAX:
            frames -= 1
    else:
        rows = max(r for r in range(1, bh + 1)
                   if bh % r == 0 and r * cols <= TILE_M)
        frames = 1
    n_tiles = -(-n // frames) * -(-h // rows) * -(-w // cols)
    return rows, frames, cols, n_tiles


def packed_weights(w):
    """w (cout, cin, 3, 3) as the kernels read it: (cin, 3, 3, cout)
    float32, the output channels of each input channel and tap contiguous
    (bf16 weights are exact in float32). A layout change, no product."""
    return w.permute(1, 2, 3, 0).contiguous().float()


def _check(name, x, w):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: needs float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: needs x (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if (w.device, w.dtype) != (x.device, x.dtype) or w.dim() != 4 \
            or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"{name}: w must be (cout, {x.shape[1]}, 3, 3) "
                         f"{x.dtype} on {x.device}, got {tuple(w.shape)} "
                         f"{w.dtype} on {w.device}")


def _launch(fn_name, x, w, scale_shift, extra, bh=None):
    """Runs one kernel; returns (y, stats)."""
    from srvp_tpu_torch.kernels.build import load_library
    n, cin, h, ww = x.shape
    cout = w.shape[0]
    x, wt = x.contiguous(), packed_weights(w)
    y = torch.empty((n, cout, h, ww), dtype=x.dtype, device=x.device)
    stats = torch.zeros((cout, 2), dtype=torch.float32, device=x.device)
    rows, frames, cols, tiles = tile_plan(n, h, ww, bh, x.dtype)
    partials = torch.empty((cout, tiles, 2), dtype=torch.float32,
                           device=x.device)
    tile = (rows, frames, cols) if bh is None else (rows, cols)
    ptrs = [t.data_ptr() for t in (x, wt)] + [
        None if t is None else t.data_ptr() for t in scale_shift] + [
        t.data_ptr() for t in (y, partials, stats)]
    with torch.cuda.device(x.device):
        err = getattr(load_library(), fn_name)(
            *ptrs, int(x.dtype == torch.bfloat16), n, cin, h, ww, cout,
            *extra, *tile, tiles,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    return y, stats


def conv3x3_block_fwd(x, w, scale=None, shift=None, act="leaky_relu",
                      n_valid=None):
    """Kernel 8 on CUDA (the plain version on the CPU): one fused vgg block
    forward. x (N, cin, H, W) raw activations of the previous block (or
    frames), float32 or bfloat16; w (cout, cin, 3, 3) in x's dtype;
    scale/shift (cin,) the per-channel normalize applied before `act`, both
    None for none. Returns (y (N, cout, H, W) in x's dtype, stats (cout, 2)
    float32 = [sum, sum of squares] of the fp32 accumulator over the frames
    < n_valid (default N) and all pixels)."""
    global block_launches
    _check("conv3x3_block_fwd", x, w)
    n, cin = x.shape[:2]
    n_valid = n if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= n:
        raise ValueError(f"conv3x3_block_fwd: n_valid {n_valid} not in "
                         f"[0, {n}]")
    if act not in ACTS:
        raise ValueError(f"conv3x3_block_fwd: act {act!r} not in "
                         f"{sorted(ACTS)}")
    if (scale is None) != (shift is None):
        raise ValueError("conv3x3_block_fwd: give scale and shift, or "
                         "neither")
    if scale is not None:
        for t in (scale, shift):
            if t.device != x.device or tuple(t.shape) != (cin,) \
                    or not t.is_floating_point():
                raise ValueError(f"conv3x3_block_fwd: scale and shift must "
                                 f"be ({cin},) floats on {x.device}")
        scale = scale.float().contiguous()
        shift = shift.float().contiguous()
    if not x.is_cuda:
        return conv3x3_block_fwd_reference(x, w, scale, shift, act, n_valid)
    y, stats = _launch("srvp_conv3x3_block_fwd", x, w, (scale, shift),
                       (n_valid, ACTS[act]))
    if y.numel():
        block_launches += 1
    return y, stats


def fused_conv_bn(x, w, bh=8):
    """Kernel 9 on CUDA (the plain version on the CPU): the clamped-halo
    conv of x (N, cin, H, W) with w (cout, cin, 3, 3), no transform, no
    activation, with the statistics of every frame. Needs H % bh == 0 and
    H // bh >= 2 (and H >= bh + 2, which only bh = 1 adds)."""
    global clamped_launches
    _check("fused_conv_bn", x, w)
    h = x.shape[2]
    if bh < 1 or h % bh or h // bh < 2 or h < bh + 2:
        raise ValueError(f"fused_conv_bn: needs H % bh == 0, H // bh >= 2 "
                         f"and H >= bh + 2, got H={h}, bh={bh}")
    if not x.is_cuda:
        return fused_conv_bn_reference(x, w, bh)
    y, stats = _launch("srvp_conv3x3_clamped_fwd", x, w, (), (bh,), bh)
    if y.numel():
        clamped_launches += 1
    return y, stats
