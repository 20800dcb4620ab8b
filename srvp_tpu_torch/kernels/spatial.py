"""2x2 max pool and 2x nearest upsample of the vgg encoder and decoder: the
CUDA kernels' wrappers, their autograd.Functions, their plain versions and
the nn.Modules that the vgg stages hold.

Replaces the Pallas TPU kernels of srvp_tpu/ops/pallas/spatial.py
(`_maxpool_fwd_kernel`, `_maxpool_bwd_kernel`, `_upsample_fwd_kernel`,
`_upsample_bwd_kernel`) with csrc/spatial.cu, in the port's NCHW layout,
for float32 and bfloat16 (one kernel template, an entry point for each
type). All four are bound by bytes: one read of each input and one write of
each output (see the source). Numerics, bit for bit with the plain
versions:

  * pool forward: the 2x2 window's max, NaN propagated;
  * pool backward: tied maxima share the gradient equally,
    gx = mask * up(g / cnt) with mask = (x == up(m)), as the JAX package's
    reshape-and-max path does under autodiff (and torch.amax's backward);
    F.max_pool2d's backward gives it all to one winner. In float32 inside
    whatever the type, with one rounding at the store, as the TPU kernel;
  * upsample forward: duplication;
  * upsample backward: the 2x2 window sum in float32, in the TPU kernel's
    order (g[2i,2j] + g[2i+1,2j]) + (g[2i,2j+1] + g[2i+1,2j+1]), with one
    rounding at the store.

`max_pool2x2` and `upsample2x` run their autograd.Function, whose forward is
the custom op `srvp::max_pool2x2` or `srvp::upsample2x` (kernels/ops.py)
and whose backward calls `max_pool2x2_bwd` or `upsample2x_bwd`: for CUDA
tensors they launch the kernels, for CPU tensors they run the plain
versions.
Any other input raises: another device, a dtype other than float32 or
bfloat16, not 4-D, or (pool) an odd height or width.
"""

import torch
import torch.nn as nn

DTYPES = (torch.float32, torch.bfloat16)
KERNELS = ("pool_fwd", "pool_bwd", "up_fwd", "up_bwd")
# Launches of each kernel in each type: launches[kernel, dtype]. Reset them
# (reset_launches) before a run to count that run's.
launches = {}


def reset_launches():
    launches.update({(k, d): 0 for k in KERNELS for d in DTYPES})


reset_launches()
# each kernel's C entry point: the name and its type's suffix
_ENTRY = {"pool_fwd": "srvp_maxpool2x2_fwd", "pool_bwd": "srvp_maxpool2x2_bwd",
          "up_fwd": "srvp_upsample2x_fwd", "up_bwd": "srvp_upsample2x_bwd"}
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def max_pool2x2_reference(x):
    """Plain 2x2/stride-2 max pool of (N, C, H, W): a reshape and an amax,
    whose autograd backward shares the gradient among tied maxima."""
    n, c, h, w = x.shape
    return x.reshape(n, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def _up(t):
    """(N, C, h, w) -> (N, C, 2h, 2w) by duplication."""
    n, c, h, w = t.shape
    return t[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(
        n, c, 2 * h, 2 * w)


def max_pool2x2_bwd_reference(x, m, g):
    """Plain pool backward: the gradient of x for the pooled m and its
    gradient g, mask * up(g / cnt), in float32 and rounded once to x's
    dtype."""
    n, c, h, w = x.shape
    mask = (x.float() == _up(m.float())).float()
    cnt = mask.reshape(n, c, h // 2, 2, w // 2, 2).sum(dim=(3, 5))
    return (mask * _up(g.float() / cnt)).to(x.dtype)


def upsample2x_reference(x):
    """Plain 2x nearest upsample of (N, C, H, W)."""
    return _up(x)


def upsample2x_bwd_reference(g):
    """Plain upsample backward: the 2x2 window sums of g in float32, in the
    TPU kernel's order, rounded once to g's dtype."""
    n, c, h, w = g.shape
    g6 = g.float().reshape(n, c, h // 2, 2, w // 2, 2)
    return ((g6[:, :, :, 0, :, 0] + g6[:, :, :, 1, :, 0])
            + (g6[:, :, :, 0, :, 1] + g6[:, :, :, 1, :, 1])).to(g.dtype)


def _check(name, x, even):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: needs float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: needs (N, C, H, W), got {tuple(x.shape)}")
    if even and (x.shape[2] % 2 or x.shape[3] % 2):
        raise ValueError(f"{name}: needs even H and W, got "
                         f"{tuple(x.shape)}")


def _dense(t):
    """t contiguous and aligned to two elements, as the kernels read a
    window's pair of columns at once (a float2, a __nv_bfloat162)."""
    t = t.contiguous()
    return t if t.data_ptr() % (2 * t.element_size()) == 0 else t.clone()


def _launch(kernel, tensors, rows, cols):
    """Launches `kernel` ("pool_fwd", ...) in the tensors' type on the
    current stream and adds one to its launch count."""
    from srvp_tpu_torch.kernels.build import load_library
    dtype = tensors[0].dtype
    fn_name = _ENTRY[kernel] + _SUFFIX[dtype]
    device = tensors[0].device
    with torch.cuda.device(device):
        err = getattr(load_library(), fn_name)(
            *[t.data_ptr() for t in tensors], rows, cols,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    launches[kernel, dtype] += 1


def pool_fwd_cuda(x):
    """The CUDA implementation of `srvp::max_pool2x2` (kernel 4)."""
    n, c, h, w = x.shape
    x = _dense(x)
    m = torch.empty((n, c, h // 2, w // 2), device=x.device, dtype=x.dtype)
    if m.numel():
        _launch("pool_fwd", (x, m), n * c * (h // 2), w // 2)
    return m


def max_pool2x2_bwd(x, m, g):
    """The pool's backward (kernel 5 on CUDA): the gradient of x for the
    pooled m and its gradient g, as max_pool2x2_bwd_reference."""
    _check("max_pool2x2_bwd", x, even=True)
    n, c, h, w = x.shape
    for name, t in (("m", m), ("g", g)):
        if (t.device, t.dtype, tuple(t.shape)) != (
                x.device, x.dtype, (n, c, h // 2, w // 2)):
            raise ValueError(f"max_pool2x2_bwd: {name} must be {x.dtype} "
                             f"{(n, c, h // 2, w // 2)} on {x.device}")
    if not x.is_cuda:
        return max_pool2x2_bwd_reference(x, m, g)
    x, m, g = _dense(x), _dense(m), _dense(g)
    gx = torch.empty_like(x)
    if g.numel():
        _launch("pool_bwd", (x, m, g, gx), n * c * (h // 2), w // 2)
    return gx


def up_fwd_cuda(x):
    """The CUDA implementation of `srvp::upsample2x` (kernel 6)."""
    n, c, h, w = x.shape
    x = _dense(x)
    y = torch.empty((n, c, 2 * h, 2 * w), device=x.device, dtype=x.dtype)
    if x.numel():
        _launch("up_fwd", (x, y), n * c * h, w)
    return y


def upsample2x_bwd(g):
    """The upsample's backward (kernel 7 on CUDA), as
    upsample2x_bwd_reference."""
    _check("upsample2x_bwd", g, even=True)
    if not g.is_cuda:
        return upsample2x_bwd_reference(g)
    n, c, h, w = g.shape
    g = _dense(g)
    gx = torch.empty((n, c, h // 2, w // 2), device=g.device, dtype=g.dtype)
    if gx.numel():
        _launch("up_bwd", (g, gx), n * c * (h // 2), w // 2)
    return gx


class MaxPool2x2(torch.autograd.Function):
    """2x2/stride-2 max pool; saves x and m, and its backward shares the
    gradient among tied maxima (kernels 4 and 5 on CUDA)."""

    @staticmethod
    def forward(ctx, x):
        from srvp_tpu_torch.kernels import ops
        m = ops.max_pool2x2(x)
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        return max_pool2x2_bwd(x, m, g)


class Upsample2x(torch.autograd.Function):
    """2x nearest upsample; its backward sums each 2x2 window (kernels 6
    and 7 on CUDA)."""

    @staticmethod
    def forward(ctx, x):
        from srvp_tpu_torch.kernels import ops
        return ops.upsample2x(x)

    @staticmethod
    def backward(ctx, g):
        return upsample2x_bwd(g)


def max_pool2x2(x):
    """2x2/stride-2 max pool of (N, C, H, W) float32 or bfloat16, H and W
    even."""
    _check("max_pool2x2", x, even=True)
    return MaxPool2x2.apply(x)


def upsample2x(x):
    """2x nearest upsample of (N, C, H, W) float32 or bfloat16."""
    _check("upsample2x", x, even=False)
    return Upsample2x.apply(x)


class SpatialOp(nn.Module):
    """A vgg pool or upsample: its kernel while `use_kernel` is set (on the
    CPU the wrapper's plain version), else the plain version under autograd,
    which is how a step is checked against the kernels on the card (see
    use_kernels)."""

    def __init__(self, op, reference):
        super().__init__()
        self._op, self._reference = op, reference
        self.use_kernel = True

    def forward(self, x):
        return self._op(x) if self.use_kernel else self._reference(x)


def use_kernels(model, on):
    """Routes every vgg pool and upsample of `model` through its kernel
    (`on`) or through its plain version under autograd."""
    for m in model.modules():
        if isinstance(m, SpatialOp):
            m.use_kernel = on


class MaxPool(SpatialOp):
    def __init__(self):
        super().__init__(max_pool2x2, max_pool2x2_reference)


class Upsample(SpatialOp):
    def __init__(self):
        super().__init__(upsample2x, upsample2x_reference)
