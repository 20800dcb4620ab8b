"""Conv blocks: conv/convT -> [BN] -> activation (counterpart of
srvp_tpu/models/layers.py).

Convolutions are bias-free and BatchNorm uses eps 1e-5, as in the JAX
package. Module nesting follows the reference checkpoints: a block is
Sequential(conv[, BN][, act]), and a block with neither BN nor activation
(the decoder tail) is the bare conv layer.

A block computes in the dtype of its input; its parameters and the batch
norm's running statistics stay float32. As in the JAX package
(srvp_tpu/ops/convops.py, srvp_tpu/models/layers.py `bn_apply`), a conv
casts its weight to the input's dtype where it uses it, and in bfloat16 the
batch norm takes its statistics in float32 from the upcast input, forms its
scale and shift in float32 and applies x * scale + shift in bfloat16. An
input of any other dtype (float32, or float64 for a float64 model) runs
torch's own batch norm and leaky ReLU unchanged, except in training at more
than one rank (parallel/): there the batch statistics are the global
batch's in every dtype (SyncBatchNorm's semantics, as a mean over the JAX
mesh's sharded batch axis is), through `_BatchStats`' reduction over the
ranks, and x * scale + shift in the input's dtype, its parameter gradients
summed over the ranks before they are rounded (`_RankAffine`).
"""

import dataclasses

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from srvp_tpu_torch.parallel import multihost

BN_EPS = 1e-5


def tile_add(h, hs, nt):
    """h (B * nt, ...) plus hs (B, ...) repeated over the nt rows of each
    b (rows b * nt + t), without materialising the repeat."""
    bsz = hs.shape[0]
    return (h.view((bsz, nt) + h.shape[1:]) + hs[:, None]).view(h.shape)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose weight is cast to the input's dtype."""

    def forward(self, x):
        return self._conv(x, self.weight)

    def _conv(self, x, w):
        return self._conv_forward(x, w.to(x.dtype), None)

    def skip_forward(self, x, skip, nt):
        """The conv of [x ; skip] (channels), skip (B, ...) shared by the
        nt frames of each video of x (B * nt, ...), as the JAX package
        computes it (srvp_tpu/models/layers.py `conv_block_apply`): the
        conv of x by the weight's first channels plus the conv of skip by
        the rest, once per video, each rounded to the input's dtype."""
        cx = x.shape[1]
        return tile_add(self._conv(x, self.weight[:, :cx]),
                        self._conv(skip, self.weight[:, cx:]), nt)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (no output_size) whose weight is cast to the
    input's dtype."""

    def forward(self, x):
        return self._conv(x, self.weight)

    def _conv(self, x, w):
        return F.conv_transpose2d(x, w.to(x.dtype), None, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)

    def skip_forward(self, x, skip, nt):
        """As Conv2d.skip_forward (the weight is (in, out, kh, kw))."""
        cx = x.shape[1]
        return tile_add(self._conv(x, self.weight[:cx]),
                        self._conv(skip, self.weight[cx:]), nt)


class _BatchStats(torch.autograd.Function):
    """Per-channel mean and biased variance of (N, C, H, W) x, in float32
    whatever x's dtype, the variance in two passes as torch's batch norm
    takes it, and the count n of values a channel. Its backward,
    dx = (g_mean + 2 g_var (x - mean)) / n, is computed in float32 and
    rounded once to x's dtype; it saves x itself, not a float32 copy.

    With `sync` the statistics are those of the global batch, over every
    rank's x: Σx and n are all-reduced (in float64) for the mean, then
    Σ(x - mean)² for the variance, the same two passes; n is then a float32
    tensor. In backward g_mean and g_var are all-reduced first: every
    rank's loss reads the shared statistics, so dx takes the sum of their
    gradients over the ranks (without it the parameter gradients that the
    ranks then average would be wrong)."""

    @staticmethod
    def forward(ctx, x, sync=False):
        xf = x.float()
        n = x.numel() // x.shape[1]
        if sync:
            sums = torch.cat([xf.sum(dim=(0, 2, 3)).double(),
                              xf.new_tensor([n], dtype=torch.float64)])
            dist.all_reduce(sums)
            n = sums[-1].float()
            mean = (sums[:-1] / sums[-1]).float()
            d = xf - mean.view(1, -1, 1, 1)
            var = (d * d).sum(dim=(0, 2, 3))
            dist.all_reduce(var)
            var = var / n
            ctx.mark_non_differentiable(n)
        else:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        ctx.sync, ctx.n = sync, n
        ctx.save_for_backward(x, mean)
        return mean, var, n

    @staticmethod
    def backward(ctx, g_mean, g_var, _):
        x, mean = ctx.saved_tensors
        if ctx.sync:
            g = torch.cat([g_mean, g_var])
            dist.all_reduce(g)
            g_mean, g_var = g.chunk(2)
        shape = (1, -1, 1, 1)
        dx = (g_mean.view(shape)
              + 2.0 * g_var.view(shape) * (x.float() - mean.view(shape))) \
            / ctx.n
        return dx.to(x.dtype), None


class _RankAffine(torch.autograd.Function):
    """x * scale + shift (per channel, all three in x's dtype) at more than
    one rank. Its backward sums the scale's and shift's gradients, each
    rank's sum over its rows accumulated in float32, over the ranks before
    it rounds them to x's dtype, as one process rounds the whole batch's
    sum (and as JAX on a mesh does, whose bfloat16 sums accumulate in
    float32 across the devices); each rank takes 1/N of it, so that the
    mean of the ranks' parameter gradients (parallel/mesh.
    all_reduce_grads) is the whole batch's. Rounding each rank's partial
    sum to bfloat16 first would add a rounding that one process does not
    make."""

    @staticmethod
    def forward(ctx, x, scale, shift):
        ctx.save_for_backward(x, scale)
        return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        sums = torch.stack([(g * x).float().sum(dim=(0, 2, 3)),
                            g.float().sum(dim=(0, 2, 3))])
        dist.all_reduce(sums)
        sums = sums.to(scale.dtype) / dist.get_world_size()
        return g * scale.view(1, -1, 1, 1), sums[0], sums[1]


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d that normalises a bfloat16 input as the JAX package
    does, and takes the global batch's statistics in training at more than
    one rank (module docstring); any other input takes torch's path."""

    def forward(self, x):
        sync = self.training and multihost.process_count() > 1
        if x.dtype != torch.bfloat16 and not sync:
            return super().forward(x)
        if self.training:
            mean, var, n = _BatchStats.apply(x, sync)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                denom = (n - 1).clamp(min=1) if sync else max(n - 1, 1)
                self.running_var.mul_(1 - m).add_(m * n / denom * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        scale = (self.weight * inv).to(x.dtype)
        shift = (self.bias - self.weight * mean * inv).to(x.dtype)
        if sync:
            return _RankAffine.apply(x, scale, shift)
        return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


@dataclasses.dataclass(frozen=True)
class ConvBlockSpec:
    """Static description of one conv block."""
    kind: str          # 'conv' | 'convt'
    in_ch: int
    out_ch: int
    kernel: int
    stride: int
    padding: int
    activation: str = "leaky_relu"
    bn: bool = True


class LeakyReLU(nn.LeakyReLU):
    """nn.LeakyReLU that multiplies by its slope in the input's dtype, as
    jax.nn.leaky_relu does: in bfloat16 the slope 0.2 is 0.2001953125.
    Any other input takes torch's path."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        slope = torch.tensor(self.negative_slope, dtype=x.dtype)
        return torch.where(x >= 0, x, x * slope)


def activation(name):
    """Activation module, or None for 'none'."""
    acts = {"leaky_relu": lambda: LeakyReLU(0.2), "tanh": lambda: nn.Tanh(),
            "none": lambda: None}
    if name not in acts:
        raise ValueError(f"Activation function '{name}' not yet implemented")
    return acts[name]()


def is_raw(spec):
    """True when the block is a bare conv layer (no BN, no activation)."""
    return not spec.bn and spec.activation == "none"


def conv_block(spec):
    """Builds the module of one ConvBlockSpec (NCHW)."""
    if spec.kind == "conv":
        conv_cls = Conv2d
    elif spec.kind == "convt":
        conv_cls = ConvTranspose2d
    else:
        raise ValueError(f"Unknown conv kind '{spec.kind}'")
    conv = conv_cls(spec.in_ch, spec.out_ch, spec.kernel, spec.stride,
                    spec.padding, bias=False)
    if is_raw(spec):
        return conv
    mods = [conv]
    if spec.bn:
        mods.append(BatchNorm2d(spec.out_ch, eps=BN_EPS))
    act = activation(spec.activation)
    if act is not None:
        mods.append(act)
    return nn.Sequential(*mods)
