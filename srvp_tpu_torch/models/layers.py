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
torch's own batch norm and leaky ReLU unchanged.
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

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
    takes it. Its backward, dx = (g_mean + 2 g_var (x - mean)) / n, is
    computed in float32 and rounded once to x's dtype; it saves x itself,
    not a float32 copy."""

    @staticmethod
    def forward(ctx, x):
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                   correction=0)
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        shape = (1, -1, 1, 1)
        dx = (g_mean.view(shape)
              + 2.0 * g_var.view(shape) * (x.float() - mean.view(shape))) / n
        return dx.to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d that normalises a bfloat16 input as the JAX package
    does (module docstring); any other input takes torch's path."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        if self.training:
            mean, var = _BatchStats.apply(x)
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * n / max(n - 1, 1) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        scale = (self.weight * inv).to(x.dtype)
        shift = (self.bias - self.weight * mean * inv).to(x.dtype)
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
