"""DCGAN64 frame encoder and decoder (counterpart of srvp_tpu/models/conv.py).

The modules run NCHW. The encoder is 4x (4x4 s2 conv + LeakyReLU(0.2), BN
on all but the first), then a 4x4 valid conv -> BN -> tanh to a flat vector;
it returns its per-stage outputs, deepest first, as skip connections. The
decoder mirrors it with transposed convs and ends in a plain convT; with
skip connections it concatenates skip i to the input of stage i.

The JAX package rewrites the 1x1 decoder stem as a GEMM and splits the skip
conv for the TPU; here the stem is an ordinary ConvTranspose2d and the skip
is concatenated, which computes the same function.
"""

import torch
import torch.nn as nn

from srvp_tpu_torch.models.layers import ConvBlockSpec, conv_block

VGG_NOT_PORTED = ("archi='vgg' is not ported yet: its pool/upsample kernels "
                  "belong to the vgg/KTH slice (ROADMAP.md, Queue 2)")


def _b(kind, in_ch, out_ch, kernel, stride, padding, activation="leaky_relu",
       bn=True):
    return ConvBlockSpec(kind, in_ch, out_ch, kernel, stride, padding,
                         activation, bn)


def _check_archi(archi):
    if archi == "vgg":
        raise NotImplementedError(VGG_NOT_PORTED)
    if archi != "dcgan":
        raise ValueError(f"No network named '{archi}'")


def encoder_spec(archi, nc, nh, nf):
    """Returns (stages, last): one block spec per stage, then the last."""
    _check_archi(archi)
    stages = [
        _b("conv", nc, nf, 4, 2, 1, bn=False),
        _b("conv", nf, nf * 2, 4, 2, 1),
        _b("conv", nf * 2, nf * 4, 4, 2, 1),
        _b("conv", nf * 4, nf * 8, 4, 2, 1),
    ]
    last = _b("conv", nf * 8, nh, 4, 1, 0, activation="tanh")
    return stages, last


def decoder_spec(archi, nc, ny, nf, skip):
    """Returns (first, stages). `ny` is the flat input dim (w + y)."""
    _check_archi(archi)
    coef = 2 if skip else 1
    first = _b("convt", ny, nf * 8, 4, 1, 0)
    stages = [
        _b("convt", nf * 8 * coef, nf * 4, 4, 2, 1),
        _b("convt", nf * 4 * coef, nf * 2, 4, 2, 1),
        _b("convt", nf * 2 * coef, nf, 4, 2, 1),
        _b("convt", nf * coef, nc, 4, 2, 1, activation="none", bn=False),
    ]
    return first, stages


class Encoder(nn.Module):
    def __init__(self, archi, nc, nh, nf):
        super().__init__()
        stages, last = encoder_spec(archi, nc, nh, nf)
        self.conv = nn.ModuleList([conv_block(s) for s in stages])
        self.last_conv = conv_block(last)
        self.nh = nh

    def forward(self, x):
        """x: (N, C, H, W) -> (h (N, nh), skips deepest first)."""
        skips = []
        h = x
        for stage in self.conv:
            h = stage(h)
            skips.append(h)
        return self.last_conv(h).reshape(-1, self.nh), skips[::-1]


class Decoder(nn.Module):
    def __init__(self, archi, nc, ny, nf, skip):
        super().__init__()
        first, stages = decoder_spec(archi, nc, ny, nf, skip)
        self.first_upconv = conv_block(first)
        self.conv = nn.ModuleList([conv_block(s) for s in stages])

    def forward(self, z, skips=None):
        """z: (N, n_in) -> frames (N, C, H, W) in [0, 1]. skips: None or a
        list (deepest first) of (N, c, h, w) tensors."""
        h = self.first_upconv(z.reshape(z.shape[0], z.shape[1], 1, 1))
        for i, stage in enumerate(self.conv):
            if skips is not None:
                h = torch.cat([h, skips[i]], dim=1)
            h = stage(h)
        return torch.sigmoid(h)
