"""DCGAN64 and VGG64 frame encoders and decoders (counterpart of
srvp_tpu/models/conv.py).

The modules run NCHW. Each network is a list of stages, each stage a list
of ops: ('block', ConvBlockSpec), ('maxpool', None) or ('upsample', None).
  * dcgan encoder: 4x (4x4 s2 conv + LeakyReLU(0.2), BN on all but the
    first), then a 4x4 valid conv -> BN -> tanh to a flat vector;
  * vgg encoder: 4 stages of 3x3 convs (+BN+LeakyReLU), each after the first
    led by a 2x2 max pool, then a max pool and the 4x4 valid conv;
  * the decoders mirror them: dcgan with transposed convs, vgg with a 4x4
    convT stem and 3x3 convs, each stage but the last ending in a 2x
    nearest upsample; both end in a plain convT.
The encoder returns its per-stage outputs, deepest first, as skip
connections; with skip connections stage i of the decoder convolves the
concatenation of its input and skip i, each video's skip shared by its
frames.

Module nesting gives the reference checkpoint's keys: a dcgan stage is its
one block (`encoder.conv.{i}.0.weight`), a vgg stage an nn.Sequential of its
ops with the pool and upsample at their reference positions
(`encoder.conv.{i}.{j}.0.weight`, `encoder.last_conv.1.0.weight`,
`decoder.first_upconv.0.0.weight`, `decoder.conv.3.1.weight`). The pools and
upsamples are kernels/spatial.py's modules: the CUDA kernels unless
`kernels.spatial.use_kernels(model, False)` turns them to the plain versions.

The networks compute in their input's dtype (models/layers.py): float32,
or bfloat16 under the trainer's `--precision bfloat16`, the pools and
upsamples then through the kernels' bfloat16 versions.

The JAX package rewrites the 1x1 decoder stem as a GEMM; here the stem is
an ordinary ConvTranspose2d, which computes the same function. The skip
conv is split as in the JAX package (models/layers.py `skip_forward`): the
conv of the stage's input by the first channels of the weight plus the conv
of the skip by the rest, once per video and added to each of its frames.
It is the same function with the skip half of the work divided by the
frame count, and in bfloat16 it rounds where the JAX package rounds.
"""

import torch
import torch.nn as nn

from srvp_tpu_torch.kernels.spatial import MaxPool, Upsample
from srvp_tpu_torch.models.layers import ConvBlockSpec, conv_block

POOL, UP = ("maxpool", None), ("upsample", None)


def _b(kind, in_ch, out_ch, kernel, stride, padding, activation="leaky_relu",
       bn=True):
    return ("block", ConvBlockSpec(kind, in_ch, out_ch, kernel, stride,
                                   padding, activation, bn))


def _c3(in_ch, out_ch):
    return _b("conv", in_ch, out_ch, 3, 1, 1)


def encoder_spec(archi, nc, nh, nf):
    """Returns (stages, last) op lists."""
    if archi == "dcgan":
        stages = [
            [_b("conv", nc, nf, 4, 2, 1, bn=False)],
            [_b("conv", nf, nf * 2, 4, 2, 1)],
            [_b("conv", nf * 2, nf * 4, 4, 2, 1)],
            [_b("conv", nf * 4, nf * 8, 4, 2, 1)],
        ]
        return stages, [_b("conv", nf * 8, nh, 4, 1, 0, activation="tanh")]
    if archi == "vgg":
        stages = [
            [_c3(nc, nf), _c3(nf, nf)],
            [POOL, _c3(nf, nf * 2), _c3(nf * 2, nf * 2)],
            [POOL, _c3(nf * 2, nf * 4), _c3(nf * 4, nf * 4),
             _c3(nf * 4, nf * 4)],
            [POOL, _c3(nf * 4, nf * 8), _c3(nf * 8, nf * 8),
             _c3(nf * 8, nf * 8)],
        ]
        last = [POOL, _b("conv", nf * 8, nh, 4, 1, 0, activation="tanh")]
        return stages, last
    raise ValueError(f"No encoder named '{archi}'")


def decoder_spec(archi, nc, ny, nf, skip):
    """Returns (first, stages) op lists. `ny` is the flat input dim (w + y)."""
    coef = 2 if skip else 1
    if archi == "dcgan":
        first = [_b("convt", ny, nf * 8, 4, 1, 0)]
        stages = [
            [_b("convt", nf * 8 * coef, nf * 4, 4, 2, 1)],
            [_b("convt", nf * 4 * coef, nf * 2, 4, 2, 1)],
            [_b("convt", nf * 2 * coef, nf, 4, 2, 1)],
            [_b("convt", nf * coef, nc, 4, 2, 1, activation="none", bn=False)],
        ]
        return first, stages
    if archi == "vgg":
        first = [_b("convt", ny, nf * 8, 4, 1, 0), UP]
        stages = [
            [_c3(nf * 8 * coef, nf * 8), _c3(nf * 8, nf * 8),
             _c3(nf * 8, nf * 4), UP],
            [_c3(nf * 4 * coef, nf * 4), _c3(nf * 4, nf * 4),
             _c3(nf * 4, nf * 2), UP],
            [_c3(nf * 2 * coef, nf * 2), _c3(nf * 2, nf), UP],
            [_c3(nf * coef, nf),
             _b("convt", nf, nc, 3, 1, 1, activation="none", bn=False)],
        ]
        return first, stages
    raise ValueError(f"No decoder named '{archi}'")


def _op_module(op, spec):
    if op == "block":
        return conv_block(spec)
    if op == "maxpool":
        return MaxPool()
    if op == "upsample":
        return Upsample()
    raise ValueError(f"Unknown op '{op}'")


def stage_module(ops):
    """One stage: its only block (dcgan), or an nn.Sequential of its ops."""
    if len(ops) == 1 and ops[0][0] == "block":
        return conv_block(ops[0][1])
    return nn.Sequential(*[_op_module(*op) for op in ops])


class Encoder(nn.Module):
    def __init__(self, archi, nc, nh, nf):
        super().__init__()
        stages, last = encoder_spec(archi, nc, nh, nf)
        self.conv = nn.ModuleList([stage_module(ops) for ops in stages])
        self.last_conv = stage_module(last)
        self.nh = nh

    def forward(self, x):
        """x: (N, C, H, W) -> (h (N, nh), skips deepest first)."""
        skips = []
        h = x
        for stage in self.conv:
            h = stage(h)
            skips.append(h)
        h = self.last_conv(h)
        return h.reshape(-1, self.nh), skips[::-1]


class Decoder(nn.Module):
    def __init__(self, archi, nc, ny, nf, skip):
        super().__init__()
        first, stages = decoder_spec(archi, nc, ny, nf, skip)
        self.first_upconv = stage_module(first)
        self.conv = nn.ModuleList([stage_module(ops) for ops in stages])

    def forward(self, z, skips=None, nt=1):
        """z: (N, n_in) -> frames (N, C, H, W) in [0, 1], in z's dtype.
        skips: None or a list (deepest first) of per-video (N / nt, c, h, w)
        tensors, cast to that dtype, each shared by the nt frames of its
        video (rows b * nt + t of z)."""
        h = self.first_upconv(z.reshape(z.shape[0], z.shape[1], 1, 1))
        for i, stage in enumerate(self.conv):
            if skips is None:
                h = stage(h)
                continue
            conv, rest = _first_conv(stage)
            h = conv.skip_forward(h, skips[i].to(h.dtype), nt)
            for m in rest:
                h = m(h)
        return torch.sigmoid(h)


def _first_conv(stage):
    """(the stage's first conv layer, the modules after it in order)."""
    mods = list(stage) if isinstance(stage, nn.Sequential) else [stage]
    if isinstance(mods[0], nn.Sequential):
        mods = list(mods[0]) + mods[1:]
    return mods[0], mods[1:]
