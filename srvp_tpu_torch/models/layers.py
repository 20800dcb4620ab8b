"""Conv blocks: conv/convT -> [BN] -> activation (counterpart of
srvp_tpu/models/layers.py).

Convolutions are bias-free and BatchNorm uses eps 1e-5, as in the JAX
package. Module nesting follows the reference checkpoints: a block is
Sequential(conv[, BN][, act]), and a block with neither BN nor activation
(the decoder tail) is the bare conv layer.
"""

import dataclasses

import torch.nn as nn

BN_EPS = 1e-5


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


def activation(name):
    """Activation module, or None for 'none'."""
    acts = {"leaky_relu": lambda: nn.LeakyReLU(0.2), "tanh": lambda: nn.Tanh(),
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
        conv_cls = nn.Conv2d
    elif spec.kind == "convt":
        conv_cls = nn.ConvTranspose2d
    else:
        raise ValueError(f"Unknown conv kind '{spec.kind}'")
    conv = conv_cls(spec.in_ch, spec.out_ch, spec.kernel, spec.stride,
                    spec.padding, bias=False)
    if is_raw(spec):
        return conv
    mods = [conv]
    if spec.bn:
        mods.append(nn.BatchNorm2d(spec.out_ch, eps=BN_EPS))
    act = activation(spec.activation)
    if act is not None:
        mods.append(act)
    return nn.Sequential(*mods)
