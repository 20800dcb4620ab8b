"""Weights made from the seed on the device: one draw of standard normals
for every parameter at once, then each leaf scaled to its family's
spread. The benchmark makes them and hands the same state_dict to the
program and to the reference; nothing of the program's initialisation is
used.

Families (the configuration's `init` block sets conv_std, res_gain):
conv and transposed-conv kernels ~ N(0, conv_std); batch-norm scales
~ N(1, 0.02) and shifts ~ N(0, 0.02), running statistics 0 and 1; the
dynamics MLP's weights ~ N(0, res_gain^2 / max(fan_in, fan_out)) with
zero biases (the norms that the port's orthogonal init at gain res_gain
keeps);
every other linear or LSTM weight and bias ~ N(0, 1 / (3 fan_in)), the
variance of torch's default uniform initialisation.
"""

import math

import torch

from perfbench.reference.model import SRVP


def _family(name, shape, init):
    """(mean, std) of the leaf `name`."""
    fan_in = shape[1] if len(shape) > 1 else None
    if name.startswith(("encoder.", "decoder.")):
        if len(shape) == 4:
            return 0.0, init["conv_std"]
        return (1.0 if name.endswith("weight") else 0.0), 0.02
    if name.startswith("dynamics."):
        if len(shape) == 1:
            return 0.0, 0.0
        return 0.0, init["res_gain"] / math.sqrt(max(shape))
    if name.startswith("inf_z."):
        hidden = shape[0] // 4
        return 0.0, 1.0 / math.sqrt(3 * hidden)
    return 0.0, 1.0 / math.sqrt(3 * (fan_in or shape[0]))


def make_state(cfg, init, seed, device):
    """The model's state_dict (float32 on `device`) from `seed`: the
    parameters from one torch.randn call on a generator of the device,
    the batch-norm buffers at their initial values."""
    with torch.device("meta"):
        model = SRVP(cfg)
    params = list(model.named_parameters())
    total = sum(p.numel() for _, p in params)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for name, p in params:
        mean, std = _family(name, tuple(p.shape), init)
        state[name] = flat[at:at + p.numel()].view(p.shape).mul_(std).add_(
            mean)
        at += p.numel()
    for name, b in model.named_buffers():
        if name.endswith("running_var"):
            state[name] = torch.ones(b.shape, device=device)
        elif name.endswith("num_batches_tracked"):
            state[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            state[name] = torch.zeros(b.shape, device=device)
    return state


def param_names(cfg):
    with torch.device("meta"):
        return [n for n, _ in SRVP(cfg).named_parameters()]
