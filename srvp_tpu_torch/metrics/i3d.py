"""Inflated 3D Inception (I3D, kinetics-400) for FVD (counterpart of
srvp_tpu/metrics/i3d.py).

Inception-v1 inflated to 3D (Carreira & Zisserman 2017), the TF-Hub module
deepmind/i3d-kinetics-400/1 that the reference's FVD embeds videos with;
the embedding is the 400-way logits averaged over time. Unit3D batch norms
are centre-only (scale fixed at 1) with eps 1e-3 and inference statistics.

Tensors are NCDHW and weights OIDHW; the convolutions and pools are
cuDNN's through torch. Every convolution and pool pads as TF's 'SAME' does,
the extra element at the end (torch's `padding=` is symmetric, so F.pad
comes first), and max pools pad with -inf. Weights load from an npz keyed
by the TF variable paths under "RGB/inception_i3d/"
(scripts/convert_i3d.py writes it), conv kernels in TF's DHWIO.
"""

import numpy as np
import torch
import torch.nn.functional as F

_BN_EPS = 1e-3

# Inception-v1 mixed-block channel table: (branch0 1x1, branch1 reduce,
# branch1 3x3, branch2 reduce, branch2 3x3, branch3 1x1)
_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
_BRANCH_PATHS = [
    ("Branch_0/Conv3d_0a_1x1", 1),
    ("Branch_1/Conv3d_0a_1x1", 1), ("Branch_1/Conv3d_0b_3x3", 3),
    ("Branch_2/Conv3d_0a_1x1", 1), ("Branch_2/Conv3d_0b_3x3", 3),
    ("Branch_3/Conv3d_0b_1x1", 1),
]
_STEM_SHAPES = {
    "Conv3d_1a_7x7": (7, 7, 7, 3, 64),
    "Conv3d_2b_1x1": (1, 1, 1, 64, 64),
    "Conv3d_2c_3x3": (3, 3, 3, 64, 192),
}
_TF_ROOT = "RGB/inception_i3d"


def _same_pads(x, window, stride):
    """F.pad's list for TF 'SAME' over x's last three dims (D, H, W):
    ceil(n / s) outputs, the odd element of the padding at the end."""
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(window),
                       reversed(stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def _unit3d(params, x, stride=(1, 1, 1), relu=True, bn=True):
    """Unit3D: conv3d SAME [+ bias] [+ centre-only BN] [+ ReLU]."""
    w = params["w"]
    y = F.conv3d(F.pad(x, _same_pads(x, w.shape[2:], stride)), w,
                 params.get("b"), stride=stride)
    if bn:
        view = (1, -1, 1, 1, 1)
        inv = torch.rsqrt(params["var"] + _BN_EPS)
        y = (y - params["mean"].view(view)) * inv.view(view) \
            + params["beta"].view(view)
    if relu:
        y = F.relu(y)
    return y


def _max_pool3d(x, window, stride):
    x = F.pad(x, _same_pads(x, window, stride), value=float("-inf"))
    return F.max_pool3d(x, window, stride)


def _avg_pool3d_valid(x, window):
    return F.avg_pool3d(x, window, stride=1)


def _mixed(params, x):
    b0 = _unit3d(params["b0"], x)
    b1 = _unit3d(params["b1b"], _unit3d(params["b1a"], x))
    b2 = _unit3d(params["b2b"], _unit3d(params["b2a"], x))
    b3 = _unit3d(params["b3"], _max_pool3d(x, (3, 3, 3), (1, 1, 1)))
    return torch.cat([b0, b1, b2, b3], dim=1)


def i3d_apply(params, videos):
    """videos: (N, 3, T, 224, 224) float in [-1, 1] -> (N, 400)."""
    h = _unit3d(params["Conv3d_1a_7x7"], videos, stride=(2, 2, 2))
    h = _max_pool3d(h, (1, 3, 3), (1, 2, 2))
    h = _unit3d(params["Conv3d_2b_1x1"], h)
    h = _unit3d(params["Conv3d_2c_3x3"], h)
    h = _max_pool3d(h, (1, 3, 3), (1, 2, 2))
    h = _mixed(params["Mixed_3b"], h)
    h = _mixed(params["Mixed_3c"], h)
    h = _max_pool3d(h, (3, 3, 3), (2, 2, 2))
    for name in ["Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"]:
        h = _mixed(params[name], h)
    h = _max_pool3d(h, (2, 2, 2), (2, 2, 2))
    h = _mixed(params["Mixed_5b"], h)
    h = _mixed(params["Mixed_5c"], h)
    h = _avg_pool3d_valid(h, (2, 7, 7))
    logits = _unit3d(params["Logits"], h, relu=False, bn=False)  # (N,400,T',1,1)
    return logits[:, :, :, 0, 0].mean(dim=2)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _mixed_in_channels():
    chans = {"Mixed_3b": 192}
    order = list(_MIXED)
    for prev, cur in zip(order, order[1:]):
        c = _MIXED[prev]
        chans[cur] = c[0] + c[2] + c[4] + c[5]
    return chans


def _branch_shapes(name):
    """[(key, (kt, kh, kw, ic, oc)), ...] of one mixed block."""
    c_in = _mixed_in_channels()[name]
    b0, r1, c1, r2, c2, b3 = _MIXED[name]
    specs = [("b0", c_in, b0, 1), ("b1a", c_in, r1, 1), ("b1b", r1, c1, 3),
             ("b2a", c_in, r2, 1), ("b2b", r2, c2, 3), ("b3", c_in, b3, 1)]
    return [(key, (k, k, k, ic, oc)) for key, ic, oc, k in specs]


def variable_specs():
    """[(npz key, shape)] of the TF-Hub module's variables, as
    scripts/convert_i3d.py writes them: conv kernels DHWIO, the Logits
    bias (400,), batch-norm vectors (1, 1, 1, 1, C)."""
    def unit(prefix, w_shape, bn=True, bias=False):
        oc = w_shape[-1]
        specs = [(f"{prefix}/conv_3d/w", w_shape)]
        if bias:
            specs.append((f"{prefix}/conv_3d/b", (oc,)))
        if bn:
            specs += [(f"{prefix}/batch_norm/{k}", (1, 1, 1, 1, oc))
                      for k in ("beta", "moving_mean", "moving_variance")]
        return specs

    specs = []
    for name, shape in _STEM_SHAPES.items():
        specs += unit(f"{_TF_ROOT}/{name}", shape)
    for name in _MIXED:
        for (_, shape), (path, _) in zip(_branch_shapes(name), _BRANCH_PATHS):
            specs += unit(f"{_TF_ROOT}/{name}/{path}", shape)
    c = _MIXED["Mixed_5c"]
    specs += unit(f"{_TF_ROOT}/Logits/Conv3d_0c_1x1",
                  (1, 1, 1, c[0] + c[2] + c[4] + c[5], 400), bn=False,
                  bias=True)
    return specs


def _unit_from_jax(unit):
    out = {}
    for k, v in unit.items():
        v = np.asarray(v, np.float32)
        # conv kernels DHWIO -> OIDHW; BN vectors and the bias flat
        out[k] = torch.tensor(v.transpose(4, 3, 0, 1, 2) if k == "w"
                              else v.reshape(-1)).contiguous()
    return out


def i3d_params_from_jax(jparams):
    """The JAX package's I3D params (nested dicts of numpy arrays, as
    i3d_random_params or load_i3d_npz give them) -> the port's, float32 on
    the CPU."""
    return {name: (_unit_from_jax(node) if "w" in node else
                   {k: _unit_from_jax(u) for k, u in node.items()})
            for name, node in jparams.items()}


def params_to(params, device):
    return {name: {k: (v.to(device) if torch.is_tensor(v) else
                       {kk: vv.to(device) for kk, vv in v.items()})
                   for k, v in node.items()}
            for name, node in params.items()}


def load_i3d_npz(path):
    """I3D weights from an npz keyed by TF variable paths (the output of
    scripts/convert_i3d.py), float32 on the CPU."""
    with np.load(path) as arc:
        def unit(prefix, bn=True, bias=False):
            p = {"w": arc[f"{prefix}/conv_3d/w"]}
            if bias:
                p["b"] = arc[f"{prefix}/conv_3d/b"]
            if bn:
                p["beta"] = arc[f"{prefix}/batch_norm/beta"]
                p["mean"] = arc[f"{prefix}/batch_norm/moving_mean"]
                p["var"] = arc[f"{prefix}/batch_norm/moving_variance"]
            return p

        jparams = {name: unit(f"{_TF_ROOT}/{name}") for name in _STEM_SHAPES}
        for name in _MIXED:
            jparams[name] = {
                key: unit(f"{_TF_ROOT}/{name}/{path}")
                for (key, _), (path, _) in zip(_branch_shapes(name),
                                               _BRANCH_PATHS)}
        jparams["Logits"] = unit(f"{_TF_ROOT}/Logits/Conv3d_0c_1x1", bn=False,
                                 bias=True)
    return i3d_params_from_jax(jparams)
