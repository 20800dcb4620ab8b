"""LPIPS, net-lin on AlexNet (counterpart of srvp_tpu/metrics/lpips.py).

The subset of LPIPS v0.1 that the evaluation uses, the `alex` network:
  * the scaling layer: x in [-1, 1] -> (x - shift) / scale;
  * AlexNet's feature slices after each of its 5 ReLUs (channels 64, 192,
    384, 256, 256), a 3x3 max pool of stride 2 before convs 2 and 3;
  * each feature unit-normalised along the channels (+1e-10), the squared
    difference, the learned 1x1 `lin` head as a weighted channel sum, the
    spatial mean, and the sum over the five layers.

Tensors are NCHW, and the convolutions and pools are cuDNN's through
torch (the JAX package computes them with lax.conv and reduce_window: no
TPU kernel). Weights come from torch files in `lpips_dir`: the linear heads
from `alex.pth` (LPIPS v0.1), the backbone from a torchvision AlexNet
state_dict (`alexnet.pth` or `alexnet-owt-*.pth`). torchvision's OIHW
convolution weights go into F.conv2d as they are.
"""

import glob
import os

import numpy as np
import torch
import torch.nn.functional as F

# (out_ch, in_ch, kernel, stride, pad) of torchvision alexnet.features' convs
_ALEX_CONVS = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
# their indices in alexnet.features
_FEATURE_IDX = [0, 3, 6, 8, 10]
# maxpool(3, 2) after ReLUs 1 and 2 (before convs 2 and 3)
_POOL_BEFORE = {1, 2}

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def alex_lpips_apply(params, x, y):
    """LPIPS distance of NCHW images in [-1, 1]. Returns (N,).

    params: {"convs": [(weight OIHW, bias)] * 5, "lins": [(C,) weights] * 5},
    on the images' device."""
    shift = torch.from_numpy(_SHIFT).to(x).view(1, 3, 1, 1)
    scale = torch.from_numpy(_SCALE).to(x).view(1, 3, 1, 1)
    val = None
    fx, fy = (x - shift) / scale, (y - shift) / scale
    for i, ((w, b), lin) in enumerate(zip(params["convs"], params["lins"])):
        if i in _POOL_BEFORE:
            fx, fy = F.max_pool2d(fx, 3, 2), F.max_pool2d(fy, 3, 2)
        stride, pad = _ALEX_CONVS[i][3], _ALEX_CONVS[i][4]
        fx = F.relu(F.conv2d(fx, w, b, stride=stride, padding=pad))
        fy = F.relu(F.conv2d(fy, w, b, stride=stride, padding=pad))
        nx = fx / (torch.sqrt(torch.sum(fx * fx, dim=1, keepdim=True)) + 1e-10)
        ny = fy / (torch.sqrt(torch.sum(fy * fy, dim=1, keepdim=True)) + 1e-10)
        diff = torch.square(nx - ny)
        # the 1x1 'lin' conv (non-negative weights): a weighted channel sum
        layer_val = torch.einsum("nchw,c->nhw", diff, lin).mean(dim=(1, 2))
        val = layer_val if val is None else val + layer_val
    return val


def _f32(v):
    return torch.tensor(np.asarray(v, np.float32))


def convert_alexnet_state_dict(sd):
    """torchvision alexnet state_dict -> [(weight OIHW, bias)] of the five
    convs, float32 on the CPU."""
    return [(_f32(sd[f"features.{i}.weight"]), _f32(sd[f"features.{i}.bias"]))
            for i in _FEATURE_IDX]


def convert_lin_state_dict(sd):
    """LPIPS v0.1 alex.pth state_dict -> the five heads' (C,) weights."""
    return [_f32(sd[f"lin{i}.model.1.weight"]).reshape(-1) for i in range(5)]


def lpips_params_from_jax(jparams):
    """The JAX package's LPIPS params as numpy ({"convs": [{"kernel" HWIO,
    "bias"}], "lins": [(C, 1)]}) -> the port's."""
    return {"convs": [(_f32(np.asarray(c["kernel"]).transpose(3, 2, 0, 1))
                       .contiguous(), _f32(c["bias"]))
                      for c in jparams["convs"]],
            "lins": [_f32(lin).reshape(-1) for lin in jparams["lins"]]}


def params_to(params, device):
    return {"convs": [(w.to(device), b.to(device)) for w, b in params["convs"]],
            "lins": [lin.to(device) for lin in params["lins"]]}


def load_lpips_params(lpips_dir):
    """Backbone and linear-head weights from the torch files in lpips_dir
    (the JAX package's search order and errors), on the CPU."""
    lin_path = os.path.join(lpips_dir, "alex.pth")
    if not os.path.exists(lin_path):
        nested = os.path.join(lpips_dir, "weights", "v0.1", "alex.pth")
        if os.path.exists(nested):
            lin_path = nested
        else:
            raise FileNotFoundError(f"LPIPS linear weights not found: {lin_path}")
    candidates = ([os.path.join(lpips_dir, "alexnet.pth")]
                  + sorted(glob.glob(os.path.join(lpips_dir, "alexnet-owt-*.pth"))))
    backbone_path = next((p for p in candidates if os.path.exists(p)), None)
    if backbone_path is None:
        raise FileNotFoundError(
            f"AlexNet backbone weights not found in {lpips_dir} "
            "(expected alexnet.pth or alexnet-owt-*.pth; torchvision "
            "downloads these online — place a copy for offline use)")
    lin_sd = torch.load(lin_path, map_location="cpu")
    bb_sd = torch.load(backbone_path, map_location="cpu")
    return {"convs": convert_alexnet_state_dict(bb_sd),
            "lins": convert_lin_state_dict(lin_sd)}


def make_video_lpips(lpips_dir, device):
    """fn(pred, target): (T, B, H, W, C) in [0, 1] on `device` -> per-frame
    LPIPS (T, B). Gray is repeated to 3 channels and frames are scaled to
    [-1, 1], as the reference's PerceptualLoss does."""
    params = params_to(load_lpips_params(lpips_dir), device)

    @torch.no_grad()
    def video_lpips(pred, target):
        t, b = pred.shape[0], pred.shape[1]

        def frames(v):
            v = v.reshape((t * b,) + v.shape[2:]).permute(0, 3, 1, 2)
            if v.shape[1] == 1:
                v = v.expand(-1, 3, -1, -1)
            return v.float() * 2.0 - 1.0

        return alex_lpips_apply(params, frames(pred),
                                frames(target)).reshape(t, b)

    return video_lpips
