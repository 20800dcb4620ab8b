"""SSIM (counterpart of srvp_tpu/metrics/ssim.py).

11x11 kernel made by a softmax over the -(x^2+y^2)/(2 sigma^2) grid (not a
normalised Gaussian), sigma 1.5; depthwise VALID convolutions for the local
moments; k1 = 0.01, k2 = 0.03. Public tensors are channels-last.
"""

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(size=11, sigma=1.5):
    """(size, size) softmax-normalised window as float32 numpy."""
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    grid = -(coords[None, :] ** 2 + coords[:, None] ** 2) / (2.0 * sigma ** 2)
    flat = np.exp(grid.reshape(-1) - grid.max())
    return (flat / flat.sum()).reshape(size, size).astype(np.float32)


def ssim(x, y, max_val=1.0, filter_size=11, k1=0.01, k2=0.03, sigma=1.5):
    """Per-pixel SSIM map of two NHWC batches: (N, H-10, W-10, C)."""
    c = x.shape[-1]
    kern = torch.from_numpy(gaussian_kernel(filter_size, sigma)).to(x)
    kern = kern.expand(c, 1, filter_size, filter_size).contiguous()
    conv = lambda a: F.conv2d(a, kern, groups=c)  # noqa: E731
    x = x.permute(0, 3, 1, 2)
    y = y.permute(0, 3, 1, 2)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu1, mu2 = conv(x), conv(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(x * x) - mu1_sq
    sigma2_sq = conv(y * y) - mu2_sq
    sigma12 = conv(x * y) - mu1_mu2
    num = (2 * mu1_mu2 + c1) * (2 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    return (num / den).permute(0, 2, 3, 1)


def video_ssim(pred, target, max_val=1.0):
    """(T, B, H, W, C) videos -> per-(frame, video, channel) SSIM (T, B, C):
    the per-pixel map averaged spatially."""
    t, b = pred.shape[0], pred.shape[1]
    maps = ssim(pred.reshape((t * b,) + pred.shape[2:]),
                target.reshape((t * b,) + target.shape[2:]), max_val=max_val)
    return maps.mean(dim=(1, 2)).reshape(t, b, pred.shape[-1])
