"""Pixel-space metrics (counterpart of srvp_tpu/metrics/pixel.py)."""

import torch


def frame_mse(pred, target):
    """(T, B, H, W, C) pairs -> per-(frame, video, channel) MSE (T, B, C)."""
    d = pred.float() - target.float()
    return torch.mean(d * d, dim=(2, 3))


def psnr_from_mse(mse, max_val=1.0):
    return 10.0 * torch.log10((max_val * max_val) / mse)
