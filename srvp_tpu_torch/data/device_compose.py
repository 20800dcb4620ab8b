"""Moving MNIST frames composited on the device (counterpart of
srvp_tpu/data/device_compose.py).

The host ships only digit images and their trajectories; the device places
each digit with two one-hot placement products, P_x @ digit @ P_y^T, sums the
digits of a frame and clamps at 255. Each output of a one-hot product has at
most one nonzero term and the values are integers <= 255, so the products
are exact in float32 and the result is bit-equal to
MovingMNIST.get_item for the same draws.
"""

import numpy as np
import torch


def composite_mmnist(digits, pos, frame_size=64):
    """digits: (B, D, h, w) uint8; pos: (B, D, T, 2) int32 top-left corners.
    Returns (T, B, frame_size, frame_size, 1) uint8."""
    _, _, h, w = digits.shape
    fx = torch.arange(frame_size, device=digits.device)
    sx, sy = pos[..., 0].long(), pos[..., 1].long()          # (B, D, T)
    oh_x = (fx[:, None] == sx[..., None, None]
            + torch.arange(h, device=digits.device)).float()  # (B,D,T,fs,h)
    oh_y = (fx[:, None] == sy[..., None, None]
            + torch.arange(w, device=digits.device)).float()  # (B,D,T,fs,w)
    d = digits.float()
    placed_y = torch.einsum("bdrc,bdtyc->bdtry", d, oh_y)
    frames = torch.einsum("bdtxr,bdtry->bdtxy", oh_x, placed_y)
    video = frames.sum(dim=1).clamp(max=255).to(torch.uint8)
    return video.transpose(0, 1)[..., None]


def is_parts_batch(batch):
    return isinstance(batch, dict) and "digits" in batch and "pos" in batch


def materialize(batch, frame_size=64):
    """Parts dict or dense tensor -> float32 (T, B, H, W, C) in [0, 1]."""
    if is_parts_batch(batch):
        batch = composite_mmnist(batch["digits"], batch["pos"], frame_size)
    if batch.dtype == torch.uint8:
        batch = batch.float() / 255.0
    return batch


def parts_collate(items):
    """Collates [(digits (D, h, w), pos (D, T, 2)), ...] into the parts
    dict of numpy arrays."""
    return {"digits": np.stack([it[0] for it in items]),
            "pos": np.stack([it[1] for it in items]).astype(np.int32)}


def stack_batches(batches):
    """Host batches (parts dicts or uint8 arrays) stacked on a new leading
    axis, parts dicts leaf-wise: a window of len(batches) steps
    (srvp_tpu/parallel shard_stacked_batches)."""
    if is_parts_batch(batches[0]):
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    return np.stack(batches)


def window_batch(window, j):
    """Step j's batch of a stacked window."""
    if is_parts_batch(window):
        return {k: v[j] for k, v in window.items()}
    return window[j]


def to_device(batch, device):
    """A host batch (parts dict or uint8 array) as tensors on `device`. To a
    CUDA device each array is copied into pinned memory of its own and sent
    with a non-blocking copy, so that the next batch's transfer overlaps the
    running step (srvp_tpu/train_main.py `device_batches`); torch's pinned
    allocator keeps a buffer until its copy has finished."""
    def send(v):
        t = torch.from_numpy(v)
        if torch.device(device).type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)
    if is_parts_batch(batch):
        return {k: send(v) for k, v in batch.items()}
    return send(batch)
