"""Fréchet Video Distance (counterpart of srvp_tpu/metrics/fvd.py).

The reference's protocol:
  * videos go to the embedder in chunks of 16; a short last chunk is padded
    with the leading videos and their embeddings are dropped;
  * gray is repeated to 3 channels (a chunk at a time);
  * frames are resized to 224 x 224 by TF1's legacy bilinear resize
    (src = i * in / out: no half-pixel offset, no corner alignment; not
    F.interpolate, whose half-pixel centres give other frames), here two
    products with interpolation matrices on the device, then scaled to
    [-1, 1];
  * the embeddings are I3D's time-averaged kinetics-400 logits
    (metrics/i3d.py);
  * the distance is tf.contrib.gan's Fréchet distance from activations
    (unbiased covariances, the trace of the covariance product's square
    root), float64 on the host.

I3D weights: SRVP_TPU_I3D_WEIGHTS or `i3d_path` (an npz written by
scripts/convert_i3d.py).
"""

import math
import os

import numpy as np
import torch

from srvp_tpu_torch.config import resolve_device
from srvp_tpu_torch.metrics.i3d import i3d_apply, load_i3d_npz, params_to

CHUNK = 16


def _tf1_bilinear_matrix(in_size, out_size):
    """Interpolation matrix (out, in) of TF1's resize_bilinear defaults:
    src = out_idx * (in/out), no half-pixel offset, no corner alignment."""
    scale = in_size / out_size
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    hi = np.minimum(lo + 1, in_size - 1)
    mat = np.zeros((out_size, in_size), np.float32)
    mat[np.arange(out_size), lo] += (1.0 - frac).astype(np.float32)
    mat[np.arange(out_size), hi] += frac.astype(np.float32)
    return mat


def resize_bilinear_tf1(x, size):
    """TF1-legacy bilinear resize of an NHWC batch, as two products."""
    mh = torch.from_numpy(_tf1_bilinear_matrix(x.shape[1], size[0])).to(x)
    mw = torch.from_numpy(_tf1_bilinear_matrix(x.shape[2], size[1])).to(x)
    y = torch.einsum("oh,nhwc->nowc", mh, x)
    return torch.einsum("ow,nhwc->nhoc", mw, y)


def make_embedder(i3d_params, device):
    """embed(videos_u8): (n, T, H, W, 3) uint8 -> (n, 400) on `device`."""
    params = params_to(i3d_params, device)

    @torch.no_grad()
    def embed(videos_u8):
        n, t = videos_u8.shape[0], videos_u8.shape[1]
        frames = videos_u8.to(device).reshape((n * t,) + videos_u8.shape[2:])
        frames = resize_bilinear_tf1(frames.float(), (224, 224))
        vids = frames.reshape(n, t, 224, 224, 3)
        vids = 2.0 * vids / 255.0 - 1.0
        return i3d_apply(params, vids.permute(0, 4, 1, 2, 3))

    return embed


def compute_embeddings(embed_fn, videos):
    """videos: (N, T, H, W, C) uint8 numpy -> (N, 400) numpy, the
    reference's chunks of 16 padded with the leading videos. embed_fn takes
    a CPU tensor of one chunk."""
    n = videos.shape[0]
    if n < CHUNK:
        raise ValueError(f"FVD needs at least {CHUNK} videos, got {n}")
    gray = videos.shape[-1] == 1
    out = []
    for k in range(int(math.ceil(n / CHUNK))):
        start, stop = k * CHUNK, min(n, (k + 1) * CHUNK)
        chunk = videos[start:stop]
        n_k = stop - start
        if n_k < CHUNK:
            chunk = np.concatenate([chunk, videos[: CHUNK - n_k]], axis=0)
        if gray:
            # a chunk at a time, so the whole set is never tripled on the host
            chunk = np.repeat(chunk, 3, axis=-1)
        emb = torch.as_tensor(embed_fn(torch.from_numpy(chunk)))
        out.append(emb.cpu().numpy()[:n_k])
    return np.concatenate(out, axis=0)


def frechet_distance(act1, act2):
    """tf.contrib.gan's Fréchet distance from activations (float64 host
    math)."""
    act1 = np.asarray(act1, np.float64)
    act2 = np.asarray(act2, np.float64)
    m1, m2 = act1.mean(0), act2.mean(0)
    c1 = np.cov(act1, rowvar=False)
    c2 = np.cov(act2, rowvar=False)
    # trace(sqrt(c1 c2)) by the symmetric form sqrt(sqrt(c1) c2 sqrt(c1))
    s1 = _sqrtm_psd(c1)
    inner = s1 @ c2 @ s1
    tr_sqrt = np.sum(np.sqrt(np.maximum(np.linalg.eigvalsh(inner), 0.0)))
    return float(np.sum((m1 - m2) ** 2) + np.trace(c1) + np.trace(c2)
                 - 2.0 * tr_sqrt)


def _sqrtm_psd(mat):
    vals, vecs = np.linalg.eigh(mat)
    return (vecs * np.sqrt(np.maximum(vals, 0.0))) @ vecs.T


def default_i3d_path():
    return os.environ.get("SRVP_TPU_I3D_WEIGHTS",
                          os.path.join(os.path.dirname(__file__), "i3d.npz"))


def require_i3d(path=None):
    """The I3D npz's path; raises FileNotFoundError naming I3D without it."""
    path = path or default_i3d_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"I3D weights npz not found at {path}; produce one with "
            "scripts/convert_i3d.py (needs tensorflow_hub) and set "
            "SRVP_TPU_I3D_WEIGHTS")
    return path


def fvd(real, fake, i3d_path=None, device="cuda"):
    """FVD between two uint8 video sets (N, T, H, W, C), embedded on
    `device`."""
    embed = make_embedder(load_i3d_npz(require_i3d(i3d_path)),
                          resolve_device(device))
    emb_real = compute_embeddings(embed, np.asarray(real))
    emb_fake = compute_embeddings(embed, np.asarray(fake))
    return frechet_distance(emb_real, emb_fake)
