"""Content/dynamics swap grid from a trained SRVP checkpoint (counterpart of
scripts/swap.py).

The SRVP paper's disentanglement experiment (Figure 5, "content swap"):
the model factorises each video into a static content variable w (and the
skip activations) and a dynamic trajectory y_{1:T}; decoding the content of
video A with the dynamics of video B gives A's appearance doing B's motion.

    python -m srvp_tpu_torch.swap --xp_dir XP --data_dir DATA \
        [--n_videos 4] [--nt_gen 25] [--seed 0] [--out swap.npz] \
        [--gif GRID.gif] [--device cuda|cpu]

The latents come from the serving core (export.ServingModule, float32,
cuDNN's deterministic algorithms) on --seed's noise, and the n x n grid is
decoded in n batched decodes of n pairs each: decode k pairs content i with
dynamics (i + k) mod n. Decode 0 is the serving core's own decode of the
same batch, so the diagonal grid[i, i] is, bit for bit, the serving core's
prediction for --seed (generate.py's sample s for --seed
counter_rng.fold_in(seed, s)), whatever the device's convolutions do with
another batch size.

Output npz keys: `cond` (N, nt_cond, H, W, C) uint8 conditioning frames,
`gt` (N, nt_gen, ...) uint8, `grid` (N, N, nt_gen, H, W, C) uint8 with axes
(content, dynamics, time), truncated to uint8. --gif writes one animated
tiled figure: row i = content i, column j = dynamics j, the sources along
the edges (utils/gif.py).
"""

import argparse
import os

import numpy as np
import torch

from srvp_tpu_torch.config import cudnn_deterministic
from srvp_tpu_torch.generate import serving_core, to_u8
from srvp_tpu_torch.utils.gif import write_gif


def swap_grid(core, x_cond, seed):
    """(N, N, nt_gen, H, W, C) float32 frames of every (content, dynamics)
    pair of the N videos of x_cond (uint8 (nt_cond, N, H, W, C)), on the
    noise of `seed` (an int)."""
    n = x_cond.shape[1]
    eps = core.noise(torch.tensor(seed, dtype=torch.int64,
                                  device=x_cond.device), n, x_cond.shape[0])
    w, y, skips = core.latents(x_cond, eps)
    grid = [[None] * n for _ in range(n)]
    for k in range(n):
        dyn = (np.arange(n) + k) % n
        out = core.decode_frames(w, y[:, torch.from_numpy(dyn).to(y.device)],
                                 skips)
        for i in range(n):
            grid[i][dyn[i]] = out[:, i]
    return torch.stack([torch.stack(row) for row in grid])


def tiled(vids, grid, nt_cond, nt_gen, pad=2):
    """The GIF's frames: a (1 + n) x (1 + n) figure, the top row the
    dynamics sources (their ground truth, animated), the left column the
    content sources (their last conditioning frame), the body the grid."""
    n = grid.shape[0]
    t, h, w, c = grid.shape[2:]
    canvas = np.zeros((t, (n + 1) * (h + pad) - pad,
                       (n + 1) * (w + pad) - pad, c), np.uint8)

    def put(r, col, clip):
        canvas[:, r * (h + pad):r * (h + pad) + h,
               col * (w + pad):col * (w + pad) + w] = clip

    for j in range(n):
        put(0, j + 1, vids[j, :nt_gen] if vids.shape[1] >= nt_gen
            else vids[j, -1][None])
    for i in range(n):
        put(i + 1, 0, vids[i, nt_cond - 1][None])
        for j in range(n):
            put(i + 1, j + 1, grid[i, j])
    return canvas


def create_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--xp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--model_name", default="model.npz",
                   help=".npz JAX snapshot or .pt state_dict")
    p.add_argument("--nt_cond", type=int, default=None)
    p.add_argument("--nt_gen", type=int, default=None,
                   help="total frames incl. conditioning (default: config's "
                        "seq_len_test, else 25)")
    p.add_argument("--n_euler_steps", type=int, default=None)
    p.add_argument("--n_videos", type=int, default=4,
                   help="grid side: n content sources x n dynamics sources")
    p.add_argument("--video_offset", type=int, default=0,
                   help="index of the first test video used")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="output npz (default: <xp_dir>/swap.npz)")
    p.add_argument("--gif", default=None,
                   help="also write one animated grid figure here")
    p.add_argument("--fps", type=float, default=4.0, help="GIF frame rate")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    return p


def main(argv=None):
    a = create_args().parse_args(argv)

    core, vids, x_cond, nt_cond, nt_gen = serving_core(a)
    with torch.no_grad(), cudnn_deterministic():
        grid = to_u8(swap_grid(core, x_cond, a.seed)).cpu().numpy()

    out_path = a.out or os.path.join(a.xp_dir, "swap.npz")
    np.savez_compressed(out_path, cond=vids[:, :nt_cond],
                        gt=vids[:, :nt_gen], grid=grid)
    print(f"wrote {out_path}: grid {grid.shape} (content, dynamics, t, ...)")

    if a.gif:
        write_gif(a.gif, tiled(vids, grid, nt_cond, nt_gen), a.fps)
        n = grid.shape[0]
        print(f"wrote {a.gif}: {n + 1}x{n + 1} tiles, {grid.shape[2]} "
              f"frames (top row = dynamics sources, left column = content "
              f"sources)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
