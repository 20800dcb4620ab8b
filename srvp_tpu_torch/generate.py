"""Conditional video generation from a trained SRVP checkpoint (counterpart
of scripts/generate.py).

Loads config.json and a checkpoint from --xp_dir as test_main does,
conditions on the first nt_cond frames of test-set videos and writes
sampled futures through the serving core (export.ServingModule, in
float32, under cuDNN's deterministic algorithms):

    python -m srvp_tpu_torch.generate --xp_dir XP --data_dir DATA \
        [--nt_gen 25] [--n_samples 5] [--n_videos 8] [--seed 0] \
        [--out samples.npz] [--gif_dir gifs/] [--device cuda|cpu]

Sample s draws its noise from the seed counter_rng.fold_in(--seed, s): it
is the serving core's prediction (and an artifact's, before quantisation)
for that seed. Output npz keys: `cond` (N, nt_cond, H, W, C) uint8, `gt`
(N, nt_gen, ...) uint8, `samples` (S, N, nt_gen, H, W, C) uint8, each
sample covering the full horizon (reconstructed conditioning frames and
prediction), truncated to uint8 as test_main's artifacts are.
--gif_dir also writes one animated GIF per (video, sample) with the port's
own writer (utils/gif.py).
"""

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from srvp_tpu_torch.config import cudnn_deterministic, strict_fp32
from srvp_tpu_torch.export import load_xp_model, make_serving_fn
from srvp_tpu_torch.ops.counter_rng import fold_in
from srvp_tpu_torch.utils.gif import write_gif


def test_videos(xp_config, data_dir, nt_gen, n_videos, offset=0):
    """uint8 (N, T, H, W, C) videos offset.. of the config's test fold, read
    at nt_gen frames (Moving MNIST's test archive, or data/base's test
    dataset), N at most n_videos."""
    if xp_config["dataset"] == "smmnist":
        from srvp_tpu_torch.data.mmnist_test import load_test_sequences
        seqs = load_test_sequences(data_dir, xp_config["nx"],
                                   xp_config["ndigits"],
                                   xp_config["deterministic"])
        vids = np.transpose(seqs, (1, 0, 2, 3))[offset:offset + n_videos]
    else:
        from srvp_tpu_torch.data.base import load_dataset
        testset = load_dataset(SimpleNamespace(
            **{**xp_config, "data_dir": data_dir, "seq_len": nt_gen}),
            train=False)
        n = min(n_videos, len(testset) - offset)
        vids = np.stack([np.asarray(testset.get_item(offset + i))
                         for i in range(n)])
    return vids[..., None] if vids.ndim == 4 else vids


def horizon(a, xp_config):
    """(nt_cond, nt_gen, oversampling) from the flags and the config, as
    the JAX scripts take them."""
    nt_cond = a.nt_cond if a.nt_cond is not None else xp_config["nt_cond"]
    nt_gen = a.nt_gen or xp_config.get("seq_len_test") or 25
    o = a.n_euler_steps if a.n_euler_steps is not None \
        else xp_config["n_euler_steps"]
    return nt_cond, nt_gen, o


def serving_core(a, dtype=torch.float32):
    """The flags' checkpoint, test videos and serving core: (core, vids
    uint8 (N, T, H, W, C), x_cond uint8 (nt_cond, N, H, W, C) on the
    device, nt_cond, nt_gen)."""
    xp_config, cfg, model = load_xp_model(a.xp_dir, a.model_name, a.device)
    nt_cond, nt_gen, o = horizon(a, xp_config)
    vids = test_videos(xp_config, a.data_dir, nt_gen, a.n_videos,
                       getattr(a, "video_offset", 0))
    device = next(model.parameters()).device
    x_cond = torch.from_numpy(np.ascontiguousarray(
        np.transpose(vids[:, :nt_cond], (1, 0, 2, 3, 4)))).to(device)
    strict_fp32()
    core = make_serving_fn(cfg, model, nt_gen, oversampling=o,
                           compute_dtype=dtype)
    return core, vids, x_cond, nt_cond, nt_gen


def to_u8(x):
    """float [0, 1] -> uint8, truncating (test_main's artifacts)."""
    return (x * 255.0).to(torch.uint8)


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
    p.add_argument("--n_samples", type=int, default=5)
    p.add_argument("--n_videos", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="output npz (default: <xp_dir>/samples.npz)")
    p.add_argument("--gif_dir", default=None,
                   help="also write per-(video, sample) animated GIFs here")
    p.add_argument("--fps", type=float, default=4.0, help="GIF frame rate")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    return p


def main(argv=None):
    a = create_args().parse_args(argv)

    core, vids, x_cond, nt_cond, nt_gen = serving_core(a)
    n = vids.shape[0]
    samples = []
    with torch.no_grad(), cudnn_deterministic():
        for s in range(a.n_samples):
            seed = torch.tensor(fold_in(a.seed, s), dtype=torch.int64,
                                device=x_cond.device)
            x = core.predict(x_cond, core.noise(seed, n, nt_cond))
            samples.append(to_u8(x).transpose(0, 1).cpu().numpy())
    samples_u8 = np.stack(samples)              # (S, N, T, H, W, C)

    out_path = a.out or os.path.join(a.xp_dir, "samples.npz")
    np.savez_compressed(out_path, cond=vids[:, :nt_cond],
                        gt=vids[:, :nt_gen], samples=samples_u8)
    print(f"wrote {out_path}: cond {vids[:, :nt_cond].shape}, "
          f"samples {samples_u8.shape}")

    if a.gif_dir:
        os.makedirs(a.gif_dir, exist_ok=True)
        for v in range(n):
            for s in range(a.n_samples):
                write_gif(os.path.join(a.gif_dir, f"video{v}_sample{s}.gif"),
                          samples_u8[s, v], a.fps)
        print(f"wrote {n * a.n_samples} GIFs to {a.gif_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
