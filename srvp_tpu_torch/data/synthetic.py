"""Synthetic datasets written with numpy and the stdlib PNG writer
(data/png.py), in the layouts the port's datasets read, for machines
without PIL or the datasets themselves: the loader bench's frame trees
(the counterpart of scripts/bench_loader.py's), and the KTH, BAIR and
Human3.6M trees of chip_smoke.py's phases.

- `bench_frame`, `write_bench_kth_tree`, `write_bench_bair_tree`: smooth
  moving gradients, plus `noise_amp`, per-pixel noise that sets the PNG
  sizes (at about 14 PIL's files are a natural 64x64 RGB frame's 6-8 KB,
  BAIR's; this writer's forced row filters make them 10.6 KB, gray 3.7),
  as KTH's training tree `processed_{nx}/<class>/person<NN>_<class>_
  d<i>/<t>.png` (persons 1-20, gray) and BAIR's `processed_data/train/
  traj_<k>/<j>/<t>.png` (RGB); `write_kth_test_videos` adds the test
  persons 21-25, trials 1-4 (RGB, read for their red channel), that the
  KTH test-set maker (data/test_sets.py) draws from.
- `kth_tree_videos`, `write_kth_packed_tree`, `write_kth_png_tree`,
  `write_bair_trees`, `write_human_tree`: moving figures and discs,
  written once as a PNG tree and once packed, or as Human3.6M's npz
  videos.
"""

import itertools
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from srvp_tpu_torch.data.kth import CLASSES
from srvp_tpu_torch.data.png import write_png_video

# the JAX bench's tree sizes (scripts/bench_loader.py:63, :83)
BENCH_KTH_VIDEOS, BENCH_KTH_FRAMES = 120, 120
BENCH_BAIR_VIDEOS, BAIR_FRAMES = 256, 30


def bench_frame(i, t, rgb=False, noise_amp=0, nx=64):
    """Frame t of video i: a smooth moving gradient, plus with `noise_amp`
    per-pixel noise (same luma in the three channels, noise drawn per
    channel). noise_amp 0 compresses like clean rendered video; about 14
    like natural camera video, whose file sizes set the decode cost."""
    y, x = np.mgrid[0:nx, 0:nx]
    img = ((np.sin(x / 9.0 + i * 0.7 + t * 0.13)
            + np.cos(y / 7.0 + t * 0.11)) * 55 + 120)
    if noise_amp:
        rng = np.random.RandomState(i * 1000 + t)
        shape = (nx, nx, 3) if rgb else (nx, nx)
        noisy = img[..., None] if rgb else img
        return np.clip(noisy + rng.randint(-noise_amp, noise_amp + 1, shape),
                       0, 255).astype(np.uint8)
    img = img.astype(np.uint8)
    if not rgb:
        return img
    return np.stack([img, np.roll(img, t, 0), 255 - img], -1)


def bench_video(i, n_frames, rgb=False, noise_amp=0, nx=64):
    return np.stack([bench_frame(i, t, rgb, noise_amp, nx)
                     for t in range(n_frames)])


def _write_bench_video(job):
    vdir, name, i, n_frames, rgb, noise_amp, nx = job
    return write_png_video(vdir, bench_video(i, n_frames, rgb, noise_amp,
                                             nx), name)


def write_bench_videos(jobs, processes=1):
    """Writes each job's video, (vdir, file name pattern, video index i,
    frames, rgb, noise_amp, nx), in `processes` spawned worker processes
    (one: here); returns the frame paths in the jobs' order."""
    if processes <= 1:
        return [p for job in jobs for p in _write_bench_video(job)]
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(processes, mp_context=spawn) as pool:
        return [p for paths in pool.map(_write_bench_video, jobs,
                                        chunksize=4) for p in paths]


def write_bench_kth_tree(root, n_videos=BENCH_KTH_VIDEOS,
                         n_frames=BENCH_KTH_FRAMES, noise_amp=0, nx=64,
                         processes=1):
    """KTH's training PNG tree of n_videos gray videos: video i of class
    CLASSES[i % 6] and person i % 20 + 1, `{t:03d}.png`. Returns the
    frame paths."""
    jobs = []
    for i in range(n_videos):
        c = CLASSES[i % len(CLASSES)]
        jobs.append((Path(root) / f"processed_{nx}" / c
                     / f"person{i % 20 + 1:02d}_{c}_d{i:04d}", "{:03d}.png",
                     i, n_frames, False, noise_amp, nx))
    return write_bench_videos(jobs, processes)


def write_kth_test_videos(root, n_frames, noise_amp=0, nx=64, processes=1):
    """The test persons 21-25 of KTH's PNG tree, every class and trials
    1-4 (`person{NN}_{class}_d{K}/image-{t:03d}.png`, ffmpeg's names),
    RGB frames. Returns the frame paths."""
    videos = itertools.product(CLASSES, range(21, 26), range(1, 5))
    jobs = [(Path(root) / f"processed_{nx}" / c
             / f"person{person:02d}_{c}_d{trial}", "image-{:03d}.png",
             10_000 + k, n_frames, True, noise_amp, nx)
            for k, (c, person, trial) in enumerate(videos)]
    return write_bench_videos(jobs, processes)


def write_bench_bair_tree(root, n_videos=BENCH_BAIR_VIDEOS, noise_amp=0,
                          processes=1):
    """BAIR's training PNG tree of n_videos RGB videos of 30 frames, video
    i in `traj_{i // 32}/{i % 32}`. Returns the frame paths."""
    jobs = [(Path(root) / "processed_data" / "train" / f"traj_{i // 32}"
             / str(i % 32), "{:02d}.png", i, BAIR_FRAMES, True, noise_amp, 64)
            for i in range(n_videos)]
    return write_bench_videos(jobs, processes)


def synthetic_kth_videos(n, n_frames, nx, rng):
    """uint8 (n, T, nx, nx) KTH-like videos: a static background of flat
    8x8 blocks with faint noise, and a flat dark figure (a body and a head)
    walking across at a constant speed and turning at the borders. The flat
    regions make tied 2x2 windows, as KTH's plain backgrounds do."""
    yy, xx = np.mgrid[0:nx, 0:nx]
    out = np.empty((n, n_frames, nx, nx), np.uint8)
    for i in range(n):
        bg = 80.0 + 100.0 * np.kron(rng.rand(nx // 8, nx // 8),
                                    np.ones((8, 8)))
        bg = np.round(bg) + rng.randint(0, 2, (nx, nx)) * (rng.rand() < 0.5)
        cy, cx = rng.uniform(0.4 * nx, 0.6 * nx), rng.uniform(8, nx - 8)
        vx = rng.choice([-3, -2, -1, 1, 2, 3])
        for t in range(n_frames):
            body = ((xx - cx) / 5.0) ** 2 + ((yy - cy) / 13.0) ** 2 <= 1
            head = (xx - cx) ** 2 + (yy - cy + 17) ** 2 <= 16
            out[i, t] = np.where(body | head, 40, bg)
            cx += vx
            if not 6 <= cx <= nx - 6:
                vx, cx = -vx, float(np.clip(cx, 6, nx - 6))
    return out


def kth_tree_videos(nx, seed):
    """(class, video name, uint8 (T, nx, nx) video) of the synthetic KTH
    training tree: 6 classes x persons 1-25, one video each of 32 to 47
    frames, but 16 for person 1 (shorter than a training window, which
    makes the loader draw again)."""
    rng = np.random.RandomState(seed)
    for c in CLASSES:
        for person in range(1, 26):
            n_frames = 16 if person == 1 else rng.randint(32, 48)
            yield (c, f"person{person:02d}_{c}_d1",
                   synthetic_kth_videos(1, n_frames, nx, rng)[0])


def write_kth_packed_tree(data_dir, nx, seed):
    """The packed KTH training tree (data/kth.py) of kth_tree_videos, and
    its COMPLETE.json. Returns the number of videos."""
    root = Path(data_dir) / f"packed_{nx}"
    n = 0
    for c, name, video in kth_tree_videos(nx, seed):
        (root / c).mkdir(parents=True, exist_ok=True)
        np.save(root / c / f"{name}.npy", video)
        n += 1
    with open(root / "COMPLETE.json", "w") as f:
        json.dump({"videos": n}, f)
    return n


def write_kth_png_tree(data_dir, nx, seed):
    """The PNG tree `processed_{nx}/{class}/{video}/image-{t}.png` of the
    same videos as write_kth_packed_tree(data_dir, nx, seed): every third
    video's frames as RGB files whose red channel is the frame (the
    loaders keep the red channel). Returns the frame paths written."""
    paths = []
    for k, (c, name, video) in enumerate(kth_tree_videos(nx, seed)):
        if k % 3 == 0:
            video = np.stack([video, 255 - video, video // 2], axis=-1)
        paths += write_png_video(
            Path(data_dir) / f"processed_{nx}" / c / name, video,
            "image-{:03d}.png")
    return paths


def synthetic_rgb_videos(n, n_frames, nx, rng):
    """uint8 (n, T, nx, nx, 3) videos: a static colour gradient and a flat
    coloured disc moving at a constant speed, turning at the borders."""
    yy, xx = np.mgrid[0:nx, 0:nx] / (nx - 1.0)
    out = np.empty((n, n_frames, nx, nx, 3), np.uint8)
    t = np.arange(n_frames)[:, None]
    for i in range(n):
        c0, c1, disc = rng.rand(3, 3) * [[120], [120], [255]]
        a = rng.rand() * 2 * np.pi
        ramp = (np.cos(a) * xx + np.sin(a) * yy + 1) / 2
        bg = np.round(c0 + ramp[..., None] * (c1 - c0))
        pos = rng.uniform(0.2, 0.8, 2) + rng.uniform(-0.03, 0.03, 2) * t
        pos = 1 - np.abs(1 - np.mod(pos, 2))    # (T, 2), bouncing in [0, 1]
        inside = (xx - pos[:, :1, None]) ** 2 \
            + (yy - pos[:, 1:, None]) ** 2 <= 0.02
        out[i] = np.where(inside[..., None], np.round(disc), bg)
    return out


def write_bair_trees(png_dir, packed_dir, n_train, n_test, seed):
    """A BAIR dataset twice, as the PNG tree `png_dir/processed_data/
    {train,test}/traj_{v // 16}/{v % 16}/{t:02d}.png`
    (scripts/make_synthetic_bair.py's layout) and as the packed tree
    `packed_dir/packed_data/{fold}/traj_{v // 16}/{v % 16}.npy` with its
    COMPLETE.json (preprocessing/bair/pack.py's): synthetic_rgb_videos of
    30 frames. Returns the frame paths written."""
    rng = np.random.RandomState(seed)
    paths = []
    for fold, n in (("train", n_train), ("test", n_test)):
        packed = Path(packed_dir) / "packed_data" / fold
        for v, video in enumerate(synthetic_rgb_videos(n, 30, 64, rng)):
            rel = Path(f"traj_{v // 16}") / str(v % 16)
            paths += write_png_video(
                Path(png_dir) / "processed_data" / fold / rel, video)
            (packed / rel.parent).mkdir(parents=True, exist_ok=True)
            np.save(packed / f"{rel}.npy", video)
        with open(packed / "COMPLETE.json", "w") as f:
            json.dump({"videos": n}, f)
    return paths


def val_fold(n):
    """The items of a training dataset of n that go to the validation fold
    (data/base.VideoDataset.get_fold)."""
    ids = list(range(n))
    np.random.RandomState(42).shuffle(ids)
    return set(ids[int(0.95 * n):])


def write_human_tree(data_dir, n_train, train_len, val_len, n_test,
                     seq_len, subsampling, seed):
    """A Human3.6M tree (preprocessing/human/convert.py's and
    make_test_set.py's layout): `train/S{s}_Act_{v}.npz` of
    synthetic_rgb_videos of train_len = (lo, hi) frames, but val_len for
    the videos of the validation fold (a validation window spans
    (seq_len_test - 1) * subsampling + 1 frames), and `test_set_{seq_len}_
    {subsampling}/test_{i}.npz` clips of (seq_len - 1) * subsampling + 1
    frames."""
    rng = np.random.RandomState(seed)
    names = [f"S{1 + v % 5}_Act_{v}" for v in range(n_train)]
    in_order = sorted(names)     # the dataset's order: sorted file names
    val = {in_order[i] for i in val_fold(n_train)}
    (Path(data_dir) / "train").mkdir(parents=True, exist_ok=True)
    for v, name in enumerate(names):
        n_frames = val_len if name in val else rng.randint(*train_len)
        np.savez(Path(data_dir) / "train" / f"{name}.npz",
                 image=synthetic_rgb_videos(1, n_frames, 64, rng)[0],
                 filename=name, subject=1 + v % 5)
    test = Path(data_dir) / f"test_set_{seq_len}_{subsampling}"
    test.mkdir(parents=True, exist_ok=True)
    for i, clip in enumerate(synthetic_rgb_videos(
            n_test, (seq_len - 1) * subsampling + 1, 64, rng)):
        np.savez(test / f"test_{i}.npz", image=clip, frame=0)
