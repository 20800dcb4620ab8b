#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (srvp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the CUDA kernels from srvp_tpu_torch/csrc with nvcc;
  3. kernel vs plain: the prior-rollout kernel against its plain PyTorch
     version on the card, at the shapes of the main path (B=160, 20 steps),
     at a whole batch (B=1600) and at a small o=2, ny != nz case, with
     rtol 1e-4 / atol 1e-5 (the JAX suite's rollout tolerance); times with
     CUDA events beside the bound;
  4. main path: the evaluation CLI (srvp_tpu_torch.test_main) at the full
     width of the Stochastic Moving MNIST dcgan model with seeded random
     weights, on synthetic moving-glyph sequences: 2 batches of 16 videos,
     5 conditioning + 20 predicted frames, 100 samples in chunks of 10. It
     runs once through the kernel and once with the eager rollout on the
     same noise; the two must agree.
Then it prints one {"kernels": [...]} line and, last, the device line.
It exits non-zero without a result when CUDA is unavailable.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from srvp_tpu_torch import test_main
from srvp_tpu_torch.config import model_config, strict_fp32
from srvp_tpu_torch.kernels import build as kbuild
from srvp_tpu_torch.kernels import rollout as krollout
from srvp_tpu_torch.models.mlp import MLP
from srvp_tpu_torch.models.srvp import SRVP

ROOT = Path(__file__).resolve().parent
WORK_DIR = ROOT / "build" / "chip_smoke"
SEED = 0
RTOL, ATOL = 1e-4, 1e-5
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Stochastic Moving MNIST, dcgan, the flagship widths
# (configs/smmnist-stochastic.yaml, bench.py) and the test protocol.
XP_CONFIG = dict(dataset="smmnist", nx=64, nc=1, nf=64, nhx=128, ny=20, nz=20,
                 skipco=False, nt_inf=5, nh_inf=256, nlayers_inf=3,
                 nh_res=512, nlayers_res=4, archi="dcgan", nt_cond=5,
                 n_euler_steps=1, ndigits=2, max_speed=4, deterministic=False,
                 seq_len=15, seq_len_test=25)
N_VIDEOS, BATCH, N_SAMPLES, CHUNK = 32, 16, 100, 10


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, iters=20):
    """Mean milliseconds per call over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rollout_bound_ms(pz_layers, dyn_layers, bsz, n_steps, oversampling, ny,
                     nz):
    """Least time for the rollout on an H100: the larger of the bytes it
    must move over the memory rate and its FLOPs over the fp32 rate. The
    p_z MLP and the eps it reads are needed only on the first substep of
    each frame."""
    n_frames = -(-n_steps // oversampling)
    macs = lambda layers: sum(w.numel() for w, _ in layers)  # noqa: E731
    flops = 2.0 * bsz * (n_frames * macs(pz_layers)
                         + n_steps * macs(dyn_layers))
    n_params = sum(w.numel() + b.numel() for w, b in pz_layers + dyn_layers)
    n_bytes = 4.0 * (n_params + bsz * ny + n_frames * bsz * nz
                     + n_steps * bsz * ny)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_rollout(name, pz_layers, dyn_layers, bsz, n_steps, oversampling,
                  ny, nz, seed):
    """Kernel vs plain version on the card; returns the measured row."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y0 = torch.randn(bsz, ny, generator=gen, device="cuda")
    eps = torch.randn(n_steps, bsz, nz, generator=gen, device="cuda")
    args = (pz_layers, dyn_layers, y0, eps, ny, nz, oversampling)
    with torch.no_grad():
        out = krollout.prior_rollout(*args)
        ref = krollout.prior_rollout_reference(*args)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        max_abs = diff.max().item()
        max_rel = (diff / ref.abs().clamp_min(1e-30)).max().item()
        worst = (diff / (ATOL + RTOL * ref.abs())).max().item()
        ok = bool(torch.isfinite(out).all()) and worst <= 1.0
        ms = cuda_ms(lambda: krollout.prior_rollout(*args))
        plain_ms = cuda_ms(lambda: krollout.prior_rollout_reference(*args))
    bound_ms, bound_by = rollout_bound_ms(pz_layers, dyn_layers, bsz, n_steps,
                                          oversampling, ny, nz)
    row = dict(case=name, B=bsz, n_steps=n_steps, oversampling=oversampling,
               ny=ny, nz=nz, rows_per_block=krollout.rows_per_block(bsz),
               max_abs_err=max_abs, max_rel_err=max_rel,
               err_over_tol=worst, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    print("kernel_check " + json.dumps(row), flush=True)
    if not ok:
        raise SystemExit(f"prior_rollout kernel disagrees with its plain "
                         f"version ({name}): max |err| / (atol + rtol |ref|) "
                         f"= {worst}")
    return row


def synthetic_sequences(n, seq_len, nx, seed, n_glyphs=2, size=28,
                        max_speed=4):
    """uint8 (T, N, H, W) moving-glyph videos: soft random strokes that move
    at a constant speed and bounce off the frame borders."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    out = np.zeros((seq_len, n, nx, nx), np.float32)
    for i in range(n):
        for _ in range(n_glyphs):
            img = np.zeros((size, size), np.float32)
            for _ in range(rng.randint(2, 5)):
                (x0, y0), (x1, y1) = rng.uniform(4, size - 4, size=(2, 2))
                for t in np.linspace(0, 1, 16):
                    d2 = (xx - x0 - t * (x1 - x0)) ** 2 \
                        + (yy - y0 - t * (y1 - y0)) ** 2
                    img = np.maximum(img, 255.0 * np.exp(-d2 / 2.6))
            lim = nx - size
            pos = rng.randint(0, lim + 1, size=2).astype(np.int64)
            vel = rng.randint(-max_speed, max_speed + 1, size=2)
            for t in range(seq_len):
                out[t, i, pos[0]:pos[0] + size, pos[1]:pos[1] + size] += img
                pos += vel
                for a in range(2):
                    if pos[a] < 0 or pos[a] > lim:
                        vel[a] = -vel[a]
                        pos[a] = np.clip(pos[a], 0, lim)
    return np.minimum(out, 255).astype(np.uint8)


def check_artifacts(arts, t_cond, t_pred, nx):
    res = arts["results"]
    if set(res) != {"psnr", "ssim"}:
        raise SystemExit(f"results.npz keys {sorted(res)}")
    for k, v in res.items():
        if v.shape != (N_VIDEOS,) or v.dtype != np.float32 \
                or not np.all(np.isfinite(v)):
            raise SystemExit(f"results[{k}]: {v.shape} {v.dtype}")
    for name, arc in arts.items():
        if name == "results":
            continue
        t = t_cond if name == "cond_rec" else t_pred
        s = arc["samples"]
        if s.shape != (N_VIDEOS, t, nx, nx, 1) or s.dtype != np.uint8:
            raise SystemExit(f"{name}: {s.shape} {s.dtype}")


def main_path(model_seed):
    """The evaluation CLI, through the kernel and then through the eager
    rollout on the same noise; returns the kernel run's summary."""
    cfg = XP_CONFIG
    xp_dir, data_dir = WORK_DIR / "xp", WORK_DIR / "data"
    xp_dir.mkdir(parents=True, exist_ok=True)
    data_dir.mkdir(parents=True, exist_ok=True)
    with open(xp_dir / "config.json", "w") as f:
        json.dump(cfg, f)
    torch.manual_seed(model_seed)
    torch.save(SRVP(model_config(cfg)).state_dict(),
               xp_dir / "model.pt")
    seqs = synthetic_sequences(N_VIDEOS, cfg["seq_len_test"], cfg["nx"],
                               seed=model_seed)
    np.savez_compressed(data_dir / "smmnist_test_2digits_64.npz",
                        sequences=seqs)

    t_cond = cfg["nt_cond"]
    t_pred = cfg["seq_len_test"] - t_cond
    krollout.launches = 0
    arts_k, secs_k, wall_k = run_cli(xp_dir, data_dir, "on")
    launches = krollout.launches
    n_batches = -(-N_VIDEOS // BATCH)
    expected = n_batches * (N_SAMPLES // CHUNK)
    if launches != expected:
        raise SystemExit(f"prior_rollout kernel launched {launches} times on "
                         f"the main path, expected {expected}")
    check_artifacts(arts_k, t_cond, t_pred, cfg["nx"])

    krollout.launches = 0
    arts_p, secs_p, wall_p = run_cli(xp_dir, data_dir, "off")
    if krollout.launches != 0:
        raise SystemExit("the eager-rollout run launched the kernel")
    check_artifacts(arts_p, t_cond, t_pred, cfg["nx"])

    # kernel vs eager rollout, same noise: metrics to 1e-3 dB / 1e-4 SSIM
    # (fp32 sums in another order), frames to one u8 level (truncation)
    d_metric = {k: float(np.abs(arts_k["results"][k]
                                - arts_p["results"][k]).max())
                for k in ("psnr", "ssim")}
    d_frames = {name: int(np.abs(arts_k[name]["samples"].astype(np.int16)
                                 - arts_p[name]["samples"]).max())
                for name in ["cond_rec"] + [f"random_{i}"
                                            for i in range(1, 6)]}
    frac = float(np.mean(arts_k["random_1"]["samples"]
                         != arts_p["random_1"]["samples"]))
    summary = dict(
        batches=n_batches, videos=N_VIDEOS, samples=N_SAMPLES, chunk=CHUNK,
        launches=launches,
        s_per_batch_kernel=float(np.mean(secs_k[1:] or secs_k)),
        s_per_batch_plain=float(np.mean(secs_p[1:] or secs_p)),
        batch_seconds_kernel=secs_k, batch_seconds_plain=secs_p,
        wall_s_kernel=wall_k, wall_s_plain=wall_p,
        max_abs_metric_diff=d_metric, max_u8_diff=d_frames,
        random_1_frac_pixels_differ=frac,
        psnr_mean=float(arts_k["results"]["psnr"].mean()),
        ssim_mean=float(arts_k["results"]["ssim"].mean()))
    frames = BATCH * N_SAMPLES * t_pred
    summary["pred_frames_per_s_kernel"] = frames / summary["s_per_batch_kernel"]
    summary["pred_frames_per_s_plain"] = frames / summary["s_per_batch_plain"]
    print("main_path " + json.dumps(summary), flush=True)
    if d_metric["psnr"] > 1e-3 or d_metric["ssim"] > 1e-4 \
            or max(d_frames.values()) > 1:
        raise SystemExit("kernel and eager rollout disagree on the main path")
    return summary


def run_cli(xp_dir, data_dir, fused):
    opt_args = [
        "--xp_dir", str(xp_dir), "--data_dir", str(data_dir),
        "--batch_size", str(BATCH), "--n_samples", str(N_SAMPLES),
        "--samples_chunk", str(CHUNK), "--fused_rollout", fused,
        "--model_name", "model.pt", "--device", "cuda"]
    opt = test_main.create_test_args().parse_args(opt_args)
    t0 = time.perf_counter()
    batch_seconds = test_main.main(opt)
    wall = time.perf_counter() - t0
    arts = {"results": dict(np.load(xp_dir / "results.npz"))}
    for name in ["cond_rec", "psnr_best", "psnr_worst", "ssim_best",
                 "ssim_worst"] + [f"random_{i}" for i in range(1, 6)]:
        arts[name] = dict(np.load(xp_dir / f"{name}.npz"))
    return arts, batch_seconds, wall


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    strict_fp32()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)

    t0 = time.perf_counter()
    kbuild.build(force=True, verbose=True)
    kbuild.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    cfg = model_config(XP_CONFIG)
    torch.manual_seed(SEED)
    model = SRVP(cfg).cuda().eval()
    pz, dyn = model.p_z.linears(), model.dynamics.linears()
    n_steps = XP_CONFIG["seq_len_test"] - XP_CONFIG["nt_cond"]
    main_row = check_rollout("main path chunk", pz, dyn, BATCH * CHUNK,
                             n_steps, 1, cfg.ny, cfg.nz, SEED + 1)
    batch_row = check_rollout("whole batch", pz, dyn, BATCH * N_SAMPLES,
                              n_steps, 1, cfg.ny, cfg.nz, SEED + 2)
    torch.manual_seed(SEED + 3)
    small_pz = MLP(20, 64, 24, 4).cuda()
    small_dyn = MLP(32, 64, 20, 4).cuda()
    check_rollout("o=2 ny!=nz", small_pz.linears(), small_dyn.linears(), 37,
                  10, 2, 20, 12, SEED + 4)
    del model

    summary = main_path(SEED)

    kernels = [dict(
        name="prior_rollout", route="cuda",
        source="srvp_tpu_torch/csrc/rollout.cu",
        replaces="srvp_tpu/ops/pallas/rollout.py:89",
        launches=summary["launches"], max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None)]
    print(f"whole-batch rollout B={batch_row['B']}: {batch_row['ms']:.4f} ms "
          f"(bound {batch_row['bound_ms']:.4f} ms, plain "
          f"{batch_row['plain_ms']:.4f} ms)", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
