#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (srvp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the CUDA kernels from srvp_tpu_torch/csrc with nvcc;
  3. kernel vs plain, prior rollout: the kernel against its plain PyTorch
     version on the card, at the shapes of the main path (B=160, 20 steps),
     at a whole batch (B=1600) and at a small o=2, ny != nz case, with
     rtol 1e-4 / atol 1e-5 (the JAX suite's rollout tolerance); times with
     CUDA events beside the bound;
  4. kernel vs plain, training rollout: the forward kernel and the two
     backward kernels against the plain version differentiated by autograd,
     at the training step's shapes (B=128, 14 substeps, o=1) and at a small
     o=2, ny != nz case: forward at rtol 2e-5 / atol 1e-6, the gradients of
     every input and weight of a loss that touches every output at rtol
     5e-4 / atol 5e-6 (tests/test_pallas_train.py). Inputs are drawn so
     that no ReLU input sits near the kink, and a float64 plain run
     arbitrates elements that fp32 cannot resolve (kernels/parity.py; the
     raw error and the elements it excused are printed); times of the
     forward, the backward and the plain version's, beside the bounds;
  5. main path, evaluation: the evaluation CLI (srvp_tpu_torch.test_main) at
     the full width of the Stochastic Moving MNIST dcgan model with seeded
     random weights, on synthetic moving-glyph sequences: 2 batches of 16
     videos, 5 conditioning + 20 predicted frames, 100 samples in chunks of
     10. It runs once through the kernel and once with the eager rollout on
     the same noise; the two must agree;
  6. main path, training: the trainer CLI (srvp_tpu_torch.train_main) at the
     same width, batch 128 of 15 frames, on synthetic Moving MNIST digits,
     for 20 steps through the training-rollout kernels (one forward and two
     backward launches a step), with finite losses; then one step from the
     state it saved, through the kernels and through the eager rollout on
     the same draws (loss rtol 1e-4; the latent model's gradients element
     by element at rtol 5e-3 / atol 5e-5, the conv gradients in L2 norm
     against a limit that a TF32 step, the control, must exceed: see
     check_step); then test_main serves the model.pt it wrote.
Then it prints one {"kernels": [...]} line and, last, the device line.
It exits non-zero without a result when CUDA is unavailable.
"""

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from srvp_tpu_torch import test_main, train_lib, train_main
from srvp_tpu_torch.config import model_config, strict_fp32
from srvp_tpu_torch.data.device_compose import materialize, to_device
from srvp_tpu_torch.kernels import build as kbuild
from srvp_tpu_torch.kernels import parity
from srvp_tpu_torch.kernels import rollout as krollout
from srvp_tpu_torch.kernels import rollout_train as krollout_train
from srvp_tpu_torch.models.lstm import lstm_apply
from srvp_tpu_torch.models.mlp import MLP
from srvp_tpu_torch.models.srvp import SRVP, rollout_masks

ROOT = Path(__file__).resolve().parent
WORK_DIR = ROOT / "build" / "chip_smoke"
SEED = 0
RTOL, ATOL = 1e-4, 1e-5
# training rollout, forward and gradients (tests/test_pallas_train.py)
TRAIN_RTOL, TRAIN_ATOL = 2e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-6
# one training step, kernel vs eager rollout (tests/test_grad_parity.py)
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-4, 5e-3, 5e-5
# the conv gradients of that step in L2 norm, in units of that tolerance:
# sound H100 runs read 0.0055-0.0076, the TF32 control 5.20 (PERF.md)
STEP_CONV_NORM_LIMIT = 0.05
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
# training protocol (bench.py:42-46): batch 128 of 15 frames, o = 1
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP = 128, 20, 5


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


def train_rollout_bounds_ms(layers, bsz, n_steps, stash_w, nh_inf, ny, nz):
    """Least times of the training rollout's forward and backward on an H100
    (each the larger of bytes / memory rate and FLOPs / fp32 rate), with
    what bounds each. Every layer runs on every substep; the backward does
    the products g W^T and g^T a, twice the forward's. Bytes: the weights,
    each input read once and each output written once; the stash of hidden
    pre-activations is the forward's output and the backward's input."""
    rows = bsz * n_steps
    macs = sum(w.numel() for w, _ in layers)
    n_params = sum(w.numel() + b.numel() for w, b in layers)
    state = rows * (2 * ny + 4 * nz + stash_w)      # ys, res, q, p, zs, stash
    fwd_bytes = 4.0 * (n_params + bsz * ny + rows * (nh_inf + nz) + state)
    bwd_bytes = 4.0 * (2 * n_params + bsz * ny + rows * (nh_inf + nz)
                       + 2 * state + rows * nh_inf)   # + cotangents, dhxz
    out = []
    for flops, n_bytes in ((2.0 * rows * macs, fwd_bytes),
                           (4.0 * rows * macs, bwd_bytes)):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_HBM_BYTES
        out.append((1e3 * max(t_ops, t_bytes),
                    "operations" if t_ops >= t_bytes else "bytes"))
    return out


def _worst(out, ref, rtol, atol):
    diff = (out - ref).abs()
    return (diff.max().item(),
            (diff / (atol + rtol * ref.abs())).max().item(),
            bool(torch.isfinite(out).all()))


def check_train_rollout(name, q_layer, pz_layers, dyn_layers, bsz, n_steps,
                        oversampling, seed):
    """Training-rollout kernels (forward, and backward through a loss that
    touches every output) against the plain version on the card, on
    kink-free inputs; times the kernels' forward and backward and the plain
    version's. Returns the measured row."""
    nh_inf, ny = q_layer[0].shape[1], pz_layers[0][0].shape[1]
    nz = q_layer[0].shape[0] // 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y0, hxz, eps, redrawn = parity.kink_free_inputs(
        q_layer, pz_layers, dyn_layers, bsz, n_steps, oversampling, gen)
    layers = [q_layer] + list(pz_layers) + list(dyn_layers)
    flat = [t.detach() for w, b in layers for t in (w, b)]
    n_pz = len(pz_layers)

    def leaves(dtype=torch.float32):
        return [t.to(dtype, copy=True).requires_grad_()
                for t in [y0, hxz] + flat]

    def call(fn, lv, dtype=torch.float32):
        pairs = [(lv[i], lv[i + 1]) for i in range(2, len(lv), 2)]
        return fn(pairs[0], pairs[1:1 + n_pz], pairs[1 + n_pz:], lv[0],
                  lv[1], eps.to(dtype), oversampling)

    runs = {}
    for route, fn, dtype in (
            ("kernel", krollout_train.train_rollout, torch.float32),
            ("plain", krollout_train.train_rollout_reference, torch.float32),
            ("plain64", krollout_train.train_rollout_reference,
             torch.float64)):
        lv = leaves(dtype)
        outs = call(fn, lv, dtype)
        grads = torch.autograd.grad(parity.rollout_loss(outs), lv)
        runs[route] = (outs, grads, lv)
    torch.cuda.synchronize()
    # per output / gradient: (max |err|, finite, raw err/tol, arbitrated
    # err/tol, elements excused by the float64 arbiter)
    fwd = [_worst(a, b, TRAIN_RTOL, TRAIN_ATOL)[::2]
           + parity.agreement(a, b, c, TRAIN_RTOL, TRAIN_ATOL)
           for a, b, c in zip(*(runs[r][0] for r in runs))]
    bwd = [_worst(a, b, GRAD_RTOL, GRAD_ATOL)[::2]
           + parity.agreement(a, b, c, GRAD_RTOL, GRAD_ATOL)
           for a, b, c in zip(*(runs[r][1] for r in runs))]

    times = {}
    for route, fn in (("kernel", krollout_train.train_rollout),
                      ("plain", krollout_train.train_rollout_reference)):
        lv = runs[route][2]
        with torch.no_grad():
            times[f"{route}_fwd_ms"] = cuda_ms(lambda: call(fn, lv))
        outs = call(fn, lv)
        cots = [torch.ones_like(o) for o in outs]
        times[f"{route}_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            outs, lv, cots, retain_graph=True))
    stash_w = sum(w.shape[0] for w, _ in list(pz_layers)[:-1]) \
        + sum(w.shape[0] for w, _ in list(dyn_layers)[:-1])
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = train_rollout_bounds_ms(
        layers, bsz, n_steps, stash_w, nh_inf, ny, nz)
    row = dict(case=name, B=bsz, n_steps=n_steps, oversampling=oversampling,
               ny=ny, nz=nz, rows_redrawn=redrawn,
               fwd_max_abs_err=max(f[0] for f in fwd),
               fwd_err_over_tol=max(f[2] for f in fwd),
               fwd_err_over_tol_f64=max(f[3] for f in fwd),
               fwd_elements_excused=sum(f[4] for f in fwd),
               bwd_max_abs_err=max(b[0] for b in bwd),
               bwd_err_over_tol=max(b[2] for b in bwd),
               bwd_err_over_tol_f64=max(b[3] for b in bwd),
               bwd_elements_excused=sum(b[4] for b in bwd),
               fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
               bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by, **times)
    row["plain_fwd_bwd_ms"] = times["plain_fwd_ms"] + times["plain_bwd_ms"]
    print("train_kernel_check " + json.dumps(row), flush=True)
    finite = all(f[1] for f in fwd) and all(b[1] for b in bwd)
    if not finite or row["fwd_err_over_tol_f64"] > 1.0 \
            or row["bwd_err_over_tol_f64"] > 1.0:
        raise SystemExit(f"train_rollout kernels disagree with the plain "
                         f"version ({name}): forward err/tol "
                         f"{row['fwd_err_over_tol_f64']}, gradients err/tol "
                         f"{row['bwd_err_over_tol_f64']}")
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


def train_args(save_path, data_dir, n_steps, fused="on"):
    """The trainer's flags at the flagship width and training protocol
    (bench.py's smmnist-dcgan cell: batch 128, seq_len 15, o=1)."""
    c = XP_CONFIG
    flags = dict(dataset="smmnist", data_dir=data_dir, save_path=save_path,
                 nc=c["nc"], nx=c["nx"], nf=c["nf"], nhx=c["nhx"],
                 ny=c["ny"], nz=c["nz"], nt_inf=c["nt_inf"],
                 nh_inf=c["nh_inf"], nlayers_inf=c["nlayers_inf"],
                 nh_res=c["nh_res"], nlayers_res=c["nlayers_res"],
                 n_euler_steps=c["n_euler_steps"], nt_cond=c["nt_cond"],
                 seq_len=c["seq_len"], batch_size=TRAIN_BATCH,
                 n_iter=n_steps, log_interval=1, val_interval=n_steps,
                 n_iter_test=1, batch_size_test=BATCH,
                 n_samples_test=CHUNK, val_samples_chunk=CHUNK,
                 seed=SEED + 1, device="cuda", fused_rollout=fused)
    args = [f"--{k}={v}" for k, v in flags.items()] + ["--allow_synthetic"]
    return train_main.create_args().parse_args(args)


@torch.no_grad()
def kink_free_step_noise(model, x, oversampling, gen):
    """The draws of one training step of `model` on the float batch x
    (frame_idx, eps_y, eps_pos), with the rows whose latent rollout puts a
    ReLU input near a kink (parity.rows_near_kink) drawn again."""
    cfg = model.cfg
    m = copy.deepcopy(model).train()   # batch statistics, as in the step
    m.inf_z.flatten_parameters()
    nt, bsz = x.shape[:2]
    hx, _ = m.encode(x)
    hxz = lstm_apply(m.inf_z, hx)[rollout_masks(nt, oversampling, nt)[0]]
    noise = dict(frame_idx=torch.rand(bsz, nt, generator=gen, device="cuda")
                 .argsort(dim=1)[:, :cfg.nt_inf].T,
                 eps_y=torch.empty(bsz, cfg.ny, device="cuda"),
                 eps_pos=torch.empty(hxz.shape[0], bsz, cfg.nz,
                                     device="cuda"))

    def fill(mask, n):
        noise["eps_y"][mask] = torch.randn(n, cfg.ny, generator=gen,
                                           device="cuda")
        noise["eps_pos"][:, mask] = torch.randn(
            hxz.shape[0], n, cfg.nz, generator=gen, device="cuda")

    def near():
        y0, _ = m.infer_y(hx[:cfg.nt_inf], noise["eps_y"])
        return parity.rows_near_kink(
            (m.q_z.weight, m.q_z.bias), m.p_z.linears(), m.dynamics.linears(),
            y0, hxz, noise["eps_pos"], oversampling)

    parity.redraw_rows(fill, near, bsz, "cuda")
    return noise


def step_grads(opt, state_dict, x, noise, use_kernel, dtype, tf32=False):
    """Loss and parameter gradients of one training step from
    `state_dict` on the float batch x with the given draws, the rollout
    through the kernels or the eager loop, in `dtype` (with TF32 matmuls
    and convs if `tf32`)."""
    hp = dataclasses.replace(train_main.train_hparams(opt),
                             use_kernel=use_kernel)
    model = SRVP(model_config(vars(opt))).cuda().to(dtype).train()
    model.load_state_dict(state_dict)
    noise = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in noise.items()}
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        loss, _ = train_lib.loss_and_grads(model, x.to(dtype), hp, **noise)
    finally:
        strict_fp32()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


def is_conv_param(name):
    return name.split(".")[0] in ("encoder", "decoder")


def check_step(opt, state_dict, batch):
    """One training step from the trainer's final state through the kernels
    and through the eager rollout, on the same kink-free draws, with cuDNN
    held to deterministic algorithms (its default ones are not: the eager
    step rerun with them is printed). The loss must agree to rtol 1e-4.
    Every gradient of the latent model (each parameter outside the encoder
    and decoder: q_z, p_z and dynamics, which the kernels write, and the
    networks that dy0 and dhxz flow into) must agree element by element to
    rtol 5e-3 / atol 5e-5. The encoder's and decoder's conv weight gradients
    are BN-centred sums over 1920 frames x up to 1024 positions, which fp32
    does not resolve to that tolerance elementwise whatever the rollout
    (the eager fp32 step against a float64 one is printed): each of those
    tensors must agree in L2 norm, ||g_kernel - g_eager|| <=
    STEP_CONV_NORM_LIMIT (atol + rtol ||g_eager||). The eager step with TF32
    matmuls and convs is the control: held to the same two checks, it must
    fail both, or the checks could not tell a lower-precision step."""
    x = materialize(batch, opt.nx)
    model = SRVP(model_config(vars(opt))).cuda()
    model.load_state_dict(state_dict)
    noise = kink_free_step_noise(model, x, opt.n_euler_steps,
                                 torch.Generator(device="cuda")
                                 .manual_seed(SEED + 2))
    del model
    # the eager step twice with cuDNN's default algorithms
    default = [step_grads(opt, state_dict, x, noise, False, torch.float32)[1]
               for _ in range(2)]
    spread = max(_worst(default[0][k], default[1][k], STEP_GRAD_RTOL,
                        STEP_GRAD_ATOL)[1] for k in default[0])
    del default
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [step_grads(opt, state_dict, x, noise, use_kernel, dtype, tf32)
                for use_kernel, dtype, tf32 in (
                    (True, torch.float32, False), (False, torch.float32, False),
                    (False, torch.float64, False), (False, torch.float32, True))]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (loss_k, g_k), (loss_e, g_e), (loss_64, g_64), (loss_tf, g_tf) = runs

    def held(g):
        """(latent model: elementwise err/tol by tensor, convs: L2-norm
        err/tol by tensor) of the gradients g against the eager step's."""
        elem, norm = {}, {}
        for k in g:
            if is_conv_param(k):
                norm[k] = ((g[k] - g_e[k]).norm() / (
                    STEP_GRAD_ATOL + STEP_GRAD_RTOL * g_e[k].norm())).item()
            else:
                elem[k] = _worst(g[k], g_e[k], STEP_GRAD_RTOL,
                                 STEP_GRAD_ATOL)[1]
        return elem, norm

    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]  # noqa
    (elem, norm), (elem_tf, norm_tf) = held(g_k), held(g_tf)
    fp32 = {k: _worst(g_e[k], g_64[k].float(), STEP_GRAD_RTOL,
                      STEP_GRAD_ATOL)[1] for k in g_k}
    conv_elem = {k: _worst(g_k[k], g_e[k], STEP_GRAD_RTOL, STEP_GRAD_ATOL)[1]
                 for k in g_k if is_conv_param(k)}
    return dict(step_loss_kernel=loss_k, step_loss_eager=loss_e,
                step_loss_f64=loss_64, step_loss_tf32=loss_tf,
                step_loss_rel_diff=abs(loss_k - loss_e) / abs(loss_e),
                step_latent_elementwise_err_over_tol=max(elem.values()),
                step_latent_elementwise_worst=top(elem),
                step_conv_norm_err_over_tol=max(norm.values()),
                step_conv_norm_worst=top(norm),
                step_conv_norm_limit=STEP_CONV_NORM_LIMIT,
                tf32_latent_elementwise_err_over_tol=max(elem_tf.values()),
                tf32_latent_elementwise_worst=top(elem_tf),
                tf32_conv_norm_err_over_tol=max(norm_tf.values()),
                tf32_conv_norm_worst=top(norm_tf),
                step_conv_elementwise_err_over_tol=max(conv_elem.values()),
                step_conv_elementwise_worst=top(conv_elem),
                step_grad_eager32_vs_f64_elementwise=max(fp32.values()),
                step_grad_eager32_vs_f64_worst=top(fp32),
                step_grad_eager_rerun_default_cudnn_elementwise=spread)


def train_path():
    """The trainer CLI at the flagship width through the kernels, then one
    step from its final state through the kernels and through the eager
    rollout, then test_main serving the checkpoint it wrote. Returns the
    summary."""
    xp_dir, data_dir = WORK_DIR / "train_xp", WORK_DIR / "data"
    data_dir.mkdir(parents=True, exist_ok=True)
    opt = train_args(str(xp_dir), str(data_dir), TRAIN_STEPS)
    krollout_train.fwd_launches = krollout_train.bwd_launches = 0
    t0 = time.perf_counter()
    history = train_main.main(opt)
    wall = time.perf_counter() - t0
    launches = (krollout_train.fwd_launches, krollout_train.bwd_launches)
    if launches != (TRAIN_STEPS, 2 * TRAIN_STEPS):
        raise SystemExit(f"training rollout kernels launched {launches} "
                         f"times in {TRAIN_STEPS} steps, expected "
                         f"{(TRAIN_STEPS, 2 * TRAIN_STEPS)}")
    losses = [h["loss"] for h in history]
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise SystemExit(f"training losses: {losses}")
    warm = history[TRAIN_WARMUP:]
    frames = opt.seq_len * opt.batch_size
    ms_step = float(np.mean([1e3 * frames / h["fps"] for h in warm]))

    state = torch.load(xp_dir / "model.pt", map_location="cuda")
    train_loader, _ = train_main.loaders(opt)
    step = check_step(opt, state,
                      to_device(next(iter(train_loader)), "cuda"))

    seqs = synthetic_sequences(BATCH, XP_CONFIG["seq_len_test"],
                               XP_CONFIG["nx"], seed=SEED + 3)
    np.savez_compressed(data_dir / "smmnist_test_2digits_64.npz",
                        sequences=seqs)
    test_main.main(test_main.create_test_args().parse_args([
        "--xp_dir", str(xp_dir), "--data_dir", str(data_dir),
        "--batch_size", str(BATCH), "--n_samples", str(CHUNK),
        "--samples_chunk", str(CHUNK), "--nt_gen",
        str(XP_CONFIG["seq_len_test"]), "--model_name", "model.pt",
        "--device", "cuda"]))
    psnr = np.load(xp_dir / "results.npz")["psnr"]

    summary = dict(
        steps=TRAIN_STEPS, batch=opt.batch_size, seq_len=opt.seq_len,
        fwd_launches=launches[0], bwd_launches=launches[1],
        losses=losses, wall_s=wall, ms_per_step=ms_step,
        frames_per_s=frames / (ms_step / 1e3), **step,
        served_psnr_mean=float(psnr.mean()), served_videos=int(psnr.size))
    print("train_path " + json.dumps(summary), flush=True)
    print(f"training step at B={opt.batch_size}, seq_len {opt.seq_len}: "
          f"{ms_step:.3f} ms per step after {TRAIN_WARMUP} warm-up steps, "
          f"{summary['frames_per_s']:.1f} frames/s", flush=True)
    if step["step_loss_rel_diff"] > STEP_LOSS_RTOL \
            or step["step_latent_elementwise_err_over_tol"] > 1.0 \
            or step["step_conv_norm_err_over_tol"] > STEP_CONV_NORM_LIMIT:
        raise SystemExit("one training step through the kernels disagrees "
                         "with the eager rollout")
    if step["tf32_latent_elementwise_err_over_tol"] <= 1.0 \
            or step["tf32_conv_norm_err_over_tol"] <= STEP_CONV_NORM_LIMIT:
        raise SystemExit("the one-step check does not tell a TF32 step from "
                         "the fp32 one")
    if psnr.shape != (BATCH,) or not np.all(np.isfinite(psnr)):
        raise SystemExit(f"test_main on the trained checkpoint: {psnr}")
    return summary


def kernel_row(name, source, replaces, launches, max_abs_err, ms, plain_ms,
               bound_ms, bound_by):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max_abs_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


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
    train_row = check_train_rollout(
        "training step", (model.q_z.weight, model.q_z.bias), pz, dyn,
        TRAIN_BATCH, XP_CONFIG["seq_len"] - 1, 1, SEED + 5)
    small_q = torch.nn.Linear(24, 24).cuda()
    check_train_rollout("o=2 ny!=nz", (small_q.weight, small_q.bias),
                        small_pz.linears(), small_dyn.linears(), 37, 10, 2,
                        SEED + 6)
    del model

    summary = main_path(SEED)
    train_summary = train_path()

    src = "srvp_tpu_torch/csrc/rollout_train.cu"
    kernels = [
        kernel_row("prior_rollout", "srvp_tpu_torch/csrc/rollout.cu",
                   "srvp_tpu/ops/pallas/rollout.py:89", summary["launches"],
                   main_row["max_abs_err"], main_row["ms"],
                   main_row["plain_ms"], main_row["bound_ms"],
                   main_row["bound_by"]),
        kernel_row("train_rollout_fwd", src,
                   "srvp_tpu/ops/pallas/rollout_train.py:83",
                   train_summary["fwd_launches"],
                   train_row["fwd_max_abs_err"], train_row["kernel_fwd_ms"],
                   train_row["plain_fwd_ms"], train_row["fwd_bound_ms"],
                   train_row["fwd_bound_by"]),
        kernel_row("train_rollout_bwd", src,
                   "srvp_tpu/ops/pallas/rollout_train.py:146",
                   train_summary["bwd_launches"],
                   train_row["bwd_max_abs_err"], train_row["kernel_bwd_ms"],
                   train_row["plain_bwd_ms"], train_row["bwd_bound_ms"],
                   train_row["bwd_bound_by"]),
    ]
    print(f"whole-batch rollout B={batch_row['B']}: {batch_row['ms']:.4f} ms "
          f"(bound {batch_row['bound_ms']:.4f} ms, plain "
          f"{batch_row['plain_ms']:.4f} ms)", flush=True)
    print(f"training rollout B={train_row['B']}: forward "
          f"{train_row['kernel_fwd_ms']:.4f} ms, backward "
          f"{train_row['kernel_bwd_ms']:.4f} ms (bounds "
          f"{train_row['fwd_bound_ms']:.4f} / {train_row['bwd_bound_ms']:.4f}"
          f" ms); plain forward + backward "
          f"{train_row['plain_fwd_bwd_ms']:.4f} ms", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
