#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (srvp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the CUDA kernels from srvp_tpu_torch/csrc with nvcc;
  3. kernel vs plain, prior rollout (kernel 1): the kernel against its
     plain PyTorch version on the card, at the shapes of the dcgan main path
     (B=160, 20 steps), at a whole batch (B=1600), at a small o=2, ny != nz
     case and at the KTH evaluation chunk (B=160, ny = nz = 50, 60
     substeps at o=2), with rtol 1e-4 / atol 1e-5 (the JAX suite's rollout
     tolerance), a second launch giving the same bits; each line names the
     cluster plan (rows a tile R, blocks a cluster C, blocks, and the
     clusters the card holds at once); times with CUDA events beside the
     bound;
  4. kernel vs plain, training rollout (kernels 2-3): the forward kernel and
     the two backward kernels against the plain version differentiated by
     autograd, at the dcgan training step's shapes (B=128, 14 substeps,
     o=1), at a small o=2, ny != nz case and at the KTH step's (B=100, 38
     substeps, o=2): forward at rtol 2e-5 / atol 1e-6, the gradients of
     every input and weight of a loss that touches every output at rtol
     5e-4 / atol 5e-6 (tests/test_pallas_train.py), the forward's stashed
     pre-activations at the forward's tolerance, a second launch giving the
     same bits (forward outputs, stashes and gradients); each line names
     both passes' cluster plans. Inputs are drawn so that no ReLU input
     sits near the kink, and a float64 plain run arbitrates elements that
     fp32 cannot resolve (kernels/parity.py; the raw error, the elements it
     excused and the worst gradient are printed); times of the forward, the
     backward and the plain version's, and the backward's carry pass,
     weight-gradient pass and the rest of its wrapper apart (CUDA events
     the wrapper records), beside the bounds of each; then the
     weight-gradient pass alone on the inputs that backward gave it, at its
     plan (S blocks a cluster sharing a tile's row sum, the tile shapes,
     blocks, clusters resident), against the same products by cuBLAS
     (torch.mm and a row sum a layer, fp32, TF32 off: the library
     yardstick, timed beside it) with a float64 arbiter, a second launch
     giving the same bits;
  5. kernel vs plain, vgg pool and upsample (kernels 4-7): each kernel at
     every site of the KTH training step (N = 2000 frames), half of the
     frames quantised with flat 2x2 windows so that ties occur, and two
     planted NaNs: bit-equal to the plain version; times beside the plain
     version's, the library call's and the bytes bound; then the same in
     bfloat16 (the bfloat16 entry points, float32 inside with one
     rounding), against the bfloat16 plain versions and library calls and
     the bfloat16 bytes bound;
  6. main path, dcgan evaluation: the evaluation CLI
     (srvp_tpu_torch.test_main) at the full width of the Stochastic Moving
     MNIST dcgan model with seeded random weights, on synthetic
     moving-glyph sequences: 2 batches of 16 videos, 5 conditioning + 20
     predicted frames, 100 samples in chunks of 10. It runs once through
     the kernel and once with the eager rollout on the same noise; the two
     must agree, and each kernel must launch exactly as often as the
     protocol needs;
  7. main path, dcgan training: the trainer CLI (srvp_tpu_torch.train_main)
     at the same width, batch 128 of 15 frames, on synthetic Moving MNIST
     digits, for 20 steps through the training-rollout kernels (one forward
     and two backward launches a step), with finite losses; then one step
     from the state it saved, through the kernels and through the eager
     rollout on the same draws (loss rtol 1e-4; the latent model's
     gradients element by element and the conv gradients in L2 norm at
     rtol 5e-3 / atol 5e-5, directly; a TF32 step, the control, must fail:
     see check_step); then test_main serves the model.pt it wrote;
  8. main path, KTH evaluation: as 6, for the KTH vgg model with skip
     connections (configs/kth.yaml) on 16 synthetic KTH-like videos
     (svg_test_set_40.npz): 10 conditioning + 30 predicted frames, o = 2,
     100 samples in chunks of 10, the pools and upsamples through kernels 4
     and 6;
  9. main path, KTH training: as 7, for the KTH model on a synthetic packed
     KTH tree (6 classes, persons 1-25): batch 100 of 20 frames, o = 2, 10
     steps, each launching every spatial kernel 4 times; the peak device
     memory is printed; the one-step check holds the kernels against the
     eager rollout and the plain pools and upsamples, on 25 videos, every
     gradient in L2 norm at KTH_STEP_NORM_LIMIT of the tolerance (fp32
     does not resolve the KTH model's gradients element by element: the
     eager step's distance to a float64 one is printed beside), on a state
     seeded with CHECK_STATE_SEED (the trained state differs from run to
     run; its readings are printed, not held); then test_main serves the
     model.pt;
 10. main path, bfloat16 training: the trainer CLI with --precision
     bfloat16 on both models at the widths and batches of 7 and 9 (dcgan
     8 steps, KTH 6), the vgg pools and upsamples through the kernels'
     bfloat16 versions (exact launch counts of every kernel, the float32
     spatial kernels launched no time), finite losses, ms per step and peak
     memory printed beside the float32 runs'; then one step on the seeded
     state through the kernels and through the eager rollout and plain
     pools and upsamples on the same kink-free draws: every gradient in L2
     norm within BF16_STEP_NORM_LIMIT (16) of (atol + 2^-8 ||g||),
     bfloat16's unit roundoff, and the loss at rtol 2^-10, the eager bf16
     step's distance to the fp32 one printed beside, and the same step
     with kernel 3's gradients scaled by 1 + 2^-3 (a planted fault) must
     fail (check_step in bfloat16); test_main serves the model.pt;
 11. main path, the port's bench: python -m srvp_tpu_torch.bench at
     reduced steps (BENCH_ARGS): its JSON line (printed) holds finite
     numbers and an mfu in (0, 1] for both configurations;
 12. kernel vs plain, conv stage (kernels 8-9): kernel 8 in fp32 at every
     3x3 conv site of the KTH vgg model (19, encoder and decoder with skip
     connections) at N = 2000 frames, the first as the frame enters (no
     transform, act none), the others with the normalize and LeakyReLU on
     the load, one with n_valid < N; at the workhorse site (64 -> 64 at
     64x64) also kernel 8 in bf16 and kernel 9 (bh = 8) in fp32 and bf16.
     y elementwise at rtol 1e-4 / atol 1e-5 with a float64 plain run as
     arbiter (fp32; K = 9 cin reaches 9,216 terms), or within one bf16 ulp
     (+ 1e-5) of the plain version (bf16); the statistics at rtol 1e-5 /
     atol 1e-3 of float64 sums of the kernel's fp32 accumulator (its fp32
     y; in bf16 the fp32 kernel's y on the same rounded values); a second
     launch must give the same bits. Times of the kernel, the plain version
     and the cuDNN leg (F.conv2d and the two reductions) beside the bound
     (fp32: three TF32 products a term at the TF32 rate, and beside it the
     CUDA cores' fp32 FMA; bf16: the bf16 rate, and beside it one TF32
     product a term) and the TFLOP/s;
 13. main path, conv stage: the port's bench (srvp_tpu_torch.
     bench_conv_stage) at the workhorse shape for kernels 8 and 9 in fp32
     and bf16, chained, beside cuDNN; then the two-block chain of
     tests/test_conv_stage.py:51-91 at the full size of KTH encoder stage 0
     (kernel 8 1 -> 64, the batch norm's scale and shift, kernel 8
     64 -> 64) against the port's eager stage (Conv2d, train-mode
     BatchNorm2d, LeakyReLU): y at atol 3e-4 with bn_scale_shift's one-pass
     variance and with a two-pass one, the sums at rtol 1e-4 / atol 1e-2
     with the two-pass one, a float64 eager stage as arbiter
     (check_conv_chain); exact launch counts.
 14. main path, resume on the card: the trainer CLI (RESUME_ARMS) as a
     child process with --n_workers 4, --chkpt_interval 4 and
     --log_interval 1, cuDNN's deterministic algorithms and no autotuning:
     for dcgan at full width in fp32, 12 steps uninterrupted, then the
     same flags with SIGTERM sent once the child logs step 4 (it must exit
     with 143, its train_state.json at the step it stopped), then --resume
     to step 12 (it must say the step it resumed from, its model.pt must
     be bit-equal to the uninterrupted run's, and so must every logged
     loss, metrics.jsonl holding each step once); the same for KTH vgg in
     bf16 over 6 steps, SIGTERM after step 2. Every child launches the
     kernels exactly as its steps and validations need, and at dcgan the
     native Moving MNIST generator serves every training batch (its batch
     counts printed). Then the dcgan trainer in bf16 for 16 steps with
     --profile_dir: the trace must be written and name the
     training-rollout kernels.
 15. main path, dispatch windows on the card (DISPATCH_ARMS): the trainer
     CLI with --steps_per_dispatch K (train_lib.WindowStep: the first
     window eager, then one CUDA graph of K steps replayed a window,
     released before each validation and captured again) against K = 1
     with the same flags, as child processes side by side in waves that
     fit the card (DISPATCH_WAVES), cuDNN deterministic, --log_interval 4,
     a validation and periodic checkpoints inside the run: dcgan fp32 and
     bf16 16 steps and KTH bf16 8 at K = 4, KTH fp32 4 at K = 2. Each K
     run's model.pt and logged losses within rtol 2e-5 / atol 1e-6 of the
     K = 1 run's (the CLI test's tolerance; the distance in ulps printed),
     two K = 4 runs bit-equal (dcgan), a K = 4 run stopped by SIGTERM and
     resumed bit-equal to the uninterrupted one (dcgan fp32), exact launch
     counts from the graphs' per-replay accounting; ms per step, frames/s,
     peak reserved memory and the allocations that failed (cuDNN then
     takes another algorithm) printed beside the K = 1 run's (children
     share the card: a record, not a measurement).
Then it prints one {"kernels": [...]} line and, last, the device line.
It exits non-zero without a result when CUDA is unavailable.
"""

import copy
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from srvp_tpu_torch import (bench, bench_conv_stage, test_main, train_lib,
                            train_main)
from srvp_tpu_torch.config import model_config, strict_fp32
from srvp_tpu_torch.data.device_compose import materialize, to_device
from srvp_tpu_torch.kernels import build as kbuild
from srvp_tpu_torch.kernels import conv_stage as kcs
from srvp_tpu_torch.kernels import launches as klaunches
from srvp_tpu_torch.kernels import parity
from srvp_tpu_torch.kernels.peaks import (PEAK_BF16_FLOPS, PEAK_FP32_FLOPS,
                                         PEAK_HBM_BYTES, PEAK_TF32_FLOPS,
                                         bound_ms, nvidia_smi_line)
from srvp_tpu_torch.kernels import rollout as krollout
from srvp_tpu_torch.kernels import rollout_train as krollout_train
from srvp_tpu_torch.kernels import spatial as krspatial
from srvp_tpu_torch.models.conv import decoder_spec, encoder_spec, stage_module
from srvp_tpu_torch.models.lstm import lstm_apply
from srvp_tpu_torch.models.mlp import MLP
from srvp_tpu_torch.models.srvp import SRVP, rollout_masks
from srvp_tpu_torch.ops.init import CONV_STD

ROOT = Path(__file__).resolve().parent
WORK_DIR = ROOT / "build" / "chip_smoke"
SEED = 0
RTOL, ATOL = 1e-4, 1e-5
# training rollout, forward and gradients (tests/test_pallas_train.py)
TRAIN_RTOL, TRAIN_ATOL = 2e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-6
# one training step, kernel vs eager rollout (tests/test_grad_parity.py)
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-4, 5e-3, 5e-5
# the dcgan step's conv gradients in L2 norm, in units of that tolerance:
# sound H100 runs read 0.0055-0.0143, the TF32 control 5.20-6.60 (PERF.md)
STEP_NORM_LIMIT = 0.05
# every gradient of the KTH step in L2 norm, in the same units: sound runs
# read 0.029-0.257 (ten trained states; the seeded one 0.085), a planted
# 1e-3 fault in kernel 7 0.803-0.808, the TF32 control 3.6-17 (PERF.md).
# The trained state differs from run to run (cuDNN's training algorithms
# are not deterministic), so the check is held on a state seeded with
# CHECK_STATE_SEED, for which it reads the same on every run; the trained
# state's readings are printed.
KTH_STEP_NORM_LIMIT = 0.5
CHECK_STATE_SEED = 0
# what check_step holds, (group, reading, limit): on dcgan the latent
# model's gradients element by element and the conv gradients in L2 norm;
# on KTH, whose gradients fp32 resolves element by element in neither
# framework, every gradient in L2 norm
DCGAN_STEP_HELD = [("latent", "elementwise", 1.0),
                   ("conv", "norm", STEP_NORM_LIMIT)]
KTH_STEP_HELD = [("latent", "norm", KTH_STEP_NORM_LIMIT),
                 ("conv", "norm", KTH_STEP_NORM_LIMIT)]

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
# KTH, vgg with skip connections, the paper's recipe (configs/kth.yaml,
# bench.py:47-51) and test protocol (10 + 30 frames, svg_test_set_40):
# one batch of 16 synthetic videos; training at batch 100 of 20 frames,
# o = 2, for 10 steps; the one-step check on 25 of a batch's videos (its
# float64 arm needs twice the fp32 step's memory, 60 GB at 100 videos)
KTH_CONFIG = dict(dataset="kth", nx=64, nc=1, nf=64, nhx=128, ny=50, nz=50,
                  skipco=True, nt_inf=3, nh_inf=256, nlayers_inf=3,
                  nh_res=512, nlayers_res=4, archi="vgg", nt_cond=10,
                  n_euler_steps=2, obs_scale=0.2, res_gain=1.2, seq_len=20,
                  seq_len_test=30)
KTH_VIDEOS, KTH_NT_GEN = 16, 40
KTH_TRAIN_BATCH, KTH_TRAIN_STEPS, KTH_TRAIN_WARMUP = 100, 10, 3
KTH_CHECK_VIDEOS = 25
# the ReLU-kink margin of the KTH rollout checks (kernels/parity.py): at 38
# substeps of 3,072 hidden units a row, nearly every row has a hidden
# pre-activation within the default 1e-5 of a layer's largest value
KTH_KINK_MARGIN = 1e-6
# the bfloat16 steps (--precision bfloat16): the trainer at the same
# widths and batches for fewer steps. The one-step check holds the loss of
# the kernel step against the eager one at BF16_LOSS_RTOL, a quarter of
# bfloat16's unit roundoff u = 2^-8, and every gradient in L2 norm within
# BF16_STEP_NORM_LIMIT (atol + u ||g||): 16 unit roundoffs, where a bf16
# step's gradients lie 31-89 of them from the fp32 step's and the kernel
# step's 0.4-6.8 from the eager one's (H100 80GB HBM3, PERF.md §6). Its
# control, kernel 3's gradients scaled by 1 + BF16_FAULT (32 unit
# roundoffs), must fail it
TRAIN_STEPS_BF16, TRAIN_WARMUP_BF16 = 8, 3
KTH_TRAIN_STEPS_BF16, KTH_TRAIN_WARMUP_BF16 = 6, 2
BF16_UNIT_ROUNDOFF = 2.0 ** -8
BF16_LOSS_RTOL = 2.0 ** -10
BF16_STEP_NORM_LIMIT = 16.0
BF16_FAULT = 2.0 ** -3
BF16_STEP_HELD = [("latent", "norm", BF16_STEP_NORM_LIMIT),
                  ("conv", "norm", BF16_STEP_NORM_LIMIT)]
# the trainer's --precision values
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the port's bench (srvp_tpu_torch.bench) at reduced steps
BENCH_ARGS = ["--steps", "3", "--warmup", "2", "--rollout_iters", "2"]
# the vgg pool and upsample sites of the KTH model, (channels, input
# height = width), at the KTH training step's N = 100 x 20 frames
POOL_SITES = [(64, 64), (128, 32), (256, 16), (512, 8)]
UP_SITES = [(512, 4), (256, 8), (128, 16), (64, 32)]
# the conv stage (kernels 8-9): the statistics at rtol 1e-5 / atol 1e-3 of
# float64 sums (tests/test_conv_stage.py:45-48) and y at the rollout
# tolerance RTOL / ATOL with a float64 plain run as arbiter (conv_check);
# the chain of tests/test_conv_stage.py:51-91 at its own tolerances, y atol
# 3e-4 and the sums rtol 1e-4 / atol 1e-2, stated before the first run on
# the card; the sums then needed a float64 arbiter (check_conv_chain)
STATS_RTOL, STATS_ATOL = 1e-5, 1e-3
CHAIN_ATOL, CHAIN_STATS_RTOL, CHAIN_STATS_ATOL = 3e-4, 1e-4, 1e-2
# the vgg workhorse site, (cin, cout, height = width), and kernel 9's rows
# per block (scripts/microbench_conv.py's default)
WORKHORSE, CLAMPED_BH = (64, 64, 64), 8
# the bench runs of the conv stage's main path (bench_conv_stage.py at the
# workhorse shape): kernel 8 in fp32 and bf16, kernel 9 in fp32 and bf16,
# each leg 1 + BENCH_REPS chains of BENCH_INNER + 1 applications
BENCH_INNER, BENCH_REPS = 2, 2
BENCH_RUNS = [["--transform"], ["--transform", "--dtype", "bfloat16"],
              ["--clamped", "--bh", str(CLAMPED_BH)],
              ["--clamped", "--bh", str(CLAMPED_BH), "--dtype", "bfloat16"]]


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
    return bound_ms(flops, n_bytes)


def check_rollout(name, pz_layers, dyn_layers, bsz, n_steps, oversampling,
                  ny, nz, seed, plan=None):
    """Kernel vs plain version on the card, with the launch plan (rows a
    tile R, blocks a cluster C, blocks; by default the wrapper's) and the
    clusters of it the card holds at once; a second launch must give the
    same bits. Returns the measured row."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y0 = torch.randn(bsz, ny, generator=gen, device="cuda")
    eps = torch.randn(n_steps, bsz, nz, generator=gen, device="cuda")
    args = (pz_layers, dyn_layers, y0, eps, ny, nz, oversampling)
    default, hmax = krollout.launch_plan(pz_layers, dyn_layers, bsz, ny, nz)
    plan = plan or default
    resident = krollout.resident_clusters(ny, nz, hmax, plan, y0.device)
    with torch.no_grad():
        out = krollout.prior_rollout(*args, plan=plan)
        again = krollout.prior_rollout(*args, plan=plan)
        ref = krollout.prior_rollout_reference(*args)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        max_abs = diff.max().item()
        max_rel = (diff / ref.abs().clamp_min(1e-30)).max().item()
        worst = (diff / (ATOL + RTOL * ref.abs())).max().item()
        same_bits = bit_equal(out, again)
        ok = bool(torch.isfinite(out).all()) and worst <= 1.0 and same_bits
        ms = cuda_ms(lambda: krollout.prior_rollout(*args, plan=plan))
        plain_ms = cuda_ms(lambda: krollout.prior_rollout_reference(*args))
    bound, bound_by = rollout_bound_ms(pz_layers, dyn_layers, bsz, n_steps,
                                       oversampling, ny, nz)
    row = dict(case=name, B=bsz, n_steps=n_steps, oversampling=oversampling,
               ny=ny, nz=nz, rows=plan.rows, cluster=plan.cluster,
               blocks=plan.tiles * plan.cluster, clusters_resident=resident,
               max_abs_err=max_abs, max_rel_err=max_rel,
               err_over_tol=worst, same_bits=same_bits, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
    print("kernel_check " + json.dumps(row), flush=True)
    if not ok:
        raise SystemExit(f"prior_rollout kernel disagrees with its plain "
                         f"version ({name}): max |err| / (atol + rtol |ref|) "
                         f"= {worst}, same bits on a second launch: "
                         f"{same_bits}")
    return row


def train_rollout_bounds_ms(layers, bsz, n_steps, stash_w, nh_inf, ny, nz):
    """Least times of the training rollout's forward, backward, and the
    backward's two passes on an H100 (each the larger of bytes / memory
    rate and FLOPs / fp32 rate), with what bounds each. Every layer runs on
    every substep. The carry pass does the products g W^T, the
    weight-gradient pass g^T a, each as many as the forward's. Bytes: each
    input read once and each output written once. The carry pass reads the
    weights, eps, q, the stashes of hidden pre-activations and the five
    outputs' cotangents, and writes every layer's output cotangent (G),
    dL/dhxz and dL/dy0; the weight-gradient pass reads the layers' inputs
    (hxz, [y, z], the stashes) and G, and writes dW and db."""
    rows = bsz * n_steps
    macs = sum(w.numel() for w, _ in layers)
    n_params = sum(w.numel() + b.numel() for w, b in layers)
    n_weights = sum(w.numel() for w, _ in layers)
    g_w = sum(w.shape[0] for w, _ in layers)       # G: every layer's output
    state = rows * (2 * ny + 4 * nz + stash_w)      # ys, res, q, p, zs, stash
    fwd_bytes = 4.0 * (n_params + bsz * ny + rows * (nh_inf + nz) + state)
    bwd_bytes = 4.0 * (2 * n_params + bsz * ny + rows * (nh_inf + nz)
                       + 2 * state + rows * nh_inf)   # + cotangents, dhxz
    carry_bytes = 4.0 * (n_weights + rows * (nz + 2 * nz + stash_w)
                         + rows * (2 * ny + 5 * nz)
                         + rows * (g_w + nh_inf) + bsz * ny)
    wgrad_bytes = 4.0 * (rows * (nh_inf + ny + nz + stash_w + g_w)
                         + n_params)
    flops = 2.0 * rows * macs
    return dict(fwd=bound_ms(flops, fwd_bytes),
                bwd=bound_ms(2 * flops, bwd_bytes),
                carry=bound_ms(flops, carry_bytes),
                wgrad=bound_ms(flops, wgrad_bytes))


def backward_split_ms(run, iters=10):
    """Device ms of the training rollout's backward by part, from the CUDA
    events the wrapper records around its launches (rollout_train
    .bwd_events): the carry pass, the weight-gradient pass, and the rest of
    the wrapper's backward (its packing and copies, and any time the device
    waits on the host within it), mean over `iters` calls of `run` after one
    warm-up."""
    run()
    krollout_train.bwd_events = []
    try:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        evs = krollout_train.bwd_events
    finally:
        krollout_train.bwd_events = None
    span = lambda e, k: e[k][0].elapsed_time(e[k][-1])  # noqa: E731
    carry = float(np.mean([span(e, "carry") for e in evs]))
    wgrad = float(np.mean([span(e, "wgrad") for e in evs]))
    whole = float(np.mean([e["start"][0].elapsed_time(e["end"][0])
                           for e in evs]))
    return dict(carry_ms=carry, wgrad_ms=wgrad,
                bwd_wrapper_ms=whole - carry - wgrad)


# readings of the weight-gradient pass's and its yardstick's times, each
# the mean of cuda_ms's 20 calls
WGRAD_READINGS = 5


def check_wgrad(name, args, bound):
    """The weight-gradient pass alone (kernel 3b) on the inputs a training
    backward gave it, `args` = (shapes, n_pz, a_src, g_src), at its
    wrapper's plan: against the same products in fp32 by the library
    (weight_gradients_reference: a torch.mm and a row sum a layer, TF32
    off, each layer's columns taken from the layer shapes and not from the
    kernel's job table, so a wrong route fails too) with a float64 run of
    them as arbiter, at GRAD_RTOL / GRAD_ATOL; a second launch must give
    the same bits. Times the kernel and, as its yardstick, the library
    sequence (timed only: the port never calls it on the card), each the
    median of WGRAD_READINGS readings taken in turns, with their least and
    most. `bound` is the pass's (ms, bound_by). Returns the row."""
    shapes, n_pz, a_src, g_src = args
    device = g_src[0].device
    n_rows = g_src[0].shape[0] * g_src[0].shape[1]
    plan = krollout_train.wgrad_plan(shapes, n_rows, device)
    clusters, per_sm = krollout_train.wgrad_occupancy(plan, device)
    n_tiles = krollout_train.wgrad_n_tiles(shapes)
    run = lambda: krollout_train.weight_gradients(  # noqa: E731
        shapes, n_pz, a_src, g_src, plan)
    library = lambda: krollout_train.weight_gradients_reference(  # noqa
        shapes, n_pz, a_src, g_src)
    out, again, lib = run(), run(), library()
    ref64 = krollout_train.weight_gradients_reference(
        shapes, n_pz, [a.double() for a in a_src],
        [g.double() for g in g_src])
    torch.cuda.synchronize()
    same_bits = all(bit_equal(a, b) for a, b in zip(out, again))
    judged = [parity.agreement(a, b, c, GRAD_RTOL, GRAD_ATOL)
              for a, b, c in zip(out, lib, ref64)]

    def from_f64(outs):
        return max(((a.double() - c).abs()
                    / (GRAD_ATOL + GRAD_RTOL * c.abs())).max().item()
                   for a, c in zip(outs, ref64))
    worst = max(range(len(judged)), key=lambda i: judged[i][1])
    readings = [(cuda_ms(run), cuda_ms(library))
                for _ in range(WGRAD_READINGS)]
    kernel_ms, library_ms = (sorted(r) for r in zip(*readings))
    row = dict(case=name, n_rows=n_rows, split=plan,
               tiles=sorted(set(krollout_train.wgrad_tiles(shapes))),
               n_tiles=n_tiles, blocks=n_tiles * plan,
               clusters_resident=clusters,
               blocks_per_sm=per_sm,
               max_abs_err=max((a - b).abs().max().item()
                               for a, b in zip(out, lib)),
               err_over_tol=max(j[0] for j in judged),
               err_over_tol_f64=judged[worst][1],
               elements_excused=sum(j[2] for j in judged),
               worst=leaf_names(n_pz, len(shapes) - 1 - n_pz)[2 + worst],
               err_over_tol_from_f64=from_f64(out),
               library_err_over_tol_from_f64=from_f64(lib),
               same_bits=same_bits,
               finite=all(bool(torch.isfinite(a).all()) for a in out),
               ms=kernel_ms[WGRAD_READINGS // 2],
               ms_range=[kernel_ms[0], kernel_ms[-1]],
               library_ms=library_ms[WGRAD_READINGS // 2],
               library_ms_range=[library_ms[0], library_ms[-1]],
               bound_ms=bound[0], bound_by=bound[1])
    print("wgrad_check " + json.dumps(row), flush=True)
    if not (row["finite"] and same_bits and row["err_over_tol_f64"] <= 1.0):
        raise SystemExit(f"weight-gradient pass disagrees with the library "
                         f"({name}): err/tol {row['err_over_tol_f64']} "
                         f"({row['worst']}), same bits on a second launch: "
                         f"{same_bits}")
    return row


def _worst(out, ref, rtol, atol):
    diff = (out - ref).abs()
    return (diff.max().item(),
            (diff / (atol + rtol * ref.abs())).max().item(),
            bool(torch.isfinite(out).all()))


def leaf_names(n_pz, n_dyn):
    """Names of the training rollout's differentiated inputs, in the order
    check_train_rollout holds their gradients."""
    return ["y0", "hxz", "q.weight", "q.bias"] + [
        f"{mlp}{i}.{t}" for mlp, n in (("p_z", n_pz), ("dynamics", n_dyn))
        for i in range(n) for t in ("weight", "bias")]


def check_train_rollout(name, q_layer, pz_layers, dyn_layers, bsz, n_steps,
                        oversampling, seed, margin=parity.KINK_MARGIN):
    """Training-rollout kernels (forward, and backward through a loss that
    touches every output) against the plain version on the card, on
    kink-free inputs, each pass at its wrapper's plan; the forward's
    stashed pre-activations against the plain ones too. A second launch
    must give the same bits: the forward's outputs and stashes, and the
    gradients. Times the kernels' forward and backward, the backward's two
    passes and the rest of its wrapper apart, and the plain version's
    forward and backward. Returns the measured row."""
    nh_inf, ny = q_layer[0].shape[1], pz_layers[0][0].shape[1]
    nz = q_layer[0].shape[0] // 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y0, hxz, eps, redrawn = parity.kink_free_inputs(
        q_layer, pz_layers, dyn_layers, bsz, n_steps, oversampling, gen,
        margin)
    layers = [q_layer] + list(pz_layers) + list(dyn_layers)
    flat = [t.detach() for w, b in layers for t in (w, b)]
    n_pz = len(pz_layers)
    lib = kbuild.load_library()
    hmax = krollout_train.bwd_hmax(layers)
    plan = krollout_train.bwd_plan(bsz, ny, nz, hmax, y0.device)
    resident = krollout.check_schedulable(
        lib.srvp_train_rollout_bwd_clusters, (ny, nz, hmax), plan, y0.device)
    fwd_hmax = krollout_train.fwd_hmax(layers)
    fplan = krollout_train.fwd_plan(bsz, ny, nz, nh_inf, fwd_hmax, y0.device)
    fwd_resident = krollout.check_schedulable(
        lib.srvp_train_rollout_fwd_clusters, (ny, nz, nh_inf, fwd_hmax),
        fplan, y0.device)
    kernel = krollout_train.train_rollout

    def leaves(dtype=torch.float32):
        return [t.to(dtype, copy=True).requires_grad_()
                for t in [y0, hxz] + flat]

    def call(fn, lv, dtype=torch.float32):
        pairs = [(lv[i], lv[i + 1]) for i in range(2, len(lv), 2)]
        return fn(pairs[0], pairs[1:1 + n_pz], pairs[1 + n_pz:], lv[0],
                  lv[1], eps.to(dtype), oversampling)

    runs = {}
    # the weight-gradient pass's inputs on the first kernel run (check_wgrad)
    krollout_train.wgrad_inputs = []
    for route, fn, dtype in (
            ("kernel", kernel, torch.float32),
            ("plain", krollout_train.train_rollout_reference, torch.float32),
            ("plain64", krollout_train.train_rollout_reference,
             torch.float64)):
        lv = leaves(dtype)
        outs = call(fn, lv, dtype)
        grads = torch.autograd.grad(parity.rollout_loss(outs), lv)
        runs[route] = (outs, grads, lv)
        if route == "kernel":
            (wgrad_args,), krollout_train.wgrad_inputs = \
                krollout_train.wgrad_inputs, None
    lv = runs["kernel"][2]
    outs_again = call(kernel, lv)
    again = torch.autograd.grad(parity.rollout_loss(outs_again), lv)
    # the forward alone, with its stashes: twice on the kernel, then the
    # plain version in float32 and float64
    stashed = [krollout_train.train_rollout_forward(
        q_layer, pz_layers, dyn_layers, y0, hxz, eps, oversampling)
        for _ in range(2)]
    for dtype in (torch.float32, torch.float64):
        lw = [t.to(dtype) for t in flat]
        pairs = [(lw[i], lw[i + 1]) for i in range(0, len(lw), 2)]
        stashed.append(krollout_train.train_rollout_reference(
            pairs[0], pairs[1:1 + n_pz], pairs[1 + n_pz:], y0.to(dtype),
            hxz.to(dtype), eps.to(dtype), oversampling, stash=True))
    torch.cuda.synchronize()
    fwd_same_bits = all(bit_equal(a, b) for a, b in zip(
        runs["kernel"][0] + stashed[0], outs_again + stashed[1])) and all(
        bit_equal(a, b) for a, b in zip(runs["kernel"][0], stashed[0]))
    bwd_same_bits = all(bit_equal(a, b)
                        for a, b in zip(runs["kernel"][1], again))
    same_bits = fwd_same_bits and bwd_same_bits
    # per output / stash / gradient: (max |err|, finite, raw err/tol,
    # arbitrated err/tol, elements excused by the float64 arbiter)
    fwd = [_worst(a, b, TRAIN_RTOL, TRAIN_ATOL)[::2]
           + parity.agreement(a, b, c, TRAIN_RTOL, TRAIN_ATOL)
           for a, b, c in zip(*(runs[r][0] for r in runs))]
    fwd += [_worst(a, b, TRAIN_RTOL, TRAIN_ATOL)[::2]
            + parity.agreement(a, b, c, TRAIN_RTOL, TRAIN_ATOL)
            for a, b, c in zip(*(st[5:] for st in stashed[1:]))]
    bwd = [_worst(a, b, GRAD_RTOL, GRAD_ATOL)[::2]
           + parity.agreement(a, b, c, GRAD_RTOL, GRAD_ATOL)
           for a, b, c in zip(*(runs[r][1] for r in runs))]

    times = {}
    for route, fn in (("kernel", kernel),
                      ("plain", krollout_train.train_rollout_reference)):
        lv = runs[route][2]
        with torch.no_grad():
            times[f"{route}_fwd_ms"] = cuda_ms(lambda: call(fn, lv))
        outs = call(fn, lv)
        cots = [torch.ones_like(o) for o in outs]
        backward = lambda: torch.autograd.grad(  # noqa: E731
            outs, lv, cots, retain_graph=True)
        times[f"{route}_bwd_ms"] = cuda_ms(backward)
        if route == "kernel":
            times.update(backward_split_ms(backward))
    stash_w = sum(w.shape[0] for w, _ in list(pz_layers)[:-1]) \
        + sum(w.shape[0] for w, _ in list(dyn_layers)[:-1])
    bounds = train_rollout_bounds_ms(layers, bsz, n_steps, stash_w, nh_inf,
                                     ny, nz)
    row = dict(case=name, B=bsz, n_steps=n_steps, oversampling=oversampling,
               ny=ny, nz=nz, kink_margin=margin, rows_redrawn=redrawn,
               fwd_rows=fplan.rows, fwd_cluster=fplan.cluster,
               fwd_blocks=fplan.tiles * fplan.cluster,
               fwd_clusters_resident=fwd_resident,
               bwd_rows=plan.rows, bwd_cluster=plan.cluster,
               bwd_blocks=plan.tiles * plan.cluster,
               bwd_clusters_resident=resident,
               fwd_max_abs_err=max(f[0] for f in fwd),
               fwd_err_over_tol=max(f[2] for f in fwd),
               fwd_err_over_tol_f64=max(f[3] for f in fwd),
               fwd_elements_excused=sum(f[4] for f in fwd),
               bwd_max_abs_err=max(b[0] for b in bwd),
               bwd_err_over_tol=max(b[2] for b in bwd),
               bwd_err_over_tol_f64=max(b[3] for b in bwd),
               bwd_elements_excused=sum(b[4] for b in bwd),
               bwd_worst=leaf_names(n_pz, len(dyn_layers))[
                   max(range(len(bwd)), key=lambda i: bwd[i][3])],
               fwd_same_bits=fwd_same_bits, bwd_same_bits=bwd_same_bits,
               **times)
    for part, (ms, by) in bounds.items():
        row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = ms, by
    row["plain_fwd_bwd_ms"] = times["plain_fwd_ms"] + times["plain_bwd_ms"]
    print("train_kernel_check " + json.dumps(row), flush=True)
    row["wgrad"] = check_wgrad(name, wgrad_args, bounds["wgrad"])
    finite = all(f[1] for f in fwd) and all(b[1] for b in bwd)
    if not finite or not same_bits or row["fwd_err_over_tol_f64"] > 1.0 \
            or row["bwd_err_over_tol_f64"] > 1.0:
        raise SystemExit(f"train_rollout kernels disagree with the plain "
                         f"version ({name}): forward err/tol "
                         f"{row['fwd_err_over_tol_f64']}, gradients err/tol "
                         f"{row['bwd_err_over_tol_f64']}, same bits on a "
                         f"second forward: {fwd_same_bits}, backward: "
                         f"{bwd_same_bits}")
    return row


def bit_equal(a, b):
    """Same shape, dtype and bits everywhere, a NaN matching any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    same = (a.view(view) == b.view(view)) \
        | (torch.isnan(a) & torch.isnan(b))
    return bool(same.all())


def max_abs_diff(a, b):
    """Largest |a - b| where neither is a NaN (0 for empty tensors)."""
    ok = ~(torch.isnan(a) | torch.isnan(b))
    return float((a[ok] - b[ok]).abs().max()) if ok.any() else 0.0


def tied_input(shape, gen, dtype=torch.float32):
    """N(0, 1) (N, C, H, W) on the card, in `dtype`, whose first half of
    frames is quantised to 1/8 with a quarter of its 2x2 windows flat (one
    value), so that pooling windows hold ties, and with a NaN planted in a
    flat window of frame 0 and in frame N-1."""
    x = torch.randn(shape, generator=gen, device="cuda")
    n, c, h, w = shape
    half = max(n // 2, 1)
    q = torch.round(x[:half] * 8) / 8
    flat = torch.rand((half, c, h // 2, w // 2), generator=gen,
                      device="cuda") < 0.25
    flat[0, 0, 0, 0] = True
    corner = krspatial.upsample2x_reference(q[:, :, ::2, ::2])
    x[:half] = torch.where(krspatial.upsample2x_reference(flat.float()) > 0,
                           corner, q)
    x[0, 0, 0, 1] = float("nan")
    x[-1, -1, -1, -1] = float("nan")
    return x.to(dtype)


def spatial_site(kind, n, c, hw, gen, dtype=torch.float32):
    """The kernels of one vgg pool (4, 5) or upsample (6, 7) site in
    `dtype` against their plain versions, bit for bit, with CUDA-event times
    beside the plain versions', the library calls' (in the same dtype) and
    the bytes bound. Returns the forward's and the backward's rows."""
    x = tied_input((n, c, hw, hw), gen, dtype)
    n_in = x.numel()
    randn = lambda shape: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda").to(dtype)
    xr = x.detach().requires_grad_()
    if kind == "pool":
        out = krspatial.max_pool2x2(x)
        ref = krspatial.max_pool2x2_reference(x)
        g = randn(out.shape)
        gx = krspatial.max_pool2x2_bwd(x, out, g)
        gx_ref = krspatial.max_pool2x2_bwd_reference(x, ref, g)
        mask = (x == krspatial.upsample2x_reference(ref)).float()
        tied = int((krspatial.upsample2x_bwd_reference(mask) > 1).sum())
        fwd = (lambda: krspatial.max_pool2x2(x),
               lambda: krspatial.max_pool2x2_reference(x),
               lambda: F.max_pool2d(x, 2), 5 * n_in / 4)
        y_lib = F.max_pool2d(xr, 2)
        bwd = (lambda: krspatial.max_pool2x2_bwd(x, out, g),
               lambda: krspatial.max_pool2x2_bwd_reference(x, ref, g),
               lambda: torch.autograd.grad(y_lib, xr, g, retain_graph=True),
               5 * n_in / 2)
    else:
        out = krspatial.upsample2x(x)
        ref = krspatial.upsample2x_reference(x)
        g = randn(out.shape)
        gx = krspatial.upsample2x_bwd(g)
        gx_ref = krspatial.upsample2x_bwd_reference(g)
        tied = 0
        up = lambda v: F.interpolate(v, scale_factor=2,  # noqa: E731
                                     mode="nearest")
        fwd = (lambda: krspatial.upsample2x(x),
               lambda: krspatial.upsample2x_reference(x),
               lambda: up(x), 5 * n_in)
        y_lib = up(xr)
        bwd = (lambda: krspatial.upsample2x_bwd(g),
               lambda: krspatial.upsample2x_bwd_reference(g),
               lambda: torch.autograd.grad(y_lib, xr, g, retain_graph=True),
               5 * n_in)
    torch.cuda.synchronize()
    rows = []
    for part, (a, b), (kern, plain, lib, elems) in (
            ("fwd", (out, ref), fwd), ("bwd", (gx, gx_ref), bwd)):
        with torch.no_grad():
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        rows.append(dict(
            kernel=f"{'maxpool' if kind == 'pool' else 'upsample'}_{part}",
            dtype=str(dtype).split(".")[-1],
            shape=[n, c, hw, hw], bit_equal=bit_equal(a, b),
            nan_where_plain_nan=bool(torch.equal(torch.isnan(a),
                                                 torch.isnan(b))),
            nans=int(torch.isnan(b).sum()), tied_windows=tied,
            max_abs_err=max_abs_diff(a.float(), b.float()), ms=ms,
            plain_ms=plain_ms, library_ms=cuda_ms(lib),
            bound_ms=1e3 * x.element_size() * elems / PEAK_HBM_BYTES,
            bound_by="bytes"))
        print("spatial_check " + json.dumps(rows[-1]), flush=True)
    return rows


def check_spatial(n_frames, seed, dtype=torch.float32):
    """Kernels 4-7 in `dtype` at every vgg site of the KTH step (N frames);
    fails unless each is bit-equal to its plain version, planted NaNs
    included. Returns {kernel: row at its largest site}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    largest = {}
    for kind, sites in (("pool", POOL_SITES), ("up", UP_SITES)):
        for c, hw in sites:
            for row in spatial_site(kind, n_frames, c, hw, gen, dtype):
                # every output but upsample_bwd's sees the planted NaNs
                planted = row["nans"] > 0 or row["kernel"] == "upsample_bwd"
                ties = row["tied_windows"] > 0 or kind == "up"
                if not (row["bit_equal"] and planted and ties):
                    raise SystemExit(f"{row['kernel']} at {row['shape']}: "
                                     f"{row}")
                best = largest.get(row["kernel"])
                if best is None or np.prod(row["shape"]) > np.prod(
                        best["shape"]):
                    largest[row["kernel"]] = row
            torch.cuda.empty_cache()
    return largest


def conv_sites(cfg):
    """[(part, cin, cout, height = width)] of every 3x3 conv of cfg's vgg
    encoder and decoder (models/conv.py's specs), in order."""
    enc, _ = encoder_spec(cfg.archi, cfg.nc, cfg.nhx, cfg.nf)
    _, dec = decoder_spec(cfg.archi, cfg.nc, cfg.nh_inf + cfg.ny, cfg.nf,
                          cfg.skipco)
    sites = []
    # the decoder's stages start at the 4x4 stem upsampled once
    for part, stages, hw in (("encoder", enc, cfg.nx),
                             ("decoder", dec, cfg.nx // 8)):
        for ops in stages:
            for op, spec in ops:
                if op == "maxpool":
                    hw //= 2
                elif op == "upsample":
                    hw *= 2
                elif spec.kind == "conv" and spec.kernel == 3:
                    sites.append((part, spec.in_ch, spec.out_ch, hw))
    return sites


def conv_bound_ms(n, cin, cout, hw, dtype):
    """(least ms, what bounds it, FLOPs, second bound ms) of one conv-stage
    call on an H100: x read once, w, scale and shift read, y and the
    statistics written once; 9 cin cout multiply-adds a pixel on the tensor
    cores, where the kernel runs them. In fp32 an fp32-accurate product
    takes three TF32 products (3xTF32) at 495 TFLOP/s; the second bound is
    the same FLOPs once at the 67 TFLOP/s of fp32 FMA on the CUDA cores. In
    bf16 the bound takes the FLOPs at the 989 TFLOP/s of bf16; the second
    bound takes them once at the TF32 rate, which the kernel's one TF32
    product a term runs at."""
    es = torch.empty((), dtype=dtype).element_size()
    flops = 2.0 * 9 * cin * cout * hw * hw * n
    n_bytes = es * (n * (cin + cout) * hw * hw + 9 * cin * cout) \
        + 4.0 * 2 * (cin + cout)
    if dtype == torch.float32:
        bound = bound_ms(3 * flops, n_bytes, PEAK_TF32_FLOPS)
        second = bound_ms(flops, n_bytes, PEAK_FP32_FLOPS)[0]
    else:
        bound = bound_ms(flops, n_bytes, PEAK_BF16_FLOPS)
        second = bound_ms(flops, n_bytes, PEAK_TF32_FLOPS)[0]
    return bound + (flops, second)


def conv_check(kind, x, w, scale=None, shift=None, act="none", n_valid=None):
    """Kernel 8 (kind "block") or 9 ("clamped", CLAMPED_BH rows a block)
    against its plain version on the card, in x's dtype. y: elementwise at
    RTOL / ATOL with a float64 plain run as arbiter (parity.agreement) in
    fp32; within one bf16 ulp + ATOL of the plain version in bf16
    (parity.bf16_ulp_err). The statistics: at STATS_RTOL / STATS_ATOL of
    float64 sums of the kernel's fp32 accumulator over the counted frames,
    which is y itself in fp32 and, in bf16, the fp32 kernel's y on the same
    rounded values (the same products summed in the same order; whether it
    matches the bf16 run bit for bit is printed). Against the plain
    version's statistics they are printed only, raw and with the float64 run
    as arbiter: over 8.2 M values a channel the fp32 rounding of y alone
    moves a sum that cancels (zero-mean y) by more than STATS_ATOL, in the
    plain version as in the kernel. A second launch must give the same bits.
    Times of the kernel and the cuDNN leg (bench_conv_stage.cudnn_stage)
    over 20 calls after 3 warm-up calls, of the plain version over 5 after
    1, beside the bound. Returns the row."""
    n, cin, hw = x.shape[0], x.shape[1], x.shape[2]
    cout = w.shape[0]
    if kind == "block":
        args = (x, w, scale, shift, act, n_valid)
        kern = lambda: kcs.conv3x3_block_fwd(*args)  # noqa: E731
        plain = lambda: kcs.conv3x3_block_fwd_reference(*args)  # noqa: E731
        lib = lambda: bench_conv_stage.cudnn_stage(*args)  # noqa: E731
        # the fp32 kernel on the values a bf16 run multiplies
        kern32 = lambda: kcs.conv3x3_block_fwd(  # noqa: E731
            kcs.activated_input(x, scale, shift, act), w.float(), act="none",
            n_valid=n_valid)
        y64, st64 = parity.conv_stage_f64(*args)
    else:
        kern = lambda: kcs.fused_conv_bn(x, w, CLAMPED_BH)  # noqa: E731
        plain = lambda: kcs.fused_conv_bn_reference(  # noqa: E731
            x, w, CLAMPED_BH)
        lib = lambda: bench_conv_stage.cudnn_stage(x, w)  # noqa: E731
        kern32 = lambda: kcs.fused_conv_bn(  # noqa: E731
            x.float(), w.float(), CLAMPED_BH)
        y64, st64 = parity.conv_stage_f64(x, w, bh=CLAMPED_BH)
    counted = n if n_valid is None else n_valid
    with torch.no_grad():
        y, st = kern()
        y_again, st_again = kern()
        y_ref, st_ref = plain()
        torch.cuda.synchronize()
        same_bits = torch.equal(st, st_again) and torch.equal(y, y_again)
        del y_again
        bf16 = x.dtype == torch.bfloat16
        if bf16:
            y_raw = y_judged = parity.bf16_ulp_err(y, y_ref, ATOL).max().item()
            excused = 0
            acc, st32 = kern32()
            as_fp32 = torch.equal(acc.bfloat16(), y) and torch.equal(st32, st)
            del st32
        else:
            y_raw, y_judged, excused = parity.agreement(y, y_ref, y64, RTOL,
                                                        ATOL)
            acc, as_fp32 = y, None
        st_own = kcs.batch_stats(acc.double(), counted)
        st_err = ((st.double() - st_own).abs()
                  / (STATS_ATOL + STATS_RTOL * st_own.abs())).max().item()
        st_raw, st_f64, _ = parity.agreement(st, st_ref, st64, STATS_RTOL,
                                             STATS_ATOL)
        max_abs = (y.float() - y_ref.float()).abs().max().item()
        finite = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
        del y, y_ref, y64, acc
        torch.cuda.empty_cache()
        # the plain version, a yardstick and 2-4x slower, over fewer calls
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain, warmup=1, iters=5)
        library_ms = cuda_ms(lib)
    bound, bound_by, flops, second = conv_bound_ms(n, cin, cout, hw,
                                                   x.dtype)
    row = dict(kernel="conv3x3_block_fwd" if kind == "block"
               else "fused_conv_bn", shape=[n, cin, cout, hw, hw],
               dtype=str(x.dtype).removeprefix("torch."), n_valid=counted,
               transform=scale is not None, act=act, max_abs_err=max_abs,
               y_err_over_tol=y_raw, y_err_over_tol_f64=y_judged,
               elements_excused=excused, stats_err_over_tol=st_err,
               stats_vs_plain_err_over_tol=st_raw,
               stats_vs_plain_err_over_tol_f64=st_f64,
               bf16_bits_as_fp32_kernel=as_fp32, same_bits_twice=same_bits,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound, bound_by=bound_by,
               second_bound_ms=second, second_bound_of=(
                   "fp32 FMA, CUDA cores" if x.dtype == torch.float32
                   else "one TF32 product"), tflops=flops / ms / 1e9,
               bound_over_ms=bound / ms)
    print("conv_check " + json.dumps(row), flush=True)
    if not (finite and same_bits and y_judged <= 1.0 and st_err <= 1.0):
        raise SystemExit(f"{row['kernel']} disagrees with its plain version "
                         f"or is not deterministic: {row}")
    return row


def check_conv_stage(n_frames, seed):
    """Kernel 8 in fp32 at every 3x3 conv site of the KTH vgg model
    (conv_sites) at N frames: the first encoder site as the frame enters
    (no transform, act none), every other with a transform and LeakyReLU,
    the decoder's first with n_valid < N; at the workhorse site also
    kernel 8 in bf16 and kernel 9 in fp32 and bf16 on the same inputs.
    Returns (the site rows, {check: row} at the workhorse)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, workhorse = [], {}
    for i, (part, cin, cout, hw) in enumerate(
            conv_sites(model_config(KTH_CONFIG))):
        x = torch.randn(n_frames, cin, hw, hw, generator=gen, device="cuda")
        w = torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") \
            * (2.0 / (9 * cin)) ** 0.5
        scale = shift = None
        if i > 0:
            scale = 1 + 0.1 * torch.randn(cin, generator=gen, device="cuda")
            shift = 0.1 * torch.randn(cin, generator=gen, device="cuda")
        act = "none" if i == 0 else "leaky_relu"
        n_valid = n_frames * 19 // 20 if (part, cin) == ("decoder", 1024) \
            else None
        row = conv_check("block", x, w, scale, shift, act, n_valid)
        rows.append(dict(row, site=f"{part} {cin}->{cout} at {hw}x{hw}"))
        if (cin, cout, hw) == WORKHORSE and not workhorse:
            xb, wb = x.bfloat16(), w.bfloat16()
            workhorse = {"block float32": row,
                         "block bfloat16": conv_check("block", xb, wb, scale,
                                                      shift, act),
                         "clamped float32": conv_check("clamped", x, w),
                         "clamped bfloat16": conv_check("clamped", xb, wb)}
            del xb, wb
        del x, w
        torch.cuda.empty_cache()
    return rows, workhorse


def check_conv_chain(n_frames, seed):
    """The two-block chain of tests/test_conv_stage.py:51-91 at the full size
    of KTH encoder stage 0, on N synthetic KTH frames in [0, 1]: kernel 8
    (1 -> 64, no transform, act none), the batch norm's (scale, shift),
    kernel 8 (64 -> 64, the normalize and LeakyReLU on the load), against
    the port's eager stage (nn.Conv2d, nn.BatchNorm2d in train mode,
    LeakyReLU) with the same seeded weights (the training init), run again
    in float64 as the arbiter of the sums. The second conv's output is held
    at CHAIN_ATOL against the eager stage's; its sums at CHAIN_STATS_RTOL /
    CHAIN_STATS_ATOL against the eager stage's, or no farther from the
    float64 stage's than those are (parity.agreement): over 8.2 M values a
    channel, an fp32 batch norm's rounding of a channel's mean and variance
    shifts all its values alike, which moves a sum that nearly cancels past
    that tolerance in the eager stage as in the chain. Both are held with
    (scale, shift) from a two-pass variance of the first conv's output, as
    BatchNorm2d takes it; with bn_scale_shift's one-pass variance (the JAX
    package's E[y^2] - mean^2 in fp32) the output is held and the sums
    printed. Returns the row."""
    cfg = model_config(KTH_CONFIG)
    torch.manual_seed(seed)
    stage = stage_module(encoder_spec(cfg.archi, cfg.nc, cfg.nhx,
                                      cfg.nf)[0][0]).cuda().train()
    for m in stage.modules():
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.normal_(m.weight, 0.0, CONV_STD)
        elif isinstance(m, torch.nn.BatchNorm2d):
            torch.nn.init.normal_(m.weight, 1.0, CONV_STD)
    seq = KTH_CONFIG["seq_len"]
    frames = synthetic_kth_videos(n_frames // seq, seq, cfg.nx,
                                  np.random.RandomState(seed))
    x = torch.from_numpy(frames).cuda().float().div(255).reshape(
        -1, 1, cfg.nx, cfg.nx)
    n, hw = x.shape[0], cfg.nx * cfg.nx
    (conv1, bn1, _), (conv2, _, _) = stage
    row = dict(shape=[n, 64, cfg.nx, cfg.nx])
    with torch.no_grad():
        eager = conv2(stage[0](x))
        st_eager = kcs.batch_stats(eager.double(), n)
        stage64 = copy.deepcopy(stage).double()
        st64 = kcs.batch_stats(stage64[1][0](stage64[0](x.double())), n)
        del stage64
        row["eager_stats_vs_f64_err_over_tol"] = ((st_eager - st64).abs() / (
            CHAIN_STATS_ATOL + CHAIN_STATS_RTOL * st64.abs())).max().item()
        y1, st1 = kcs.conv3x3_block_fwd(x, conv1.weight, act="none")
        mean = y1.double().mean((0, 2, 3))
        inv = bn1.weight.double() * torch.rsqrt(
            y1.double().var((0, 2, 3), unbiased=False) + bn1.eps)
        for variance, (scale, shift) in (
                ("one_pass", kcs.bn_scale_shift(st1, bn1.weight, bn1.bias, n,
                                                hw)),
                ("two_pass", (inv.float(),
                              (bn1.bias.double() - mean * inv).float()))):
            y2, st2 = kcs.conv3x3_block_fwd(y1, conv2.weight, scale, shift,
                                            "leaky_relu")
            err = (y2 - eager).abs().max().item()
            raw, judged, _ = parity.agreement(st2, st_eager, st64,
                                              CHAIN_STATS_RTOL,
                                              CHAIN_STATS_ATOL)
            row.update({f"{variance}_y_max_abs_err": err,
                        f"{variance}_y_err_over_tol": err / CHAIN_ATOL,
                        f"{variance}_stats_err_over_tol": raw,
                        f"{variance}_stats_err_over_tol_f64": judged,
                        f"{variance}_finite": bool(torch.isfinite(y2).all())})
            del y2
    print("conv_chain " + json.dumps(row), flush=True)
    if not (row["one_pass_finite"] and row["two_pass_finite"]
            and row["one_pass_y_err_over_tol"] <= 1.0
            and row["two_pass_y_err_over_tol"] <= 1.0
            and row["two_pass_stats_err_over_tol_f64"] <= 1.0):
        raise SystemExit(f"the kernel-8 chain disagrees with the eager "
                         f"stage: {row}")
    return row


def conv_stage_path(n_frames, seed):
    """The conv stage's main path: the port's bench (bench_conv_stage.run)
    at the workhorse shape, BENCH_RUNS each beside the cuDNN leg, then the
    full-size chain (check_conv_chain), with exact launch counts. Returns
    ({run: {leg: ms}}, launch counts, the chain's row)."""
    cin, _, hw = WORKHORSE
    klaunches.reset()
    bench = {}
    for extra in BENCH_RUNS:
        bench[" ".join(extra)] = bench_conv_stage.run(
            bench_conv_stage.create_args().parse_args([
                "--c", str(cin), "--hw", str(hw), "--n", str(n_frames),
                "--inner", str(BENCH_INNER), "--reps", str(BENCH_REPS),
                "--cudnn", *extra]))
        torch.cuda.empty_cache()
    chain = check_conv_chain(n_frames, seed)
    counts = klaunches.counts()
    per_leg = (BENCH_REPS + 1) * (BENCH_INNER + 1)
    expect_launches("conv stage path", counts, dict(
        conv3x3_block=2 * per_leg + 3, conv3x3_clamped=2 * per_leg))
    print("conv_path " + json.dumps(dict(bench=bench, launches=counts)),
          flush=True)
    return bench, counts, chain


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


def write_kth_packed_tree(data_dir, nx, seed):
    """A packed KTH training tree (data/kth.py): 6 classes x persons 1-25,
    one synthetic video each of 32 to 47 frames, but 16 for person 1 (shorter
    than a training window, which makes the loader draw again), and
    COMPLETE.json. Returns the number of videos."""
    from srvp_tpu_torch.data.kth import CLASSES
    rng = np.random.RandomState(seed)
    root = Path(data_dir) / f"packed_{nx}"
    n = 0
    for c in CLASSES:
        (root / c).mkdir(parents=True, exist_ok=True)
        for person in range(1, 26):
            n_frames = 16 if person == 1 else rng.randint(32, 48)
            video = synthetic_kth_videos(1, n_frames, nx, rng)[0]
            np.save(root / c / f"person{person:02d}_{c}_d1.npy", video)
            n += 1
    with open(root / "COMPLETE.json", "w") as f:
        json.dump({"videos": n}, f)
    return n


def write_test_set(cfg, data_dir, n_videos, nt_test, seed):
    """The test fold test_main reads for cfg's dataset, synthetic."""
    if cfg["dataset"] == "kth":
        seqs = synthetic_kth_videos(n_videos, nt_test, cfg["nx"],
                                    np.random.RandomState(seed))
        np.savez_compressed(Path(data_dir) / f"svg_test_set_{nt_test}.npz",
                            sequences=seqs)
    else:
        seqs = synthetic_sequences(n_videos, nt_test, cfg["nx"], seed=seed)
        np.savez_compressed(Path(data_dir) / "smmnist_test_2digits_64.npz",
                            sequences=seqs)


def expect_launches(what, counts, expected):
    """Fails unless every kernel launched exactly as often as expected."""
    expected = {k: expected.get(k, 0) for k in counts}
    if counts != expected:
        raise SystemExit(f"{what}: kernel launches {counts}, expected "
                         f"{expected}")


def check_artifacts(arts, n_videos, t_cond, t_pred, nx):
    res = arts["results"]
    if set(res) != {"psnr", "ssim"}:
        raise SystemExit(f"results.npz keys {sorted(res)}")
    for k, v in res.items():
        if v.shape != (n_videos,) or v.dtype != np.float32 \
                or not np.all(np.isfinite(v)):
            raise SystemExit(f"results[{k}]: {v.shape} {v.dtype}")
    for name, arc in arts.items():
        if name == "results":
            continue
        t = t_cond if name == "cond_rec" else t_pred
        s = arc["samples"]
        if s.shape != (n_videos, t, nx, nx, 1) or s.dtype != np.uint8:
            raise SystemExit(f"{name}: {s.shape} {s.dtype}")


def eval_path(cfg, n_videos, nt_test, model_seed):
    """The evaluation CLI on cfg's model with seeded random weights,
    through the prior-rollout kernel and then through the eager rollout on
    the same noise, with exact launch counts; returns the kernel run's
    summary."""
    name = f"{cfg['dataset']}-{cfg['archi']}"
    xp_dir, data_dir = WORK_DIR / f"xp_{name}", WORK_DIR / f"data_{name}"
    xp_dir.mkdir(parents=True, exist_ok=True)
    data_dir.mkdir(parents=True, exist_ok=True)
    with open(xp_dir / "config.json", "w") as f:
        json.dump(cfg, f)
    torch.manual_seed(model_seed)
    torch.save(SRVP(model_config(cfg)).state_dict(), xp_dir / "model.pt")
    write_test_set(cfg, data_dir, n_videos, nt_test, model_seed)

    t_cond = cfg["nt_cond"]
    t_pred = nt_test - t_cond
    n_batches = -(-n_videos // BATCH)
    n_chunks = n_batches * (N_SAMPLES // CHUNK)
    # per chunk: the rollout; on vgg, the 4 pools of the conditioning
    # encode and the 4 upsamples of each of the two decodes
    vgg = 1 if cfg["archi"] == "vgg" else 0
    runs = {}
    for fused in ("on", "off"):
        klaunches.reset()
        runs[fused] = run_cli(xp_dir, data_dir, fused, nt_test)
        counts = klaunches.counts()
        expect_launches(f"{name} evaluation, rollout {fused}", counts, dict(
            prior_rollout=n_chunks if fused == "on" else 0,
            maxpool_fwd=4 * vgg * n_chunks, upsample_fwd=8 * vgg * n_chunks))
        runs[fused] += (counts,)
        check_artifacts(runs[fused][0], n_videos, t_cond, t_pred, cfg["nx"])
    (arts_k, secs_k, wall_k, counts), (arts_p, secs_p, wall_p, _) = \
        runs["on"], runs["off"]

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
        config=name, batches=n_batches, videos=n_videos, samples=N_SAMPLES,
        chunk=CHUNK, nt_cond=t_cond, nt_test=nt_test,
        o_gen=cfg["n_euler_steps"], launches=counts,
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
    print("eval_path " + json.dumps(summary), flush=True)
    if d_metric["psnr"] > 1e-3 or d_metric["ssim"] > 1e-4 \
            or max(d_frames.values()) > 1:
        raise SystemExit(f"{name}: kernel and eager rollout disagree on the "
                         "evaluation path")
    return summary


def run_cli(xp_dir, data_dir, fused, nt_test, n_samples=N_SAMPLES,
            model_name="model.pt"):
    opt_args = [
        "--xp_dir", str(xp_dir), "--data_dir", str(data_dir),
        "--batch_size", str(BATCH), "--n_samples", str(n_samples),
        "--samples_chunk", str(CHUNK), "--fused_rollout", fused,
        "--nt_gen", str(nt_test), "--model_name", model_name,
        "--device", "cuda"]
    opt = test_main.create_test_args().parse_args(opt_args)
    t0 = time.perf_counter()
    batch_seconds = test_main.main(opt)
    wall = time.perf_counter() - t0
    arts = {"results": dict(np.load(xp_dir / "results.npz"))}
    for name in ["cond_rec", "psnr_best", "psnr_worst", "ssim_best",
                 "ssim_worst"] + [f"random_{i}" for i in range(1, 6)]:
        arts[name] = dict(np.load(xp_dir / f"{name}.npz"))
    return arts, batch_seconds, wall


def train_args(save_path, data_dir, n_steps, fused="on", cfg=XP_CONFIG,
               batch_size=TRAIN_BATCH, precision="float32"):
    """The trainer's flags at cfg's width and training protocol: for the
    dcgan flagship, bench.py's smmnist-dcgan cell (batch 128, seq_len 15,
    o = 1) on synthetic digits; for kth-vgg, configs/kth.yaml (batch 100,
    seq_len 20, o = 2); `precision` is the trainer's --precision."""
    return train_main.create_args().parse_args(train_argv(
        save_path, data_dir, n_steps, fused, cfg, batch_size, precision))


def train_argv(save_path, data_dir, n_steps, fused="on", cfg=XP_CONFIG,
               batch_size=TRAIN_BATCH, precision="float32"):
    """train_args's command line."""
    flags = dict(dataset=cfg["dataset"], data_dir=data_dir,
                 save_path=save_path, batch_size=batch_size, n_iter=n_steps,
                 log_interval=1, val_interval=n_steps, n_iter_test=1,
                 batch_size_test=BATCH, n_samples_test=CHUNK,
                 val_samples_chunk=CHUNK, seed=SEED + 1, device="cuda",
                 fused_rollout=fused, precision=precision)
    for k in ("nc", "nx", "nf", "nhx", "ny", "nz", "nt_inf", "nh_inf",
              "nlayers_inf", "nh_res", "nlayers_res", "n_euler_steps",
              "nt_cond", "seq_len", "seq_len_test", "archi", "obs_scale",
              "res_gain"):
        if k in cfg:
            flags[k] = cfg[k]
    args = [f"--{k}={v}" for k, v in flags.items()]
    args += ["--skipco"] if cfg["skipco"] else []
    args += ["--allow_synthetic"] if cfg["dataset"] == "smmnist" else []
    return args


def training_rows(xp_dir):
    """The training-step rows of a trainer's metrics.jsonl (its
    validation rows apart)."""
    with open(Path(xp_dir) / "metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if "loss" in r]


@torch.no_grad()
def kink_free_step_noise(model, x, oversampling, gen, margin):
    """The draws of one training step of `model` on the float batch x
    (frame_idx, eps_y, eps_pos, and skip_t with skip connections), with the
    rows whose latent rollout puts a ReLU input within `margin` of a kink
    (parity.rows_near_kink) drawn again."""
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
    if cfg.skipco:
        noise["skip_t"] = torch.randint(0, nt, (bsz,), generator=gen,
                                        device="cuda")

    def fill(mask, n):
        noise["eps_y"][mask] = torch.randn(n, cfg.ny, generator=gen,
                                           device="cuda")
        noise["eps_pos"][:, mask] = torch.randn(
            hxz.shape[0], n, cfg.nz, generator=gen, device="cuda")

    def near():
        y0, _ = m.infer_y(hx[:cfg.nt_inf], noise["eps_y"])
        return parity.rows_near_kink(
            (m.q_z.weight, m.q_z.bias), m.p_z.linears(), m.dynamics.linears(),
            y0, hxz, noise["eps_pos"], oversampling, margin)

    parity.redraw_rows(fill, near, bsz, "cuda")
    return noise


def step_grads(opt, state_dict, x, noise, use_kernel, dtype,
               compute_dtype=None, tf32=False, fault=0.0):
    """Loss and parameter gradients of one training step from
    `state_dict` on the float batch x with the given draws, the model in
    `dtype` and its encoder and decoder in `compute_dtype` (`dtype` when
    None; with TF32 matmuls and convs if `tf32`): through every kernel (the
    training rollout's and, on vgg, the pools' and upsamples'), or through
    the eager rollout and the plain pools and upsamples. A `fault` scales
    kernel 3's gradients by 1 + fault (a planted fault)."""
    hp = dataclasses.replace(train_main.train_hparams(opt),
                             use_kernel=use_kernel,
                             compute_dtype=compute_dtype or dtype)
    model = SRVP(model_config(vars(opt))).cuda().to(dtype).train()
    model.load_state_dict(state_dict)
    krspatial.use_kernels(model, use_kernel)
    noise = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in noise.items()}
    rollout_bwd = krollout_train.TrainRollout.backward

    def faulty(ctx, *grads):
        return tuple(None if g is None else g * (1 + fault)
                     for g in rollout_bwd(ctx, *grads))

    if fault:
        krollout_train.TrainRollout.backward = staticmethod(faulty)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        loss, _ = train_lib.loss_and_grads(model, x.to(dtype), hp, **noise)
    finally:
        strict_fp32()
        krollout_train.TrainRollout.backward = staticmethod(rollout_bwd)
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


def is_conv_param(name):
    return name.split(".")[0] in ("encoder", "decoder")


# the one-step check in each compute dtype (check_step): the unit of a
# gradient reading, atol + rtol ||g||; the loss's rtol; the eager step that
# the eager one is printed against (its name and step_grads' arguments);
# the control (likewise), and how many held checks it must fail
STEP_CHECKS = {
    torch.float32: dict(
        rtol=STEP_GRAD_RTOL, loss_rtol=STEP_LOSS_RTOL,
        reference=("f64_eager", dict(use_kernel=False, dtype=torch.float64,
                                     compute_dtype=torch.float64)),
        control=("tf32", dict(use_kernel=False, tf32=True)),
        control_fails="every"),
    torch.bfloat16: dict(
        rtol=BF16_UNIT_ROUNDOFF, loss_rtol=BF16_LOSS_RTOL,
        reference=("fp32_eager", dict(use_kernel=False,
                                      compute_dtype=torch.float32)),
        control=("fault", dict(use_kernel=True, fault=BF16_FAULT)),
        control_fails="some"),
}


def check_step(opt, state_dict, batch, margin, held, hold=True,
               compute_dtype=torch.float32):
    """One training step from `state_dict`, its encoder and decoder in
    `compute_dtype` (the trainer's --precision), through the kernels and
    through the eager rollout and plain pools and upsamples, on the same
    kink-free draws (`margin`), with cuDNN held to deterministic
    algorithms (its default ones are not: the eager step rerun with them is
    printed), and a reference and a control step (STEP_CHECKS).

    The loss must agree to the dtype's loss rtol (1e-4; bfloat16 2^-10).
    The gradients are held directly against the eager step in units of
    atol + rtol ||g_eager||, atol 5e-5 and rtol 5e-3 (bfloat16: its unit
    roundoff 2^-8), in which each reading is printed, as `held` says
    (DCGAN_STEP_HELD, KTH_STEP_HELD, BF16_STEP_HELD) by group: "latent"
    (each parameter outside the encoder and decoder: q_z, p_z and dynamics,
    which the kernels write, and the networks that dy0 and dhxz flow into)
    and "conv" (the encoder's and decoder's), each gradient "elementwise"
    or in L2 "norm", ||g_kernel - g_eager|| <= limit (atol + rtol
    ||g_eager||). A conv gradient is a BN-centred sum over every frame of
    the batch and up to 4096 positions that fp32 resolves in norm only; on
    KTH no gradient is resolved element by element. The eager step's
    distance to the reference step is printed beside, by group, in both
    readings: in float32 the eager step in float64, in bfloat16 the eager
    float32 step.

    The control must fail the held checks, or the check could not tell a
    faulty step: in float32 the eager step with TF32 matmuls and convs
    must fail each of them; in bfloat16 the kernel step with kernel 3's
    gradients scaled by 1 + BF16_FAULT (32 unit roundoffs) must fail one.
    With `hold` off the readings are returned, not held."""
    spec = STEP_CHECKS[compute_dtype]
    x = materialize(batch, opt.nx)
    model = SRVP(model_config(vars(opt))).cuda()
    model.load_state_dict(state_dict)
    noise = kink_free_step_noise(model, x, opt.n_euler_steps,
                                 torch.Generator(device="cuda")
                                 .manual_seed(SEED + 2), margin)
    del model

    def grads(use_kernel, dtype=torch.float32, **kw):
        kw.setdefault("compute_dtype", compute_dtype)
        return step_grads(opt, state_dict, x, noise, use_kernel, dtype, **kw)

    # the eager step twice with cuDNN's default algorithms
    default = [grads(False)[1] for _ in range(2)]
    spread = max(_worst(default[0][k], default[1][k], spec["rtol"],
                        STEP_GRAD_ATOL)[1] for k in default[0])
    del default
    (ref, ref_kw), (control, control_kw) = spec["reference"], spec["control"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {arm: grads(**kw) for arm, kw in (
            ("kernel", dict(use_kernel=True)), ("eager", dict(use_kernel=False)),
            (ref, ref_kw), (control, control_kw))}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    loss_k, g_k = runs["kernel"]
    loss_e, g_e = runs["eager"]
    tol = lambda g: STEP_GRAD_ATOL + spec["rtol"] * g.norm()  # noqa: E731
    groups = {"latent": [k for k in g_e if not is_conv_param(k)],
              "conv": [k for k in g_e if is_conv_param(k)]}

    def readings(g, ref):
        """By tensor, against `ref`: the L2 reading and the elementwise
        one."""
        return dict(
            norm={k: ((g[k].to(ref[k].dtype) - ref[k]).norm()
                      / tol(ref[k])).item() for k in g},
            elementwise={k: _worst(g[k].to(ref[k].dtype), ref[k],
                                   spec["rtol"], STEP_GRAD_ATOL)[1]
                         for k in g})

    def worst(d, group):
        return max(d[k] for k in groups[group])

    top = lambda d, group: sorted(((k, d[k]) for k in groups[group]),  # noqa
                                  key=lambda kv: -kv[1])[:3]
    step = dict(step_videos=int(x.shape[1]),
                step_compute_dtype=str(compute_dtype).split(".")[-1],
                **{f"step_loss_{arm}": run[0] for arm, run in runs.items()},
                step_loss_rel_diff=abs(loss_k - loss_e) / abs(loss_e),
                step_held=[f"{g}_{kind} <= {limit}" for g, kind, limit
                           in held])
    failed = {}
    for arm, g, ref_g in (("step", g_k, g_e), (control, runs[control][1], g_e),
                          (ref, g_e, runs[ref][1])):
        r = readings(g, ref_g)
        for group in groups:
            for kind in r:
                step[f"{arm}_{group}_{kind}_err_over_tol"] = worst(r[kind],
                                                                   group)
            step[f"{arm}_{group}_worst"] = top(r["norm"], group)
        failed[arm] = [f"{group}_{kind}" for group, kind, limit in held
                       if worst(r[kind], group) > limit]
    step["step_grad_eager_rerun_default_cudnn_elementwise"] = spread
    step["step_failed"] = failed["step"]
    step[f"{control}_failed"] = failed[control]
    if not hold:
        return step
    if step["step_loss_rel_diff"] > spec["loss_rtol"] or failed["step"]:
        raise SystemExit(f"one {step['step_compute_dtype']} training step "
                         f"through the kernels disagrees with the eager "
                         f"one: {step}")
    need = len(held) if spec["control_fails"] == "every" else 1
    if len(failed[control]) < need:
        raise SystemExit(f"the {step['step_compute_dtype']} one-step check "
                         f"does not tell its control ({control}) from the "
                         f"step: {step}")
    return step


def seeded_state(opt):
    """The state_dict of cfg's model at torch's default init from
    CHECK_STATE_SEED: the state the KTH one-step check is held on."""
    torch.manual_seed(CHECK_STATE_SEED)
    return SRVP(model_config(vars(opt))).state_dict()


def train_launches(opt, n_steps, n_vals):
    """The launches of each kernel in a trainer run of n_steps steps and
    n_vals validations: per step, the rollout's forward and backward and,
    on vgg, 4 pools and 4 upsamples each way; a validation encodes its
    conditioning frames once (4 pools) and decodes each chunk (4
    upsamples), with the eager rollout; all in the compute dtype's
    kernels."""
    vgg = 4 if opt.archi == "vgg" else 0
    val_chunks = opt.n_iter_test * (opt.n_samples_test
                                    // opt.val_samples_chunk)
    sfx = "_bf16" if opt.precision == "bfloat16" else ""
    return {"train_rollout_fwd": n_steps,
            "train_rollout_bwd": 2 * n_steps,
            f"maxpool_fwd{sfx}": vgg * (n_steps + n_vals * opt.n_iter_test),
            f"maxpool_bwd{sfx}": vgg * n_steps,
            f"upsample_fwd{sfx}": vgg * (n_steps + n_vals * val_chunks),
            f"upsample_bwd{sfx}": vgg * n_steps}


def train_path(cfg, n_steps, warmup, batch_size, check_videos, test_dir,
               nt_test, margin, held, seeded_check=False,
               precision="float32"):
    """The trainer CLI at cfg's width through the kernels, with exact
    launch counts; one step through the kernels and through the eager
    rollout and plain pools and upsamples (check_step, on the first
    `check_videos` videos of a batch), held on the trainer's final state or,
    with `seeded_check`, on seeded_state (the final state's readings then
    printed, not held); then test_main serving the checkpoint it wrote on
    the test fold in `test_dir`. `margin` and `held` go to check_step.
    With `precision` "bfloat16" the trainer runs --precision bfloat16 (the
    pools and upsamples through the kernels' bfloat16 versions) and the
    check is check_step's in bfloat16, on seeded_state. Returns the
    summary."""
    name = f"{cfg['dataset']}-{cfg['archi']}"
    xp_dir = WORK_DIR / f"train_{name}_{precision}"
    data_dir = WORK_DIR / f"data_{name}"
    data_dir.mkdir(parents=True, exist_ok=True)
    if cfg["dataset"] == "kth":
        write_kth_packed_tree(data_dir, cfg["nx"], SEED + 4)
    opt = train_args(str(xp_dir), str(data_dir), n_steps, cfg=cfg,
                     batch_size=batch_size, precision=precision)
    shutil.rmtree(xp_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    klaunches.reset()
    t0 = time.perf_counter()
    status = train_main.main(opt)
    wall = time.perf_counter() - t0
    counts = klaunches.counts()
    if status != 0:
        raise SystemExit(f"{name} training exited with {status}")
    history = training_rows(xp_dir)
    expect_launches(f"{name} training, {n_steps} steps, {precision}", counts,
                    train_launches(opt, n_steps, 1))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in history]
    if len(losses) != n_steps or not np.all(np.isfinite(losses)):
        raise SystemExit(f"training losses: {losses}")
    frames = opt.seq_len * opt.batch_size
    ms_step = float(np.mean([1e3 * frames / h["fps"]
                             for h in history[warmup:]]))

    state = torch.load(xp_dir / "model.pt", map_location="cuda")
    train_loader, _ = train_main.loaders(opt)
    batch = next(iter(train_loader))
    if cfg["dataset"] == "kth":
        batch = batch[:, :check_videos]
    batch = to_device(batch, "cuda")
    compute_dtype = DTYPES[precision]
    if compute_dtype == torch.bfloat16:
        state = seeded_state(opt)
    elif seeded_check:
        trained = check_step(opt, state, batch, margin, held, hold=False)
        print("trained_state_step_check " + json.dumps(trained), flush=True)
        state = seeded_state(opt)
    step = check_step(opt, state, batch, margin, held,
                      compute_dtype=compute_dtype)

    arts, _, _ = run_cli(xp_dir, test_dir, "on", nt_test, n_samples=CHUNK)
    psnr = arts["results"]["psnr"]
    summary = dict(
        config=name, precision=precision, steps=n_steps,
        batch=opt.batch_size, seq_len=opt.seq_len,
        oversampling=opt.n_euler_steps, launches=counts, losses=losses,
        wall_s=wall, ms_per_step=ms_step, frames_per_s=frames / (ms_step / 1e3),
        peak_memory_gb=peak_gb, **step, served_psnr_mean=float(psnr.mean()),
        served_videos=int(psnr.size))
    print("train_path " + json.dumps(summary), flush=True)
    print(f"{name} {precision} training step at B={opt.batch_size}, "
          f"seq_len {opt.seq_len}: {ms_step:.3f} ms per step after {warmup} "
          f"warm-up "
          f"steps, {summary['frames_per_s']:.1f} frames/s, peak "
          f"{peak_gb:.2f} GB", flush=True)
    if not np.all(np.isfinite(psnr)):
        raise SystemExit(f"test_main on the trained checkpoint: {psnr}")
    return summary


def bench_path():
    """srvp_tpu_torch.bench at reduced steps (BENCH_ARGS), its golden record
    a copy of the committed one under WORK_DIR: its JSON line must hold
    finite numbers and 0 < mfu <= 1 for both configurations. Returns the
    line."""
    golden = WORK_DIR / "bench_golden.json"
    golden.write_text(Path(bench.GOLDEN_PATH).read_text()
                      if Path(bench.GOLDEN_PATH).exists() else "{}")
    t0 = time.perf_counter()
    line = bench.main(BENCH_ARGS + ["--golden", str(golden)])
    print(f"bench: {time.perf_counter() - t0:.1f} s", flush=True)
    if set(line["configs"]) != set(bench.CONFIGS):
        raise SystemExit(f"bench configs {sorted(line['configs'])}")
    for name, info in line["configs"].items():
        values = [info[k] for k in ("sec_per_step", "frames_per_sec", "loss",
                                    "model_flops_per_step", "mfu",
                                    "peak_memory_gb", "loss_step2_fp32")]
        if not (np.all(np.isfinite(values)) and 0 < info["mfu"] <= 1):
            raise SystemExit(f"bench {name}: {info}")
    if not np.isfinite(line["rollout_frames_per_sec_per_chip"]):
        raise SystemExit(f"bench generation: {line}")
    return line


# the resume phase: per arm (name, model, batch, steps, the step after
# whose log line SIGTERM is sent, --precision), the trainer CLI as a child
# process three times with RESUME_FLAGS: a run never stopped, a run
# stopped by SIGTERM, and that run's --resume; each child with cuDNN's
# deterministic algorithms (TRAINER_CHILD). The arms' children run side by
# side on the card (together at most ~60 GB)
RESUME_ARMS = [("dcgan float32", XP_CONFIG, TRAIN_BATCH, 12, 4, "float32"),
               ("kth-vgg bfloat16", KTH_CONFIG, KTH_TRAIN_BATCH, 6, 2,
                "bfloat16")]
RESUME_FLAGS = ["--n_workers", "4", "--chkpt_interval", "4",
                "--log_interval", "1"]
CHILD_TIMEOUT_S = 300
TRAINER_CHILD = """
import json, sys
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
from srvp_tpu_torch import train_main
from srvp_tpu_torch.data import native
from srvp_tpu_torch.kernels import launches
status = train_main.main(train_main.create_args().parse_args(sys.argv[1:]))
print("child_counts " + json.dumps(dict(
    launches=launches.counts(), native=native.served,
    peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
    peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
    alloc_retries=torch.cuda.memory_stats().get("num_alloc_retries", 0),
    ooms=torch.cuda.memory_stats().get("num_ooms", 0))), flush=True)
sys.exit(status)
"""
# the --profile_dir run: the dcgan trainer in bf16 for PROFILE_RUN_STEPS
# steps (the trace covers steps 10-15); the trace must name these kernels
PROFILE_RUN_STEPS = 16
PROFILED_KERNELS = ("train_rollout_fwd_kernel",
                    "train_rollout_bwd_carry_kernel",
                    "train_rollout_wgrad_kernel")


class TrainerChild:
    """The trainer CLI in a child process (TRAINER_CHILD), its output read
    by a thread of its own; with `stop_after`, SIGTERM is sent once the
    child logs that step. `result()` waits for it (killing it after
    CHILD_TIMEOUT_S) and returns (exit code, output lines, the child's
    kernel launch counts and native generator batches, seconds)."""

    def __init__(self, argv, stop_after=None):
        self.argv, self.stop_after, self.lines = argv, stop_after, []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", TRAINER_CHILD, *argv], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            if self.stop_after is not None \
                    and line.startswith(f"[{self.stop_after}/"):
                self.proc.send_signal(signal.SIGTERM)
                self.stop_after = None
        self.t_end = time.perf_counter()

    def result(self):
        left = CHILD_TIMEOUT_S - (time.perf_counter() - self.t0)
        try:
            rc = self.proc.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self.reader.join(timeout=30)
        counts = next((json.loads(line.split(" ", 1)[1])
                       for line in self.lines
                       if line.startswith("child_counts ")), None)
        if counts is None:
            print("\n".join(self.lines[-40:]), flush=True)
            raise SystemExit(f"trainer child {self.argv} printed no counts "
                             f"(rc {rc})")
        return rc, self.lines, counts, self.t_end - self.t0


def resume_path():
    """The resume phase (RESUME_ARMS): for each arm the trainer CLI run
    never stopped and run stopped by SIGTERM (all arms' children at once),
    then the stopped runs' --resume (at once); then resume_check on each.
    Returns the arms' summaries."""
    arms = []
    for name, cfg, batch_size, n_steps, stop_after, precision in RESUME_ARMS:
        tag = f"{cfg['dataset']}-{cfg['archi']}"
        data_dir = WORK_DIR / f"data_{tag}"
        if cfg["dataset"] == "kth" and not (data_dir / "packed_64").exists():
            write_kth_packed_tree(data_dir, cfg["nx"], SEED + 4)
        dirs = [WORK_DIR / f"resume_{name.replace(' ', '_')}_{k}"
                for k in ("whole", "part")]
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
        argv = [train_argv(str(d), str(data_dir), n_steps, cfg=cfg,
                           batch_size=batch_size, precision=precision)
                + RESUME_FLAGS for d in dirs]
        arms.append(dict(
            name=name, n_steps=n_steps, stop_after=stop_after, dirs=dirs,
            argv=argv, children=(TrainerChild(argv[0]),
                                 TrainerChild(argv[1], stop_after)),
            opt=train_main.create_args().parse_args(argv[1])))
    for arm in arms:
        arm["runs"] = {k: c.result() for k, c in
                       zip(("whole", "stopped"), arm["children"])}
        part = arm["dirs"][1]
        arm["stopped_at"] = json.loads(
            (part / "train_state.json").read_text())["step"]
        arm["stopped_rows"] = training_rows(part)
    resumed = [TrainerChild(arm["argv"][1] + ["--resume"]) for arm in arms]
    for arm, child in zip(arms, resumed):
        arm["runs"]["resumed"] = child.result()
    return [resume_check(**{k: arm[k] for k in (
        "name", "n_steps", "stop_after", "dirs", "opt", "runs", "stopped_at",
        "stopped_rows")}) for arm in arms]


def resume_check(name, n_steps, stop_after, dirs, opt, runs, stopped_at,
                 stopped_rows):
    """One arm of the resume phase: the stopped run exits with 143 and its
    train_state.json names the step it stopped at, the resumed run says it
    resumed there, its model.pt is bit-equal to the uninterrupted run's,
    and so is every logged loss (metrics.jsonl holding each step once);
    every child launched kernels 2-3 (and on vgg 4-7) exactly as its steps
    and validations need, and on Moving MNIST the native generator served
    every training batch. Returns the arm's summary."""
    whole, part = dirs
    rcs = {k: r[0] for k, r in runs.items()}
    if rcs != {"whole": 0, "stopped": 143, "resumed": 0}:
        for k, r in runs.items():
            print(f"{name} {k}:\n" + "\n".join(r[1][-30:]), flush=True)
        raise SystemExit(f"{name} resume: exit codes {rcs}")
    if not stop_after <= stopped_at < n_steps \
            or stopped_rows[-1]["step"] != stopped_at:
        raise SystemExit(f"{name} resume: stopped at step {stopped_at}, "
                         f"last logged {stopped_rows[-1]['step']}")
    if f"Resumed from step {stopped_at}" not in runs["resumed"][1]:
        raise SystemExit(f"{name} resume: the resumed run did not say it "
                         f"resumed from step {stopped_at}")

    steps = {"whole": (n_steps, 1), "stopped": (stopped_at, 0),
             "resumed": (n_steps - stopped_at, 1)}
    native_batches = {}
    for k, (n, n_vals) in steps.items():
        counts = runs[k][2]
        expect_launches(f"{name} resume, {k} run", counts["launches"],
                        train_launches(opt, n, n_vals))
        native_batches[k] = counts["native"]["parts"]
        if opt.dataset == "smmnist" and native_batches[k] < n:
            raise SystemExit(f"{name} resume, {k} run: the native generator "
                             f"served {native_batches[k]} batches for {n} "
                             "steps")

    # model.pt, and the periodic snapshots that the background writer took
    # while the next steps were queued (at stopped_at, the stopped run's
    # had no step after it)
    differ = {}
    for f in ["model.pt"] + [f"model_{k}.pt" for k in range(
            opt.chkpt_interval, n_steps + 1, opt.chkpt_interval)]:
        ref, got = (torch.load(d / f) for d in (whole, part))
        differ.update({f"{f}:{k}": float((ref[k].double()
                                          - got[k].double()).abs().max())
                       for k in ref if not torch.equal(ref[k], got[k])})
    ref_rows, rows = training_rows(whole), training_rows(part)
    if [r["step"] for r in rows] != list(range(1, n_steps + 1)):
        raise SystemExit(f"{name} resume: metrics.jsonl steps "
                         f"{[r['step'] for r in rows]}")
    loss_differ = [(a["step"], a["loss"], b["loss"])
                   for a, b in zip(ref_rows, rows)
                   if a["step"] > stopped_at and a["loss"] != b["loss"]]
    summary = dict(
        arm=name, steps=n_steps, stopped_at=stopped_at, exit_codes=rcs,
        seconds={k: r[3] for k, r in runs.items()},
        native_batches=native_batches,
        launches={k: {n: c for n, c in r[2]["launches"].items() if c}
                  for k, r in runs.items()},
        model_pt_bit_equal=not differ, tensors_differ=len(differ),
        max_abs_diff=max(differ.values(), default=0.0),
        losses_after_resume_bit_equal=not loss_differ,
        losses=[r["loss"] for r in rows])
    print("resume_path " + json.dumps(summary), flush=True)
    print(f"{name} resume: SIGTERM after step {stop_after} stopped the run "
          f"at step {stopped_at} (exit 143); resumed to {n_steps}: model.pt "
          f"and the periodic snapshots "
          f"{'bit-equal' if not differ else 'DIFFER'} to the uninterrupted "
          f"run's, losses after the resume "
          f"{'bit-equal' if not loss_differ else 'DIFFER'}; native generator "
          f"batches {native_batches}", flush=True)
    if differ or loss_differ:
        raise SystemExit(f"{name} resume: {len(differ)} tensors of model.pt "
                         f"or the snapshots differ (max "
                         f"{summary['max_abs_diff']:.3e}: "
                         f"{sorted(differ)[:8]}); losses {loss_differ}")
    return summary


def profile_path():
    """The dcgan trainer in bf16 with --profile_dir: a trace of steps 10-15
    is written and names the training-rollout kernels; exact launch counts.
    Returns the trace's kernel device time by name (ms over its steps)."""
    xp_dir = WORK_DIR / "profile_smmnist-dcgan"
    shutil.rmtree(xp_dir, ignore_errors=True)
    opt = train_args(str(xp_dir), str(WORK_DIR / "data_smmnist-dcgan"),
                     PROFILE_RUN_STEPS, precision="bfloat16")
    opt.profile_dir = str(xp_dir / "profile")
    klaunches.reset()
    status = train_main.main(opt)
    expect_launches("dcgan bf16 training with --profile_dir",
                    klaunches.counts(),
                    train_launches(opt, PROFILE_RUN_STEPS, 1))
    traces = sorted((xp_dir / "profile").glob("*.json"))
    if status != 0 or len(traces) != 1:
        raise SystemExit(f"--profile_dir: status {status}, traces {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            kernels[ev["name"]] = kernels.get(ev["name"], 0.0) \
                + ev.get("dur", 0) / 1e3
    missing = [k for k in PROFILED_KERNELS
               if not any(k in name for name in kernels)]
    if missing:
        raise SystemExit(f"--profile_dir: the trace {traces[0]} names no "
                         f"{missing} ({len(kernels)} kernel names)")
    busy = sum(kernels.values())
    print(f"--profile_dir: {traces[0].name}, {traces[0].stat().st_size} "
          f"bytes, {len(kernels)} kernel names, device busy {busy:.2f} ms "
          f"over steps 10-15; the rollout kernels "
          f"{sum(v for k, v in kernels.items() if 'rollout' in k):.3f} ms",
          flush=True)
    return kernels


# the dispatch phase: per arm (name, model, batch, steps, K, --precision,
# --val_interval, --chkpt_interval, the step after whose log line SIGTERM
# is sent to a K run or None), the trainer CLI with --steps_per_dispatch K
# against K = 1, each with DISPATCH_FLAGS (TRAINER_CHILD: cuDNN's
# deterministic algorithms, no autotuning); an arm's runs are those that
# DISPATCH_WAVES names: K = 1 ("k1"), K ("k"), K again, K stopped by
# SIGTERM and its --resume at K
DISPATCH_ARMS = [
    ("dcgan float32", XP_CONFIG, TRAIN_BATCH, 16, 4, "float32", 8, 4, 4),
    ("dcgan bfloat16", XP_CONFIG, TRAIN_BATCH, 16, 4, "bfloat16", 8, 4,
     None),
    ("kth-vgg bfloat16", KTH_CONFIG, KTH_TRAIN_BATCH, 8, 4, "bfloat16", 4, 4,
     None),
    ("kth-vgg float32", KTH_CONFIG, KTH_TRAIN_BATCH, 4, 2, "float32", 4, 2,
     None)]
DISPATCH_FLAGS = ["--n_workers", "4", "--log_interval", "4"]
# the children side by side, in waves that fit the card (a run's peak,
# PERF.md: dcgan 4-8 GB, KTH bf16 about 30 and fp32 about 60)
DISPATCH_WAVES = [
    [("dcgan float32", k) for k in ("k1", "k", "k_again", "stopped")]
    + [("dcgan bfloat16", k) for k in ("k1", "k", "k_again")],
    [("dcgan float32", "resumed"), ("kth-vgg bfloat16", "k1"),
     ("kth-vgg bfloat16", "k")],
    [("kth-vgg float32", "k")],
    [("kth-vgg float32", "k1")]]


def ulp_distance(a, b):
    """The largest distance of two float32 tensors in units in the last
    place (0: the same bits)."""
    def ordered(x):
        i = x.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def model_distance(ref_path, got_path):
    """(max |got - ref| over model.pt's floats, its largest distance in
    ulps, the worst |got - ref| / (TRAIN_ATOL + TRAIN_RTOL |ref|), the
    tensors whose bits differ)."""
    ref, got = torch.load(ref_path), torch.load(got_path)
    worst = dict(abs=0.0, ulps=0, ratio=0.0, differ=0)
    for k in ref:
        if torch.equal(ref[k], got[k]):
            continue
        worst["differ"] += 1
        if not ref[k].is_floating_point():
            worst["ratio"] = float("inf")   # a count that differs
            continue
        d = (got[k].double() - ref[k].double()).abs()
        worst["abs"] = max(worst["abs"], float(d.max()))
        worst["ulps"] = max(worst["ulps"], ulp_distance(ref[k], got[k]))
        worst["ratio"] = max(worst["ratio"], float(
            (d / (TRAIN_ATOL + TRAIN_RTOL * ref[k].double().abs())).max()))
    return worst


def dispatch_path():
    """The dispatch phase (DISPATCH_ARMS, DISPATCH_WAVES): every child of a
    wave at once, the waves in turn; then dispatch_check on each arm.
    Returns the arms' summaries."""
    arms = {}
    for name, cfg, batch_size, n_steps, k, precision, val, chkpt, stop \
            in DISPATCH_ARMS:
        tag = f"{cfg['dataset']}-{cfg['archi']}"
        data_dir = WORK_DIR / f"data_{tag}"
        data_dir.mkdir(parents=True, exist_ok=True)
        if cfg["dataset"] == "kth" and not (data_dir / "packed_64").exists():
            write_kth_packed_tree(data_dir, cfg["nx"], SEED + 4)
        dirs = {kind: WORK_DIR / f"dispatch_{name.replace(' ', '_')}_{kind}"
                for kind in ("k1", "k", "k_again", "stopped")}
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)

        def argv(kind, d, n_steps=n_steps, cfg=cfg, batch_size=batch_size,
                 precision=precision, k=k, val=val, chkpt=chkpt):
            return (train_argv(str(d), str(data_dir), n_steps, cfg=cfg,
                               batch_size=batch_size, precision=precision)
                    + DISPATCH_FLAGS
                    + ["--val_interval", str(val), "--chkpt_interval",
                       str(chkpt), "--steps_per_dispatch",
                       str(1 if kind == "k1" else k)])
        argvs = {kind: argv(kind, d) for kind, d in dirs.items()}
        argvs["resumed"] = argvs["stopped"] + ["--resume"]
        dirs["resumed"] = dirs["stopped"]
        arms[name] = dict(name=name, n_steps=n_steps, k=k, stop_after=stop,
                          dirs=dirs, argvs=argvs, runs={},
                          frames=cfg["seq_len"] * batch_size,
                          opt=train_main.create_args().parse_args(
                              argvs["k"]))
    for wave in DISPATCH_WAVES:
        children = [(arms[name], kind, TrainerChild(
            arms[name]["argvs"][kind],
            arms[name]["stop_after"] if kind == "stopped" else None))
            for name, kind in wave]
        for arm, kind, child in children:
            arm["runs"][kind] = child.result()
            if kind == "stopped":
                arm["stopped_at"] = json.loads((arm["dirs"]["stopped"]
                                                / "train_state.json")
                                               .read_text())["step"]
                arm["stopped_rows"] = training_rows(arm["dirs"]["stopped"])
    return [dispatch_check(arm) for arm in arms.values()]


def dispatch_check(arm):
    """One arm of the dispatch phase: exit codes; every child launched
    kernels 2-3 (and on vgg 4-7) exactly as its steps and validations need,
    the window runs through their graph's per-replay counts; the K run's
    model.pt and logged losses within TRAIN_RTOL / TRAIN_ATOL of the K = 1
    run's (the CLI test's tolerance), the bit-level distance printed; K
    and K again bit-equal; with a stop, the stopped run exits with 143 at a
    window boundary and its --resume ends bit-equal to the K run (model.pt,
    the periodic snapshots, the losses after the resume). Returns the
    arm's summary."""
    name, runs, opt, n = arm["name"], arm["runs"], arm["opt"], arm["n_steps"]
    val = opt.val_interval
    want = {kind: (0 if kind != "stopped" else 143) for kind in runs}
    rcs = {kind: r[0] for kind, r in runs.items()}
    if rcs != want:
        for kind, r in runs.items():
            print(f"{name} {kind}:\n" + "\n".join(r[1][-30:]), flush=True)
        raise SystemExit(f"{name} dispatch: exit codes {rcs}")
    spans = {kind: (0, n) for kind in runs}
    if "stopped" in runs:
        at = arm["stopped_at"]
        if not arm["stop_after"] <= at < n or at % arm["k"] \
                or arm["stopped_rows"][-1]["step"] != at:
            raise SystemExit(f"{name} dispatch: stopped at step {at}")
        if f"Resumed from step {at}" not in runs["resumed"][1]:
            raise SystemExit(f"{name} dispatch: no resume from step {at}")
        spans.update(stopped=(0, at), resumed=(at, n))
    for kind, (a, b) in spans.items():
        expect_launches(f"{name} dispatch, {kind} run",
                        runs[kind][2]["launches"],
                        train_launches(opt, b - a, b // val - a // val))

    dirs = arm["dirs"]
    rows = {kind: training_rows(dirs[kind])
            for kind in ("k1", "k", "k_again") if kind in runs}
    steps = {kind: [r["step"] for r in rs] for kind, rs in rows.items()}
    if len({tuple(v) for v in steps.values()}) != 1:
        raise SystemExit(f"{name} dispatch: logged steps {steps}")
    losses = {kind: [r["loss"] for r in rs] for kind, rs in rows.items()}
    loss_ratio = max(abs(a - b) / (TRAIN_ATOL + TRAIN_RTOL * abs(a))
                     for a, b in zip(losses["k1"], losses["k"]))
    vs_k1 = model_distance(dirs["k1"] / "model.pt", dirs["k"] / "model.pt")
    again = None
    if "k_again" in runs:
        again = model_distance(dirs["k"] / "model.pt",
                               dirs["k_again"] / "model.pt")
        again["losses_equal"] = losses["k"] == losses["k_again"]
    resumed = None
    if "resumed" in runs:
        resumed = dict(differ=0, losses_differ=[])
        for f in ["model.pt"] + [f"model_{s}.pt" for s in range(
                opt.chkpt_interval, n + 1, opt.chkpt_interval)]:
            resumed["differ"] += model_distance(dirs["k"] / f,
                                                dirs["stopped"] / f)["differ"]
        resumed["losses_differ"] = [
            (a["step"], a["loss"], b["loss"])
            for a, b in zip(rows["k"], training_rows(dirs["stopped"]))
            if a["step"] > arm["stopped_at"] and a["loss"] != b["loss"]]

    def timing(kind):
        # the last logged row: at dcgan a replay alone, at KTH it holds
        # the window that captures
        fps = rows[kind][-1]["fps"]
        return dict(ms_per_step=1e3 * arm["frames"] / fps,
                    frames_per_s=fps,
                    peak_reserved_gb=runs[kind][2]["peak_reserved_gb"],
                    peak_allocated_gb=runs[kind][2]["peak_allocated_gb"],
                    ooms=runs[kind][2]["ooms"],
                    alloc_retries=runs[kind][2]["alloc_retries"],
                    seconds=runs[kind][3])
    summary = dict(
        arm=name, k=arm["k"], steps=n, exit_codes=rcs,
        k1=timing("k1"), window=timing("k"),
        launches={kind: {c: v for c, v in r[2]["launches"].items() if v}
                  for kind, r in runs.items()},
        model_pt_vs_k1=vs_k1, loss_vs_k1_ratio=loss_ratio,
        losses=losses,
        k_again_bit_equal=None if again is None
        else again["differ"] == 0 and again["losses_equal"],
        stopped_at=arm.get("stopped_at"), resumed=resumed)
    print("dispatch_path " + json.dumps(summary), flush=True)
    w, one = summary["window"], summary["k1"]
    print(f"{name} K={arm['k']} against K=1, {n} steps: model.pt "
          f"{vs_k1['ratio']:.3f} of the tolerance (max |diff| "
          f"{vs_k1['abs']:.3e}, {vs_k1['ulps']} ulps, {vs_k1['differ']} "
          f"tensors differ), losses {loss_ratio:.3f}"
          + ("" if again is None else "; K again " + (
              "bit-equal" if summary["k_again_bit_equal"] else "DIFFERS"))
          + ("" if resumed is None else
             f"; SIGTERM at step {arm['stopped_at']} and --resume "
             + ("bit-equal" if not resumed["differ"]
                and not resumed["losses_differ"] else "DIFFER"))
          + f"; {w['ms_per_step']:.1f} against {one['ms_per_step']:.1f} ms "
          f"a step, {w['frames_per_s']:.0f} against "
          f"{one['frames_per_s']:.0f} frames/s, peak reserved "
          f"{w['peak_reserved_gb']:.2f} against "
          f"{one['peak_reserved_gb']:.2f} GB, allocations that failed "
          f"{w['ooms']} against {one['ooms']}", flush=True)
    if vs_k1["ratio"] > 1 or loss_ratio > 1:
        raise SystemExit(f"{name} dispatch: K={arm['k']} is not within the "
                         f"CLI tolerance of K=1 ({vs_k1}, losses "
                         f"{loss_ratio:.3f})")
    if summary["k_again_bit_equal"] is False:
        raise SystemExit(f"{name} dispatch: two K={arm['k']} runs differ "
                         f"({again}; {losses['k']} {losses['k_again']})")
    if resumed is not None and (resumed["differ"]
                                or resumed["losses_differ"]):
        raise SystemExit(f"{name} dispatch: the resumed run differs from "
                         f"the uninterrupted one ({resumed})")
    return summary


def kernel_row(name, source, replaces, launches, max_abs_err, ms, plain_ms,
               bound_ms, bound_by, library_ms=None):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max_abs_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


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

    # kernels 1-3 against their plain versions: the dcgan flagship's
    # shapes, then the KTH model's (evaluation chunk B = 160, 30 frames at
    # o = 2; training B = 100, 19 frames at o = 2)
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
    kcfg = model_config(KTH_CONFIG)
    torch.manual_seed(SEED + 7)
    kmodel = SRVP(kcfg).cuda().eval()
    kpz, kdyn = kmodel.p_z.linears(), kmodel.dynamics.linears()
    ko = KTH_CONFIG["n_euler_steps"]
    kth_eval_row = check_rollout(
        "kth evaluation chunk", kpz, kdyn, BATCH * CHUNK,
        ko * (KTH_NT_GEN - KTH_CONFIG["nt_cond"]), ko, kcfg.ny, kcfg.nz,
        SEED + 8)
    kth_train_row = check_train_rollout(
        "kth training step", (kmodel.q_z.weight, kmodel.q_z.bias), kpz, kdyn,
        KTH_TRAIN_BATCH, ko * (KTH_CONFIG["seq_len"] - 1), ko, SEED + 9,
        KTH_KINK_MARGIN)
    del model, kmodel
    # kernels 4-7 at every vgg site of the KTH step, fp32 and bf16
    spatial = check_spatial(KTH_TRAIN_BATCH * KTH_CONFIG["seq_len"], SEED + 10)
    spatial_bf16 = check_spatial(KTH_TRAIN_BATCH * KTH_CONFIG["seq_len"],
                                 SEED + 13, torch.bfloat16)
    summary = eval_path(XP_CONFIG, N_VIDEOS, XP_CONFIG["seq_len_test"], SEED)
    train_summary = train_path(
        XP_CONFIG, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_BATCH, TRAIN_BATCH,
        WORK_DIR / "data_smmnist-dcgan", XP_CONFIG["seq_len_test"],
        parity.KINK_MARGIN, DCGAN_STEP_HELD)
    kth_summary = eval_path(KTH_CONFIG, KTH_VIDEOS, KTH_NT_GEN, SEED)
    kth_train = train_path(
        KTH_CONFIG, KTH_TRAIN_STEPS, KTH_TRAIN_WARMUP, KTH_TRAIN_BATCH,
        KTH_CHECK_VIDEOS, WORK_DIR / "data_kth-vgg", KTH_NT_GEN,
        KTH_KINK_MARGIN, KTH_STEP_HELD, seeded_check=True)
    # the trainer in bfloat16 (--precision bfloat16) on both models, then
    # the port's bench at reduced steps
    torch.cuda.empty_cache()
    train_bf16 = train_path(
        XP_CONFIG, TRAIN_STEPS_BF16, TRAIN_WARMUP_BF16, TRAIN_BATCH,
        TRAIN_BATCH, WORK_DIR / "data_smmnist-dcgan",
        XP_CONFIG["seq_len_test"], parity.KINK_MARGIN, BF16_STEP_HELD,
        precision="bfloat16")
    torch.cuda.empty_cache()
    kth_train_bf16 = train_path(
        KTH_CONFIG, KTH_TRAIN_STEPS_BF16, KTH_TRAIN_WARMUP_BF16,
        KTH_TRAIN_BATCH, KTH_CHECK_VIDEOS, WORK_DIR / "data_kth-vgg",
        KTH_NT_GEN, KTH_KINK_MARGIN, BF16_STEP_HELD, precision="bfloat16")
    torch.cuda.empty_cache()
    bench_line = bench_path()
    # kernels 8-9 at every 3x3 conv site of the KTH step, then their path;
    # last, so that the model's paths run as they did before this phase
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    conv_rows, conv_workhorse = check_conv_stage(
        KTH_TRAIN_BATCH * KTH_CONFIG["seq_len"], SEED + 11)
    conv_bench, conv_counts, _ = conv_stage_path(
        KTH_TRAIN_BATCH * KTH_CONFIG["seq_len"], SEED + 12)
    print(f"conv stage phases: {time.perf_counter() - t0:.1f} s", flush=True)
    # the trainer's run control: SIGTERM and --resume in child processes
    # (dcgan fp32, KTH bf16), then a --profile_dir trace
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resume_path()
    profile_path()
    print(f"run-control phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    # dispatch windows: the trainer CLI at --steps_per_dispatch K (one
    # CUDA graph of K steps) against K = 1
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dispatch_path()
    print(f"dispatch phase: {time.perf_counter() - t0:.1f} s", flush=True)

    src = "srvp_tpu_torch/csrc/rollout_train.cu"
    kernels = [
        kernel_row("prior_rollout", "srvp_tpu_torch/csrc/rollout.cu",
                   "srvp_tpu/ops/pallas/rollout.py:89",
                   summary["launches"]["prior_rollout"],
                   main_row["max_abs_err"], main_row["ms"],
                   main_row["plain_ms"], main_row["bound_ms"],
                   main_row["bound_by"]),
        kernel_row("train_rollout_fwd", src,
                   "srvp_tpu/ops/pallas/rollout_train.py:83",
                   train_summary["launches"]["train_rollout_fwd"],
                   train_row["fwd_max_abs_err"], train_row["kernel_fwd_ms"],
                   train_row["plain_fwd_ms"], train_row["fwd_bound_ms"],
                   train_row["fwd_bound_by"]),
        # kernel 3: its two passes' device time
        kernel_row("train_rollout_bwd", src,
                   "srvp_tpu/ops/pallas/rollout_train.py:146",
                   train_summary["launches"]["train_rollout_bwd"],
                   train_row["bwd_max_abs_err"],
                   train_row["carry_ms"] + train_row["wgrad_ms"],
                   train_row["plain_bwd_ms"], train_row["bwd_bound_ms"],
                   train_row["bwd_bound_by"]),
    ]
    for rows, train, sfx in ((spatial, kth_train, ""),
                             (spatial_bf16, kth_train_bf16, "_bf16")):
        for name, line in (("maxpool_fwd", 101), ("maxpool_bwd", 105),
                           ("upsample_fwd", 116), ("upsample_bwd", 120)):
            row = rows[name]
            kernels.append(kernel_row(
                name + sfx, "srvp_tpu_torch/csrc/spatial.cu",
                f"srvp_tpu/ops/pallas/spatial.py:{line}",
                train["launches"][name + sfx], row["max_abs_err"], row["ms"],
                row["plain_ms"], row["bound_ms"], row["bound_by"],
                row["library_ms"]))
    for name, line, check, counted in (
            ("conv3x3_block_fwd", "srvp_tpu/ops/pallas/conv_stage.py:50",
             "block float32", "conv3x3_block"),
            ("fused_conv_bn", "scripts/microbench_conv.py:31",
             "clamped float32", "conv3x3_clamped")):
        row = conv_workhorse[check]
        kernels.append(kernel_row(
            name, "srvp_tpu_torch/csrc/conv_stage.cu", line,
            conv_counts[counted], row["max_abs_err"], row["ms"],
            row["plain_ms"], row["bound_ms"], row["bound_by"],
            row["library_ms"]))
    print(f"conv stage, {len(conv_rows)} KTH vgg sites at N="
          f"{conv_rows[0]['shape'][0]} in fp32: kernel "
          f"{sum(r['ms'] for r in conv_rows):.3f} ms, cuDNN "
          f"{sum(r['library_ms'] for r in conv_rows):.3f} ms, plain "
          f"{sum(r['plain_ms'] for r in conv_rows):.3f} ms, bound "
          f"{sum(r['bound_ms'] for r in conv_rows):.3f} ms (3xTF32; fp32 "
          f"FMA on the CUDA cores "
          f"{sum(r['second_bound_ms'] for r in conv_rows):.3f} ms); bench "
          f"{json.dumps(conv_bench)}", flush=True)
    print(f"whole-batch rollout B={batch_row['B']}: {batch_row['ms']:.4f} ms "
          f"(bound {batch_row['bound_ms']:.4f} ms, plain "
          f"{batch_row['plain_ms']:.4f} ms)", flush=True)
    for what, tr in (("dcgan", train_row), ("kth", kth_train_row)):
        print(f"{what} training rollout B={tr['B']}, K={tr['n_steps']}: "
              f"forward {tr['kernel_fwd_ms']:.4f} ms (R={tr['fwd_rows']}, "
              f"C={tr['fwd_cluster']}, {tr['fwd_blocks']} blocks), backward "
              f"{tr['kernel_bwd_ms']:.4f} ms = carry pass "
              f"{tr['carry_ms']:.4f} (R={tr['bwd_rows']}, "
              f"C={tr['bwd_cluster']}, {tr['bwd_blocks']} blocks) + "
              f"weight-gradient pass {tr['wgrad_ms']:.4f} + the rest of the "
              f"wrapper {tr['bwd_wrapper_ms']:.4f} (bounds: forward "
              f"{tr['fwd_bound_ms']:.4f}, backward {tr['bwd_bound_ms']:.4f}, "
              f"carry {tr['carry_bound_ms']:.4f}, weight gradients "
              f"{tr['wgrad_bound_ms']:.4f} ms); plain forward + backward "
              f"{tr['plain_fwd_bwd_ms']:.4f} ms", flush=True)
        wg = tr["wgrad"]
        print(f"{what} weight-gradient pass N={wg['n_rows']}: plan S="
              f"{wg['split']}, tiles {wg['tiles']}, {wg['n_tiles']} tiles, "
              f"{wg['blocks']} blocks, {wg['clusters_resident']} clusters "
              f"resident ({wg['blocks_per_sm']} blocks an SM): "
              f"{wg['ms']:.4f} ms (bound {wg['bound_ms']:.4f} ms, "
              f"{wg['bound_by']}; cuBLAS torch.mm + sum, TF32 off, "
              f"{wg['library_ms']:.4f} ms; medians of "
              f"{WGRAD_READINGS}, ranges {wg['ms_range']} and "
              f"{wg['library_ms_range']}); err/tol "
              f"{wg['err_over_tol_f64']:.3f} arbitrated by float64 "
              f"({wg['worst']}); from float64 "
              f"{wg['err_over_tol_from_f64']:.3f}, cuBLAS "
              f"{wg['library_err_over_tol_from_f64']:.3f}", flush=True)
    print(f"kth prior rollout B={kth_eval_row['B']}, "
          f"{kth_eval_row['n_steps']} substeps: {kth_eval_row['ms']:.4f} ms "
          f"(bound {kth_eval_row['bound_ms']:.4f} ms, plain "
          f"{kth_eval_row['plain_ms']:.4f} ms)", flush=True)
    print(f"kth evaluation: {kth_summary['s_per_batch_kernel']:.3f} s per "
          f"batch of {BATCH} videos x {N_SAMPLES} samples; kth training: "
          f"{kth_train['ms_per_step']:.1f} ms per step, peak "
          f"{kth_train['peak_memory_gb']:.2f} GB", flush=True)
    for what, fp32, bf16 in (("dcgan", train_summary, train_bf16),
                             ("kth", kth_train, kth_train_bf16)):
        print(f"{what} training, bf16 against fp32 (trainer CLI): "
              f"{bf16['ms_per_step']:.1f} against {fp32['ms_per_step']:.1f} "
              f"ms per step, peak {bf16['peak_memory_gb']:.2f} against "
              f"{fp32['peak_memory_gb']:.2f} GB", flush=True)
    for name, info in bench_line["configs"].items():
        print(f"bench {name} ({bench_line['precision']}, "
              f"{info['steps']} steps): {info['ms_per_step']:.2f} ms per "
              f"step, {info['frames_per_sec']:.1f} frames/s, mfu "
              f"{info['mfu']:.4f}, peak {info['peak_memory_gb']:.2f} GB; "
              f"generation {bench_line['rollout_frames_per_sec_per_chip']:.1f}"
              f" frames/s", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
