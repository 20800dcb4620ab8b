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
 16. main path, the datasets (datasets_path): synthetic trees written
     with numpy and a stdlib PNG writer that puts row y of frame t under
     row filter (y + t) % 5: BAIR as a PNG tree and as the packed tree of
     the same videos, Human3.6M (npz videos, validation videos of 440
     frames, test_set_53_8 clips of 417), KTH as a PNG tree (every third
     video in RGB files, read for their red channel) and packed. The
     native PNG decoder (srvp_tpu_torch/csrc/png_decode.cpp, built with
     g++) bit-equal to data/png.py on every frame, its rate at 4 threads
     printed with the host's CPU; the trainer's loader on each PNG tree
     bit-equal to the packed tree's, the PNG batches through the decoder.
     Kernels 1-3 at the BAIR and Human3.6M shapes (training B = 192, K =
     22 and B = 100, K = 30; evaluation B = 160, 56 substeps and B = 80,
     90 substeps, kernel 1 judged with a float64 arbiter, the raw error
     printed) and kernels 4-7 at every vgg site of N = 2304 frames, fp32
     and bf16, at the tolerances of phases 3-5. Then the trainer at
     configs/bair.yaml's width (batch 192 x 12 frames, nc = 3) from the PNG
     tree, 6 steps in fp32 (the one-step check on the seeded state, every
     gradient in L2 norm as in phase 9) and 6 in bf16, exact launch
     counts, ms per step, frames/s, peak memory, and every batch through
     the decoder; its fp32 model.pt served by test_main (2 + 28 frames, 2
     batches of 16, 100 samples in chunks of 10), through the kernel and
     eagerly, in agreement, with exact launch counts; the bf16 run again
     from the packed tree (the decoder's share of the step); the same for
     configs/human.yaml (batch 100 x 16 frames at --subsampling 8, 6 steps
     in bf16; served at 8 + 45 frames, 2 batches of 8); KTH 6 steps in bf16
     from its PNG tree.
 17. main path, the evaluation metrics (metrics_path): random AlexNet and
     LPIPS v0.1 weights in their official .pth files (the lin heads
     non-negative) and a random I3D npz under the TF variable paths
     (positive variances, through SRVP_TPU_I3D_WEIGHTS); the KTH vgg
     evaluation of phase 8 (16 videos, 10 + 30 frames, 100 samples in
     chunks of 10) through test_main without and then with --lpips_dir and
     --fvd, both with cuDNN's deterministic algorithms: LPIPS finite and
     >= 0, its lpips_best / lpips_worst archives, every other artifact and
     result bit-equal to the run without LPIPS,
     one finite positive FVD line, equal to fvd() called again, the
     ground truth's distance to itself within FVD_SELF_RTOL of its
     covariance's trace, exact launch counts; the card's LPIPS on one
     chunk's 4,800 frame pairs and its I3D embeddings of 2 videos against
     the port's CPU versions (LPIPS rtol 1e-4 / atol 1e-6, I3D rtol 1e-3 /
     atol 1e-4); LPIPS ms per chunk, I3D ms per chunk of 16 videos, FVD
     wall seconds and the evaluation's s per batch with and without
     LPIPS; then BAIR (nc = 3) with both metrics on one batch of 16
     synthetic videos, 2 + 28 frames, 20 samples (cut from 100).
 18. main path, serving (serving_path): the generation program exported
     by srvp_tpu_torch.export at full width with seeded weights
     (SERVING_EXPORTS: dcgan fp32 and bf16 with a symbolic batch, KTH vgg
     bf16 at o = 2, dcgan fp32 pinned at batch 16; each artifact's bytes
     and export seconds printed), loaded on the card with load_serving and
     run on 16 synthetic videos against the live serving core on the same
     seed under cuDNN's deterministic algorithms: bit for bit in fp32, at
     most one uint8 level apart in bf16 (the share of pixels that differ
     printed); kernel 1 launched once a call and, at KTH, kernels 4 and 6
     at the live core's counts, through the srvp custom ops; the same seed
     twice the same bits, another seed other predicted frames; batches 1,
     16 and 128 from the symbolic artifact, the pinned one equal to it at
     its batch and refusing batch 8; the fp32 dcgan file loaded onto the
     CPU and onto the card in a child process that imports load_serving
     alone (batch 2, one uint8 level; no srvp_tpu_torch.models module
     loaded); bench_serving's timing of the bf16 artifacts at batches 1,
     16 and 128 (p50 / p95 device and end-to-end ms, frames/s); then the
     generate and swap CLIs at full dcgan width on 4 synthetic videos
     (shapes, GIFs, the swap grid's diagonal equal to generate's sample 0
     and to the serving core, exact launches).
 19. main path, data parallelism (data_parallel_path; srvp_tpu_torch/
     parallel): the trainer CLI as child processes, cuDNN deterministic,
     dcgan fp32 at full width (batch 128 x 15, 8 steps, a validation). (a)
     Through a process group of one rank under NCCL (--coordinator_address
     localhost:<port> --num_processes 1 --process_id 0; each run alone on
     the card): its logged losses and model.pt bit-equal to the run
     without the flags, ms per step of both printed; then at
     --steps_per_dispatch 4 under NCCL, bit-equal to K = 1 (the gradient
     all-reduce captured in the window's graph). (b) Two ranks on the one
     card under gloo (--device cuda:0; NCCL refuses two ranks on one
     device): dcgan fp32 at the global batch 128 (kernels 2-3 at B = 64 a
     rank), rank 0's losses within rtol 1e-4 / atol 1e-6 of the run
     without a group and its model.pt within that tolerance in L2 norm a
     tensor (the element-wise reading printed beside a control's: one
     process under cuDNN's default algorithms), rank 1 printing no log
     line; KTH vgg bf16 at the global batch 100 for 3 steps, finite losses
     (one process's printed beside); every rank's
     launches of kernels 2-7 exact; kernels 2-3 held against their plain
     versions at B = 64 (check_train_rollout); the ranks' ms per step
     printed as gloo on one card, not a speed figure. (c) Phase 6's dcgan
     evaluation through test_main --n_devices 2 --device cuda:0 (two
     spawned gloo ranks) against one rank, child processes: every result
     and artifact bit-equal, or within the rank-count tolerance (one uint8
     level, metrics rtol 1e-5) with the tensors that differ printed.
 20. main path, the data tools (data_tools_path): the loader bench
     (srvp_tpu_torch.bench_loader, LOADER_BENCH_ARGS) writes KTH's and
     BAIR's synthetic PNG trees at noise_amp 14 (natural video's noise)
     with the package's writer, packs them with data/pack.py, and
     at the training shapes (KTH 100 x 20, BAIR 192 x 12, Human3.6M 100 x
     16 at --subsampling 8, Moving MNIST 128 x 15) times the port's loader
     at 1 and 4 threads, 3 batches a leg: the PNG tree through the native
     decoder, the plain decoder, the packed tree, Human3.6M's videos, the
     native Moving MNIST generator (whole videos and parts); every leg's
     first batch bit-equal to the others', the native decoder equal to the
     plain one on the trees' frames; and the training step of each
     configuration in bf16 on the card (kernels 2-7, exact launch
     counts). Its four JSON lines (loader frames/s against the step's) are
     printed. The packed trees read back through the datasets; a KTH test
     set of the test persons' videos made by data/test_sets.py through the
     native and the plain decoders, equal, and read back by KTH's test
     fold.
 21. main path, the offline drop (offline_drop_path): a drop in the
     official layout (srvp_tpu_torch/verify_artifacts.py) written by the
     port's own writers: phase 17's LPIPS, AlexNet and I3D files, the
     seeded KTH vgg checkpoint (model.pt, config.json), KTH's test set by
     data/test_sets.py kth over a synthetic tree of the test persons, the
     glyph Moving MNIST set by test_sets synthetic, an MNIST IDX file, and
     BAIR's PNG tree by data/convert.py from TFRecords of seeded 30-frame
     RGB videos (data/synthetic.write_bair_download). The drop checker's CLI
     in a child process: every row ok, rc 0, its manifest written; again
     with --check_manifest: rc 0; one byte of alex.pth flipped: CHANGED, rc
     1 (restored); a truncated copy of model.pt: INVALID, rc 1. The
     converted BAIR tree through data/bair.py and the native PNG decoder,
     bit-equal to the videos in the TFRecords (the mean bytes of a frame
     printed); then test_main on the drop as the README's recipe runs it
     (--xp_dir DROP/checkpoints/kth --data_dir DROP/datasets --lpips_dir
     DROP/lpips --fvd, the I3D npz through SRVP_TPU_I3D_WEIGHTS), 16 videos
     x 20 samples: finite artifacts, one FVD line, exact launches of
     kernels 1, 4 and 6.
test_main runs under cuDNN's deterministic algorithms; phases 6 and 8 run
its kernel evaluation once more under cuDNN's defaults and print the s per
batch of both.
Then it prints one {"kernels": [...]} line (the rows of kernels 1, 4 and 6
also give `serving_launches`, their launches in phase 18's checks; every
row `data_tools_launches`, its launches in phase 20's step leg, and
`drop_launches`, its launches in phase 21's evaluation) and, last,
the device line.
It exits non-zero without a result when CUDA is unavailable.
"""

import contextlib
import copy
import dataclasses
import gzip
import io
import itertools
import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from srvp_tpu_torch import bench_serving as sbench
from srvp_tpu_torch import export as sexport
from srvp_tpu_torch import generate as sgenerate
from srvp_tpu_torch import swap as sswap
from srvp_tpu_torch import (bench, bench_conv_stage, eval_lib, test_main,
                            train_lib, train_main)
from srvp_tpu_torch.config import (cudnn_deterministic, model_config,
                                   strict_fp32)
from srvp_tpu_torch.data.device_compose import materialize, to_device
from srvp_tpu_torch.data.synthetic import (synthetic_kth_videos,
                                           write_bair_trees,
                                           write_human_tree,
                                           write_kth_packed_tree,
                                           write_kth_png_tree)
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
from srvp_tpu_torch.metrics import fvd as mfvd
from srvp_tpu_torch.metrics import i3d as mi3d
from srvp_tpu_torch.metrics import lpips as mlpips
from srvp_tpu_torch.metrics.ssim import video_ssim
from srvp_tpu_torch.models.conv import decoder_spec, encoder_spec, stage_module
from srvp_tpu_torch.models.lstm import lstm_apply
from srvp_tpu_torch.models.mlp import MLP
from srvp_tpu_torch.models.srvp import SRVP, rollout_masks
from srvp_tpu_torch.ops import counter_rng
from srvp_tpu_torch.ops.init import CONV_STD

ROOT = Path(__file__).resolve().parent
WORK_DIR = ROOT / "build" / "chip_smoke"
SEED = 0
RTOL, ATOL = 1e-4, 1e-5
# training rollout, forward and gradients (tests/test_pallas_train.py)
TRAIN_RTOL, TRAIN_ATOL = 2e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-6
# the control of the training rollout's gradient check: the kernel's
# gradients scaled by 1 + GRAD_FAULT (twice GRAD_RTOL) must fail it
GRAD_FAULT = 1e-3
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
                  ny, nz, seed, plan=None, arbiter=False):
    """Kernel vs plain version on the card, with the launch plan (rows a
    tile R, blocks a cluster C, blocks; by default the wrapper's) and the
    clusters of it the card holds at once; a second launch must give the
    same bits. With `arbiter` (the long horizons of Human3.6M and BAIR) an
    element fp32 cannot resolve is judged against a float64 plain run
    (parity.agreement); the raw error is printed either way. Returns the
    measured row."""
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
        ref64 = krollout.prior_rollout_reference(
            [(w.double(), b.double()) for w, b in pz_layers],
            [(w.double(), b.double()) for w, b in dyn_layers], y0.double(),
            eps.double(), ny, nz, oversampling)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        max_abs = diff.max().item()
        max_rel = (diff / ref.abs().clamp_min(1e-30)).max().item()
        worst, worst_f64, excused = parity.agreement(out, ref, ref64, RTOL,
                                                     ATOL)
        same_bits = bit_equal(out, again)
        held = worst_f64 if arbiter else worst
        ok = bool(torch.isfinite(out).all()) and held <= 1.0 and same_bits
        ms = cuda_ms(lambda: krollout.prior_rollout(*args, plan=plan))
        plain_ms = cuda_ms(lambda: krollout.prior_rollout_reference(*args))
    bound, bound_by = rollout_bound_ms(pz_layers, dyn_layers, bsz, n_steps,
                                       oversampling, ny, nz)
    row = dict(case=name, B=bsz, n_steps=n_steps, oversampling=oversampling,
               ny=ny, nz=nz, rows=plan.rows, cluster=plan.cluster,
               blocks=plan.tiles * plan.cluster, clusters_resident=resident,
               max_abs_err=max_abs, max_rel_err=max_rel,
               err_over_tol=worst, err_over_tol_f64=worst_f64,
               elements_excused=excused, arbiter=arbiter,
               same_bits=same_bits, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
    print("kernel_check " + json.dumps(row), flush=True)
    if not ok:
        raise SystemExit(f"prior_rollout kernel disagrees with its plain "
                         f"version ({name}): max |err| / (atol + rtol |ref|) "
                         f"= {worst} ({worst_f64} with the float64 arbiter), "
                         f"same bits on a second launch: {same_bits}")
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
                        oversampling, seed, margin=parity.KINK_MARGIN,
                        reorder=False):
    """Training-rollout kernels (forward, and backward through a loss that
    touches every output) against the plain version on the card, on
    kink-free inputs, each pass at its wrapper's plan; the forward's
    stashed pre-activations against the plain ones too. A second launch
    must give the same bits: the forward's outputs and stashes, and the
    gradients. The control: the kernel's gradients scaled by 1 +
    GRAD_FAULT must fail the gradients' check. With `reorder` (the BAIR and
    Human3.6M shapes) the float64 arbiter also takes a plain fp32 run on
    the batch's rows in another order (a weight gradient's row sums then
    add up in another order): an element no farther from float64 than one
    of the two plain runs agrees. Times the kernels' forward and backward,
    the backward's two passes and the rest of its wrapper apart, and the
    plain version's forward and backward. Returns the measured row."""
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
    others = [[] for _ in runs["plain"][1]]
    if reorder:
        perm = torch.randperm(bsz, generator=gen, device=y0.device)
        lv = [t.clone().requires_grad_() for t in [y0[perm], hxz[:, perm]]
              + flat]
        pairs = [(lv[i], lv[i + 1]) for i in range(2, len(lv), 2)]
        outs = krollout_train.train_rollout_reference(
            pairs[0], pairs[1:1 + n_pz], pairs[1 + n_pz:], lv[0], lv[1],
            eps[:, perm], oversampling)
        grads = list(torch.autograd.grad(parity.rollout_loss(outs), lv))
        inv = torch.argsort(perm)
        grads[0], grads[1] = grads[0][inv], grads[1][:, inv]
        others = [[g] for g in grads]
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
           + parity.agreement(a, b, c, GRAD_RTOL, GRAD_ATOL, o)
           for a, b, c, o in zip(*(runs[r][1] for r in runs), others)]
    fault = max(parity.agreement(a * (1 + GRAD_FAULT), b, c, GRAD_RTOL,
                                 GRAD_ATOL, o)[1]
                for a, b, c, o in zip(*(runs[r][1] for r in runs), others))

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
               bwd_reordered_arbiter=reorder,
               bwd_fault_err_over_tol_f64=fault,
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
            or row["bwd_err_over_tol_f64"] > 1.0 or fault <= 1.0:
        raise SystemExit(f"train_rollout kernels disagree with the plain "
                         f"version ({name}): forward err/tol "
                         f"{row['fwd_err_over_tol_f64']}, gradients err/tol "
                         f"{row['bwd_err_over_tol_f64']} (a planted "
                         f"fault: {fault}), same bits on a second forward: "
                         f"{fwd_same_bits}, backward: {bwd_same_bits}")
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


def check_artifacts(arts, n_videos, t_cond, t_pred, nx, nc=1, lpips=False):
    res = arts["results"]
    if set(res) != {"psnr", "ssim"} | ({"lpips"} if lpips else set()):
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
        if s.shape != (n_videos, t, nx, nx, nc) or s.dtype != np.uint8:
            raise SystemExit(f"{name}: {s.shape} {s.dtype}")


def seeded_xp(cfg, name, n_videos, nt_test, model_seed, test_set=True):
    """An experiment directory WORK_DIR/xp_<name> of cfg's model with
    seeded random weights (model.pt) and, with test_set, a synthetic test
    fold in WORK_DIR/data_<name>. Returns both directories."""
    xp_dir, data_dir = WORK_DIR / f"xp_{name}", WORK_DIR / f"data_{name}"
    xp_dir.mkdir(parents=True, exist_ok=True)
    data_dir.mkdir(parents=True, exist_ok=True)
    with open(xp_dir / "config.json", "w") as f:
        json.dump(cfg, f)
    torch.manual_seed(model_seed)
    torch.save(SRVP(model_config(cfg)).state_dict(), xp_dir / "model.pt")
    if test_set:
        write_test_set(cfg, data_dir, n_videos, nt_test, model_seed)
    return xp_dir, data_dir


def eval_path(cfg, n_videos, nt_test, model_seed, xp_dir=None,
              data_dir=None, batch=BATCH, default_algos=False):
    """The evaluation CLI on cfg's model with seeded random weights (or on
    the model.pt of the trainer's `xp_dir`, on the test fold in
    `data_dir`), batches of `batch` videos, through the prior-rollout
    kernel and then through the eager rollout on the same noise, with exact
    launch counts; returns the kernel run's summary. test_main runs under
    cuDNN's deterministic algorithms; with `default_algos` the kernel run
    is made again under cuDNN's defaults, which the summary times beside
    it (its frames within one uint8 level)."""
    name = f"{cfg['dataset']}-{cfg['archi']}"
    if xp_dir is None:
        xp_dir, data_dir = seeded_xp(cfg, name, n_videos, nt_test, model_seed)

    t_cond = cfg["nt_cond"]
    t_pred = nt_test - t_cond
    n_batches = -(-n_videos // batch)
    n_chunks = n_batches * (N_SAMPLES // CHUNK)
    # per chunk: the rollout; on vgg, the 4 pools of the conditioning
    # encode and the 4 upsamples of each of the two decodes
    vgg = 1 if cfg["archi"] == "vgg" else 0
    runs = {}
    for fused, algos in (("on", "deterministic"), ("off", "deterministic"),
                         ("on", "default")):
        if algos == "default" and not default_algos:
            continue
        klaunches.reset()
        with (mock.patch.object(test_main, "cudnn_deterministic",
                                contextlib.nullcontext)
              if algos == "default" else contextlib.nullcontext()):
            run = run_cli(xp_dir, data_dir, fused, nt_test, batch=batch)
        counts = klaunches.counts()
        expect_launches(f"{name} evaluation, rollout {fused}", counts, dict(
            prior_rollout=n_chunks if fused == "on" else 0,
            maxpool_fwd=4 * vgg * n_chunks, upsample_fwd=8 * vgg * n_chunks))
        runs[fused, algos] = run + (counts,)
        check_artifacts(run[0], n_videos, t_cond, t_pred, cfg["nx"],
                        cfg["nc"])
    (arts_k, secs_k, wall_k, _, counts), (arts_p, secs_p, wall_p, _, _) = \
        runs["on", "deterministic"], runs["off", "deterministic"]

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
        config=name, batches=n_batches, batch=batch, videos=n_videos,
        samples=N_SAMPLES, chunk=CHUNK, nt_cond=t_cond, nt_test=nt_test,
        o_gen=cfg["n_euler_steps"], launches=counts,
        s_per_batch_kernel=float(np.mean(secs_k[1:] or secs_k)),
        s_per_batch_plain=float(np.mean(secs_p[1:] or secs_p)),
        batch_seconds_kernel=secs_k, batch_seconds_plain=secs_p,
        wall_s_kernel=wall_k, wall_s_plain=wall_p,
        max_abs_metric_diff=d_metric, max_u8_diff=d_frames,
        random_1_frac_pixels_differ=frac,
        psnr_mean=float(arts_k["results"]["psnr"].mean()),
        ssim_mean=float(arts_k["results"]["ssim"].mean()))
    frames = batch * N_SAMPLES * t_pred
    summary["pred_frames_per_s_kernel"] = frames / summary["s_per_batch_kernel"]
    summary["pred_frames_per_s_plain"] = frames / summary["s_per_batch_plain"]
    if default_algos:
        arts_d, secs_d = runs["on", "default"][:2]
        summary["s_per_batch_default_algos"] = float(
            np.mean(secs_d[1:] or secs_d))
        summary["batch_seconds_default_algos"] = secs_d
        d_default = max(int(np.abs(arts_k[k]["samples"].astype(np.int16)
                                   - arts_d[k]["samples"]).max())
                        for k in ["cond_rec"] + [f"random_{i}"
                                                 for i in range(1, 6)])
        summary["max_u8_diff_default_algos"] = d_default
        d_frames["default_algos"] = d_default
    print("eval_path " + json.dumps(summary), flush=True)
    if d_metric["psnr"] > 1e-3 or d_metric["ssim"] > 1e-4 \
            or max(d_frames.values()) > 1:
        raise SystemExit(f"{name}: kernel and eager rollout disagree on the "
                         "evaluation path")
    return summary


class Tee(io.StringIO):
    """A text stream that keeps what is written and passes it on."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)

    def flush(self):
        self.out.flush()


def run_cli(xp_dir, data_dir, fused, nt_test, n_samples=N_SAMPLES,
            model_name="model.pt", batch=BATCH, extra=()):
    """test_main with the protocol's flags and `extra`. Returns (artifacts,
    batch seconds, wall seconds, the FVD it printed or None)."""
    opt_args = [
        "--xp_dir", str(xp_dir), "--data_dir", str(data_dir),
        "--batch_size", str(batch), "--n_samples", str(n_samples),
        "--samples_chunk", str(CHUNK), "--fused_rollout", fused,
        "--nt_gen", str(nt_test), "--model_name", model_name,
        "--device", "cuda", *extra]
    opt = test_main.create_test_args().parse_args(opt_args)
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        batch_seconds = test_main.main(opt)
    wall = time.perf_counter() - t0
    fvd = [float(ln.split()[1]) for ln in tee.getvalue().splitlines()
           if ln.startswith("FVD ")]
    arts = {"results": dict(np.load(xp_dir / "results.npz"))}
    metrics = ["psnr", "ssim"] + (["lpips"] if "lpips" in arts["results"]
                                  else [])
    for name in ["cond_rec"] + [f"{m}_{w}" for m in metrics
                                for w in ("best", "worst")] \
            + [f"random_{i}" for i in range(1, 6)]:
        arts[name] = dict(np.load(xp_dir / f"{name}.npz"))
    if len(fvd) > 1:
        raise SystemExit(f"test_main printed {len(fvd)} FVD lines")
    return arts, batch_seconds, wall, fvd[0] if fvd else None


def train_args(save_path, data_dir, n_steps, fused="on", cfg=XP_CONFIG,
               batch_size=TRAIN_BATCH, precision="float32",
               batch_size_test=BATCH):
    """The trainer's flags at cfg's width and training protocol: for the
    dcgan flagship, bench.py's smmnist-dcgan cell (batch 128, seq_len 15,
    o = 1) on synthetic digits; for kth-vgg, configs/kth.yaml (batch 100,
    seq_len 20, o = 2); bair-vgg and human-vgg, configs/bair.yaml (batch
    192, seq_len 12) and configs/human.yaml (batch 100, seq_len 16,
    --subsampling 8); `precision` is the trainer's --precision."""
    return train_main.create_args().parse_args(train_argv(
        save_path, data_dir, n_steps, fused, cfg, batch_size, precision,
        batch_size_test))


def train_argv(save_path, data_dir, n_steps, fused="on", cfg=XP_CONFIG,
               batch_size=TRAIN_BATCH, precision="float32",
               batch_size_test=BATCH):
    """train_args's command line."""
    flags = dict(dataset=cfg["dataset"], data_dir=data_dir,
                 save_path=save_path, batch_size=batch_size, n_iter=n_steps,
                 log_interval=1, val_interval=n_steps, n_iter_test=1,
                 batch_size_test=batch_size_test, n_samples_test=CHUNK,
                 val_samples_chunk=CHUNK, seed=SEED + 1, device="cuda",
                 fused_rollout=fused, precision=precision)
    for k in ("nc", "nx", "nf", "nhx", "ny", "nz", "nt_inf", "nh_inf",
              "nlayers_inf", "nh_res", "nlayers_res", "n_euler_steps",
              "nt_cond", "seq_len", "seq_len_test", "archi", "obs_scale",
              "res_gain", "subsampling"):
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
    with cudnn_deterministic():
        runs = {arm: grads(**kw) for arm, kw in (
            ("kernel", dict(use_kernel=True)), ("eager", dict(use_kernel=False)),
            (ref, ref_kw), (control, control_kw))}
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
               nt_test, margin, held, check="trained", precision="float32",
               data_dir=None, batch_size_test=BATCH):
    """The trainer CLI at cfg's width through the kernels, with exact
    launch counts, on the dataset in `data_dir` (by default a directory of
    its own, where KTH's packed tree is written); one step through the
    kernels and through the eager rollout and plain pools and upsamples
    (check_step, on the first `check_videos` videos of a batch, in the
    trainer's compute dtype), held on the trainer's final state (`check`
    "trained"), on seeded_state ("seeded"), or on seeded_state with the
    final state's readings printed, not held ("both"; None: no check);
    then, with a `test_dir`, test_main serving the checkpoint it wrote on
    the test fold there. `margin` and `held` go to check_step. With
    `precision` "bfloat16" the trainer runs --precision bfloat16 (the pools
    and upsamples through the kernels' bfloat16 versions). Returns the
    summary."""
    name = f"{cfg['dataset']}-{cfg['archi']}"
    xp_dir = WORK_DIR / f"train_{name}_{precision}"
    if data_dir is None:
        data_dir = WORK_DIR / f"data_{name}"
        data_dir.mkdir(parents=True, exist_ok=True)
        if cfg["dataset"] == "kth":
            write_kth_packed_tree(data_dir, cfg["nx"], SEED + 4)
    opt = train_args(str(xp_dir), str(data_dir), n_steps, cfg=cfg,
                     batch_size=batch_size, precision=precision,
                     batch_size_test=batch_size_test)
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
    summary = dict(
        config=name, precision=precision, steps=n_steps,
        batch=opt.batch_size, seq_len=opt.seq_len,
        oversampling=opt.n_euler_steps, launches=counts, losses=losses,
        wall_s=wall, ms_per_step=ms_step, frames_per_s=frames / (ms_step / 1e3),
        peak_memory_gb=peak_gb, xp_dir=str(xp_dir))

    if check is not None:
        state = torch.load(xp_dir / "model.pt", map_location="cuda")
        train_loader, _ = train_main.loaders(opt)
        batch = next(iter(train_loader))
        if not isinstance(batch, dict):     # dcgan's batch is its parts
            batch = batch[:, :check_videos]
        batch = to_device(batch, "cuda")
        compute_dtype = DTYPES[precision]
        if check == "both":
            trained = check_step(opt, state, batch, margin, held, hold=False,
                                 compute_dtype=compute_dtype)
            print("trained_state_step_check " + json.dumps(trained),
                  flush=True)
        if check != "trained":
            state = seeded_state(opt)
        summary.update(check_step(opt, state, batch, margin, held,
                                  compute_dtype=compute_dtype))
    if test_dir is not None:
        arts, _, _, _ = run_cli(xp_dir, test_dir, "on", nt_test,
                                n_samples=CHUNK)
        psnr = arts["results"]["psnr"]
        if not np.all(np.isfinite(psnr)):
            raise SystemExit(f"test_main on the trained checkpoint: {psnr}")
        summary.update(served_psnr_mean=float(psnr.mean()),
                       served_videos=int(psnr.size))
    print("train_path " + json.dumps(summary), flush=True)
    print(f"{name} {precision} training step at B={opt.batch_size}, "
          f"seq_len {opt.seq_len}: {ms_step:.3f} ms per step after {warmup} "
          f"warm-up "
          f"steps, {summary['frames_per_s']:.1f} frames/s, peak "
          f"{peak_gb:.2f} GB", flush=True)
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

    def __init__(self, argv, stop_after=None, script=TRAINER_CHILD):
        self.argv, self.stop_after, self.lines = argv, stop_after, []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script, *argv], cwd=ROOT,
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


def model_distance(ref_path, got_path, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
    """model.pt against a reference: the tensors whose bits differ; over
    the floats, the largest |got - ref|, its largest distance in ulps, the
    worst |got - ref| / (atol + rtol |ref|) and the elements past 1 of it;
    and the worst ||got - ref|| / (atol sqrt(n) + rtol ||ref||) over the
    tensors (L2 norms), with that tensor's name."""
    ref, got = torch.load(ref_path), torch.load(got_path)
    worst = dict(abs=0.0, ulps=0, ratio=0.0, differ=0, past=0,
                 norm_ratio=0.0, worst_tensor=None)
    for k in ref:
        if torch.equal(ref[k], got[k]):
            continue
        worst["differ"] += 1
        if not ref[k].is_floating_point():
            worst["ratio"] = float("inf")   # a count that differs
            worst["norm_ratio"] = float("inf")
            continue
        r = ref[k].double()
        d = (got[k].double() - r).abs()
        elem = d / (atol + rtol * r.abs())
        norm = float(d.norm() / (atol * r.numel() ** 0.5 + rtol * r.norm()))
        worst["abs"] = max(worst["abs"], float(d.max()))
        worst["ulps"] = max(worst["ulps"], ulp_distance(ref[k], got[k]))
        worst["ratio"] = max(worst["ratio"], float(elem.max()))
        worst["past"] += int((elem > 1).sum())
        if norm > worst["norm_ratio"]:
            worst["norm_ratio"], worst["worst_tensor"] = norm, k
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


# the datasets phase (16): BAIR (configs/bair.yaml) and Human3.6M
# (configs/human.yaml) at their published widths, vgg with skip
# connections and 3 channels, and KTH from its PNG tree
BAIR_CONFIG = dict(dataset="bair", nx=64, nc=3, nf=64, nhx=128, ny=50, nz=50,
                   skipco=True, nt_inf=2, nh_inf=256, nlayers_inf=3,
                   nh_res=512, nlayers_res=4, archi="vgg", nt_cond=2,
                   n_euler_steps=2, obs_scale=0.71, res_gain=1.41,
                   seq_len=12)
HUMAN_CONFIG = dict(dataset="human", nx=64, nc=3, nf=64, nhx=128, ny=50,
                    nz=50, skipco=True, nt_inf=3, nh_inf=256, nlayers_inf=3,
                    nh_res=512, nlayers_res=4, archi="vgg", nt_cond=8,
                    n_euler_steps=2, obs_scale=0.2, res_gain=1.2,
                    seq_len=16, seq_len_test=53, subsampling=8)
# BAIR: 210 training videos (a train fold of 199, one batch of 192; a
# validation fold of 11, one batch of 8) and 32 test videos (2 batches of
# 16, 2 + 28 frames); the one-step check on 48 of a batch's videos (576
# frames, its float64 arm about 30 GB)
BAIR_TRAIN_BATCH, BAIR_TRAIN_VIDEOS, BAIR_VAL_BATCH = 192, 210, 8
BAIR_TEST_VIDEOS, BAIR_NT_GEN, BAIR_CHECK_VIDEOS = 32, 30, 48
BAIR_STEPS, BAIR_WARMUP = 6, 3
# Human3.6M: 40 training videos of 100-199 frames (a training window spans
# 121: the shorter are drawn again) but 440 for the validation fold's (a
# window at seq_len_test 53 spans 417), and 16 test clips of 417 frames (2
# batches of 8, 8 + 45 frames)
HUMAN_TRAIN_BATCH, HUMAN_TRAIN_VIDEOS = 100, 40
HUMAN_TRAIN_LEN, HUMAN_VAL_LEN = (100, 200), 440
HUMAN_TEST_BATCH, HUMAN_TEST_CLIPS, HUMAN_NT_GEN = 8, 16, 53
HUMAN_STEPS, HUMAN_WARMUP = 6, 3
KTH_PNG_STEPS, KTH_PNG_WARMUP = 6, 3
DECODE_THREADS = 4


def host_cpu():
    """The host's CPU as /proc/cpuinfo names its first processor (model
    name, vendor, family, model, MHz) and its logical cores."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    return (f"{info.get('model name', 'CPU model not reported')} "
            f"({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}, "
            f"{info.get('cpu MHz', '?')} MHz), {os.cpu_count()} cores")


def check_decoder(paths, channels):
    """The native PNG decoder against the plain one (data/png.py) on every
    file of `paths`, read as `channels` channels: bit-equal. Its rate at
    DECODE_THREADS threads is the best of 3 passes over the files (in the
    page cache), at one thread that of one pass over the first 1000, the
    plain version's of one pass. Returns the row."""
    from srvp_tpu_torch.data import native, png
    paths = [str(p) for p in paths]
    t0 = time.perf_counter()
    plain = png.decode_png_batch(paths, 64, 64, channels)
    plain_s = time.perf_counter() - t0
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = native.decode_png_batch(paths, 64, 64, channels,
                                      DECODE_THREADS)
        secs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    native.decode_png_batch(paths[:1000], 64, 64, channels, 1)
    one_s = time.perf_counter() - t0
    row = dict(frames=len(paths), channels=channels,
               bit_equal=bool(np.array_equal(got, plain)),
               threads=DECODE_THREADS, frames_per_s=len(paths) / min(secs),
               one_thread_frames_per_s=len(paths[:1000]) / one_s,
               plain_frames_per_s=len(paths) / plain_s, host=host_cpu())
    print("decoder_check " + json.dumps(row), flush=True)
    if not row["bit_equal"]:
        raise SystemExit(f"the native PNG decoder disagrees with "
                         f"data/png.py: {row}")
    return row


def check_tree_batches(name, png_dir, packed_dir, cfg, batch_size, n=2):
    """The trainer's training loader on the PNG tree and on the packed
    tree of the same videos: n batches, bit-equal, the PNG tree's through
    the native decoder. Returns the row."""
    from srvp_tpu_torch.data import native
    batches, decoded = {}, {}
    for tree, data_dir in (("png", png_dir), ("packed", packed_dir)):
        opt = train_args(str(WORK_DIR / "unused"), str(data_dir), 1, cfg=cfg,
                         batch_size=batch_size)
        loader, _ = train_main.loaders(opt)
        if loader.dataset.packed != (tree == "packed"):
            raise SystemExit(f"{name}: the {tree} tree was not read")
        before = native.decoded["frames"]
        batches[tree] = list(itertools.islice(
            train_main.infinite_batches(loader), n))
        decoded[tree] = native.decoded["frames"] - before
    row = dict(dataset=name, batches=n, shape=list(batches["png"][0].shape),
               bit_equal=all(np.array_equal(a, b) for a, b in zip(
                   batches["png"], batches["packed"])),
               frames_decoded=decoded)
    print("tree_batches " + json.dumps(row), flush=True)
    if not row["bit_equal"] or decoded["packed"] \
            or decoded["png"] < n * np.prod(row["shape"][:2]):
        raise SystemExit(f"{name}: PNG and packed trees disagree: {row}")
    return row


def dataset_kernel_checks():
    """Kernels 1-3 at the BAIR and Human3.6M models' shapes (training B =
    192, K = 22 and B = 100, K = 30; evaluation chunks B = 160, 56
    substeps and B = 80, 90 substeps, judged with the float64 arbiter),
    kernels 4-7 at every vgg site of the BAIR step (N = 192 x 12 = 2304
    frames) in fp32 and bf16. Returns the rows."""
    rows = {}
    o = 2
    for cfg, key, batch, test_batch, nt_gen, seed in (
            (BAIR_CONFIG, "bair", BAIR_TRAIN_BATCH, BATCH, BAIR_NT_GEN,
             SEED + 22),
            (HUMAN_CONFIG, "human", HUMAN_TRAIN_BATCH, HUMAN_TEST_BATCH,
             HUMAN_NT_GEN, SEED + 25)):
        mcfg = model_config(cfg)
        torch.manual_seed(seed)
        model = SRVP(mcfg).cuda().eval()
        pz, dyn = model.p_z.linears(), model.dynamics.linears()
        rows[f"{key}_train"] = check_train_rollout(
            f"{key} training step", (model.q_z.weight, model.q_z.bias), pz,
            dyn, batch, o * (cfg["seq_len"] - 1), o, seed + 1,
            KTH_KINK_MARGIN, reorder=True)
        rows[f"{key}_eval"] = check_rollout(
            f"{key} evaluation chunk", pz, dyn, test_batch * CHUNK,
            o * (nt_gen - cfg["nt_cond"]), o, mcfg.ny, mcfg.nz, seed + 2,
            arbiter=True)
        del model
    n_frames = BAIR_TRAIN_BATCH * BAIR_CONFIG["seq_len"]
    largest = n_frames * max(c * hw * hw for c, hw in POOL_SITES + [
        (c, 2 * hw) for c, hw in UP_SITES])
    print(f"largest pool / upsample tensor at BAIR training: {largest} "
          f"elements (2^31 = {2 ** 31}; csrc/spatial.cu indexes in 64 "
          "bits)", flush=True)
    torch.cuda.empty_cache()
    rows["spatial"] = check_spatial(n_frames, SEED + 27)
    rows["spatial_bf16"] = check_spatial(n_frames, SEED + 28, torch.bfloat16)
    return rows


def datasets_path():
    """Phase 16: synthetic BAIR (PNG and packed), Human3.6M and KTH (PNG
    and packed) trees written with numpy and the stdlib PNG writer; the
    native PNG decoder against data/png.py on every frame and its rate; the
    PNG trees' loader batches against the packed trees'; the kernels at the
    new shapes; BAIR trained at full width in fp32 (the one-step check on
    the seeded state) and bf16 from its PNG tree, its fp32 model.pt served
    through the kernel and eagerly; Human3.6M trained in bf16 and served
    likewise; KTH trained from its PNG tree. BAIR's bf16 run is repeated
    on the packed tree, which needs no decoding. Returns the summaries."""
    from srvp_tpu_torch.data import native
    root = WORK_DIR / "datasets"
    shutil.rmtree(root, ignore_errors=True)
    dirs = {k: root / k for k in ("bair_png", "bair_packed", "human",
                                  "kth_png", "kth_packed")}
    t0 = time.perf_counter()
    bair_frames = write_bair_trees(dirs["bair_png"], dirs["bair_packed"],
                                   BAIR_TRAIN_VIDEOS, BAIR_TEST_VIDEOS,
                                   SEED + 20)
    write_human_tree(dirs["human"], HUMAN_TRAIN_VIDEOS, HUMAN_TRAIN_LEN,
                     HUMAN_VAL_LEN, HUMAN_TEST_CLIPS, HUMAN_NT_GEN,
                     HUMAN_CONFIG["subsampling"], SEED + 21)
    kth_frames = write_kth_png_tree(dirs["kth_png"], 64, SEED + 4)
    write_kth_packed_tree(dirs["kth_packed"], 64, SEED + 4)
    out = dict(write_s=time.perf_counter() - t0)
    out["decoder"] = [check_decoder(bair_frames, 3),
                      check_decoder(kth_frames, 1)]
    out["trees"] = [
        check_tree_batches("bair", dirs["bair_png"], dirs["bair_packed"],
                           BAIR_CONFIG, BAIR_TRAIN_BATCH),
        check_tree_batches("kth", dirs["kth_png"], dirs["kth_packed"],
                           KTH_CONFIG, KTH_TRAIN_BATCH)]
    kernels = dataset_kernel_checks()

    torch.cuda.empty_cache()
    before = native.decoded["frames"]
    bair = train_path(
        BAIR_CONFIG, BAIR_STEPS, BAIR_WARMUP, BAIR_TRAIN_BATCH,
        BAIR_CHECK_VIDEOS, None, BAIR_NT_GEN, KTH_KINK_MARGIN, KTH_STEP_HELD,
        data_dir=dirs["bair_png"], batch_size_test=BAIR_VAL_BATCH,
        check="seeded")
    bair["frames_decoded"] = native.decoded["frames"] - before
    if bair["frames_decoded"] < BAIR_STEPS * BAIR_TRAIN_BATCH * 12:
        raise SystemExit(f"BAIR training: {bair['frames_decoded']} frames "
                         "through the native decoder")
    torch.cuda.empty_cache()
    # bf16 from the PNG tree, then from the packed tree: the decoder's
    # share of the step
    bair_bf16, bair_bf16_packed = (train_path(
        BAIR_CONFIG, BAIR_STEPS, BAIR_WARMUP, BAIR_TRAIN_BATCH, 0, None,
        BAIR_NT_GEN, None, None, check=None, precision="bfloat16",
        data_dir=dirs[tree], batch_size_test=BAIR_VAL_BATCH)
        for tree in ("bair_png", "bair_packed"))
    torch.cuda.empty_cache()
    bair_eval = eval_path(BAIR_CONFIG, BAIR_TEST_VIDEOS, BAIR_NT_GEN, SEED,
                          xp_dir=Path(bair["xp_dir"]),
                          data_dir=dirs["bair_png"])
    human = train_path(
        HUMAN_CONFIG, HUMAN_STEPS, HUMAN_WARMUP, HUMAN_TRAIN_BATCH, 0, None,
        HUMAN_NT_GEN, None, None, check=None, precision="bfloat16",
        data_dir=dirs["human"], batch_size_test=HUMAN_TEST_BATCH)
    torch.cuda.empty_cache()
    human_eval = eval_path(HUMAN_CONFIG, HUMAN_TEST_CLIPS, HUMAN_NT_GEN, SEED,
                           xp_dir=Path(human["xp_dir"]),
                           data_dir=dirs["human"], batch=HUMAN_TEST_BATCH)
    kth_png = train_path(
        KTH_CONFIG, KTH_PNG_STEPS, KTH_PNG_WARMUP, KTH_TRAIN_BATCH, 0, None,
        KTH_NT_GEN, None, None, check=None, precision="bfloat16",
        data_dir=dirs["kth_png"])
    out.update(kernels=kernels, bair=bair, bair_bf16=bair_bf16,
               bair_bf16_packed=bair_bf16_packed, bair_eval=bair_eval,
               human=human, human_eval=human_eval, kth_png=kth_png)
    for what, tr in (("bair", kernels["bair_train"]),
                     ("human", kernels["human_train"])):
        wg = tr["wgrad"]
        print(f"{what} training rollout B={tr['B']}, K={tr['n_steps']}: "
              f"forward {tr['kernel_fwd_ms']:.4f} ms (plan R="
              f"{tr['fwd_rows']}, C={tr['fwd_cluster']}, {tr['fwd_blocks']} "
              f"blocks; bound {tr['fwd_bound_ms']:.4f}), carry pass "
              f"{tr['carry_ms']:.4f} ms (R={tr['bwd_rows']}, "
              f"C={tr['bwd_cluster']}; bound {tr['carry_bound_ms']:.4f}), "
              f"weight-gradient pass {wg['ms']:.4f} ms (S={wg['split']}; "
              f"bound {wg['bound_ms']:.4f}); plain forward + backward "
              f"{tr['plain_fwd_bwd_ms']:.4f} ms", flush=True)
    for what, ev in (("bair", kernels["bair_eval"]),
                     ("human", kernels["human_eval"])):
        print(f"{what} prior rollout B={ev['B']}, {ev['n_steps']} substeps: "
              f"{ev['ms']:.4f} ms (R={ev['rows']}, C={ev['cluster']}; bound "
              f"{ev['bound_ms']:.4f}, plain {ev['plain_ms']:.4f}); err/tol "
              f"{ev['err_over_tol']:.3f} raw, {ev['err_over_tol_f64']:.3f} "
              f"with the float64 arbiter", flush=True)
    for what, tr in (("bair fp32", bair), ("bair bf16", bair_bf16),
                     ("bair bf16 (packed tree)", bair_bf16_packed),
                     ("human bf16", human), ("kth png bf16", kth_png)):
        print(f"{what} training: {tr['ms_per_step']:.1f} ms per step, "
              f"{tr['frames_per_s']:.1f} frames/s, peak "
              f"{tr['peak_memory_gb']:.2f} GB; launches {tr['launches']}",
              flush=True)
    for what, ev in (("bair", bair_eval), ("human", human_eval)):
        print(f"{what} evaluation: {ev['s_per_batch_kernel']:.3f} s per "
              f"batch of {ev['batch']} videos x {N_SAMPLES} samples "
              f"(eager rollout {ev['s_per_batch_plain']:.3f}); launches "
              f"{ev['launches']}", flush=True)
    print(f"PNG decode at {DECODE_THREADS} threads: "
          f"{out['decoder'][0]['frames_per_s']:.0f} RGB and "
          f"{out['decoder'][1]['frames_per_s']:.0f} gray frames/s on "
          f"{host_cpu()}", flush=True)
    return out


# the metrics phase (17): LPIPS at the golden's tolerance
# (tests/test_lpips.py) and I3D at the JAX mirror test's
# (tests/test_i3d_torch_mirror.py), card against the port's CPU version;
# the Fréchet distance of a set of 16 embeddings with itself, float64
# eigen-rounding of a rank-15 400 x 400 covariance, at most FVD_SELF_RTOL
# of its trace (about 1.8e-7 of it on random embeddings, on the CPU); the
# FVD test_main prints against fvd() called again at FVD_AGAIN_RTOL
LPIPS_RTOL, LPIPS_ATOL = 1e-4, 1e-6
I3D_RTOL, I3D_ATOL = 1e-3, 1e-4
FVD_SELF_RTOL, FVD_AGAIN_RTOL = 1e-5, 1e-6
# BAIR with both metrics: one batch of 16 test videos, 20 samples (cut
# from the protocol's 100)
METRICS_BAIR_VIDEOS, METRICS_BAIR_SAMPLES = 16, 20


def write_lpips_weights(lpips_dir, seed):
    """Random weights in the official files: a torchvision AlexNet
    state_dict (features.{0,3,6,8,10}, OIHW, He-scaled) as
    alexnet-owt-7be5be79.pth, and LPIPS v0.1's alex.pth
    (lin{i}.model.1.weight, (1, C, 1, 1), non-negative)."""
    gen = torch.Generator().manual_seed(seed)
    backbone, lins = {}, {}
    for i, (idx, (co, ci, k, _, _)) in enumerate(zip(mlpips._FEATURE_IDX,
                                                     mlpips._ALEX_CONVS)):
        backbone[f"features.{idx}.weight"] = torch.randn(
            co, ci, k, k, generator=gen) * (2.0 / (ci * k * k)) ** 0.5
        backbone[f"features.{idx}.bias"] = 0.01 * torch.randn(co,
                                                              generator=gen)
        lins[f"lin{i}.model.1.weight"] = torch.rand(1, co, 1, 1,
                                                    generator=gen) / co
    Path(lpips_dir).mkdir(parents=True, exist_ok=True)
    torch.save(backbone, Path(lpips_dir) / "alexnet-owt-7be5be79.pth")
    torch.save(lins, Path(lpips_dir) / "alex.pth")


def write_i3d_weights(path, seed):
    """A random I3D npz under the TF variable paths
    (metrics/i3d.variable_specs): He-scaled kernels, the batch norms'
    moving variances in [0.5, 1.5), their means, offsets and the Logits
    bias 0.1 N(0, 1)."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for key, shape in mi3d.variable_specs():
        if key.endswith("/w"):
            arrays[key] = rng.randn(*shape) * (2.0 / np.prod(shape[:-1])) ** 0.5
        elif key.endswith("moving_variance"):
            arrays[key] = rng.uniform(0.5, 1.5, shape)
        else:
            arrays[key] = 0.1 * rng.randn(*shape)
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrays.items()})


def metrics_cli(cfg, xp_dir, data_dir, nt_test, n_videos, n_samples, extra):
    """test_main on cfg's seeded model, with exact launch counts (one batch:
    the rollout a chunk, vgg's 4 pools and 8 upsamples a chunk). Returns
    run_cli's tuple."""
    klaunches.reset()
    out = run_cli(xp_dir, data_dir, "on", nt_test, n_samples=n_samples,
                  extra=extra)
    n_chunks = -(-n_videos // BATCH) * (n_samples // CHUNK)
    expect_launches(f"{cfg['dataset']} evaluation {list(extra)}",
                    klaunches.counts(), dict(
                        prior_rollout=n_chunks, maxpool_fwd=4 * n_chunks,
                        upsample_fwd=8 * n_chunks))
    check_artifacts(out[0], n_videos, cfg["nt_cond"], nt_test - cfg["nt_cond"],
                    cfg["nx"], cfg["nc"], lpips="--lpips_dir" in extra)
    lp = out[0]["results"].get("lpips")
    if lp is not None and not (np.all(np.isfinite(lp)) and np.all(lp >= 0)):
        raise SystemExit(f"LPIPS results {lp}")
    if ("--fvd" in extra) != (out[3] is not None) or (
            out[3] is not None and not (np.isfinite(out[3]) and out[3] > 0)):
        raise SystemExit(f"FVD printed: {out[3]}")
    return out


def metrics_path():
    """Phase 17: LPIPS and FVD through test_main (KTH vgg at full width as
    phase 8 evaluates it, then BAIR with 3 channels), their agreement with
    the runs without them and with the port's CPU versions, and their
    times. Returns the summary."""
    strict_fp32()
    root = WORK_DIR / "metrics"
    shutil.rmtree(root, ignore_errors=True)
    lpips_dir, i3d_path = root / "lpips", root / "i3d.npz"
    write_lpips_weights(lpips_dir, SEED + 30)
    write_i3d_weights(i3d_path, SEED + 31)
    with mock.patch.dict(os.environ, SRVP_TPU_I3D_WEIGHTS=str(i3d_path)):
        return metrics_runs(lpips_dir, i3d_path)


def metrics_runs(lpips_dir, i3d_path):
    """metrics_path's runs and checks, I3D's weights at i3d_path."""
    cfg, nt_test = KTH_CONFIG, KTH_NT_GEN
    t_cond = cfg["nt_cond"]
    xp_dir, data_dir = seeded_xp(cfg, "metrics-kth", KTH_VIDEOS, nt_test,
                                 SEED)
    metric_flags = ("--lpips_dir", str(lpips_dir), "--fvd")
    # the two runs held bit-equal: test_main takes cuDNN's deterministic
    # algorithms (under its defaults the decode differs from run to run by
    # up to 1.2e-7, scripts/eval_determinism.py, which can flip the best
    # of near-tied samples)
    plain = metrics_cli(cfg, xp_dir, data_dir, nt_test, KTH_VIDEOS,
                        N_SAMPLES, ())
    full = metrics_cli(cfg, xp_dir, data_dir, nt_test, KTH_VIDEOS,
                       N_SAMPLES, metric_flags)
    arts_p, arts_m, fvd_cli = plain[0], full[0], full[3]
    differ = sorted(
        [f"results.{k}" for k, v in arts_p["results"].items()
         if not np.array_equal(v, arts_m["results"][k])]
        + [k for k in arts_p if k != "results"
           and not np.array_equal(arts_p[k]["samples"],
                                  arts_m[k]["samples"])])

    # FVD again through fvd(), timed; the ground truth against itself
    seqs = np.load(data_dir / f"svg_test_set_{nt_test}.npz")["sequences"]
    real = seqs[:, :, :, :, None]              # (N, T, H, W, 1) uint8
    fake = np.concatenate([real[:, :t_cond],
                           arts_m["random_1"]["samples"]], axis=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fvd_again = mfvd.fvd(real, fake, str(i3d_path), "cuda")
    fvd_s = time.perf_counter() - t0
    params = mi3d.load_i3d_npz(str(i3d_path))
    embed = mfvd.make_embedder(params, torch.device("cuda"))
    emb_real = mfvd.compute_embeddings(embed, real)
    fvd_self = mfvd.frechet_distance(emb_real, emb_real)
    trace = float(np.trace(np.cov(emb_real.astype(np.float64),
                                  rowvar=False)))
    chunk = torch.from_numpy(np.repeat(real[:mfvd.CHUNK], 3, axis=-1))
    i3d_ms = cuda_ms(lambda: embed(chunk), warmup=1, iters=3)
    emb_cpu = mfvd.make_embedder(params, torch.device("cpu"))(chunk[:2])
    i3d_err = _worst(embed(chunk[:2]).cpu(), emb_cpu, I3D_RTOL, I3D_ATOL)

    # LPIPS on one chunk's frames: the 5 random samples of each video,
    # twice, against the targets (T, S * B = 160)
    rows = np.concatenate([arts_m[f"random_{i}"]["samples"]
                           for i in range(1, 6)] * 2, axis=0)
    pred = torch.from_numpy(rows.transpose(1, 0, 2, 3, 4)).float() / 255.0
    target = torch.from_numpy(np.tile(real[:, t_cond:], (10, 1, 1, 1, 1))
                              .transpose(1, 0, 2, 3, 4)).float() / 255.0
    lp_gpu_fn = mlpips.make_video_lpips(str(lpips_dir), torch.device("cuda"))
    pred_d, target_d = pred.cuda(), target.cuda()
    lpips_ms = cuda_ms(lambda: lp_gpu_fn(pred_d, target_d), warmup=2,
                       iters=5)
    lp_gpu = lp_gpu_fn(pred_d, target_d).cpu()
    lp_cpu = mlpips.make_video_lpips(str(lpips_dir),
                                     torch.device("cpu"))(pred, target)
    lpips_err = _worst(lp_gpu, lp_cpu, LPIPS_RTOL, LPIPS_ATOL)

    # BAIR, 3 channels: one batch of 16 videos, 2 + 28 frames
    bcfg = dict(BAIR_CONFIG, seq_len_test=BAIR_NT_GEN)
    bxp, bdata = seeded_xp(bcfg, "metrics-bair", METRICS_BAIR_VIDEOS,
                           BAIR_NT_GEN, SEED + 32, test_set=False)
    write_bair_trees(bdata / "png", bdata, 1, METRICS_BAIR_VIDEOS, SEED + 33)
    bair = metrics_cli(bcfg, bxp, bdata, BAIR_NT_GEN, METRICS_BAIR_VIDEOS,
                       METRICS_BAIR_SAMPLES, metric_flags)

    summary = dict(
        kth=dict(videos=KTH_VIDEOS, samples=N_SAMPLES, nt_cond=t_cond,
                 nt_test=nt_test,
                 lpips_mean=float(arts_m["results"]["lpips"].mean()),
                 fvd=fvd_cli, fvd_again=fvd_again, fvd_self=fvd_self,
                 fvd_self_over_trace=abs(fvd_self) / trace,
                 differ_from_plain_run=differ,
                 s_per_batch=full[1][0], s_per_batch_without_lpips=plain[1][0],
                 wall_s=full[2], wall_s_without_metrics=plain[2]),
        lpips_chunk=dict(pairs=int(pred.shape[0] * pred.shape[1]),
                         ms=lpips_ms, max_abs_err=lpips_err[0],
                         err_over_tol=lpips_err[1]),
        i3d_chunk=dict(videos=mfvd.CHUNK, frames=int(chunk.shape[1]),
                       ms=i3d_ms, max_abs_err_2_videos=i3d_err[0],
                       err_over_tol_2_videos=i3d_err[1]),
        fvd_s=fvd_s,
        bair=dict(videos=METRICS_BAIR_VIDEOS, samples=METRICS_BAIR_SAMPLES,
                  nt_cond=bcfg["nt_cond"], nt_test=BAIR_NT_GEN,
                  lpips_mean=float(bair[0]["results"]["lpips"].mean()),
                  fvd=bair[3], s_per_batch=bair[1][0]))
    print("metrics_path " + json.dumps(summary), flush=True)
    if differ:
        raise SystemExit(f"--lpips_dir changed the evaluation: {differ}")
    if abs(fvd_again - fvd_cli) > FVD_AGAIN_RTOL * abs(fvd_cli):
        raise SystemExit(f"FVD {fvd_cli} printed, {fvd_again} again")
    if abs(fvd_self) > FVD_SELF_RTOL * trace:
        raise SystemExit(f"FVD of the ground truth with itself {fvd_self} "
                         f"(covariance trace {trace})")
    if not (lpips_err[1] <= 1 and lpips_err[2] and i3d_err[1] <= 1
            and i3d_err[2]):
        raise SystemExit(f"card against CPU (max abs error, of the "
                         f"tolerance, finite): LPIPS {lpips_err}, I3D "
                         f"{i3d_err}")
    return summary


# the serving phase (18): the generation program exported as one artifact
# (srvp_tpu_torch/export.py) at full width with seeded weights, the conv
# kernels scaled by SERVING_CONV_GAIN: (name, configuration, compute
# dtype, pinned batch or None for a symbolic one, the device it is
# exported on). The pinned artifact is exported on the CPU and served on
# the card
SERVING_EXPORTS = [
    ("dcgan float32", XP_CONFIG, torch.float32, None, "cuda"),
    ("dcgan bfloat16", XP_CONFIG, torch.bfloat16, None, "cuda"),
    ("kth bfloat16", KTH_CONFIG, torch.bfloat16, None, "cuda"),
    ("dcgan float32 pinned", XP_CONFIG, torch.float32, 16, "cpu")]
SERVING_SEED = 3
SERVING_BATCHES, SERVING_ITERS = [1, 16, 128], 10
SERVING_TOOL_VIDEOS = 4
# a fresh init decodes every pixel to about 127; with the conv kernels
# scaled by these gains the frames have structure and do not saturate
# (a larger gain saturates them, KTH's first). The checks require both
# (SERVING_MIN_STD, SERVING_MAX_SATURATED) and that another seed changes
# the prediction (SERVING_SEED_SHARE), so that a wrong kernel shows
SERVING_CONV_GAIN = {"dcgan": 3.0, "vgg": 2.0}
SERVING_MIN_STD, SERVING_MAX_SATURATED = 0.05, 0.5
SERVING_SEED_SHARE = 0.25
# kernels against the plain versions on the same noise: the latent states
# at the rollout check's RTOL and ATOL; in float32 the frames before
# quantisation within one uint8 level (eval_path's)
SERVING_FRAME_ATOL = 1.0 / 255.0
# the same artifact on the CPU and on the card, in a child process that
# imports load_serving alone: argv is the artifact, the frames' npy file
SERVING_CHILD = """
import json, sys
import numpy as np
import torch
from srvp_tpu_torch.export import load_serving
x = np.load(sys.argv[2])
out = {dev: load_serving(sys.argv[1], dev)[0](x, 3).cpu().numpy()
       for dev in ("cpu", "cuda")}
d = np.abs(out["cpu"].astype(np.int16) - out["cuda"])
print("serving_child " + json.dumps(dict(
    max_u8_diff=int(d.max()), frac_pixels_differ=float((d > 0).mean()),
    shape=list(out["cpu"].shape),
    model_modules=sorted(m for m in sys.modules
                         if m.startswith("srvp_tpu_torch.models")))))
"""


def structured(state_dict, archi):
    """A state dict with its conv kernels scaled by SERVING_CONV_GAIN (as
    tests/torch_port_util.jax_model's conv_gain scales them)."""
    gain = SERVING_CONV_GAIN[archi]
    return {k: v * gain if v.dim() == 4 else v
            for k, v in state_dict.items()}


def serving_frames(cfg, n_videos, seed):
    """uint8 (nt_cond, B, 64, 64, 1) conditioning frames of the synthetic
    test set of cfg's dataset."""
    nt_cond = cfg["nt_cond"]
    if cfg["dataset"] == "kth":
        v = synthetic_kth_videos(n_videos, nt_cond, cfg["nx"],
                                 np.random.RandomState(seed))
        v = v.transpose(1, 0, 2, 3)
    else:
        v = synthetic_sequences(n_videos, nt_cond, cfg["nx"], seed)
    return torch.from_numpy(np.ascontiguousarray(v[..., None]))


def serving_artifact(root, name, cfg, dtype, batch, device):
    """Exports one entry of SERVING_EXPORTS on `device` and loads it on the
    card: (fn, header, live serving core on the card, path, export seconds,
    bytes, call_function nodes of the program, of them srvp ops)."""
    torch.manual_seed(SEED + 40)
    model = SRVP(model_config(cfg)).cuda().eval()
    model.load_state_dict(structured(model.state_dict(), cfg["archi"]))
    nt_gen, o = cfg["seq_len_test"], cfg["n_euler_steps"]
    t0 = time.perf_counter()
    blob = sexport.export_serving(
        model.cfg, copy.deepcopy(model).to(device), cfg["nt_cond"], nt_gen,
        oversampling=o, compute_dtype=dtype, batch_size=batch)
    export_s = time.perf_counter() - t0
    path = root / (name.replace(" ", "_") + ".srvptex")
    sexport.save_serving(path, blob)
    fn, header = sexport.load_serving(path, "cuda")
    core = sexport.make_serving_fn(model.cfg, model, nt_gen, oversampling=o,
                                   compute_dtype=dtype)
    ep = torch.export.load(io.BytesIO(blob[sexport.read_header(blob)[1]:]))
    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    nodes = (len(calls), sum(getattr(n.target, "namespace", "") == "srvp"
                             for n in calls))
    del ep, calls
    print(f"serving export {name} on {device}: {len(blob)} bytes, "
          f"{export_s:.3f} s, batch {header['batch']} (at most "
          f"{header['max_batch']}), {nodes[0]} call_function nodes, "
          f"{nodes[1]} of them srvp ops", flush=True)
    return fn, header, core, path, export_s, len(blob), nodes


def plain_core(core, dtype):
    """A copy of the serving core in `dtype` with the plain pools and
    upsamples (its predict then takes use_kernel_rollout=False)."""
    plain = sexport.make_serving_fn(core.model.cfg, core.model, core.nt_gen,
                                    oversampling=core.oversampling,
                                    compute_dtype=dtype)
    krspatial.use_kernels(plain.model, False)
    return plain


def serving_check(name, cfg, dtype, fn, core):
    """At each of SERVING_BATCHES, on the same frames, seed and noise,
    cuDNN deterministic: the artifact against the live serving core, bit
    for bit in fp32, one uint8 level in bf16; the core against the plain
    versions (plain rollout, pools and upsamples): the latent states at
    RTOL and ATOL, the frames before quantisation in fp32 within
    SERVING_FRAME_ATOL (and the artifact's uint8 frames within one level
    of the plain ones), in bf16 no farther from the plain bf16 frames than
    those are from the plain fp32 ones (L2); the launches of a call, equal
    to the live core's, kernel 1 once and at vgg kernels 4 and 6 on every
    pool and upsample; frames with structure, not saturated; the same seed
    twice, and another seed that changes a share of the predicted pixels.
    Returns the rows."""
    nt_cond = cfg["nt_cond"]
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    vgg = 4 if cfg["archi"] == "vgg" else 0
    plain = plain_core(core, dtype)
    plain32 = plain_core(core, torch.float32) if sfx else None
    xs = serving_frames(cfg, max(SERVING_BATCHES), SEED + 41).cuda()
    seed = torch.tensor(SERVING_SEED, device="cuda")
    rows = []
    for b in SERVING_BATCHES:
        x = xs[:, :b]
        klaunches.reset()
        got = fn(x, seed)
        art = klaunches.counts()
        with torch.no_grad(), cudnn_deterministic():
            eps = core.noise(seed, b, nt_cond)
            klaunches.reset()
            lat = core.latents(x, eps)
            live = core.decode_frames(*lat)
            live_counts = klaunches.counts()
            lat_p = plain.latents(x, eps, use_kernel_rollout=False)
            ref = plain.decode_frames(*lat_p)
            ref32 = (plain32.predict(x, eps, use_kernel_rollout=False)
                     if sfx else ref)
        expect_launches(f"serving {name} batch {b}, artifact", art, {
            "prior_rollout": 1, "maxpool_fwd" + sfx: vgg,
            "upsample_fwd" + sfx: vgg})
        expect_launches(f"serving {name} batch {b}, live core", live_counts,
                        art)
        live_u8 = torch.round(live * 255.0).to(torch.uint8)
        d = (got.int() - live_u8.int()).abs()
        d_plain = (got.int() - torch.round(ref32 * 255.0).int()).abs()
        again, other = fn(x, seed), fn(x, SERVING_SEED + 1)
        row = dict(case=name, batch=b,
                   max_u8_diff_live=int(d.max()),
                   frac_pixels_differ_live=float((d > 0).float().mean()),
                   latent_err_over_tol=float(((lat[1] - lat_p[1]).abs()
                                              / (ATOL + RTOL
                                                 * lat_p[1].abs())).max()),
                   max_abs_err_plain=float((live - ref).abs().max()),
                   max_u8_diff_plain_fp32=int(d_plain.max()),
                   pred_std=float(live[nt_cond:].std()),
                   saturated=float(((got[nt_cond:] == 0)
                                    | (got[nt_cond:] == 255)).float().mean()),
                   launches={k: v for k, v in art.items() if v},
                   same_seed_same_bits=bool(torch.equal(got, again)),
                   other_seed_share_differ=float(
                       (got[nt_cond:] != other[nt_cond:]).float().mean()))
        if sfx:
            row["dist_plain_bf16"] = distance(live, ref, ref32)
            row["dist_plain_bf16_fp32"] = distance(ref, ref32, ref32)
        print("serving_check " + json.dumps(row), flush=True)
        close = (row["max_abs_err_plain"] <= SERVING_FRAME_ATOL
                 and row["max_u8_diff_plain_fp32"] <= 1 if not sfx else
                 row["dist_plain_bf16"] <= row["dist_plain_bf16_fp32"])
        if (row["max_u8_diff_live"] > (1 if sfx else 0) or not close
                or row["latent_err_over_tol"] > 1.0
                or row["pred_std"] < SERVING_MIN_STD
                or row["saturated"] > SERVING_MAX_SATURATED
                or not row["same_seed_same_bits"]
                or row["other_seed_share_differ"] < SERVING_SEED_SHARE):
            raise SystemExit(f"serving {name}: {row}")
        rows.append(row)
    del plain, plain32
    return rows


def distance(a, b, ref):
    """||a - b|| / ||ref|| in float64 (tests/test_torch_bf16.py's)."""
    a, b, ref = (v.double() for v in (a, b, ref))
    return float((a - b).norm() / ref.norm())


def serving_profile(fn, x, seed):
    """One call of a loaded artifact under torch.profiler after a warm
    one: its device events (kernels and copies) and their summed device
    time (one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    fn(x, seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(x, seed)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.device_time_total > 0]
    return dict(device_events=len(dev),
                device_busy_ms=sum(e.device_time_total for e in dev) / 1e3)


def serving_tools(root):
    """generate and swap (the CLIs, in this process) at full dcgan width on
    a synthetic test set of SERVING_TOOL_VIDEOS videos: shapes, GIFs, swap's
    diagonal equal to generate's sample 0 and to the serving core, exact
    launch counts."""
    xp_dir, data_dir = seeded_xp(XP_CONFIG, "serving-dcgan",
                                 SERVING_TOOL_VIDEOS,
                                 XP_CONFIG["seq_len_test"], SEED + 42)
    # the conv kernels scaled (SERVING_CONV_GAIN): at a fresh init the
    # grid's cells would not differ
    weights = torch.load(xp_dir / "model.pt", weights_only=True)
    torch.save(structured(weights, XP_CONFIG["archi"]), xp_dir / "model.pt")
    n, nt_gen = SERVING_TOOL_VIDEOS, XP_CONFIG["seq_len_test"]
    flags = ["--xp_dir", str(xp_dir), "--data_dir", str(data_dir),
             "--model_name", "model.pt", "--n_videos", str(n)]
    gifs = root / "gifs"
    t0 = time.perf_counter()
    klaunches.reset()
    sgenerate.main(flags + ["--n_samples", "2", "--seed", str(SEED),
                            "--out", str(root / "samples.npz"),
                            "--gif_dir", str(gifs)])
    gen_counts = klaunches.counts()
    seed0 = counter_rng.fold_in(SEED, 0)
    klaunches.reset()
    sswap.main(flags + ["--seed", str(seed0), "--out",
                        str(root / "swap.npz"), "--gif",
                        str(root / "grid.gif")])
    swap_counts = klaunches.counts()
    tools_s = time.perf_counter() - t0
    expect_launches("generate", gen_counts, {"prior_rollout": 2})
    expect_launches("swap", swap_counts, {"prior_rollout": 1})
    samples = np.load(root / "samples.npz")["samples"]
    grid = np.load(root / "swap.npz")["grid"]
    # the serving core itself, on generate's frames and seed 0
    args = sgenerate.create_args().parse_args(flags)
    core, _, x_cond, nt_cond, _ = sgenerate.serving_core(args)
    with torch.no_grad(), cudnn_deterministic():
        eps = core.noise(torch.tensor(seed0, device="cuda"), n, nt_cond)
        pred = sgenerate.to_u8(core.predict(x_cond, eps)).transpose(0, 1)
    diag = np.stack([grid[i, i] for i in range(n)])
    row = dict(samples=list(samples.shape), grid=list(grid.shape),
               gifs=len(list(gifs.glob("*.gif"))),
               grid_gif_bytes=(root / "grid.gif").stat().st_size,
               diagonal_is_generate=bool(np.array_equal(diag, samples[0])),
               diagonal_is_core=bool(np.array_equal(diag,
                                                    pred.cpu().numpy())),
               off_diagonal_differs=bool(np.any(grid[0, 1] != grid[0, 0])),
               seconds=tools_s)
    print("serving_tools " + json.dumps(row), flush=True)
    if (row["samples"] != [2, n, nt_gen, 64, 64, 1]
            or row["grid"] != [n, n, nt_gen, 64, 64, 1]
            or row["gifs"] != 2 * n or not row["diagonal_is_generate"]
            or not row["diagonal_is_core"]
            or not row["off_diagonal_differs"]):
        raise SystemExit(f"serving tools: {row}")
    return row


def serving_path():
    """Phase 18: the serving export (SERVING_EXPORTS) on the card against
    the live serving core and the plain versions at SERVING_BATCHES,
    kernel 1 against its plain version at those batches, the same file on
    the CPU, the CPU-exported artifact on the card, launches, seeds,
    batches, the pinned batch, bench_serving's latencies on the dcgan and
    KTH bf16 artifacts with a profiled call, and the generate and swap
    tools. Returns the summary."""
    strict_fp32()
    root = WORK_DIR / "serving"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    arts, checks, rollouts = {}, {}, []
    for name, cfg, dtype, batch, device in SERVING_EXPORTS:
        fn, header, core, path, export_s, size, nodes = serving_artifact(
            root, name, cfg, dtype, batch, device)
        arts[name] = dict(fn=fn, header=header, path=path, device=device,
                          export_s=export_s, bytes=size, nodes=nodes[0],
                          srvp_nodes=nodes[1])
        if batch is None:
            checks[name] = serving_check(name, cfg, dtype, fn, core)
        if name in ("dcgan float32", "kth bfloat16"):
            # kernel 1 against its plain version at the serving batches,
            # their launch plans, the configuration's horizon
            o, m = cfg["n_euler_steps"], core.model
            for b in SERVING_BATCHES:
                rollouts.append(check_rollout(
                    f"serving {cfg['dataset']} B={b}", m.p_z.linears(),
                    m.dynamics.linears(), b,
                    o * (cfg["seq_len_test"] - cfg["nt_cond"]), o, m.cfg.ny,
                    m.cfg.nz, SEED + 44 + b))
        del core
    # one symbolic artifact at batches 1, 16 and 128; the pinned one,
    # exported on the CPU, at its batch (the same bits, kernel 1 once) and
    # not at another
    sym, pinned = arts["dcgan float32"]["fn"], \
        arts["dcgan float32 pinned"]["fn"]
    x = serving_frames(XP_CONFIG, max(SERVING_BATCHES), SEED + 43).cuda()
    nt_gen = XP_CONFIG["seq_len_test"]
    shapes = {b: list(sym(x[:, :b], 1).shape) for b in SERVING_BATCHES}
    klaunches.reset()
    pinned_out = pinned(x[:, :16], 1)
    pinned_counts = klaunches.counts()
    expect_launches("serving, the CPU-exported artifact on the card",
                    pinned_counts, {"prior_rollout": 1})
    same_pinned = torch.equal(pinned_out, sym(x[:, :16], 1))
    try:
        pinned(x[:, :8], 1)
        pinned_refuses = False
    except ValueError:
        pinned_refuses = True
    if any(s != [nt_gen, b, 64, 64, 1] for b, s in shapes.items()) \
            or not same_pinned or not pinned_refuses:
        raise SystemExit(f"serving batches {shapes}, pinned same bits "
                         f"{same_pinned}, refuses batch 8 {pinned_refuses}")
    # the fp32 dcgan file on the CPU and on the card, in a child process
    x2 = root / "x2.npy"
    np.save(x2, x[:, :2].cpu().numpy())
    proc = subprocess.run(
        [sys.executable, "-c", SERVING_CHILD,
         str(arts["dcgan float32"]["path"]), str(x2)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=CHILD_TIMEOUT_S)
    child = next((json.loads(ln.split(" ", 1)[1])
                  for ln in proc.stdout.splitlines()
                  if ln.startswith("serving_child ")), None)
    if proc.returncode or child is None:
        print(proc.stdout[-3000:] + proc.stderr[-3000:], flush=True)
        raise SystemExit(f"serving child failed (rc {proc.returncode})")
    print("serving_cpu_vs_card " + json.dumps(child), flush=True)
    if child["max_u8_diff"] > 1 or child["model_modules"] \
            or child["shape"] != [nt_gen, 2, 64, 64, 1]:
        raise SystemExit(f"serving: the file on the CPU and the card "
                         f"{child}")
    # bench_serving's timing of the bf16 artifacts; after both, one
    # profiled call at the smallest and the largest batch (no timing runs
    # after a profiler session)
    device = torch.device("cuda")
    served = (("dcgan bfloat16", "smmnist-dcgan", XP_CONFIG),
              ("kth bfloat16", "kth-vgg", KTH_CONFIG))
    latency = {}
    for name, config, _ in served:
        art = arts[name]
        latency[config] = dict(
            artifact_bytes=art["bytes"], export_s=art["export_s"],
            nodes=art["nodes"], srvp_nodes=art["srvp_nodes"],
            **sbench.time_artifact(art["fn"], art["header"],
                                   SERVING_BATCHES, SERVING_ITERS, device,
                                   config))
    for name, config, cfg in served:
        xb = serving_frames(cfg, max(SERVING_BATCHES), SEED + 45).cuda()
        for b in (min(SERVING_BATCHES), max(SERVING_BATCHES)):
            r = latency[config]["batches"][str(b)]
            prof = serving_profile(arts[name]["fn"], xb[:, :b], SERVING_SEED)
            prof["device_idle_share_at_p50"] = max(
                0.0, 1.0 - prof["device_busy_ms"]
                / r["device_latency_p50_ms"])
            r["profiled_call"] = prof
    # KTH at batch 1 timed again after the profiler sessions, beside the
    # reading before them
    again = sbench.time_artifact(arts["kth bfloat16"]["fn"],
                                 arts["kth bfloat16"]["header"], [1],
                                 SERVING_ITERS, device, "kth-vgg")
    print("serving_after_profiler " + json.dumps(dict(
        kth_batch1_p50_ms_before=latency["kth-vgg"]["batches"]["1"][
            "device_latency_p50_ms"],
        kth_batch1_p50_ms_after=again["batches"]["1"][
            "device_latency_p50_ms"])), flush=True)
    print("serving_latency " + json.dumps(dict(
        nvidia_smi=nvidia_smi_line(), iters=SERVING_ITERS,
        configs=latency)), flush=True)
    tools = serving_tools(root)
    summary = dict(
        exports={k: dict(bytes=v["bytes"], export_s=v["export_s"],
                         device=v["device"], nodes=v["nodes"])
                 for k, v in arts.items()},
        checks=checks, rollouts=rollouts, batches=shapes,
        pinned_refuses=pinned_refuses, cpu_vs_card=child, latency=latency,
        tools=tools, seconds=time.perf_counter() - t_phase)
    del arts
    torch.cuda.empty_cache()
    print(f"serving phase: {summary['seconds']:.1f} s", flush=True)
    return summary


# the data-parallel phase (19): the trainer and test_main through
# torch.distributed (srvp_tpu_torch/parallel). Arm (a): dcgan fp32 at full
# width through a process group of one rank under NCCL, against the run
# without one, and at --steps_per_dispatch 4 (the all-reduce captured in
# the window's graph); arm (b): two ranks on the one card under gloo (NCCL
# refuses two ranks on one device), dcgan fp32 at the global batch of (a)
# and KTH bf16; arm (c): phase 6's evaluation at --n_devices 2. The ranks'
# losses against one process's at DP_RTOL / DP_ATOL (tests/test_multihost.py
# :270-281: the gradient all-reduce and the batch sums add in another
# order). Their model.pt is held against the controls': one process under
# cuDNN's default (non-deterministic) algorithms, whose reductions too add
# in another order, run DP_CONTROLS times. After 8 steps a control reads
# 586 of that tolerance element by element and 3.2 in L2 norm (H100 80GB
# HBM3, 700 W; PERF.md): 8 Adam steps at full width do not keep the
# weights within it under another summation order, while the losses stay
# 1e-3 of it. So the ranks' model.pt must lie within DP_CONTROL_FACTOR of
# the farther control in L2 norm a tensor (the element-wise readings
# printed)
DP_STEPS, DP_K, DP_KTH_STEPS = 8, 4, 3
DP_FLAGS = ["--n_workers", "4", "--log_interval", "4"]
DP_RTOL, DP_ATOL = 1e-4, 1e-6
DP_RANKS, DP_CONTROLS, DP_CONTROL_FACTOR = 2, 2, 2.0
# the control's trainer: TRAINER_CHILD under cuDNN's default algorithms
DEFAULT_ALGOS_CHILD = TRAINER_CHILD.replace(
    "torch.backends.cudnn.deterministic = True",
    "torch.backends.cudnn.deterministic = False")


def free_port():
    """A TCP port of this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def group_flags(ranks, rank, port):
    """The trainer's flags of rank `rank` of an explicit group of
    `ranks`; more than one rank shares cuda:0 (and so gloo)."""
    flags = ["--coordinator_address", f"localhost:{port}",
             "--num_processes", str(ranks), "--process_id", str(rank)]
    return flags + (["--device", "cuda:0"] if ranks > 1 else [])


def rows_distance(ref_rows, rows):
    """The worst |loss - ref| / (DP_ATOL + DP_RTOL |ref|) over the logged
    steps (which must be the same), and whether every loss is bit-equal."""
    if [r["step"] for r in rows] != [r["step"] for r in ref_rows]:
        raise SystemExit(f"logged steps {[r['step'] for r in rows]} against "
                         f"{[r['step'] for r in ref_rows]}")
    ratio = max(abs(b["loss"] - a["loss"])
                / (DP_ATOL + DP_RTOL * abs(a["loss"]))
                for a, b in zip(ref_rows, rows))
    return ratio, all(a["loss"] == b["loss"] for a, b in zip(ref_rows, rows))


def eval_rows_probe(device="cuda"):
    """Phase 6's dcgan chunk (16 videos x 10 samples, seeded weights and
    inputs) on the card under cuDNN's deterministic algorithms, at one
    rank's rows (all 16 videos) against rank 1's 8 alone, step by step on
    the same inputs: whether each step of the evaluation gives the same
    bits for those rows at the other row count."""
    cfg = model_config(XP_CONFIG)
    torch.manual_seed(SEED)
    model = SRVP(cfg).to(device).eval()
    gen = torch.Generator(device=device).manual_seed(SEED)
    nt_cond, nt = XP_CONFIG["nt_cond"], XP_CONFIG["seq_len_test"]
    x = torch.rand(nt, BATCH, 64, 64, 1, generator=gen, device=device)
    eps = eval_lib.chunk_noise(cfg, BATCH, CHUNK, nt_cond, nt, 1, 1, gen,
                               device)
    vids, rows = slice(BATCH // 2, BATCH), slice(BATCH // 2 * CHUNK,
                                                 BATCH * CHUNK)
    eps_half = (eps[0][rows], eps[1][:, rows], eps[2][:, rows])
    same = {}
    with torch.no_grad(), cudnn_deterministic():
        hx, _ = model.encode(x[:nt_cond])
        same["encoder (cuDNN convs)"] = torch.equal(
            hx[:, vids], model.encode(x[:nt_cond, vids])[0])
        w = model.infer_w(hx)
        same["infer_w (nn.Linear, cuBLAS)"] = torch.equal(
            w[vids], model.infer_w(hx[:, vids]))
        # each step of sample_latents on the whole batch's inputs to it
        hx_z = lstm_apply(model.inf_z, hx)
        same["z-LSTM (cuDNN LSTM)"] = torch.equal(
            hx_z[:, vids], lstm_apply(model.inf_z, hx[:, vids]))
        hx_f = eval_lib.fold(hx, CHUNK, 1)[:cfg.nt_inf]
        y_0 = model.infer_y(hx_f, eps[0])[0]
        same["infer_y (nn.Linear MLP)"] = torch.equal(
            y_0[rows], model.infer_y(hx_f[:, rows], eps_half[0])[0])
        hx_zf = eval_lib.fold(hx_z, CHUNK, 1)
        y_inf = model.generate(y_0, None, nt_cond, eps_pos=eps[1],
                               hx_z=hx_zf).y
        same["posterior rollout (eager, nn.Linear)"] = torch.equal(
            y_inf[:, rows], model.generate(y_0[rows], None, nt_cond,
                                           eps_pos=eps_half[1],
                                           hx_z=hx_zf[:, rows]).y)
        y_gen = model.generate_prior(y_inf[-1], nt - nt_cond + 1,
                                     eps=eps[2]).y
        same["prior rollout (kernel 1)"] = torch.equal(
            y_gen[:, rows], model.generate_prior(
                y_inf[-1, rows], nt - nt_cond + 1, eps=eps_half[2]).y)
        whole = eval_lib.sample_latents(model, x[:nt_cond], CHUNK,
                                        nt - nt_cond + 1, 1, 1, eps)
        half = eval_lib.sample_latents(model, x[:nt_cond, vids], CHUNK,
                                       nt - nt_cond + 1, 1, 1, eps_half)
        same["latents (all of sample_latents)"] = torch.equal(
            whole[2][:, rows], half[2])
        w_f = eval_lib.fold(whole[0], CHUNK, 0)
        pred = model.decode(w_f, whole[2][1:], None).float()
        same["decoder (cuDNN convTs, first nn.Linear)"] = torch.equal(
            pred[:, rows], model.decode(w_f[rows], whole[2][1:, rows],
                                        None).float())
        target = eval_lib.fold(x[nt_cond:], CHUNK, 1)
        same["SSIM (depthwise F.conv2d, means)"] = torch.equal(
            video_ssim(pred, target)[:, rows],
            video_ssim(pred[:, rows], target[:, rows]))
    return {k: bool(v) for k, v in same.items()}


def dp_ms_per_step(rows, frames):
    """ms per step of the last logged row (its window of steps)."""
    return 1e3 * frames / rows[-1]["fps"]


def dp_children(runs):
    """TrainerChild of each (name, argv[, script]) at once; their results
    by name."""
    children = [(name, TrainerChild(*run)) for name, *run in runs]
    return {name: child.result() for name, child in children}


def dp_check_child(name, result, want_rc, opt, n_steps, n_vals):
    """Exit status and exact launches of one trainer child (a rank)."""
    rc, lines, counts, _ = result
    if rc != want_rc:
        print("\n".join(lines[-40:]), flush=True)
        raise SystemExit(f"data parallel, {name}: exit status {rc}")
    expect_launches(f"data parallel, {name}", counts["launches"],
                    train_launches(opt, n_steps, n_vals))
    return counts["launches"]


def test_main_child(xp_dir, data_dir, extra, log):
    """test_main on the dcgan protocol of phase 6 in a child process with
    cuDNN deterministic (test_main's own), killed after CHILD_TIMEOUT_S."""
    argv = [sys.executable, "-m", "srvp_tpu_torch.test_main", "--xp_dir",
            str(xp_dir), "--data_dir", str(data_dir), "--batch_size",
            str(BATCH), "--n_samples", str(N_SAMPLES), "--samples_chunk",
            str(CHUNK), "--nt_gen", str(XP_CONFIG["seq_len_test"]),
            "--model_name", "model.pt", *extra]
    with open(log, "w") as out:
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return proc


def wait_child(proc, log, what):
    try:
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    if rc != 0:
        print(Path(log).read_text()[-4000:], flush=True)
        raise SystemExit(f"data parallel, {what}: exit status {rc}")


def data_parallel_path():
    """Phase 19 (the module docstring). Returns its summary."""
    t_phase = time.perf_counter()
    data = WORK_DIR / "data_smmnist-dcgan"
    kdata = WORK_DIR / "data_kth-vgg"
    for d in (data, kdata):
        d.mkdir(parents=True, exist_ok=True)
    if not (kdata / "packed_64").exists():
        write_kth_packed_tree(kdata, KTH_CONFIG["nx"], SEED + 4)
    controls = [f"control{c}" for c in range(DP_CONTROLS)]
    dirs = {k: WORK_DIR / f"dp_{k}" for k in [
        "plain", "nccl", "nccl_k4", "gloo2_dcgan", "gloo2_kth", "kth"]
        + controls}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)

    def argv(kind, *extra, cfg=XP_CONFIG, n_steps=DP_STEPS,
             batch_size=TRAIN_BATCH, precision="float32"):
        return (train_argv(str(dirs[kind]), str(kdata if cfg is KTH_CONFIG
                                                 else data), n_steps,
                           cfg=cfg, batch_size=batch_size,
                           precision=precision) + DP_FLAGS + list(extra))
    kth = dict(cfg=KTH_CONFIG, n_steps=DP_KTH_STEPS,
               batch_size=KTH_TRAIN_BATCH, precision="bfloat16")
    opt = train_main.create_args().parse_args(argv("plain"))
    kopt = train_main.create_args().parse_args(argv("gloo2_kth", **kth))
    # (a), each run alone on the card (their ms per step are compared)
    runs = dp_children([("plain", argv("plain"))])
    runs.update(dp_children([("nccl", argv("nccl",
                                          *group_flags(1, 0, free_port())))]))
    # (a) at K = 4, (b) and the controls side by side; then (b) at KTH
    # beside one process (together about 50 GB) and (c)
    port_d, port_k = free_port(), free_port()
    runs.update(dp_children(
        [("nccl_k4", argv("nccl_k4", *group_flags(1, 0, free_port()),
                          "--steps_per_dispatch", str(DP_K)))]
        + [(c, argv(c), None, DEFAULT_ALGOS_CHILD) for c in controls]
        # rank 1 writes nothing: its save path is rank 0's
        + [(f"gloo2_dcgan_{r}", argv("gloo2_dcgan", *group_flags(
            DP_RANKS, r, port_d))) for r in range(DP_RANKS)]))
    # (c) phase 6's evaluation, one rank against two, beside the KTH wave
    xp_dir, data_dir = seeded_xp(XP_CONFIG, "smmnist-dcgan", N_VIDEOS,
                                 XP_CONFIG["seq_len_test"], SEED)
    evals = {}
    for k, extra in (("one", []), ("two", ["--n_devices", str(DP_RANKS),
                                           "--device", "cuda:0"])):
        d = WORK_DIR / f"dp_eval_{k}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(xp_dir, d)
        evals[k] = (d, WORK_DIR / f"dp_eval_{k}.log",)
        evals[k] += (test_main_child(d, data_dir, extra, evals[k][1]),)
    try:
        runs.update(dp_children(
            [("kth", argv("kth", "--log_interval", "1", **kth))]
            + [(f"gloo2_kth_{r}", argv("gloo2_kth", *group_flags(
                DP_RANKS, r, port_k), "--log_interval", "1", **kth))
               for r in range(DP_RANKS)]))
        for k, (d, log, proc) in evals.items():
            wait_child(proc, log, f"test_main {k}")
    finally:
        for _, _, proc in evals.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    launches = {}
    for name in ["plain", "nccl", "nccl_k4"] + controls + [
            f"gloo2_dcgan_{r}" for r in range(DP_RANKS)]:
        launches[name] = dp_check_child(name, runs[name], 0, opt, DP_STEPS, 1)
    for name in ("kth",) + tuple(f"gloo2_kth_{r}" for r in range(DP_RANKS)):
        launches[name] = dp_check_child(name, runs[name], 0, kopt,
                                        DP_KTH_STEPS, 1)
    for name, backend in (("nccl", "1 ranks, cpu:gloo,cuda:nccl"),
                          ("nccl_k4", "1 ranks, cpu:gloo,cuda:nccl"),
                          ("gloo2_dcgan_0", "2 ranks, gloo"),
                          ("gloo2_kth_0", "2 ranks, gloo")):
        if not any(backend in line for line in runs[name][1]):
            raise SystemExit(f"data parallel, {name}: no '{backend}' group")

    rows = {k: training_rows(d) for k, d in dirs.items()}
    frames = TRAIN_BATCH * XP_CONFIG["seq_len"]
    a_losses = rows_distance(rows["plain"], rows["nccl"])
    a_model = model_distance(dirs["plain"] / "model.pt",
                             dirs["nccl"] / "model.pt")
    k_losses = rows_distance(rows["nccl"], rows["nccl_k4"])
    k_model = model_distance(dirs["nccl"] / "model.pt",
                             dirs["nccl_k4"] / "model.pt")
    b_losses = rows_distance(rows["plain"], rows["gloo2_dcgan"])
    b_model = model_distance(dirs["plain"] / "model.pt",
                             dirs["gloo2_dcgan"] / "model.pt", DP_RTOL,
                             DP_ATOL)
    c_losses = [rows_distance(rows["plain"], rows[c])[0] for c in controls]
    c_models = [model_distance(dirs["plain"] / "model.pt",
                               dirs[c] / "model.pt", DP_RTOL, DP_ATOL)
                for c in controls]
    floor = max(m["norm_ratio"] for m in c_models)
    kth_losses = [r["loss"] for r in rows["gloo2_kth"]]
    kth_one_losses = [r["loss"] for r in rows["kth"]]
    for r in range(1, DP_RANKS):
        if any(line.startswith(f"[{DP_STEPS}/")
               for line in runs[f"gloo2_dcgan_{r}"][1]):
            raise SystemExit("data parallel: rank 1 printed a log line")

    # kernels 2-3 at the rank's shape (B = 64), against the plain version
    cfg = model_config(XP_CONFIG)
    torch.manual_seed(SEED)
    model = SRVP(cfg).cuda().eval()
    rank_row = check_train_rollout(
        "per-rank training step", (model.q_z.weight, model.q_z.bias),
        model.p_z.linears(), model.dynamics.linears(),
        TRAIN_BATCH // DP_RANKS, XP_CONFIG["seq_len"] - 1, 1, SEED + 19)
    del model

    probe = eval_rows_probe()
    if "2 ranks, gloo" not in evals["two"][1].read_text():
        raise SystemExit("data parallel: test_main --n_devices 2 made no "
                         "group of 2 ranks")
    names = ["results", "cond_rec"] + [
        f"{m}_{w}" for m in ("psnr", "ssim") for w in ("best", "worst")] \
        + [f"random_{i}" for i in range(1, 6)]
    eval_diff = dict(bit_equal=True, max_u8=0, max_rel=0.0, differ={})
    for name in names:
        ref, got = (np.load(evals[k][0] / f"{name}.npz")
                    for k in ("one", "two"))
        for f in ref.files:
            a, b = ref[f], got[f]
            if a.shape != b.shape or a.shape[0] != N_VIDEOS:
                raise SystemExit(f"data parallel, {name}:{f}: {b.shape} "
                                 f"against {a.shape}")
            if np.array_equal(a, b):
                continue
            eval_diff["bit_equal"] = False
            eval_diff["differ"][f"{name}:{f}"] = int(np.sum(a != b))
            if a.dtype == np.uint8:
                eval_diff["max_u8"] = max(eval_diff["max_u8"], int(
                    np.abs(a.astype(np.int16) - b).max()))
            else:
                eval_diff["max_rel"] = max(eval_diff["max_rel"], float(
                    (np.abs(a - b) / np.abs(a)).max()))

    kth_frames = KTH_TRAIN_BATCH * KTH_CONFIG["seq_len"]
    summary = dict(
        steps=DP_STEPS, k=DP_K, launches=launches,
        nccl_world1=dict(losses_bit_equal=a_losses[1],
                         model_pt_tensors_differ=a_model["differ"],
                         ms_per_step=dp_ms_per_step(rows["nccl"], frames),
                         plain_ms_per_step=dp_ms_per_step(rows["plain"],
                                                          frames)),
        nccl_k4=dict(losses_bit_equal=k_losses[1],
                     model_pt_tensors_differ=k_model["differ"],
                     ms_per_step=dp_ms_per_step(rows["nccl_k4"], frames)),
        gloo2_dcgan=dict(loss_ratio=b_losses[0], model=b_model,
                         ms_per_step=dp_ms_per_step(rows["gloo2_dcgan"],
                                                    frames)),
        controls_default_algos=dict(loss_ratios=c_losses, models=c_models,
                                    model_limit=DP_CONTROL_FACTOR * floor),
        gloo2_kth_bf16=dict(losses=kth_losses, ms_per_step=dp_ms_per_step(
            rows["gloo2_kth"], kth_frames), one_process_losses=kth_one_losses,
            one_process_ms_per_step=dp_ms_per_step(rows["kth"], kth_frames)),
        rows_probe=probe,
        rank_rollout=dict(B=rank_row["B"], fwd_ms=rank_row["kernel_fwd_ms"],
                          bwd_ms=rank_row["kernel_bwd_ms"],
                          fwd_max_abs_err=rank_row["fwd_max_abs_err"],
                          bwd_max_abs_err=rank_row["bwd_max_abs_err"]),
        evaluation=eval_diff, seconds=time.perf_counter() - t_phase)
    print("data_parallel_path " + json.dumps(summary), flush=True)
    a, k4, b = (summary[k] for k in ("nccl_world1", "nccl_k4",
                                      "gloo2_dcgan"))
    same = {k: v["losses_bit_equal"] and not v["model_pt_tensors_differ"]
            for k, v in (("a", a), ("k4", k4))}
    print(f"data parallel (a): NCCL at one rank "
          f"{'bit-equal' if same['a'] else 'DIFFERS'}"
          f" to the run without a group, {a['ms_per_step']:.3f} against "
          f"{a['plain_ms_per_step']:.3f} ms per step (each alone on the "
          f"card); K={DP_K} under NCCL "
          f"{'bit-equal' if same['k4'] else 'DIFFERS'}"
          f" to K=1, {k4['ms_per_step']:.3f} ms per step (beside (b)'s "
          f"ranks)", flush=True)
    bm = b["model"]
    controls_read = "; ".join(
        f"losses {lr:.4f}, L2 {m['norm_ratio']:.4f}, element by element "
        f"{m['ratio']:.1f} ({m['past']} past, at most {m['abs']:.3e} "
        f"apart)" for lr, m in zip(c_losses, c_models))
    print(f"data parallel (b): 2 gloo ranks on one card (not a speed "
          f"figure): dcgan fp32 losses {b['loss_ratio']:.4f} of rtol "
          f"{DP_RTOL} / atol {DP_ATOL} from one process, model.pt "
          f"{bm['norm_ratio']:.4f} of it in L2 norm ({bm['worst_tensor']}; "
          f"limit {DP_CONTROL_FACTOR * floor:.4f}); element by element "
          f"{bm['ratio']:.1f} ({bm['past']} elements past it, at most "
          f"{bm['abs']:.3e} apart); the controls, one process under "
          f"cuDNN's default algorithms: {controls_read}; "
          f"{b['ms_per_step']:.3f} ms per "
          f"step; KTH bf16 losses {kth_losses} (one process "
          f"{kth_one_losses}), "
          f"{summary['gloo2_kth_bf16']['ms_per_step']:.3f} ms per step (one "
          f"process {summary['gloo2_kth_bf16']['one_process_ms_per_step']:.3f}"
          f", side by side); kernels 2-3 at B={rank_row['B']}: forward "
          f"{rank_row['kernel_fwd_ms']:.4f} ms, backward "
          f"{rank_row['kernel_bwd_ms']:.4f} ms", flush=True)
    print(f"data parallel (c): test_main at 2 gloo ranks "
          f"{'bit-equal' if eval_diff['bit_equal'] else 'differs'} to one "
          f"rank (max {eval_diff['max_u8']} uint8 levels, metrics "
          f"{eval_diff['max_rel']:.3e} relative; {eval_diff['differ']}); "
          f"at 16 videos against rank 1's 8 alone, the same bits: "
          f"{probe}; "
          f"phase {summary['seconds']:.1f} s", flush=True)
    if not same["a"]:
        raise SystemExit(f"data parallel (a): NCCL at one rank differs from "
                         f"the run without a group ({a_losses}, {a_model})")
    if not same["k4"]:
        raise SystemExit(f"data parallel (a): K={DP_K} under NCCL differs "
                         f"from K=1 ({k_losses}, {k_model})")
    if b["loss_ratio"] > 1 or bm["norm_ratio"] > DP_CONTROL_FACTOR * floor:
        raise SystemExit(f"data parallel (b): two ranks are not within the "
                         f"tolerance of one process ({b_losses}, {b_model})")
    if len(kth_losses) != DP_KTH_STEPS or not np.all(np.isfinite(kth_losses)):
        raise SystemExit(f"data parallel (b): KTH bf16 losses {kth_losses}")
    if eval_diff["max_u8"] > 1 or eval_diff["max_rel"] > 1e-5:
        raise SystemExit(f"data parallel (c): two ranks' evaluation is not "
                         f"within the rank-count tolerance ({eval_diff})")
    return summary


# the data tools phase (20): the loader bench (srvp_tpu_torch.bench_loader)
# at the training shapes on trees of natural video's noise (noise_amp 14),
# 3 timed batches a leg at 1 and 4 threads, its step leg in bf16 on the four
# configurations, LOADER_WARMUP + LOADER_STEPS steps each; then a KTH test
# set of KTH_TEST_SET windows of the test persons' videos
LOADER_WARMUP, LOADER_STEPS = 3, 6
LOADER_BENCH_ARGS = ["--noise_amp", "14", "--n_batches", "3", "--workers",
                     "1,4", "--warmup", str(LOADER_WARMUP), "--steps",
                     str(LOADER_STEPS), "--precision", "bfloat16"]
KTH_TEST_SET = dict(n_frames=24, size=32, seq_len=20)


def data_tools_path():
    """Phase 20 (the module docstring). Returns the bench's rows and the
    step leg's launches."""
    from srvp_tpu_torch import bench_loader
    from srvp_tpu_torch.data import native, synthetic, test_sets
    from srvp_tpu_torch.data.bair import BAIR
    from srvp_tpu_torch.data.kth import KTH
    t_phase = time.perf_counter()
    root = WORK_DIR / "data_tools"
    shutil.rmtree(root, ignore_errors=True)
    klaunches.reset()
    rows = bench_loader.main(LOADER_BENCH_ARGS + ["--root",
                                                  str(root / "bench")])
    counts = klaunches.counts()
    steps = LOADER_WARMUP + LOADER_STEPS
    vgg = 4 * steps * sum(c["kwargs"]["archi"] == "vgg" for c in (
        bench_loader.step_config(n) for n in bench_loader.CONFIG_FILES))
    expect_launches("data tools path (the loader bench's step leg)", counts,
                    dict(train_rollout_fwd=4 * steps,
                         train_rollout_bwd=8 * steps,
                         maxpool_fwd_bf16=vgg, maxpool_bwd_bf16=vgg,
                         upsample_fwd_bf16=vgg, upsample_bwd_bf16=vgg))
    kind = torch.cuda.get_device_name(0)
    for row in rows:
        name = row["metric"].rsplit("_", 1)[-1]
        c = bench_loader.step_config(name)
        rates = [v for legs in row["legs"].values() for v in legs.values()]
        if not (row["batches_agree"] and row["device"] == kind
                and row["device_rate_source"] == "measured"
                and (row["batch"], row["seq_len"]) == (c["batch"],
                                                       c["seq_len"])
                and len(row["legs"]) == 2
                and np.all(np.isfinite(rates + [row["device_rate"]]))
                and min(rates) > 0 and row["device_rate"] > 0):
            raise SystemExit(f"data tools: loader bench row {row}")
    # the packed trees the bench wrote, read back through the datasets
    bench_root = Path(rows[0]["root"])
    for ds, n in ((KTH.make_dataset(str(bench_root), 64, 20, True),
                   synthetic.BENCH_KTH_VIDEOS),
                  (BAIR.make_dataset(str(bench_root), 12, True),
                   synthetic.BENCH_BAIR_VIDEOS)):
        if not ds.packed or len(ds.data) != n:
            raise SystemExit(f"data tools: packed tree of {len(ds.data)} "
                             f"videos (packed {ds.packed}), expected {n}")
    # a KTH test set of the test persons, through the native decoder and
    # through the plain one, read back by KTH's test fold
    t0 = time.perf_counter()
    kth_test = root / "kth_test"
    synthetic.write_kth_test_videos(kth_test, KTH_TEST_SET["n_frames"],
                                    noise_amp=14,
                                    processes=len(os.sched_getaffinity(0)))
    size, seq_len = KTH_TEST_SET["size"], KTH_TEST_SET["seq_len"]
    before = native.decoded["frames"]
    path = Path(test_sets.make_kth_test_set(str(kth_test), size, seq_len))
    decoded = native.decoded["frames"] - before
    with np.load(path) as arc:
        made = {k: arc[k] for k in arc.files}
    path.rename(kth_test / "native.npz")
    test_sets.make_kth_test_set(str(kth_test), size, seq_len, plain=True)
    with np.load(path) as arc:
        plain = {k: arc[k] for k in arc.files}
    fold = KTH.make_dataset(str(kth_test), 64, seq_len, train=False)
    seqs = made["sequences"]
    if not (seqs.shape == (size, seq_len, 64, 64) and seqs.dtype == np.uint8
            and decoded == size * seq_len and len(fold) == size
            and all(np.array_equal(made[k], plain[k]) for k in made)
            and all(np.array_equal(fold.get_item(i), seqs[i])
                    for i in range(size))
            and set(made["persons"]) <= set(range(21, 26))):
        raise SystemExit(f"data tools: KTH test set {seqs.shape} "
                         f"{seqs.dtype}, {decoded} frames decoded")
    print(f"data tools: KTH test set of {size} x {seq_len} frames "
          f"({len(fold)} read back, native and plain decoders equal) in "
          f"{time.perf_counter() - t0:.1f} s; step leg launches {counts}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows, counts


# the offline-drop phase (21): a drop in the official layout
# (srvp_tpu_torch/verify_artifacts.py) assembled with the port's writers,
# verified and its manifest re-checked by the CLI in child processes, two
# planted faults, the BAIR tree converted from TFRecords read back, then the
# KTH checkpoint evaluated from the drop with LPIPS and FVD (DROP_VIDEOS
# videos, DROP_SAMPLES samples)
DROP_VIDEOS, DROP_SAMPLES = 16, 20
# BAIR's download in the drop: train and test videos, records a file
DROP_BAIR = dict(n_train=2, n_test=6, per_file=2)
DROP_ARTIFACTS = ["lpips-linear-heads", "i3d-kinetics400",
                  "smmnist-test-set", "kth-test-set", "alexnet-backbone",
                  "mnist-idx", "checkpoint:kth", "bair-test-set"]


def verify_cli(drop, *flags):
    """The drop checker's CLI in a child process: (exit code, its JSON
    lines)."""
    proc = subprocess.run(
        [sys.executable, "-m", "srvp_tpu_torch.verify_artifacts", "--drop",
         str(drop), *flags], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=CHILD_TIMEOUT_S)
    try:
        rows = [json.loads(ln) for ln in proc.stdout.splitlines()]
    except ValueError:
        rows = None
    if rows is None or not rows:
        print(proc.stdout[-3000:] + proc.stderr[-3000:], flush=True)
        raise SystemExit(f"verify_artifacts {flags}: rc {proc.returncode}, "
                         "no JSON rows")
    return proc.returncode, rows


def verify_in_process(drop, *flags):
    """The drop checker's main in this process: (exit code, JSON lines)."""
    from srvp_tpu_torch import verify_artifacts
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = verify_artifacts.main(["--drop", str(drop), *flags])
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()]


def write_drop(drop):
    """The drop, written by the port's own writers: LPIPS and AlexNet
    weights, the I3D npz, the seeded KTH checkpoint, KTH's test set by
    test_sets kth over a synthetic tree of the test persons, the synthetic
    glyph set by test_sets synthetic, an MNIST IDX file, and BAIR's PNG
    tree by data.convert from TFRecords. Returns the videos put in the
    TFRecords, {(fold, file stem, k): video}."""
    from srvp_tpu_torch.data import convert, synthetic, test_sets
    from srvp_tpu_torch.data.mmnist import synthetic_digits
    write_lpips_weights(drop / "lpips", SEED + 50)
    (drop / "i3d").mkdir(parents=True)
    write_i3d_weights(drop / "i3d" / "i3d_kinetics400.npz", SEED + 51)
    xp_dir, _ = seeded_xp(KTH_CONFIG, "drop-kth", DROP_VIDEOS, KTH_NT_GEN,
                          SEED + 52, test_set=False)
    shutil.copytree(xp_dir, drop / "checkpoints" / "kth")
    ds = drop / "datasets"
    kth_tree = WORK_DIR / "drop_kth_tree"
    synthetic.write_kth_test_videos(kth_tree, KTH_NT_GEN + 4, noise_amp=14,
                                    processes=len(os.sched_getaffinity(0)))
    made = test_sets.main(["kth", "--data_dir", str(kth_tree), "--size",
                           str(DROP_VIDEOS), "--seq_len", str(KTH_NT_GEN)])
    ds.mkdir(parents=True)
    shutil.move(made, ds / f"svg_test_set_{KTH_NT_GEN}.npz")
    test_sets.main(["synthetic", "--data_dir", str(ds), "--n_videos",
                    str(DROP_VIDEOS)])
    (drop / "mnist").mkdir()
    digits = np.stack(synthetic_digits(16, np.random.RandomState(SEED + 53)))
    with gzip.open(drop / "mnist" / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, *digits.shape) + digits.tobytes())
    videos = synthetic.write_bair_download(ds / "bair", **DROP_BAIR)
    convert.main(["bair", "--data_dir", str(ds / "bair")])
    return videos


def flip_tensor_byte(path):
    """Flips the lowest bit of the first value of the first tensor in a
    torch file (a finite value stays finite); returns the byte's offset."""
    sd = torch.load(path, weights_only=True)
    first = next(iter(sd.values())).contiguous().numpy().tobytes()
    data = bytearray(path.read_bytes())
    pos = data.find(first)
    if pos < 0:
        raise SystemExit(f"{path}: tensor bytes not found")
    data[pos] ^= 1
    path.write_bytes(bytes(data))
    return pos


def offline_drop_path():
    """Phase 21 (the module docstring). Returns the evaluation's launches
    and the summary."""
    from srvp_tpu_torch.data import native
    from srvp_tpu_torch.data.bair import BAIR
    t_phase = time.perf_counter()
    drop = WORK_DIR / "drop"
    for d in (drop, WORK_DIR / "drop_bad", WORK_DIR / "drop_kth_tree"):
        shutil.rmtree(d, ignore_errors=True)
    videos = write_drop(drop)
    t_written = time.perf_counter() - t_phase

    # 1-2: the CLI records the manifest, then re-checks the drop against it
    manifest = WORK_DIR / "drop_manifest.json"
    rc, rows = verify_cli(drop, "--manifest", str(manifest))
    artifacts = [r for r in rows if "artifact" in r]
    if rc or [r["artifact"] for r in artifacts] != DROP_ARTIFACTS or any(
            r["status"] != "ok" for r in artifacts):
        raise SystemExit(f"verify_artifacts on the drop: rc {rc}, {rows}")
    rc_check, check_rows = verify_cli(drop, "--check_manifest",
                                      str(manifest))
    checked = [r["manifest_check"] for r in check_rows
               if "manifest_check" in r]
    if rc_check or len(checked) != len(DROP_ARTIFACTS) or any(
            r["status"] != "ok" for r in checked):
        raise SystemExit(f"--check_manifest: rc {rc_check}, {check_rows}")
    # 3: one byte of alex.pth flipped reads CHANGED; the byte restored
    alex = drop / "lpips" / "alex.pth"
    pristine = alex.read_bytes()
    flip_tensor_byte(alex)
    rc_flip, flip_rows = verify_in_process(drop, "--check_manifest",
                                           str(manifest), "--device", "cuda")
    alex.write_bytes(pristine)
    flipped = {r["manifest_check"]["path"]: r["manifest_check"]["status"]
               for r in flip_rows if "manifest_check" in r}
    if rc_flip != 1 or flipped.pop("lpips/alex.pth") != "CHANGED" or set(
            flipped.values()) != {"ok"}:
        raise SystemExit(f"flipped byte of alex.pth: rc {rc_flip}, "
                         f"{flip_rows}")
    # 4: a truncated copy of model.pt reads INVALID
    bad = WORK_DIR / "drop_bad" / "checkpoints" / "kth"
    shutil.copytree(drop / "checkpoints" / "kth", bad)
    data = (bad / "model.pt").read_bytes()
    (bad / "model.pt").write_bytes(data[:len(data) // 2])
    rc_bad, bad_rows = verify_in_process(bad.parent.parent, "--device",
                                         "cuda")
    if rc_bad != 1 or [r.get("status") for r in bad_rows[:1]] != [
            "INVALID"] or bad_rows[0]["artifact"] != "checkpoint:kth":
        raise SystemExit(f"truncated model.pt: rc {rc_bad}, {bad_rows}")

    # 5: the converted BAIR tree through the BAIR loader and the native PNG
    # decoder, bit for bit the videos put into the TFRecords
    fold = BAIR.make_dataset(str(drop / "datasets" / "bair"), 30, False)
    want = [videos[k] for k in sorted(k for k in videos if k[0] == "test")]
    before = native.decoded["frames"]
    got = fold.get_batch_seeded(list(range(len(fold))), [0] * len(fold))
    decoded = native.decoded["frames"] - before
    frames = [Path(p) for v in fold.data for p in v]
    frame_bytes = float(np.mean([p.stat().st_size for p in frames]))
    equal = got.shape == (len(want), 30, 64, 64, 3) and np.array_equal(
        got, np.stack(want))
    if fold.packed or len(fold) != len(want) or decoded != 30 * len(want) \
            or not equal:
        raise SystemExit(f"converted BAIR tree: {len(fold)} videos, "
                         f"{decoded} frames decoded, equal {equal}")

    # 6: the README's drop recipe: test_main on the verified drop
    i3d_path = drop / "i3d" / "i3d_kinetics400.npz"
    with mock.patch.dict(os.environ, SRVP_TPU_I3D_WEIGHTS=str(i3d_path)):
        ev = metrics_cli(KTH_CONFIG, drop / "checkpoints" / "kth",
                         drop / "datasets", KTH_NT_GEN, DROP_VIDEOS,
                         DROP_SAMPLES, ("--lpips_dir", str(drop / "lpips"),
                                        "--fvd"))
    counts = klaunches.counts()
    summary = dict(
        artifacts=len(artifacts), manifest_rows=len(checked),
        flipped="CHANGED", truncated="INVALID",
        bair=dict(videos=len(want), frames=len(frames),
                  mean_frame_bytes=frame_bytes,
                  tfrecord_bytes=sum(p.stat().st_size for p in (
                      drop / "datasets" / "bair").rglob("*.tfrecords"))),
        evaluation=dict(videos=DROP_VIDEOS, samples=DROP_SAMPLES,
                        s_per_batch=ev[1][0], wall_s=ev[2], fvd=ev[3],
                        lpips_mean=float(ev[0]["results"]["lpips"].mean()),
                        launches=counts),
        write_s=t_written, seconds=time.perf_counter() - t_phase)
    print("offline_drop " + json.dumps(summary), flush=True)
    print(f"offline drop: {len(artifacts)} artifacts ok, manifest re-checked, "
          f"a flipped byte CHANGED, a truncated model.pt INVALID; BAIR "
          f"{len(frames)} converted frames of {frame_bytes:.1f} bytes on "
          f"average, bit-equal through the native decoder; KTH evaluation "
          f"from the drop {ev[1][0]:.3f} s per batch of {DROP_VIDEOS} x "
          f"{DROP_SAMPLES} samples with LPIPS and FVD; phase "
          f"{summary['seconds']:.1f} s", flush=True)
    return counts, summary


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
    summary = eval_path(XP_CONFIG, N_VIDEOS, XP_CONFIG["seq_len_test"], SEED,
                        default_algos=True)
    train_summary = train_path(
        XP_CONFIG, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_BATCH, TRAIN_BATCH,
        WORK_DIR / "data_smmnist-dcgan", XP_CONFIG["seq_len_test"],
        parity.KINK_MARGIN, DCGAN_STEP_HELD)
    kth_summary = eval_path(KTH_CONFIG, KTH_VIDEOS, KTH_NT_GEN, SEED,
                            default_algos=True)
    kth_train = train_path(
        KTH_CONFIG, KTH_TRAIN_STEPS, KTH_TRAIN_WARMUP, KTH_TRAIN_BATCH,
        KTH_CHECK_VIDEOS, WORK_DIR / "data_kth-vgg", KTH_NT_GEN,
        KTH_KINK_MARGIN, KTH_STEP_HELD, check="both")
    # the trainer in bfloat16 (--precision bfloat16) on both models, then
    # the port's bench at reduced steps
    torch.cuda.empty_cache()
    train_bf16 = train_path(
        XP_CONFIG, TRAIN_STEPS_BF16, TRAIN_WARMUP_BF16, TRAIN_BATCH,
        TRAIN_BATCH, WORK_DIR / "data_smmnist-dcgan",
        XP_CONFIG["seq_len_test"], parity.KINK_MARGIN, BF16_STEP_HELD,
        check="seeded", precision="bfloat16")
    torch.cuda.empty_cache()
    kth_train_bf16 = train_path(
        KTH_CONFIG, KTH_TRAIN_STEPS_BF16, KTH_TRAIN_WARMUP_BF16,
        KTH_TRAIN_BATCH, KTH_CHECK_VIDEOS, WORK_DIR / "data_kth-vgg",
        KTH_NT_GEN, KTH_KINK_MARGIN, BF16_STEP_HELD, check="seeded",
        precision="bfloat16")
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
    # the datasets: BAIR and Human3.6M at their published widths, KTH's
    # PNG tree, through the native PNG decoder
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    datasets_path()
    print(f"datasets phase: {time.perf_counter() - t0:.1f} s", flush=True)
    # the evaluation metrics: LPIPS and FVD through test_main
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    met = metrics_path()
    print(f"metrics phase: {time.perf_counter() - t0:.1f} s", flush=True)
    # the serving export: the generation program as one artifact through
    # kernels 1, 4 and 6, the tools on its serving core
    torch.cuda.empty_cache()
    served = serving_path()
    # data parallelism: the trainer at one NCCL rank and at two gloo ranks
    # on the card, test_main at two ranks
    torch.cuda.empty_cache()
    data_parallel_path()
    # the data tools: the loader bench against the step on the card, the
    # packers and a KTH test set
    torch.cuda.empty_cache()
    _, tools_counts = data_tools_path()
    # the offline drop: written, verified, converted and evaluated from
    torch.cuda.empty_cache()
    drop_counts, drop = offline_drop_path()
    # launches of one call at each checked batch, over the symbolic
    # artifacts
    served_counts = {}
    for rows in served["checks"].values():
        for k, v in rows[0]["launches"].items():
            served_counts[k] = served_counts.get(k, 0) + v

    src = "srvp_tpu_torch/csrc/rollout_train.cu"
    kernels = [
        dict(kernel_row("prior_rollout", "srvp_tpu_torch/csrc/rollout.cu",
                        "srvp_tpu/ops/pallas/rollout.py:89",
                        summary["launches"]["prior_rollout"],
                        main_row["max_abs_err"], main_row["ms"],
                        main_row["plain_ms"], main_row["bound_ms"],
                        main_row["bound_by"]),
             serving_launches=served_counts["prior_rollout"]),
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
            if name.endswith("_fwd"):
                kernels[-1]["serving_launches"] = served_counts.get(
                    name + sfx, 0)
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
    for row in kernels:     # launches of phase 20's step leg and phase 21
        row["data_tools_launches"] = tools_counts.get(row["name"], 0)
        row["drop_launches"] = drop_counts.get(row["name"], 0)
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
    kth_m = met["kth"]
    print(f"metrics (fp32, TF32 off): LPIPS {met['lpips_chunk']['ms']:.3f} "
          f"ms per chunk of {met['lpips_chunk']['pairs']} frame pairs; I3D "
          f"{met['i3d_chunk']['ms']:.3f} ms per chunk of "
          f"{met['i3d_chunk']['videos']} videos x "
          f"{met['i3d_chunk']['frames']} frames; FVD {met['fvd_s']:.3f} s "
          f"wall for 2 x {KTH_VIDEOS} videos; KTH evaluation (cuDNN "
          f"deterministic) {kth_m['s_per_batch']:.3f} s per batch with "
          f"LPIPS, {kth_m['s_per_batch_without_lpips']:.3f} without (phase 8,"
          f" default algorithms: {kth_summary['s_per_batch_kernel']:.3f}); "
          f"BAIR "
          f"{met['bair']['s_per_batch']:.3f} s per batch of "
          f"{METRICS_BAIR_VIDEOS} x {METRICS_BAIR_SAMPLES} samples with both",
          flush=True)
    for what, ev in (("dcgan", summary), ("kth", kth_summary)):
        print(f"{what} evaluation (phase {6 if what == 'dcgan' else 8}): "
              f"{ev['s_per_batch_kernel']:.3f} s per batch under cuDNN's "
              f"deterministic algorithms, {ev['s_per_batch_default_algos']:.3f}"
              f" under its defaults", flush=True)
    for config, lat in served["latency"].items():
        for b, r in lat["batches"].items():
            print(f"serving {config} bf16 batch {b}: device p50 "
                  f"{r['device_latency_p50_ms']:.3f} ms (p95 "
                  f"{r['device_latency_p95_ms']:.3f}), end to end p50 "
                  f"{r['latency_p50_ms']:.3f} ms (p95 "
                  f"{r['latency_p95_ms']:.3f}), {r['frames_per_sec']:.1f} "
                  f"frames/s", flush=True)
    print(f"offline drop (phase 21): {drop['artifacts']} artifacts "
          f"verified, BAIR frames of {drop['bair']['mean_frame_bytes']:.1f} "
          f"bytes, evaluation {drop['evaluation']['s_per_batch']:.3f} s per "
          f"batch with LPIPS and FVD, {drop['seconds']:.1f} s", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
