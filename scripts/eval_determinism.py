#!/usr/bin/env python
"""Whether the port's best-of-N evaluation chunk gives the same bits when it
runs again, on one GPU, and which of its stages do not.

    python scripts/eval_determinism.py [--config kth-vgg|smmnist-dcgan]
        [--seed 0] [--time_rounds N]

Runs the stages of `srvp_tpu_torch.eval_lib.compute_chunk` (encode, w,
the z-LSTM, the rollouts through kernel 1, the decode, the clipped
predictions, their MSE and SSIM, and SSIM alone on fixed frames) at the
full width of a published configuration with seeded random weights on 16
synthetic videos, 10 samples, the same noise each time: twice under
cuDNN's default algorithms, again after other allocations, then twice with
torch.backends.cudnn.deterministic, and twice under
torch.use_deterministic_algorithms. Prints one JSON line: for each pair,
the stages that differ and their largest absolute difference (an empty
object: bit-equal), with the card's name and power limit. With
--time_rounds N it also times eval_lib.compute_chunk (the evaluation's
chunk, host clock closed by torch.cuda.synchronize) under cuDNN's
deterministic algorithms and under its defaults, in turns (deterministic
first in even rounds, the defaults first in odd ones), N chunks each
after one of each as warm-up, and prints their median ms and ranges.
Needs CUDA.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from srvp_tpu_torch import eval_lib  # noqa: E402
from srvp_tpu_torch.config import model_config, strict_fp32  # noqa: E402
from srvp_tpu_torch.kernels import build  # noqa: E402
from srvp_tpu_torch.kernels.peaks import nvidia_smi_line  # noqa: E402
from srvp_tpu_torch.metrics.pixel import frame_mse  # noqa: E402
from srvp_tpu_torch.metrics.ssim import video_ssim  # noqa: E402
from srvp_tpu_torch.models.lstm import lstm_apply  # noqa: E402
from srvp_tpu_torch.models.srvp import SRVP  # noqa: E402

import chip_smoke  # noqa: E402  (configurations and synthetic videos)

CONFIGS = {"kth-vgg": (chip_smoke.KTH_CONFIG, chip_smoke.KTH_NT_GEN),
           "smmnist-dcgan": (chip_smoke.XP_CONFIG,
                             chip_smoke.XP_CONFIG["seq_len_test"])}
VIDEOS, SAMPLES = 16, 10


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="kth-vgg")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--time_rounds", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("eval_determinism: CUDA is not available")
    build.build()
    build.load_library()
    strict_fp32()
    cfg, nt_test = CONFIGS[args.config]
    nt_cond, o = cfg["nt_cond"], cfg["n_euler_steps"]
    mcfg = model_config(cfg)
    torch.manual_seed(args.seed)
    model = SRVP(mcfg).cuda().eval()
    rng = np.random.RandomState(args.seed)
    if cfg["dataset"] == "kth":
        seqs = chip_smoke.synthetic_kth_videos(VIDEOS, nt_test, 64, rng) \
            .transpose(1, 0, 2, 3)
    else:
        seqs = chip_smoke.synthetic_sequences(VIDEOS, nt_test, 64, args.seed)
    x = torch.from_numpy(seqs[..., None].astype(np.float32) / 255).cuda()
    x_cond, x_target = x[:nt_cond], x[nt_cond:]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 1)
    eps = eval_lib.chunk_noise(mcfg, VIDEOS, SAMPLES, nt_cond, nt_test, o, o,
                               gen, "cuda")
    x_target_f = eval_lib.fold(x_target, SAMPLES, 1)

    @torch.no_grad()
    def stages():
        out = {}
        hx, skips = model.encode(x_cond)
        out["hx"] = hx
        if skips is not None:
            out["skips"] = torch.cat([s.flatten() for s in skips])
        w = model.infer_w(hx)
        hx_z = lstm_apply(model.inf_z, hx)
        out.update(w=w, hx_z=hx_z)
        y_inf, y_gen = eval_lib.sample_rollout(
            model, hx, hx_z, SAMPLES, nt_test - nt_cond + 1, o, o, eps)
        out.update(y_inf=y_inf, y_gen=y_gen)
        skips_f = (None if skips is None
                   else [eval_lib.fold(s, SAMPLES, 0) for s in skips])
        x_pred = model.decode(eval_lib.fold(w, SAMPLES, 0), y_gen[1:],
                              skips_f).float().clamp(0.0, 1.0)
        out.update(x_pred=x_pred, mse=frame_mse(x_pred, x_target_f),
                   ssim=video_ssim(x_pred, x_target_f),
                   ssim_fixed_frames=video_ssim(x_target_f,
                                                x_target_f.flip(0)))
        return out

    def differ(a, b):
        return {k: float((a[k] - b[k]).abs().max()) for k in a
                if not torch.equal(a[k], b[k])}

    res = {}
    ref = stages()
    res["default_again"] = differ(ref, stages())
    others = [torch.empty(int(n), device="cuda") for n in (1e6, 3e7, 7, 5e5)]
    res["default_after_other_allocations"] = differ(ref, stages())
    del others
    torch.backends.cudnn.deterministic = True
    det = stages()
    res["cudnn_deterministic_again"] = differ(det, stages())
    res["cudnn_deterministic_vs_default"] = differ(ref, det)
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    alg = stages()
    res["deterministic_algorithms_again"] = differ(alg, stages())
    torch.use_deterministic_algorithms(False)
    timing = chunk_ms(lambda: eval_lib.compute_chunk(
        model, x_cond, x_target, SAMPLES, o, o, eps), args.time_rounds)
    print(json.dumps(dict(config=args.config, videos=VIDEOS, samples=SAMPLES,
                          device=nvidia_smi_line(), differ=res,
                          chunk_ms=timing)), flush=True)


def chunk_ms(chunk, rounds):
    """{"deterministic", "default"}: median, min and max ms of `chunk`
    under each cuDNN setting, timed in turns over `rounds` rounds."""
    if not rounds:
        return None
    ms = {True: [], False: []}
    for r in range(-1, rounds):
        for det in ((True, False) if r % 2 == 0 else (False, True)):
            torch.backends.cudnn.deterministic = det
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunk()
            torch.cuda.synchronize()
            if r >= 0:
                ms[det].append(1e3 * (time.perf_counter() - t0))
    torch.backends.cudnn.deterministic = False
    return {("deterministic" if det else "default"): dict(
        median=float(np.median(v)), min=min(v), max=max(v))
        for det, v in ms.items()}


if __name__ == "__main__":
    main()
