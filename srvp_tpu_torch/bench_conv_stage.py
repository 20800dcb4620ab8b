"""Times the fused conv stage on the card: kernel 8 (csrc/conv_stage.cu via
kernels.conv_stage.conv3x3_block_fwd), or kernel 9 with --clamped, beside
cuDNN's conv and the two reductions. The counterpart of
scripts/bench_conv_stage.py and scripts/microbench_conv.py.

    python -m srvp_tpu_torch.bench_conv_stage [--c 64] [--hw 64] [--n 2000]
        [--inner 10] [--reps 3] [--transform] [--act leaky_relu]
        [--dtype float32|bfloat16] [--cudnn | --cudnn_only]
        [--clamped --bh 8] [--profile] [--device cuda]

It computes y = conv3x3(act(x * scale + shift)) and the batch statistics of
y at the KTH vgg workhorse shape by default: 64 -> 64 channels, 64 x 64,
N = 2000 frames, the KTH training step's 100 videos x 20 frames. The
applications are chained: inner + 1 of them, y feeding the next (cin ==
cout) and the statistics summed into a carried accumulator, so that every
application pays for the conv and the statistics. Each leg runs one chain
to warm up, then --reps chains timed with CUDA events; it prints the best
per-application ms, TFLOP/s and the share of the H100's published peak for
the dtype (kernels/peaks.PEAK_FLOPS: for fp32 a third of the TF32 rate,
as 3xTF32 runs), beside the card's name and power limit.
With --profile it then lists each leg's device kernels by time over one
more chain (torch.profiler), which names the algorithms cuDNN picked.

The cuDNN leg (--cudnn beside the kernel, --cudnn_only alone) is F.conv2d
of act(x * scale + shift) and the two reductions, with TF32 off
(config.strict_fp32). With --clamped the kernel leg is kernel 9: no
transform and no activation (--transform and --act then apply to the cuDNN
leg only), halo rows clamped for blocks of --bh rows; cuDNN computes the
exact-edge conv, which kernel 9 approximates.

Not ported: the TPU script's --no_double_buffer, --no_packed and --vmem_kib
describe the Pallas kernel's internals (its DMA double buffering, its
packed K = 9 cin matmul, its VMEM limit), and so does its --bn lane block;
--bh sizes kernel 9's clamped row blocks only, as kernel 8 has none.

--device cpu runs the plain versions and F.conv2d on the CPU and times
them on the host clock, which says nothing of the card. Without it the
bench needs CUDA and raises where there is none.
"""

import argparse
import time

import torch
import torch.nn.functional as F

from srvp_tpu_torch.config import resolve_device, strict_fp32
from srvp_tpu_torch.kernels import conv_stage
from srvp_tpu_torch.kernels.peaks import PEAK_FLOPS, nvidia_smi_line

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def create_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--c", type=int, default=64, help="cin == cout (chained)")
    p.add_argument("--hw", type=int, default=64)
    p.add_argument("--n", type=int, default=2000, help="frames")
    p.add_argument("--inner", type=int, default=10,
                   help="chain depth: inner + 1 applications a chain")
    p.add_argument("--reps", type=int, default=3,
                   help="timed chains; the best is reported (>= 1)")
    p.add_argument("--transform", action="store_true",
                   help="apply the per-channel normalize on load")
    p.add_argument("--act", default="leaky_relu",
                   choices=sorted(conv_stage.ACTS))
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    p.add_argument("--cudnn", action="store_true",
                   help="time the cuDNN leg too")
    p.add_argument("--cudnn_only", action="store_true",
                   help="time the cuDNN leg alone")
    p.add_argument("--clamped", action="store_true",
                   help="kernel 9 (clamped halo rows) instead of kernel 8")
    p.add_argument("--bh", type=int, default=8,
                   help="kernel 9's rows per block")
    p.add_argument("--profile", action="store_true",
                   help="after timing, list each leg's device kernels by "
                        "time over one chain (torch.profiler)")
    p.add_argument("--device", default="cuda")
    return p


def profile_chain(block, x0, inner, device):
    """Prints the device kernels of one chain by total time: which
    algorithms cuDNN picked, and what else a leg launches."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        chain(block, x0, inner)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    key = "self_cuda_time_total" if device.type == "cuda" \
        else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=key, row_limit=8), flush=True)


def cudnn_stage(x, w, scale=None, shift=None, act="none", n_valid=None):
    """The library's counterpart of kernel 8: F.conv2d (cuDNN on the card)
    of act(x * scale + shift) and the two reductions over the frames
    < n_valid. Timed beside the kernel, never used by the port."""
    z = conv_stage.activated_input(x, scale, shift, act).to(x.dtype)
    y = F.conv2d(z, w, padding=1)
    yf = y[:n_valid].float()
    return y, torch.stack([yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))], 1)


def chain(block, x0, inner):
    """inner + 1 applications of block, y feeding the next; returns the
    summed statistics."""
    y, acc = x0, None
    for _ in range(inner + 1):
        y, st = block(y)
        acc = st if acc is None else acc + st
    return acc


def time_chain(block, x0, a, device):
    """Best per-application ms over a.reps chains after one warm-up chain:
    CUDA events on the card, the host clock on the CPU."""
    chain(block, x0, a.inner)
    per_call = []
    for _ in range(a.reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            acc = chain(block, x0, a.inner)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            acc = chain(block, x0, a.inner)
            ms = 1e3 * (time.perf_counter() - t0)
        if not torch.isfinite(acc).all():
            raise RuntimeError(f"non-finite statistics: {acc}")
        per_call.append(ms / (a.inner + 1))
    return min(per_call)


def run(a):
    """Times the legs a asks for; returns {leg: ms per application}."""
    if a.reps < 1 or a.inner < 0:
        raise ValueError("--reps must be >= 1 and --inner >= 0")
    device = resolve_device(a.device)
    strict_fp32()
    dtype = DTYPES[a.dtype]
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (a.n, a.c, a.hw, a.hw)
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    w = (0.04 * torch.randn((a.c, a.c, 3, 3), generator=gen, device=device)
         ).to(dtype)
    scale = torch.full((a.c,), 0.9, device=device) if a.transform else None
    shift = torch.full((a.c,), 0.01, device=device) if a.transform else None

    def kernel_block(y):
        if a.clamped:
            return conv_stage.fused_conv_bn(y, w, a.bh)
        return conv_stage.conv3x3_block_fwd(y, w, scale, shift, a.act)

    flops = 2.0 * 9 * a.c * a.c * a.hw * a.hw * a.n
    peak = PEAK_FLOPS[dtype]
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)} | "
              f"{nvidia_smi_line()}", flush=True)
    kernel = (f"kernel9[clamped bh={a.bh}]" if a.clamped else
              f"kernel8[{'T' if a.transform else '-'} act={a.act}]")
    legs = ([] if a.cudnn_only else [(kernel, kernel_block)]) \
        + ([("cudnn", lambda y: cudnn_stage(y, w, scale, shift, a.act))]
           if a.cudnn or a.cudnn_only else [])
    out = {}
    for label, block in legs:
        ms = time_chain(block, x, a, device)
        out[label] = ms
        rate = flops / (ms / 1e3) / 1e12
        share = (f"{100 * rate * 1e12 / peak:.1f}% of the H100 {a.dtype} "
                 f"tensor-core peak, {peak / 1e12:.0f} TFLOP/s"
                 if device.type == "cuda"
                 else "host CPU time, not a device measurement")
        print(f"{label:<32} {a.dtype} N={a.n} c={a.c} hw={a.hw}: "
              f"{ms:.3f} ms/block  {rate:.2f} TFLOP/s  ({share})",
              flush=True)
        if a.profile:
            profile_chain(block, x, a.inner, device)
    return out


def main(argv=None):
    run(create_args().parse_args(argv))


if __name__ == "__main__":
    main()
