"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), the roofline bound computed from
them, and the card's name and power limit as nvidia-smi reads them: what
chip_smoke.py, bench_conv_stage.py and bench.py (its MFU) state their
times against."""

import subprocess

import torch

PEAK_FP32_FLOPS = 67e12     # fp32 FMA outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # bf16 tensor cores, dense
PEAK_TF32_FLOPS = 495e12    # TF32 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12    # HBM3, bytes per second
# the rate of an fp32-accurate product on the tensor cores by storage type:
# three TF32 products a term for fp32 (3xTF32), one bf16 product for bf16
PEAK_FLOPS = {torch.float32: PEAK_TF32_FLOPS / 3,
              torch.bfloat16: PEAK_BF16_FLOPS}


def bound_ms(flops, n_bytes, peak_flops=PEAK_FP32_FLOPS):
    """The least time for work of `flops` operations that must move
    `n_bytes` (each input read once, each output written once): the larger
    of the two times, in ms, and which of them ("operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nvidia_smi_line():
    """`name, power.limit` of the first card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]
