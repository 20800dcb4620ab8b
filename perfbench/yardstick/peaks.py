"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the roofline bound computed
from them.

Copied from srvp_tpu_torch/kernels/peaks.py (PEAK_* and `bound_ms`, as of
the benchmark's first version); the tests pin the numbers.
"""

PEAK_FP32_FLOPS = 67e12     # fp32 FMA outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # bf16 tensor cores, dense
PEAK_TF32_FLOPS = 495e12    # TF32 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12    # HBM3, bytes per second
# the peak an MFU is taken against, by the compute dtype (fp32 with TF32
# off runs outside the tensor cores)
PEAK_BY_DTYPE = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_FP32_FLOPS}


def bound_ms(flops, n_bytes, peak_flops=PEAK_FP32_FLOPS):
    """The least time for work of `flops` operations that must move
    `n_bytes` (each input read once, each output written once): the larger
    of the two times, in ms, and which of them ("operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
