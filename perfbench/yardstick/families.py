"""Kernel families of a device trace, by a part of the kernel's name, the
first that matches, and the port's own kernels.

Copied from scripts/profile_torch_train.py (`OWN_KERNELS`, `FAMILIES`,
`family`, as of the benchmark's first version); the tests pin them.
"""

# the port's own kernels, by a part of their names (csrc/*.cu)
OWN_KERNELS = {"rollout": ("rollout",),
               "spatial": ("maxpool_fwd_kernel", "maxpool_bwd_kernel",
                           "upsample_fwd_kernel", "upsample_bwd_kernel")}

# the port's kernels; cuDNN's batch norm (fp32) and its NCHW <-> NHWC
# layout transposes; cuDNN's convolutions, FFT ones (complex GEMMs and
# pointwise products) included; the remaining GEMMs; ATen's reductions
# (the bf16 batch norm's statistics among them) and elementwise kernels
# (its normalisation, casts and the LeakyReLU among them)
FAMILIES = [
    ("rollout (port)", ("rollout",)),
    ("pool/upsample (port)", OWN_KERNELS["spatial"]),
    ("batch norm (cuDNN, ATen)", ("bn_fw", "bn_bw", "batch_norm",
                                  "batchnorm")),
    ("layout transpose (cuDNN)", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "fft",
                             "winograd", "complex", "cf32", "cudnn")),
    ("GEMM (cuBLAS, cuDNN GEMM convs)", ("gemm", "cutlass", "cublas")),
    ("reduction (ATen)", ("reduce",)),
    ("elementwise (ATen)", ("elementwise", "vectorized", "unrolled")),
    ("copy", ("copy", "memcpy", "memset")),
]


def family(name):
    low = name.lower()
    return next((fam for fam, parts in FAMILIES
                 if any(part.lower() in low for part in parts)), "other")


def is_own(name):
    return any(part in name for parts in OWN_KERNELS.values()
               for part in parts)
