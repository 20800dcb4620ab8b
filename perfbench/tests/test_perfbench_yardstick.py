"""The frozen yardstick's numbers, pinned: the H100 peaks, the kernels'
least times at the shapes the program's own checks printed them
(chip_smoke.py, as PERF.md's kernel table gives them), and the family
classifier."""

import pytest
import torch

from perfbench.yardstick import bounds, families, peaks


def _mlp(dims):
    return [(torch.empty(o, i, device="meta"), torch.empty(o, device="meta"))
            for i, o in dims]


def _layers(ny, nz, nh_inf=256, nh=512, n=4):
    pz = _mlp([(ny, nh)] + [(nh, nh)] * (n - 2) + [(nh, 2 * nz)])
    dyn = _mlp([(ny + nz, nh)] + [(nh, nh)] * (n - 2) + [(nh, ny)])
    q = _mlp([(nh_inf, 2 * nz)])[0]
    return q, pz, dyn


def test_peaks_pinned():
    assert peaks.PEAK_FP32_FLOPS == 67e12
    assert peaks.PEAK_BF16_FLOPS == 989e12
    assert peaks.PEAK_TF32_FLOPS == 495e12
    assert peaks.PEAK_HBM_BYTES == 3.35e12
    assert peaks.PEAK_BY_DTYPE == {"bfloat16": 989e12, "float32": 67e12}
    assert peaks.bound_ms(67e9, 0) == (1.0, "operations")
    assert peaks.bound_ms(0, 3.35e9) == (1.0, "bytes")


@pytest.mark.parametrize("ny,nz,bsz,steps,o,want", [
    (20, 20, 160, 20, 1, 0.106),      # kernel 1, dcgan evaluation
    (20, 20, 1600, 20, 1, 1.060),
    (50, 50, 160, 60, 2, 0.258),      # kernel 1, KTH evaluation
])
def test_rollout_bound_pinned(ny, nz, bsz, steps, o, want):
    _, pz, dyn = _layers(ny, nz)
    ms, by = bounds.rollout_bound_ms(pz, dyn, bsz, steps, o, ny, nz)
    assert by == "operations"
    assert ms == pytest.approx(want, abs=5e-4)


@pytest.mark.parametrize("ny,nz,bsz,steps,want", [
    (20, 20, 128, 14, 0.060),         # kernels 2-3, dcgan training
    (50, 50, 100, 38, 0.139),         # kernels 2-3, KTH training
])
def test_train_rollout_bounds_pinned(ny, nz, bsz, steps, want):
    q, pz, dyn = _layers(ny, nz)
    b = bounds.train_rollout_bounds_ms([q] + pz + dyn, bsz, steps,
                                       bounds.stash_width(pz, dyn), 256, ny,
                                       nz)
    for part in ("fwd", "carry", "wgrad"):
        assert b[part][1] == "operations"
        assert b[part][0] == pytest.approx(want, abs=5e-4)


@pytest.mark.parametrize("kernel,es,want", [
    ("pool_fwd", 4, 0.783), ("pool_bwd", 4, 1.565), ("up_fwd", 4, 0.783),
    ("up_bwd", 4, 0.783), ("pool_fwd", 2, 0.391), ("up_fwd", 2, 0.391)])
def test_spatial_bound_pinned(kernel, es, want):
    # the largest KTH site, N = 2000 frames: pools read 64 x 64 x 64,
    # upsamples 64 channels of 32 x 32
    n_in = 2000 * 64 * (64 * 64 if kernel.startswith("pool") else 32 * 32)
    assert bounds.spatial_bound_ms(kernel, n_in, es) == pytest.approx(
        want, abs=5e-4)


@pytest.mark.parametrize("name,fam", [
    ("void (anonymous namespace)::prior_rollout_kernel<12, 4>(float)",
     "rollout (port)"),
    ("train_rollout_wgrad_kernel", "rollout (port)"),
    ("maxpool_bwd_kernel<float>", "pool/upsample (port)"),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float>", "batch norm (cuDNN, "
                                                      "ATen)"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<bf16>",
     "layout transpose (cuDNN)"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32", "convolution (cuDNN)"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_cublas", "GEMM (cuBLAS, "
                                                        "cuDNN GEMM convs)"),
    ("void at::native::reduce_kernel<512, 1>", "reduction (ATen)"),
    ("void at::native::vectorized_elementwise_kernel<8>",
     "elementwise (ATen)"),
    ("Memcpy DtoH (Device -> Pageable)", "copy"),
    ("something else", "other")])
def test_families_pinned(name, fam):
    assert families.family(name) == fam
    assert families.is_own(name) == fam.endswith("(port)")
