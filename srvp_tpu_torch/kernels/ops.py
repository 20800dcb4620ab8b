"""The generation path's kernels as torch.library custom ops.

    srvp::prior_rollout  kernel 1 (csrc/rollout.cu)
    srvp::max_pool2x2    kernel 4 (csrc/spatial.cu, float32 and bfloat16)
    srvp::upsample2x     kernel 6 (csrc/spatial.cu, float32 and bfloat16)

The kernels are launched through ctypes, which a tracer cannot see through:
as custom ops they stay single nodes of a traced or exported program
(export.py), and the implementation is chosen where the op is called, by
the device of its tensors. The CUDA implementation is the kernel's launch
(`rollout.launch_prior_rollout`, `spatial.pool_fwd_cuda`,
`spatial.up_fwd_cuda`), which counts its launches as before; the CPU
implementation is the plain version; on any other device the op has no
implementation and raises. Each op's fake implementation gives its output's
shape and dtype for a symbolic batch.

The wrappers `rollout.prior_rollout`, `spatial.max_pool2x2` and
`spatial.upsample2x` (through their autograd.Functions' forwards) call these
ops, so the evaluation, the trainer, its CUDA graphs and an exported program
go through one route. The backward kernels (5 and 7) and the training
rollout (kernels 2-3) are not ops: an exported program is inference only.

Importing this module registers the `srvp` namespace and builds nothing;
the kernel library is built on the first CUDA call (kernels/build.py).
"""

from typing import List

import torch

from srvp_tpu_torch.kernels import rollout, spatial


def _layers(weights, biases):
    return list(zip(weights, biases))


@torch.library.custom_op("srvp::prior_rollout", mutates_args=(),
                         device_types="cuda")
def prior_rollout(pz_weights: List[torch.Tensor],
                  pz_biases: List[torch.Tensor],
                  dyn_weights: List[torch.Tensor],
                  dyn_biases: List[torch.Tensor], y0: torch.Tensor,
                  eps: torch.Tensor, ny: int, nz: int, oversampling: int,
                  rows: int = 0, cluster: int = 0) -> torch.Tensor:
    """Kernel 1: y after every substep, (n_steps, B, ny), from y0 (B, ny)
    and the draws eps (n_steps, B, nz) (rollout.prior_rollout_reference).
    rows and cluster pin the launch plan (0: cluster_plan's)."""
    plan = (rollout.Plan(rows, cluster, -(-y0.shape[0] // rows)) if rows
            else None)
    return rollout.launch_prior_rollout(
        _layers(pz_weights, pz_biases), _layers(dyn_weights, dyn_biases),
        y0, eps, ny, nz, oversampling, plan)


@prior_rollout.register_kernel("cpu")
def _(pz_weights, pz_biases, dyn_weights, dyn_biases, y0, eps, ny, nz,
      oversampling, rows=0, cluster=0):
    return rollout.prior_rollout_reference(
        _layers(pz_weights, pz_biases), _layers(dyn_weights, dyn_biases),
        y0, eps, ny, nz, oversampling)


@prior_rollout.register_fake
def _(pz_weights, pz_biases, dyn_weights, dyn_biases, y0, eps, ny, nz,
      oversampling, rows=0, cluster=0):
    return y0.new_empty((eps.shape[0], y0.shape[0], ny))


@torch.library.custom_op("srvp::max_pool2x2", mutates_args=(),
                         device_types="cuda")
def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """Kernel 4: the 2x2/stride-2 max pool of (N, C, H, W)."""
    return spatial.pool_fwd_cuda(x)


@max_pool2x2.register_kernel("cpu")
def _(x):
    return spatial.max_pool2x2_reference(x)


@max_pool2x2.register_fake
def _(x):
    n, c, h, w = x.shape
    return x.new_empty((n, c, h // 2, w // 2))


@torch.library.custom_op("srvp::upsample2x", mutates_args=(),
                         device_types="cuda")
def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Kernel 6: the 2x nearest upsample of (N, C, H, W)."""
    return spatial.up_fwd_cuda(x)


@upsample2x.register_kernel("cpu")
def _(x):
    return spatial.upsample2x_reference(x)


@upsample2x.register_fake
def _(x):
    n, c, h, w = x.shape
    return x.new_empty((n, c, 2 * h, 2 * w))
