"""The least time of the port's own kernels at given shapes on an H100:
the larger of the bytes each must move over the memory rate and its
operations over the arithmetic rate (peaks.py).

`rollout_bound_ms` (kernel 1) and `train_rollout_bounds_ms` (kernels 2
and 3) are copied from chip_smoke.py, and the pool and upsample byte
counts (kernels 4-7) from chip_smoke.py `spatial_site`, as of the
benchmark's first version. The layers are anything with `.numel()` and
`.shape` (the reference model's parameters, on the meta device).
"""

from perfbench.yardstick.peaks import PEAK_HBM_BYTES, bound_ms

# elements moved by each spatial kernel, per element of the site's input
# x (n_in): the pool's forward reads x and writes x/4; its backward reads
# x, the output and its cotangent and writes dx; the upsample's forward
# reads x and writes 4x; its backward reads 4x and writes x
SPATIAL_ELEMS = {"pool_fwd": 5 / 4, "pool_bwd": 5 / 2, "up_fwd": 5.0,
                 "up_bwd": 5.0}


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


def stash_width(pz_layers, dyn_layers):
    """The stashed hidden pre-activations' width a substep (chip_smoke.py
    `check_train_rollout`)."""
    return sum(w.shape[0] for w, _ in list(pz_layers)[:-1]) \
        + sum(w.shape[0] for w, _ in list(dyn_layers)[:-1])


def spatial_bound_ms(kernel, n_in, element_size):
    """Least time of one pool or upsample kernel (SPATIAL_ELEMS' keys) on
    a site of n_in input elements: bytes over the memory rate."""
    return 1e3 * element_size * SPATIAL_ELEMS[kernel] * n_in \
        / PEAK_HBM_BYTES
