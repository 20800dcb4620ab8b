"""Pure-prior latent rollout: CUDA kernel wrapper and its plain version.

Replaces the Pallas TPU kernel `_rollout_kernel` of
srvp_tpu/ops/pallas/rollout.py (`prior_rollout_fused`). The kernel
(csrc/rollout.cu) runs the whole rollout in one launch: one block per tile
of `rows_per_block` batch rows, the substep loop inside the block, weights
streamed from L2 (4.44 MB at the flagship widths does not fit in shared
memory), fp32 FMA throughout. It is bound by arithmetic: 2.22 MFLOP per row
and substep at the flagship widths, 71 GFLOP for B=1600 x 20 substeps,
about 1.06 ms at the H100's 67 TFLOP/s of fp32. As measured (PERF.md) it
is limited instead by each SM streaming all the weights from L2 every
substep. See the source for the design.

`prior_rollout` launches the kernel for CUDA tensors and runs
`prior_rollout_reference` for CPU tensors; it raises for anything else.
"""

import torch
import torch.nn.functional as F

from srvp_tpu_torch.ops.dists import EPS

# Kernel launches made by prior_rollout (reset it before a run to count
# that run's launches).
launches = 0

# Every block streams all the weights from L2 once per substep, and one SM
# takes them in at a fixed rate, so an SM that holds two blocks takes twice
# as long. The rows per block are the fewest that still fit the grid in one
# wave over the H100's 132 SMs (more rows per block mean less L2 traffic per
# FLOP), and at least 4 for the kernel's 16-byte loads of the tile.
_N_SMS = 132
_ROWS = (4, 8, 16)


def rows_per_block(bsz):
    return next((r for r in _ROWS if -(-bsz // r) <= _N_SMS), _ROWS[-1])


def _mlp(layers, h):
    for il, (w, b) in enumerate(layers):
        if il > 0:
            h = torch.relu(h)
        h = F.linear(h, w, b)
    return h


def prior_rollout_reference(pz_layers, dyn_layers, y0, eps, ny, nz,
                            oversampling=1):
    """Plain PyTorch prior rollout.

    pz_layers / dyn_layers: [(weight (out, in), bias (out,))] of the p_z and
    dynamics MLPs. y0: (B, ny); eps: (n_steps, B, nz) standard-normal draws,
    of which only the first substep of each frame is read. Returns y after
    every substep, (n_steps, B, ny), y0 excluded.
    """
    dt = 1.0 / oversampling
    y, z, ys = y0, None, []
    for t in range(eps.shape[0]):
        if t % oversampling == 0:
            p_par = _mlp(pz_layers, y)
            z = p_par[:, :nz] + eps[t] * (F.softplus(p_par[:, nz:]) + EPS)
        y = y + dt * _mlp(dyn_layers, torch.cat([y, z], dim=-1))
        ys.append(y)
    return torch.stack(ys) if ys else y0.new_zeros((0,) + y0.shape)


def _pack(mats):
    """Flat fp32 buffer of (matrix (din, dout), bias (dout,) or None) pairs,
    each piece starting at a multiple of 4 floats (16-byte loads), plus the
    int32 {din, dout, w_off, b_off} rows the kernels read (b_off -1: no
    bias)."""
    chunks, meta, off = [], [], 0
    for m, b in mats:
        din, dout = m.shape
        row = [din, dout]
        for t in (m, b):
            if t is None:
                row.append(-1)
                continue
            t = t.reshape(-1)
            row.append(off)
            pad = -t.numel() % 4
            chunks += [t, t.new_zeros(pad)]
            off += t.numel() + pad
        meta += row
    return torch.cat(chunks), meta


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def prior_rollout(pz_layers, dyn_layers, y0, eps, ny, nz, oversampling=1):
    """Prior rollout; same arguments and result as prior_rollout_reference.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches
    if y0.device.type == "cpu":
        return prior_rollout_reference(pz_layers, dyn_layers, y0, eps, ny, nz,
                                       oversampling)
    if y0.device.type != "cuda":
        raise ValueError(f"prior_rollout: unsupported device {y0.device}")
    device = y0.device
    n_steps, bsz = eps.shape[0], y0.shape[0]
    _check("y0", y0, (bsz, ny), device)
    _check("eps", eps, (n_steps, bsz, nz), device)
    if not (y0.is_contiguous() and eps.is_contiguous()):
        raise ValueError("prior_rollout: y0 and eps must be contiguous")
    layers = list(pz_layers) + list(dyn_layers)
    for i, (w, b) in enumerate(layers):
        _check(f"weight[{i}]", w, w.shape, device)
        _check(f"bias[{i}]", b, (w.shape[0],), device)
    if (pz_layers[0][0].shape[1] != ny or pz_layers[-1][0].shape[0] != 2 * nz
            or dyn_layers[0][0].shape[1] != ny + nz
            or dyn_layers[-1][0].shape[0] != ny):
        raise ValueError("prior_rollout: MLP widths do not match ny/nz")
    if oversampling < 1:
        raise ValueError(f"prior_rollout: oversampling {oversampling} < 1")
    out = torch.empty((n_steps, bsz, ny), device=device, dtype=torch.float32)
    if n_steps == 0 or bsz == 0:
        return out

    from srvp_tpu_torch.kernels.build import load_library
    lib = load_library()
    with torch.no_grad():
        params, meta = _pack([(w.t(), b) for w, b in layers])
    meta_t = torch.tensor(meta, dtype=torch.int32, device=device)
    hmax = max(w.shape[0] for w, _ in layers)
    # the C function launches on the calling thread's current device
    with torch.cuda.device(device):
        err = lib.srvp_prior_rollout(
            params.data_ptr(), meta_t.data_ptr(), len(pz_layers),
            len(dyn_layers), y0.data_ptr(), eps.data_ptr(), out.data_ptr(),
            bsz, ny, nz, n_steps, oversampling, hmax, rows_per_block(bsz),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"srvp_prior_rollout launch failed: cudaError {err}")
    launches += 1
    return out
