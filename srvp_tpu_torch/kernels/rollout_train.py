"""Training-mode latent rollout: CUDA forward and backward kernels, their
autograd.Function, and the plain version.

Replaces the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` of
srvp_tpu/ops/pallas/rollout_train.py (`make_train_rollout`, tied by
jax.custom_vjp). For every substep k of K = o * (nt - 1), z is drawn from
the posterior q(z | hxz_k) on the first substep of each frame and reused for
the other o - 1:

    q_k = hxz_k W_q + b_q
    z_k = k % o == 0 ? q_k[:nz] + eps_k * (softplus(q_k[nz:]) + 1e-8) : z_{k-1}
    p_k = p_z(y_k);   r_k = dt * dynamics([y_k, z_k]);   y_{k+1} = y_k + r_k

and the outputs are ys (y_1..y_K), res (r_k), q, p and z per substep. The
kernels (csrc/rollout_train.cu) are one forward launch and two backward
launches (a reverse-time carry pass, then a weight-gradient pass that owns
each tile of each dW: deterministic, no atomics). At the flagship widths a
row does 1,120,256 multiply-adds per substep, so B=128, K=14 is 4.0 GFLOP
forward and about twice that backward: arithmetic-bound on the H100's fp32
cores. eps is noise: it gets no gradient.

`train_rollout` runs `TrainRollout` (the kernels) for CUDA tensors and
`train_rollout_reference` for CPU tensors; it raises for anything else.
"""

import torch
import torch.nn.functional as F

from srvp_tpu_torch.kernels.rollout import _check, _mlp, _pack, rows_per_block
from srvp_tpu_torch.ops.dists import rsample

# Launches of the forward kernel, and of the two backward passes (two per
# backward). Reset them before a run to count that run's launches.
fwd_launches = 0
bwd_launches = 0

# widest tile whose shared memory fits a block (227 KB on the H100)
_SMEM_LIMIT = 232448
_THREADS = 512


def train_rollout_reference(q_layer, pz_layers, dyn_layers, y0, hxz, eps,
                            oversampling=1):
    """Plain PyTorch training rollout, differentiable by autograd.

    q_layer: (weight (2nz, nh_inf), bias) of q_z; pz_layers / dyn_layers:
    [(weight (out, in), bias)]. y0 (B, ny); hxz (K, B, nh_inf) the z-LSTM
    output of each substep's frame; eps (K, B, nz), of which only the first
    substep of each frame is read. Returns (ys, res (K, B, ny), q_par, p_par
    (K, B, 2nz), zs (K, B, nz)).
    """
    dt = 1.0 / oversampling
    y, z = y0, None
    outs = [[] for _ in range(5)]
    for k in range(eps.shape[0]):
        q_par = F.linear(hxz[k], *q_layer)
        if k % oversampling == 0:
            z = rsample(q_par, eps[k])
        p_par = _mlp(pz_layers, y)
        r = dt * _mlp(dyn_layers, torch.cat([y, z], dim=-1))
        y = y + r
        for lst, v in zip(outs, (y, r, q_par, p_par, z)):
            lst.append(v)
    return tuple(torch.stack(v) for v in outs)


def _rows(bsz, ny, nz, nh_inf, hmax):
    """Rows per block: rollout.py's rule, cut until the forward's and the
    carry pass's shared memory fit."""
    floats = ny + nz + max(nh_inf, 2 * ny + nz) + 2 * nz + 2 * hmax \
        + 4 * _THREADS
    rows = rows_per_block(bsz)
    while rows > 4 and 4 * rows * floats > _SMEM_LIMIT:
        rows //= 2
    return rows


def _layers(flat, n_pz):
    pairs = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
    return pairs[0], pairs[1:1 + n_pz], pairs[1 + n_pz:]


def _lib():
    from srvp_tpu_torch.kernels.build import load_library
    return load_library()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


class TrainRollout(torch.autograd.Function):
    """The rollout through the CUDA kernels, with their backward.

    apply(oversampling, n_pz, y0, hxz, eps, q_w, q_b, *pz (w, b),
    *dyn (w, b)) -> (ys, res, q_par, p_par, zs), as train_rollout_reference.
    Weight gradients come back in nn.Linear's (out, in) layout.
    """

    @staticmethod
    def forward(ctx, oversampling, n_pz, y0, hxz, eps, *flat):
        global fwd_launches
        q_layer, pz, dyn = _layers(flat, n_pz)
        layers = [q_layer] + pz + dyn
        n_steps, bsz, nh_inf = hxz.shape
        ny, nz = y0.shape[1], eps.shape[2]
        device = y0.device
        params, meta = _pack([(w.detach().t(), b.detach())
                              for w, b in layers])
        meta_t = torch.tensor(meta, dtype=torch.int32, device=device)
        hmax = max(w.shape[0] for w, _ in layers)
        sw_p = sum(w.shape[0] for w, _ in pz[:-1])
        sw_d = sum(w.shape[0] for w, _ in dyn[:-1])
        new = lambda *shape: torch.empty(shape, device=device)  # noqa: E731
        ys, res = new(n_steps, bsz, ny), new(n_steps, bsz, ny)
        q_par, p_par = new(n_steps, bsz, 2 * nz), new(n_steps, bsz, 2 * nz)
        zs = new(n_steps, bsz, nz)
        stash_p, stash_d = new(n_steps, bsz, sw_p), new(n_steps, bsz, sw_d)
        rows = _rows(bsz, ny, nz, nh_inf,
                     max(hmax, max(w.shape[1] for w, _ in layers)))
        with torch.cuda.device(device):
            err = _lib().srvp_train_rollout_fwd(
                params.data_ptr(), meta_t.data_ptr(), len(pz), len(dyn),
                y0.data_ptr(), hxz.data_ptr(), eps.data_ptr(), ys.data_ptr(),
                res.data_ptr(), q_par.data_ptr(), p_par.data_ptr(),
                zs.data_ptr(), stash_p.data_ptr(), stash_d.data_ptr(), bsz, ny,
                nz, nh_inf, n_steps, oversampling, hmax, rows,
                _stream(device))
        if err != 0:
            raise RuntimeError(
                f"srvp_train_rollout_fwd launch failed: cudaError {err}")
        fwd_launches += 1
        ctx.oversampling, ctx.n_pz, ctx.rows = oversampling, n_pz, rows
        ctx.save_for_backward(y0, hxz, eps, ys, q_par, zs, stash_p, stash_d,
                              *flat)
        return ys, res, q_par, p_par, zs

    @staticmethod
    def backward(ctx, g_ys, g_res, g_q, g_p, g_zs):
        global bwd_launches
        y0, hxz, eps, ys, q_par, zs, stash_p, stash_d, *flat = \
            ctx.saved_tensors
        q_layer, pz, dyn = _layers(flat, ctx.n_pz)
        layers = [q_layer] + pz + dyn
        n_steps, bsz, nh_inf = hxz.shape
        ny, nz = y0.shape[1], eps.shape[2]
        device = y0.device
        cots = [c.contiguous() for c in (g_ys, g_res, g_q, g_p, g_zs)]
        # the carry pass reads W (out, in) as the (in', out') matrix of g W^T
        params, meta = _pack([(w.detach(), None) for w, _ in layers])
        meta_t = torch.tensor(meta, dtype=torch.int32, device=device)
        hmax = max(max(w.shape) for w, _ in layers)
        new = lambda *shape: torch.empty(shape, device=device)  # noqa: E731
        g_qbuf = new(n_steps, bsz, 2 * nz)
        g_pz = new(n_steps, bsz, sum(w.shape[0] for w, _ in pz))
        g_dyn = new(n_steps, bsz, sum(w.shape[0] for w, _ in dyn))
        g_y0, g_hxz = new(bsz, ny), new(n_steps, bsz, nh_inf)
        lib = _lib()
        with torch.cuda.device(device):
            err = lib.srvp_train_rollout_bwd(
                params.data_ptr(), meta_t.data_ptr(), len(pz), len(dyn),
                eps.data_ptr(), q_par.data_ptr(), stash_p.data_ptr(),
                stash_d.data_ptr(), *[c.data_ptr() for c in cots],
                g_qbuf.data_ptr(), g_pz.data_ptr(), g_dyn.data_ptr(),
                g_y0.data_ptr(), g_hxz.data_ptr(), bsz, ny, nz, nh_inf,
                n_steps, ctx.oversampling, hmax, ctx.rows, _stream(device))
            if err != 0:
                raise RuntimeError(
                    f"srvp_train_rollout_bwd launch failed: cudaError {err}")
            bwd_launches += 1

            # the inputs of layer 0 of p_z ([y_k]) and of the dynamics
            # ([y_k, z_k]) at every substep, y_k being the input state
            y_in = torch.cat([y0[None], ys[:-1]])
            yz_in = torch.cat([y_in, zs], dim=-1).contiguous()
            a_src = [hxz, yz_in, stash_p, stash_d]
            g_src = [g_qbuf, g_pz, g_dyn]
            jobs, grads, views, n_tiles = _wgrad_jobs(q_layer, pz, dyn, ny,
                                                      nz, nh_inf, device)
            err = lib.srvp_train_rollout_wgrad(
                jobs.data_ptr(), jobs.shape[0], n_tiles,
                *[a.data_ptr() for a in a_src],
                *[g.data_ptr() for g in g_src], grads.data_ptr(),
                n_steps * bsz, _stream(device))
        if err != 0:
            raise RuntimeError(
                f"srvp_train_rollout_wgrad launch failed: cudaError {err}")
        bwd_launches += 1
        return (None, None, g_y0, g_hxz, None, *views)


_TILE = 64


def _wgrad_jobs(q_layer, pz, dyn, ny, nz, nh_inf, device):
    """The weight-gradient pass's job table (see csrc/rollout_train.cu),
    the flat gradient buffer, and its (dW, db) views in `flat` order.

    A sources: 0 hxz (nh_inf), 1 [y_k, z_k] (ny + nz), 2 / 3 the p_z /
    dynamics stashes. G sources: 0 q, 1 p_z, 2 dynamics cotangents."""
    rows, sizes, tile0 = [], [], 0
    off = 0

    def add(a_src, a_ld, a_off, relu, g_src, g_ld, g_off, w):
        nonlocal tile0, off
        dout, din = w.shape
        w_off = off
        b_off = w_off + dout * din
        off = b_off + dout
        rows.append([a_src, a_ld, a_off, relu, g_src, g_ld, g_off, w_off,
                     b_off, din, dout, tile0])
        sizes.append((w_off, dout, din, b_off))
        tile0 += -(-dout // _TILE) * -(-din // _TILE)

    add(0, nh_inf, 0, 0, 0, 2 * nz, 0, q_layer[0])
    for g_src, a_src, mlp in ((1, 2, pz), (2, 3, dyn)):
        s_ld = sum(w.shape[0] for w, _ in mlp[:-1])
        g_ld = sum(w.shape[0] for w, _ in mlp)
        g_off = 0
        for il, (w, _) in enumerate(mlp):
            if il == 0:
                add(1, ny + nz, 0, 0, g_src, g_ld, 0, w)
            else:
                add(a_src, s_ld, g_off - w.shape[1], 1, g_src, g_ld, g_off, w)
            g_off += w.shape[0]
    grads = torch.empty(off, device=device)
    views = []
    for w_off, dout, din, b_off in sizes:
        views += [grads[w_off:w_off + dout * din].view(dout, din),
                  grads[b_off:b_off + dout]]
    jobs = torch.tensor(rows, dtype=torch.int32, device=device)
    return jobs, grads, views, tile0


def train_rollout(q_layer, pz_layers, dyn_layers, y0, hxz, eps,
                  oversampling=1):
    """Training rollout; same arguments and results as
    train_rollout_reference, differentiable in the weights, y0 and hxz.

    CPU tensors take the plain version; CUDA tensors launch the kernels.
    """
    if y0.device.type == "cpu":
        return train_rollout_reference(q_layer, pz_layers, dyn_layers, y0,
                                       hxz, eps, oversampling)
    if y0.device.type != "cuda":
        raise ValueError(f"train_rollout: unsupported device {y0.device}")
    device = y0.device
    n_steps, bsz, nh_inf = hxz.shape
    ny, nz = y0.shape[1], eps.shape[-1]
    _check("y0", y0, (bsz, ny), device)
    _check("hxz", hxz, (n_steps, bsz, nh_inf), device)
    _check("eps", eps, (n_steps, bsz, nz), device)
    layers = [q_layer] + list(pz_layers) + list(dyn_layers)
    for i, (w, b) in enumerate(layers):
        _check(f"weight[{i}]", w, w.shape, device)
        _check(f"bias[{i}]", b, (w.shape[0],), device)
    for mlp, d_in, d_out in ((pz_layers, ny, 2 * nz),
                             (dyn_layers, ny + nz, ny)):
        dims = [(w.shape[1], w.shape[0]) for w, _ in mlp]
        if dims[0][0] != d_in or dims[-1][1] != d_out or any(
                a[1] != b[0] for a, b in zip(dims, dims[1:])):
            raise ValueError("train_rollout: MLP widths do not match ny/nz")
    if tuple(q_layer[0].shape) != (2 * nz, nh_inf):
        raise ValueError("train_rollout: q_z weight does not match nz/hxz")
    if oversampling < 1:
        raise ValueError(f"train_rollout: oversampling {oversampling} < 1")
    if n_steps == 0 or bsz == 0:
        raise ValueError("train_rollout: needs at least one substep and row")
    flat = [t for w, b in layers for t in (w, b)]
    return TrainRollout.apply(oversampling, len(pz_layers), y0.contiguous(),
                              hxz.contiguous(), eps.contiguous(), *flat)
