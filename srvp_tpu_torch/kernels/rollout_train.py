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
launches: the forward and a reverse-time carry pass on the prior rollout's
cluster design (kernels/rollout.py `cluster_plan`: a thread-block cluster
shares a tile of rows and splits each layer's columns across its SMs; the
plans are `fwd_plan` and `bwd_plan`), then a weight-gradient pass that owns
each tile of each dW (deterministic, no atomics). At the flagship widths a
row does 1,120,256 multiply-adds per substep, so B=128, K=14 is 4.0 GFLOP
forward and about twice that backward: arithmetic-bound on the H100's fp32
cores. eps is noise: it gets no gradient.

`train_rollout` runs `TrainRollout` (the kernels) for CUDA tensors and
`train_rollout_reference` for CPU tensors, `train_rollout_forward` the
forward alone with its stashes; both raise for any other device.
"""

import functools

import torch
import torch.nn.functional as F

from srvp_tpu_torch.kernels.rollout import (ONE_BLOCK_SMEM, THREADS,
                                            _check, _lib,
                                            check_schedulable, cluster_plan,
                                            max_clusters, pack)
from srvp_tpu_torch.ops.dists import rsample

# Launches of the forward kernel, and of the two backward passes (two per
# backward). Reset them before a run to count that run's launches.
fwd_launches = 0
bwd_launches = 0
# Set to a list to time the backward's parts: each backward then appends a
# dict of CUDA events recorded on its stream, "start", "carry" and "wgrad"
# (each a (before, after) pair around the launch) and "end".
bwd_events = None


def _mlp_stash(layers, h):
    """_mlp, and the pre-activations of its hidden layers side by side."""
    pre = []
    for il, (w, b) in enumerate(layers):
        if il > 0:
            pre.append(h)
            h = torch.relu(h)
        h = F.linear(h, w, b)
    return h, pre


def train_rollout_reference(q_layer, pz_layers, dyn_layers, y0, hxz, eps,
                            oversampling=1, stash=False):
    """Plain PyTorch training rollout, differentiable by autograd.

    q_layer: (weight (2nz, nh_inf), bias) of q_z; pz_layers / dyn_layers:
    [(weight (out, in), bias)]. y0 (B, ny); hxz (K, B, nh_inf) the z-LSTM
    output of each substep's frame; eps (K, B, nz), of which only the first
    substep of each frame is read. Returns (ys, res (K, B, ny), q_par, p_par
    (K, B, 2nz), zs (K, B, nz)); with `stash`, also the hidden layers'
    pre-activations of p_z and of the dynamics, (K, B, sum of the hidden
    widths) each, as the forward kernel stashes them.
    """
    dt = 1.0 / oversampling
    y, z = y0, None
    outs = [[] for _ in range(7 if stash else 5)]
    for k in range(eps.shape[0]):
        q_par = F.linear(hxz[k], *q_layer)
        if k % oversampling == 0:
            z = rsample(q_par, eps[k])
        p_par, pre_p = _mlp_stash(pz_layers, y)
        r, pre_d = _mlp_stash(dyn_layers, torch.cat([y, z], dim=-1))
        r = dt * r
        y = y + r
        vals = [y, r, q_par, p_par, z]
        if stash:
            vals += [torch.cat(pre, -1) if pre
                     else y0.new_zeros((y0.shape[0], 0))
                     for pre in (pre_p, pre_d)]
        for lst, v in zip(outs, vals):
            lst.append(v)
    return tuple(torch.stack(v) for v in outs)


def fwd_smem_bytes(rows, ny, nz, nh_inf, hmax):
    """Shared memory of the forward at `rows` rows a tile: y and z, the hxz
    tile, q, two buffers of the widest layer output, the partial sums; at
    least ONE_BLOCK_SMEM, as the kernel asks for."""
    return max(ONE_BLOCK_SMEM, 4 * rows * (ny + nz + nh_inf + 2 * nz
                                           + 2 * hmax + 4 * THREADS))


def fwd_plan(bsz, ny, nz, nh_inf, hmax, device):
    """The forward's launch plan on `device` (rollout.cluster_plan, with the
    clusters the card holds at once)."""
    query = _lib().srvp_train_rollout_fwd_clusters
    return cluster_plan(
        bsz, lambda r: fwd_smem_bytes(r, ny, nz, nh_inf, hmax),
        lambda r, c: max_clusters(query, (ny, nz, nh_inf, hmax), r, c,
                                  device))


def fwd_hmax(layers):
    """The forward's widest layer output."""
    return max(w.shape[0] for w, _ in layers)


def bwd_smem_bytes(rows, ny, nz, hmax):
    """Shared memory of the carry pass at `rows` rows a tile: the carried
    dL/dy and z gradient, the MLPs' input cotangents, q's cotangent, two
    buffers of the widest layer, the partial sums."""
    return 4 * rows * (3 * ny + 4 * nz + 2 * hmax + 4 * THREADS)


def bwd_plan(bsz, ny, nz, hmax, device):
    """The carry pass's launch plan on `device` (rollout.cluster_plan, with
    the clusters the card holds at once)."""
    query = _lib().srvp_train_rollout_bwd_clusters
    return cluster_plan(
        bsz, lambda r: bwd_smem_bytes(r, ny, nz, hmax),
        lambda r, c: max_clusters(query, (ny, nz, hmax), r, c, device))


def bwd_hmax(layers):
    """The carry pass's widest layer input or output."""
    return max(max(w.shape) for w, _ in layers)


def _layers(flat, n_pz):
    pairs = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
    return pairs[0], pairs[1:1 + n_pz], pairs[1 + n_pz:]


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _forward(layers, n_pz, y0, hxz, eps, oversampling, plan):
    """Launches the forward kernel on checked, contiguous CUDA tensors with
    `plan` (None: fwd_plan's); returns the five outputs and the two
    stashes."""
    global fwd_launches
    n_steps, bsz, nh_inf = hxz.shape
    ny, nz = y0.shape[1], eps.shape[2]
    device = y0.device
    lib = _lib()
    hmax = fwd_hmax(layers)
    plan = plan or fwd_plan(bsz, ny, nz, nh_inf, hmax, device)
    check_schedulable(lib.srvp_train_rollout_fwd_clusters,
                      (ny, nz, nh_inf, hmax), plan, device)
    params, meta = pack(layers, plan.cluster, True, True)
    sw_p = sum(w.shape[0] for w, _ in layers[1:n_pz])
    sw_d = sum(w.shape[0] for w, _ in layers[1 + n_pz:-1])
    new = lambda *shape: torch.empty(shape, device=device)  # noqa: E731
    outs = (new(n_steps, bsz, ny), new(n_steps, bsz, ny),
            new(n_steps, bsz, 2 * nz), new(n_steps, bsz, 2 * nz),
            new(n_steps, bsz, nz), new(n_steps, bsz, sw_p),
            new(n_steps, bsz, sw_d))
    with torch.cuda.device(device):
        err = lib.srvp_train_rollout_fwd(
            params.data_ptr(), meta.data_ptr(), n_pz, len(layers) - 1 - n_pz,
            y0.data_ptr(), hxz.data_ptr(), eps.data_ptr(),
            *[t.data_ptr() for t in outs], bsz, ny, nz, nh_inf, n_steps,
            oversampling, hmax, plan.rows, plan.cluster, _stream(device))
    if err != 0:
        raise RuntimeError(
            f"srvp_train_rollout_fwd launch failed: cudaError {err}")
    fwd_launches += 1
    return outs


class TrainRollout(torch.autograd.Function):
    """The rollout through the CUDA kernels, with their backward.

    apply(oversampling, n_pz, fwd_plan, bwd_plan, y0, hxz, eps, q_w, q_b,
    *pz (w, b), *dyn (w, b)) -> (ys, res, q_par, p_par, zs), as
    train_rollout_reference; fwd_plan / bwd_plan: the forward's and the
    carry pass's plans (None: fwd_plan's / bwd_plan's). Weight gradients
    come back in nn.Linear's (out, in) layout.
    """

    @staticmethod
    def forward(ctx, oversampling, n_pz, fwd_plan, bwd_plan, y0, hxz, eps,
                *flat):
        q_layer, pz, dyn = _layers(flat, n_pz)
        ys, res, q_par, p_par, zs, stash_p, stash_d = _forward(
            [q_layer] + pz + dyn, n_pz, y0, hxz, eps, oversampling, fwd_plan)
        ctx.oversampling, ctx.n_pz, ctx.plan = oversampling, n_pz, bwd_plan
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
        stream = torch.cuda.current_stream(device)
        events = {} if bwd_events is not None else None

        def mark(name):
            if events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(stream)
                events.setdefault(name, []).append(ev)

        mark("start")
        cots = [c.contiguous() for c in (g_ys, g_res, g_q, g_p, g_zs)]
        lib = _lib()
        hmax = bwd_hmax(layers)
        plan = ctx.plan or bwd_plan(bsz, ny, nz, hmax, device)
        check_schedulable(lib.srvp_train_rollout_bwd_clusters, (ny, nz, hmax),
                          plan, device)
        # the carry pass reads W (out, in) as the (in', out') matrix of g W^T
        params, meta_t = pack(layers, plan.cluster, False, False)
        new = lambda *shape: torch.empty(shape, device=device)  # noqa: E731
        g_qbuf = new(n_steps, bsz, 2 * nz)
        g_pz = new(n_steps, bsz, sum(w.shape[0] for w, _ in pz))
        g_dyn = new(n_steps, bsz, sum(w.shape[0] for w, _ in dyn))
        g_y0, g_hxz = new(bsz, ny), new(n_steps, bsz, nh_inf)
        with torch.cuda.device(device):
            mark("carry")
            err = lib.srvp_train_rollout_bwd(
                params.data_ptr(), meta_t.data_ptr(), len(pz), len(dyn),
                eps.data_ptr(), q_par.data_ptr(), stash_p.data_ptr(),
                stash_d.data_ptr(), *[c.data_ptr() for c in cots],
                g_qbuf.data_ptr(), g_pz.data_ptr(), g_dyn.data_ptr(),
                g_y0.data_ptr(), g_hxz.data_ptr(), bsz, ny, nz, nh_inf,
                n_steps, ctx.oversampling, hmax, plan.rows, plan.cluster,
                stream.cuda_stream)
            mark("carry")
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
            jobs, sizes, n_grads, n_tiles = _wgrad_table(
                _shapes(layers), len(pz), ny, nz, nh_inf, device)
            grads = torch.empty(n_grads, device=device)
            mark("wgrad")
            err = lib.srvp_train_rollout_wgrad(
                jobs.data_ptr(), jobs.shape[0], n_tiles,
                *[a.data_ptr() for a in a_src],
                *[g.data_ptr() for g in g_src], grads.data_ptr(),
                n_steps * bsz, stream.cuda_stream)
            mark("wgrad")
        if err != 0:
            raise RuntimeError(
                f"srvp_train_rollout_wgrad launch failed: cudaError {err}")
        bwd_launches += 1
        views = []
        for w_off, dout, din, b_off in sizes:
            views += [grads[w_off:w_off + dout * din].view(dout, din),
                      grads[b_off:b_off + dout]]
        mark("end")
        if events is not None:
            bwd_events.append(events)
        return (None, None, None, None, g_y0, g_hxz, None, *views)


_TILE = 64


def _shapes(layers):
    return tuple(tuple(w.shape) for w, _ in layers)


@functools.lru_cache(maxsize=None)
def _wgrad_table(shapes, n_pz, ny, nz, nh_inf, device):
    """The weight-gradient pass's job table on `device` (see
    csrc/rollout_train.cu) for layers of these (out, in) shapes (q, then
    p_z's n_pz, then the dynamics'), built once per shapes and device; the
    (w_off, dout, din, b_off) of every layer's dW and db in the flat
    gradient buffer; that buffer's size; the pass's blocks.

    A sources: 0 hxz (nh_inf), 1 [y_k, z_k] (ny + nz), 2 / 3 the p_z /
    dynamics stashes. G sources: 0 q, 1 p_z, 2 dynamics cotangents."""
    rows, sizes, tile0 = [], [], 0
    off = 0

    def add(a_src, a_ld, a_off, relu, g_src, g_ld, g_off, shape):
        nonlocal tile0, off
        dout, din = shape
        w_off = off
        b_off = w_off + dout * din
        off = b_off + dout
        rows.append([a_src, a_ld, a_off, relu, g_src, g_ld, g_off, w_off,
                     b_off, din, dout, tile0])
        sizes.append((w_off, dout, din, b_off))
        tile0 += -(-dout // _TILE) * -(-din // _TILE)

    add(0, nh_inf, 0, 0, 0, 2 * nz, 0, shapes[0])
    for g_src, a_src, mlp in ((1, 2, shapes[1:1 + n_pz]),
                              (2, 3, shapes[1 + n_pz:])):
        s_ld = sum(shape[0] for shape in mlp[:-1])
        g_ld = sum(shape[0] for shape in mlp)
        g_off = 0
        for il, shape in enumerate(mlp):
            if il == 0:
                add(1, ny + nz, 0, 0, g_src, g_ld, 0, shape)
            else:
                add(a_src, s_ld, g_off - shape[1], 1, g_src, g_ld, g_off,
                    shape)
            g_off += shape[0]
    jobs = torch.tensor(rows, dtype=torch.int32, device=device)
    return jobs, tuple(sizes), off, tile0


def _check_inputs(q_layer, pz_layers, dyn_layers, y0, hxz, eps,
                  oversampling):
    """Raises unless the CUDA tensors fit the kernels."""
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


def _route(y0):
    """True for the kernels (CUDA tensors), False for the plain version (CPU
    tensors); raises for any other device."""
    if y0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"train_rollout: unsupported device {y0.device}")
    return y0.device.type == "cuda"


def train_rollout(q_layer, pz_layers, dyn_layers, y0, hxz, eps,
                  oversampling=1, fwd_plan=None, bwd_plan=None):
    """Training rollout; same arguments and results as
    train_rollout_reference, differentiable in the weights, y0 and hxz.

    CPU tensors take the plain version; CUDA tensors launch the kernels,
    the forward with `fwd_plan` and the carry pass with `bwd_plan` (each a
    rollout.Plan; by default fwd_plan's and bwd_plan's). Each raises if the
    card cannot schedule its plan's cluster.
    """
    if not _route(y0):
        return train_rollout_reference(q_layer, pz_layers, dyn_layers, y0,
                                       hxz, eps, oversampling)
    _check_inputs(q_layer, pz_layers, dyn_layers, y0, hxz, eps, oversampling)
    flat = [t for w, b in [q_layer, *pz_layers, *dyn_layers] for t in (w, b)]
    return TrainRollout.apply(oversampling, len(pz_layers), fwd_plan,
                              bwd_plan, y0.contiguous(), hxz.contiguous(),
                              eps.contiguous(), *flat)


def train_rollout_forward(q_layer, pz_layers, dyn_layers, y0, hxz, eps,
                          oversampling=1, plan=None):
    """The forward alone, without autograd: train_rollout's five outputs and
    the stashed pre-activations, as train_rollout_reference(..., stash=True)
    returns them. CPU tensors take the plain version; CUDA tensors launch
    the forward kernel with `plan` (by default fwd_plan's), which raises if
    the card cannot schedule its cluster."""
    with torch.no_grad():
        if not _route(y0):
            return train_rollout_reference(q_layer, pz_layers, dyn_layers,
                                           y0, hxz, eps, oversampling, True)
        _check_inputs(q_layer, pz_layers, dyn_layers, y0, hxz, eps,
                      oversampling)
        layers = [q_layer] + list(pz_layers) + list(dyn_layers)
        return _forward(layers, len(pz_layers), y0.contiguous(),
                        hxz.contiguous(), eps.contiguous(), oversampling,
                        plan)
