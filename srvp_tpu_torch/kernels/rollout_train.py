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
plans are `fwd_plan` and `bwd_plan`), then a weight-gradient pass in which a
cluster owns each tile of each dW and splits its row sum across its ranks
(deterministic, no atomics; the plan is `wgrad_plan`). At the flagship widths a
row does 1,120,256 multiply-adds per substep, so B=128, K=14 is 4.0 GFLOP
forward and about twice that backward: arithmetic-bound on the H100's fp32
cores. eps is noise: it gets no gradient.

`train_rollout` runs `TrainRollout` (the kernels) for CUDA tensors and
`train_rollout_reference` for CPU tensors, `train_rollout_forward` the
forward alone with its stashes; both raise for any other device.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from srvp_tpu_torch.kernels.rollout import (CLUSTERS, N_SMS, ONE_BLOCK_SMEM,
                                            THREADS, _check, _lib,
                                            check_schedulable, cluster_plan,
                                            max_clusters, pack)
from srvp_tpu_torch.ops.dists import rsample

# Launches of the forward kernel, and of the two backward passes (two per
# backward). Reset them before a run to count that run's launches.
fwd_launches = 0
bwd_launches = 0
# Set to a list to time the backward's parts: each backward then appends a
# dict of CUDA events recorded on its stream, "start", "carry" and "wgrad"
# (each a (before, after) pair around the launch) and "end"; a backward
# that a CUDA graph captures appends none.
bwd_events = None
# Set to a list to keep the weight-gradient pass's inputs: each backward
# then appends the arguments of its `weight_gradients` call, (shapes, n_pz,
# a_src, g_src).
wgrad_inputs = None


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

    apply(oversampling, n_pz, fwd_plan, bwd_plan, wgrad_plan, y0, hxz, eps,
    q_w, q_b, *pz (w, b), *dyn (w, b)) -> (ys, res, q_par, p_par, zs), as
    train_rollout_reference; fwd_plan / bwd_plan / wgrad_plan: the
    forward's, the carry pass's and the weight-gradient pass's plans (None:
    fwd_plan's / bwd_plan's / wgrad_plan's). Weight gradients come back in
    nn.Linear's (out, in) layout.
    """

    @staticmethod
    def forward(ctx, oversampling, n_pz, fwd_plan, bwd_plan, wgrad_plan, y0,
                hxz, eps, *flat):
        q_layer, pz, dyn = _layers(flat, n_pz)
        ys, res, q_par, p_par, zs, stash_p, stash_d = _forward(
            [q_layer] + pz + dyn, n_pz, y0, hxz, eps, oversampling, fwd_plan)
        ctx.oversampling, ctx.n_pz, ctx.plan = oversampling, n_pz, bwd_plan
        ctx.wgrad_plan = wgrad_plan
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
        # a graph capture records no timing events
        events = ({} if bwd_events is not None
                  and not torch.cuda.is_current_stream_capturing() else None)

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
            args = (_shapes(layers), len(pz), [hxz, yz_in, stash_p, stash_d],
                    [g_qbuf, g_pz, g_dyn])
            if wgrad_inputs is not None:
                wgrad_inputs.append(args)
            views = _weight_gradients(*args, n_steps * bsz, ctx.wgrad_plan,
                                      mark)
        mark("end")
        if events is not None:
            bwd_events.append(events)
        return (None, None, None, None, None, g_y0, g_hxz, None, *views)


def _shapes(layers):
    return tuple(tuple(w.shape) for w, _ in layers)


# The weight-gradient pass (csrc/rollout_train.cu train_rollout_wgrad_kernel)
WGRAD_THREADS = 256
WGRAD_AREA = WGRAD_THREADS * 8 * 4   # outputs a tile: 8 x 4 a thread
WGRAD_CHUNK = 16                     # rows a chunk (kTK)
# the tile shapes (TO, TI) the kernel has, in the order ties go to
WGRAD_TILES = ((128, 64), (64, 128), (256, 32), (32, 256))
# a block's fixed cost in chunk times: its pipeline's first stages, and the
# combine of the ranks' partial tiles through distributed shared memory
WGRAD_OVERHEAD_CHUNKS = 2


def _n_tiles(shape, tile):
    """Tiles of shape tile = (TO, TI) that cover a (dout, din) dW."""
    return -(-shape[0] // tile[0]) * -(-shape[1] // tile[1])


def wgrad_tiles(shapes):
    """Each layer's tile shape (TO, TI) for its (dout, din): the one of
    WGRAD_TILES with the fewest tiles, then the fewest staged floats a row
    (TO + TI), then the first. So a 512 x 512 layer gets 128 x 64 tiles and
    a thin one the shape that fits its width."""
    return tuple(min(WGRAD_TILES, key=lambda t, s=s: (_n_tiles(s, t),
                                                      t[0] + t[1]))
                 for s in shapes)


def wgrad_n_tiles(shapes):
    """Tiles of the pass in all: each layer's, of its `wgrad_tiles` shape."""
    return sum(map(_n_tiles, shapes, wgrad_tiles(shapes)))


def wgrad_rank_chunks(n_rows, split):
    """Each rank's chunks [c0, c1) of the ceil(n_rows / WGRAD_CHUNK) chunks:
    contiguous, in rank order, as even as whole chunks allow (ranks past
    the chunks get none)."""
    n_chunks = -(-n_rows // WGRAD_CHUNK)
    ends = [n_chunks * s // split for s in range(split + 1)]
    return list(zip(ends, ends[1:]))


def wgrad_cost(n_tiles, n_rows, split, clusters, blocks_per_sm):
    """The pass's time at split S in one SM's chunk times: its n_tiles * S
    blocks over the SMs that clusters of S fill at once (the card's
    `clusters` of them, at blocks_per_sm blocks an SM), each block a rank's
    chunks and WGRAD_OVERHEAD_CHUNKS. None when no cluster fits."""
    sms = min(N_SMS, clusters * split // max(blocks_per_sm, 1))
    if sms < 1:
        return None
    rounds = -(-n_tiles * split // sms)
    n_chunks = -(-n_rows // WGRAD_CHUNK)
    return rounds * (-(-n_chunks // split) + WGRAD_OVERHEAD_CHUNKS)


_wgrad_occupancy = {}
_wgrad_plans = {}


def wgrad_occupancy(split, device):
    """(clusters of `split` blocks of the weight-gradient pass that the card
    holds at once, its blocks an SM), by the kernel library's query
    (cudaOccupancyMaxActiveClusters, cudaOccupancyMaxActiveBlocksPer
    Multiprocessor); cached per device."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (split, index)
    if key not in _wgrad_occupancy:
        clusters, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _lib().srvp_train_rollout_wgrad_occupancy(
                split, ctypes.byref(clusters), ctypes.byref(per_sm))
        if err != 0:
            raise RuntimeError(f"srvp_train_rollout_wgrad_occupancy failed: "
                               f"cudaError {err}")
        _wgrad_occupancy[key] = (clusters.value, per_sm.value)
    return _wgrad_occupancy[key]


def wgrad_plan(shapes, n_rows, device):
    """The weight-gradient pass's plan on `device` for layers of these
    (out, in) shapes and n_rows = K * B rows: its split S, the blocks of a
    cluster that share a tile's row sum. Of the splits in CLUSTERS, the one
    of least `wgrad_cost` with the clusters the card holds at once (then
    the smaller S); the tiles are always `wgrad_tiles`'. Built once per
    shapes, rows and device; raises if no split can be scheduled."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (tuple(shapes), n_rows, index)
    if key not in _wgrad_plans:
        n_tiles = wgrad_n_tiles(shapes)
        costs = []
        for split in sorted(CLUSTERS):
            cost = wgrad_cost(n_tiles, n_rows, split,
                              *wgrad_occupancy(split, device))
            if cost is not None:
                costs.append((cost, split))
        if not costs:
            raise RuntimeError(f"the weight-gradient pass cannot be scheduled "
                               f"on {device}")
        _wgrad_plans[key] = min(costs)[1]
    return _wgrad_plans[key]


def wgrad_resident(split, device):
    """Clusters of `split` blocks of the pass that the card holds at once;
    raises if it cannot hold one."""
    clusters = wgrad_occupancy(split, device)[0]
    if clusters < 1:
        raise RuntimeError(
            f"srvp_train_rollout_wgrad: clusters of {split} blocks "
            f"cannot be scheduled on {device} "
            f"({torch.cuda.get_device_name(device)})")
    return clusters


@functools.lru_cache(maxsize=None)
def _wgrad_jobs(shapes, n_pz):
    """The weight-gradient pass's jobs (see csrc/rollout_train.cu), one a
    layer of these (out, in) shapes (q, then p_z's n_pz, then the
    dynamics'), with `wgrad_tiles`' tile shapes; the (w_off, dout, din,
    b_off) of every layer's dW and db in the flat gradient buffer; that
    buffer's size; the tiles in all.

    A sources: 0 hxz (nh_inf), 1 [y_k, z_k] (ny + nz), 2 / 3 the p_z /
    dynamics stashes. G sources: 0 q, 1 p_z, 2 dynamics cotangents."""
    rows, sizes, tile0 = [], [], 0
    off = 0
    tiles = wgrad_tiles(shapes)
    nh_inf, ny = shapes[0][1], shapes[1][1]
    nz = shapes[0][0] // 2

    def add(a_src, a_ld, a_off, relu, g_src, g_ld, g_off, shape):
        nonlocal tile0, off
        dout, din = shape
        to, ti = tiles[len(rows)]
        w_off = off
        b_off = w_off + dout * din
        off = b_off + dout
        rows.append([a_src, a_ld, a_off, relu, g_src, g_ld, g_off, w_off,
                     b_off, din, dout, tile0, to, ti])
        sizes.append((w_off, dout, din, b_off))
        tile0 += _n_tiles(shape, (to, ti))

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
    return tuple(map(tuple, rows)), tuple(sizes), off, tile0


def wgrad_source_widths(shapes, n_pz):
    """The widths of the pass's A sources (hxz, [y_k, z_k], the p_z and
    dynamics stashes) and G sources (q, p_z, dynamics cotangents) for
    layers of these (out, in) shapes, by its job table."""
    rows = _wgrad_jobs(tuple(map(tuple, shapes)), n_pz)[0]
    widths_a, widths_g = [0] * 4, [0] * 3
    for a_i, a_ld, _, _, g_i, g_ld, *_ in rows:
        widths_a[a_i], widths_g[g_i] = a_ld, g_ld
    return widths_a, widths_g


@functools.lru_cache(maxsize=None)
def _wgrad_table(shapes, n_pz, device):
    """_wgrad_jobs with the jobs as an int32 tensor on `device`, built once
    per shapes and device."""
    rows, sizes, n_grads, n_tiles = _wgrad_jobs(shapes, n_pz)
    return (torch.tensor(rows, dtype=torch.int32, device=device), sizes,
            n_grads, n_tiles)


def _flat_views(grads, sizes):
    views = []
    for w_off, dout, din, b_off in sizes:
        views += [grads[w_off:w_off + dout * din].view(dout, din),
                  grads[b_off:b_off + dout]]
    return views


def weight_gradients_reference(shapes, n_pz, a_src, g_src):
    """Plain version of the weight-gradient pass: per layer, dW = G^T
    act(A) by torch.mm and db = the sum of G's rows; [dW (out, in), db] per
    layer. Each layer's columns are taken from the layer shapes, not from
    the kernel's job table: q reads hxz and the q cotangents; an MLP's
    first layer the first columns of [y_k, z_k], each later layer the ReLU
    of its input's columns of the MLP's stash (its hidden layers' outputs
    side by side), and each layer its own columns of the MLP's
    cotangents."""
    a_src = [a.flatten(0, -2) for a in a_src]
    g_src = [g.flatten(0, -2) for g in g_src]
    out = [torch.mm(g_src[0].t(), a_src[0]), g_src[0].sum(0)]
    for mlp, stash, g_all in ((shapes[1:1 + n_pz], a_src[2], g_src[1]),
                              (shapes[1 + n_pz:], a_src[3], g_src[2])):
        a, a_off, g_off = a_src[1], 0, 0
        for il, (dout, din) in enumerate(mlp):
            if il > 0:
                a = torch.relu(stash[:, a_off:a_off + din])
                a_off += din
            g = g_all[:, g_off:g_off + dout]
            g_off += dout
            out += [torch.mm(g.t(), a[:, :din]), g.sum(0)]
    return out


def weight_gradients(shapes, n_pz, a_src, g_src, plan=None):
    """The weight-gradient pass: [dW (out, in), db] of every layer of these
    (out, in) shapes, from the layers' inputs a_src (hxz, [y_k, z_k], the
    p_z and dynamics stashes, (K, B, width) or (K * B, width) each) and
    output cotangents g_src (q, p_z, dynamics). CPU tensors take the plain
    version; CUDA tensors launch the kernel with `plan` (the split S; by
    default wgrad_plan's), which raises if the card cannot schedule its
    cluster."""
    device = g_src[0].device
    if device.type == "cpu":
        return weight_gradients_reference(shapes, n_pz, a_src, g_src)
    if device.type != "cuda":
        raise ValueError(f"weight_gradients: unsupported device {device}")
    n_rows = g_src[0].numel() // g_src[0].shape[-1]
    shapes = tuple(map(tuple, shapes))
    widths = wgrad_source_widths(shapes, n_pz)
    for t, width in zip(list(a_src) + list(g_src), sum(widths, [])):
        if t.device != device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.numel() != n_rows * width:
            raise ValueError("weight_gradients: the sources must be "
                             "contiguous float32 on one device, with the "
                             "same rows and the layers' widths")
    return _weight_gradients(shapes, n_pz, a_src, g_src, n_rows, plan)


def _weight_gradients(shapes, n_pz, a_src, g_src, n_rows, plan,
                      mark=lambda name: None):
    """Launches the weight-gradient pass on checked CUDA sources of n_rows
    rows with `plan` (None: wgrad_plan's), between two mark("wgrad")."""
    global bwd_launches
    device = g_src[0].device
    split = plan or wgrad_plan(shapes, n_rows, device)
    wgrad_resident(split, device)
    jobs, sizes, n_grads, n_tiles = _wgrad_table(shapes, n_pz, device)
    grads = torch.empty(n_grads, device=device)
    with torch.cuda.device(device):
        mark("wgrad")
        err = _lib().srvp_train_rollout_wgrad(
            jobs.data_ptr(), jobs.shape[0], n_tiles,
            *[a.data_ptr() for a in a_src], *[g.data_ptr() for g in g_src],
            grads.data_ptr(), n_rows, split, _stream(device))
        mark("wgrad")
    if err != 0:
        raise RuntimeError(
            f"srvp_train_rollout_wgrad launch failed: cudaError {err}")
    bwd_launches += 1
    return _flat_views(grads, sizes)


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
                  oversampling=1, fwd_plan=None, bwd_plan=None,
                  wgrad_plan=None):
    """Training rollout; same arguments and results as
    train_rollout_reference, differentiable in the weights, y0 and hxz.

    CPU tensors take the plain version; CUDA tensors launch the kernels,
    the forward with `fwd_plan` and the carry pass with `bwd_plan` (each a
    rollout.Plan; by default fwd_plan's and bwd_plan's), the weight-gradient
    pass with `wgrad_plan` (its split S; by default wgrad_plan's). Each
    raises if the card cannot schedule its plan's cluster.
    """
    if not _route(y0):
        return train_rollout_reference(q_layer, pz_layers, dyn_layers, y0,
                                       hxz, eps, oversampling)
    _check_inputs(q_layer, pz_layers, dyn_layers, y0, hxz, eps, oversampling)
    flat = [t for w, b in [q_layer, *pz_layers, *dyn_layers] for t in (w, b)]
    return TrainRollout.apply(oversampling, len(pz_layers), fwd_plan,
                              bwd_plan, wgrad_plan, y0.contiguous(),
                              hxz.contiguous(), eps.contiguous(), *flat)


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
