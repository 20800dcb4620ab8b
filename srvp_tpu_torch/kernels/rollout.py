"""Pure-prior latent rollout: CUDA kernel wrapper, its launch plan and weight
packing, and its plain version.

Replaces the Pallas TPU kernel `_rollout_kernel` of
srvp_tpu/ops/pallas/rollout.py (`prior_rollout_fused`). The kernel
(csrc/rollout.cu) runs the whole rollout in one launch, the substep loop
inside the block, fp32 FMA throughout. A thread-block cluster of C blocks
shares a tile of R batch rows and splits every layer's output columns
across its ranks, which exchange their slices through distributed shared
memory: each SM takes in 1/C of the weights (4.44 MB at the flagship
widths) a substep, from L2. `cluster_plan` picks R and C for a batch,
`pack_layout` lays out each rank's slice of every weight. See the source for
the design.

`prior_rollout` runs the custom op `srvp::prior_rollout` (kernels/ops.py),
whose CUDA implementation `launch_prior_rollout` launches the kernel and
whose CPU implementation is `prior_rollout_reference`; it raises for any
other device.
"""

import ctypes
import functools
from collections import namedtuple

import numpy as np
import torch
import torch.nn.functional as F

from srvp_tpu_torch.ops.dists import EPS

# Kernel launches made by prior_rollout (reset it before a run to count
# that run's launches).
launches = 0

N_SMS = 132                 # the H100's SMs: a wave is one block an SM
SMEM_LIMIT = 232448         # shared memory a block can have (227 KB)
THREADS = 512               # threads a block (tile_mlp.cuh kThreads)
ONE_BLOCK_SMEM = 116 * 1024  # shared memory asked for at least (kOneBlockSmem)
ROWS = (4, 8, 12, 16)       # rows a tile (multiples of 4: 16-byte row loads)
CLUSTERS = (16, 8, 4, 2, 1)  # blocks a cluster (16 is non-portable)

# rows: R; cluster: C (blocks a cluster); tiles: ceil(B / R), so the grid
# is tiles * cluster blocks
Plan = namedtuple("Plan", "rows cluster tiles")

# A plan's time a substep, in units of what one tile row costs an SM: R +
# WEIGHT_ROWS / C. Each row costs its multiply-adds, partial sums and the
# exchange of every layer's output (which every rank receives whole); each
# SM also streams 1/C of the weights from L2, which takes WEIGHT_ROWS rows'
# time. From kernel 1's times at every one-wave plan at the flagship widths
# on an H100 (scripts/bench_torch_rollout.py --plans; PERF.md): a
# least-squares fit gives 22-30, but only a value above 32 ranks the
# fastest measured plan at B = 160 first.
WEIGHT_ROWS = 36


def cluster_plan(bsz, smem_bytes, max_clusters=None):
    """The launch plan of a cluster rollout kernel for a batch of bsz rows.

    smem_bytes(R): the block's shared memory at R rows a tile.
    max_clusters(R, C): clusters of C blocks of R rows that the card holds
    at once (the wrappers ask the card); by default N_SMS // C. Of the plans
    whose grid fits one wave, one block an SM (ceil(B / R) * C blocks at
    most N_SMS, and ceil(B / R) clusters at most max_clusters(R, C)), with
    the shared memory within SMEM_LIMIT, the one of least cost R +
    WEIGHT_ROWS / C (then the larger C, then the smaller R). A batch no plan
    fits in one wave gets C = 1 and the largest R, over several waves.
    """
    rows = [r for r in ROWS if smem_bytes(r) <= SMEM_LIMIT]
    if not rows:
        raise ValueError(f"a tile of {ROWS[0]} rows needs "
                         f"{smem_bytes(ROWS[0])} bytes of shared memory, "
                         f"more than {SMEM_LIMIT}")
    if max_clusters is None:
        max_clusters = lambda r, c: N_SMS // c  # noqa: E731
    plans = [Plan(r, c, -(-bsz // r)) for c in CLUSTERS for r in rows
             if -(-bsz // r) * c <= N_SMS
             and -(-bsz // r) <= max_clusters(r, c)]
    if not plans:
        return Plan(rows[-1], 1, -(-bsz // rows[-1]))
    return min(plans, key=lambda p: (p.rows + WEIGHT_ROWS / p.cluster,
                                     -p.cluster, p.rows))


def smem_bytes(rows, ny, nz, hmax):
    """Shared memory of the prior-rollout kernel at `rows` rows a tile: y
    and z, two activation buffers of the widest layer, the partial sums."""
    return 4 * rows * (ny + nz + 2 * hmax + 4 * THREADS)


def column_slices(dout, n_ranks):
    """[(c0, width)] of each rank: a layer's dout output columns in groups
    of 4 (16-byte loads), dealt out as evenly as the groups allow. Ranks
    beyond the groups get width 0; the last group is narrower than 4 when
    dout is not a multiple of 4."""
    groups = -(-dout // 4)
    ends = [min(dout, 4 * (groups * c // n_ranks)) for c in range(n_ranks + 1)]
    return [(a, b - a) for a, b in zip(ends, ends[1:])]


def pack_layout(shapes, n_ranks, transposed, with_bias):
    """Where each float of the packed parameter buffer comes from.

    shapes: per layer, (din, dout) of the matrix M the kernel multiplies a
    tile by (h (R, din) @ M). The source is every layer's weight flattened,
    each followed by its bias when `with_bias`, then one 0. M is the weight
    transposed when `transposed` (nn.Linear's (dout, din): the forward),
    else the weight itself (the backward's g W). Every rank's slice of M
    (`column_slices`) is its own (din, width) row-major matrix, followed by
    its slice of the bias; each piece starts at a multiple of 4 floats.

    Returns (index, meta): index, the source position of every packed float
    (the final 0 for padding), and the int32 rows {din, width, w_off, b_off,
    c0, dout} of every (layer, rank), layer-major (b_off -1: no bias)."""
    pieces, meta, off, src = [], [], 0, 0

    def put(idx):
        nonlocal off
        start = off
        pad = -idx.size % 4
        pieces.extend([idx, np.full(pad, -1)])
        off += idx.size + pad
        return start

    for din, dout in shapes:
        k = np.arange(din)[:, None]
        for c0, width in column_slices(dout, n_ranks):
            j = c0 + np.arange(width)[None, :]
            w_off = put((src + (j * din + k if transposed else k * dout + j))
                        .reshape(-1))
            b_off = put(src + din * dout + c0 + np.arange(width)) \
                if with_bias else -1
            meta.append([din, width, w_off, b_off, c0, dout])
        src += din * dout + (dout if with_bias else 0)
    index = np.concatenate(pieces).astype(np.int64)
    index[index < 0] = src
    return index, meta


@functools.lru_cache(maxsize=None)
def _packing(shapes, n_ranks, transposed, with_bias, device):
    index, meta = pack_layout(shapes, n_ranks, transposed, with_bias)
    return (torch.from_numpy(index).to(device),
            torch.tensor(meta, dtype=torch.int32, device=device))


def pack(layers, n_ranks, transposed, with_bias):
    """The packed parameter buffer of `layers` [(weight (dout, din), bias)]
    for clusters of n_ranks (pack_layout), and its int32 meta rows on the
    weights' device. The layout tables are built once per shapes and
    device; the weights are gathered on every call."""
    if transposed:
        shapes = tuple((w.shape[1], w.shape[0]) for w, _ in layers)
    else:
        shapes = tuple(tuple(w.shape) for w, _ in layers)
    device = layers[0][0].device
    index, meta = _packing(shapes, n_ranks, transposed, with_bias, device)
    parts = [t.reshape(-1) for w, b in layers
             for t in ((w, b) if with_bias else (w,))]
    src = torch.cat(parts + [parts[0].new_zeros(1)])
    return src.index_select(0, index), meta


_max_clusters = {}


def max_clusters(query, dims, rows, cluster, device):
    """Clusters of `cluster` blocks of `rows` rows that the card holds at
    once, by the kernel library's `query` (cudaOccupancyMaxActiveClusters;
    dims are its shape arguments); cached per device."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (query.__name__, dims, rows, cluster, index)
    if key not in _max_clusters:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = query(*dims, rows, cluster, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"{query.__name__} failed: cudaError {err}")
        _max_clusters[key] = n.value
    return _max_clusters[key]


def check_schedulable(query, dims, plan, device):
    """Raises unless the card can hold at least one cluster of the plan;
    returns how many it holds at once."""
    n = max_clusters(query, dims, plan.rows, plan.cluster, device)
    if n < 1:
        raise RuntimeError(
            f"{query.__name__}: clusters of {plan.cluster} blocks of "
            f"{plan.rows} rows cannot be scheduled on {device} "
            f"({torch.cuda.get_device_name(device)})")
    return n


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


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _lib():
    from srvp_tpu_torch.kernels.build import load_library
    return load_library()


def launch_plan(pz_layers, dyn_layers, bsz, ny, nz):
    """The plan prior_rollout launches for a batch of bsz rows on the card
    of the weights (cluster_plan, with the clusters that card holds at
    once), and the widest layer output (hmax) it is planned for."""
    hmax = max(w.shape[0] for w, _ in list(pz_layers) + list(dyn_layers))
    query = _lib().srvp_prior_rollout_clusters
    device = pz_layers[0][0].device
    plan = cluster_plan(
        bsz, lambda r: smem_bytes(r, ny, nz, hmax),
        lambda r, c: max_clusters(query, (ny, nz, hmax), r, c, device))
    return plan, hmax


def resident_clusters(ny, nz, hmax, plan, device):
    """Clusters of the prior rollout's plan that the card holds at once;
    raises if it cannot hold one."""
    return check_schedulable(_lib().srvp_prior_rollout_clusters,
                             (ny, nz, hmax), plan, device)


def prior_rollout(pz_layers, dyn_layers, y0, eps, ny, nz, oversampling=1,
                  plan=None):
    """Prior rollout; same arguments and result as prior_rollout_reference.

    It runs the custom op `srvp::prior_rollout` (kernels/ops.py), which
    takes the plain version for CPU tensors and launches the kernel for CUDA
    tensors with `plan` (a Plan; by default cluster_plan's for the batch).
    It raises for another device, and if the card cannot schedule the
    plan's cluster.
    """
    if y0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"prior_rollout: unsupported device {y0.device}")
    from srvp_tpu_torch.kernels import ops
    rows, cluster = (plan.rows, plan.cluster) if plan else (0, 0)
    return ops.prior_rollout(
        [w for w, _ in pz_layers], [b for _, b in pz_layers],
        [w for w, _ in dyn_layers], [b for _, b in dyn_layers], y0, eps,
        ny, nz, oversampling, rows, cluster)


def launch_prior_rollout(pz_layers, dyn_layers, y0, eps, ny, nz,
                         oversampling, plan=None):
    """The CUDA implementation of `srvp::prior_rollout`: checks the
    tensors, launches the kernel with `plan` (cluster_plan's when None) on
    the current stream and adds one to `launches`."""
    global launches
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

    default, hmax = launch_plan(pz_layers, dyn_layers, bsz, ny, nz)
    plan = plan or default
    resident_clusters(ny, nz, hmax, plan, device)
    with torch.no_grad():
        params, meta = pack(layers, plan.cluster, True, True)
    # the C function launches on the calling thread's current device
    with torch.cuda.device(device):
        err = _lib().srvp_prior_rollout(
            params.data_ptr(), meta.data_ptr(), len(pz_layers),
            len(dyn_layers), y0.data_ptr(), eps.data_ptr(), out.data_ptr(),
            bsz, ny, nz, n_steps, oversampling, hmax, plan.rows, plan.cluster,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"srvp_prior_rollout launch failed: cudaError {err}")
    launches += 1
    return out
