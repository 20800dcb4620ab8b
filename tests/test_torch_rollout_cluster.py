"""The cluster design of the latent-rollout kernels 1, 2 and 3 (carry pass
and weight-gradient pass), checked on the CPU.

The kernels (csrc/rollout.cu, csrc/rollout_train.cu) split every layer's
output columns across the C blocks of a thread-block cluster: each rank
reads its own packed slice of the weights and writes its output slice into
every rank's activation buffer. Here the launch plan (`cluster_plan`), the
column slices and the packed layout are checked directly, and the
column-split schedule is emulated in numpy, rank by rank, reading the
weights from the wrapper's packed buffer through its meta rows. The
emulated prior rollout is held at rtol 1e-4 / atol 1e-5 (tests/
test_pallas.py) against `prior_rollout_reference` and JAX's
`prior_rollout_fused(..., interpret=True)`; the emulated training forward,
its five outputs and its stashes held at rtol 2e-5 / atol 1e-6
(tests/test_torch_train_rollout.py) against `train_rollout_reference` (the
stashes against its hidden pre-activations) and the outputs against JAX's
`make_train_rollout(..., interpret=True)`; the emulated carry pass, with
the weight gradients summed from the G buffers it writes by the
weight-gradient pass's schedule (`emulate_wgrad`: the wrapper's job table,
tile by tile, each rank of a cluster over its chunks of rows, the ranks'
partials combined in rank order), at rtol 5e-4 / atol 5e-6
(tests/test_pallas_train.py) against autograd of `train_rollout_reference`
and JAX's `make_train_rollout(..., interpret=True)`, on the same weights
and noise. Widths are tiny and not multiples of 4 C (30, 6, 2 nz = 8), so
ranks get narrow, ragged or empty slices. The weight-gradient pass's
tiles, row ranges and plan (`wgrad_plan`, a fake occupancy query) are
checked at the dcgan and KTH widths too."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu.ops.pallas.rollout import prior_rollout_fused
from srvp_tpu.ops.pallas.rollout_train import make_train_rollout
from srvp_tpu_torch.kernels import rollout as kr
from srvp_tpu_torch.kernels import rollout_train as krt
from tests.torch_port_util import ROLLOUT_ATOL, ROLLOUT_RTOL

GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-6
FWD_RTOL, FWD_ATOL = 2e-5, 1e-6
NY, NZ, NH, NH_INF, NLAYERS = 6, 4, 30, 10, 3
BSZ, O, NT = 7, 2, 3
N_STEPS = O * (NT - 1)
RANKS = [1, 2, 8, 16]


# -- the launch plan -------------------------------------------------------

# H100 80GB HBM3: clusters the card holds at once, by C, for both kernels
# at the flagship widths (cudaOccupancyMaxActiveClusters; PERF.md)
H100_CLUSTERS = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}


def _smem(rows):
    return kr.smem_bytes(rows, 20, 20, 512)


def _bwd_smem(rows):
    return krt.bwd_smem_bytes(rows, 50, 50, 512)


@pytest.mark.parametrize("bsz", [5, 37, 100, 128, 160, 1600])
@pytest.mark.parametrize("resident", [None, H100_CLUSTERS])
def test_plan_fits_one_wave(bsz, resident):
    cap = (lambda r, c: kr.N_SMS // c) if resident is None \
        else (lambda r, c: resident[c])
    cost = lambda r, c: r + kr.WEIGHT_ROWS / c  # noqa: E731
    for smem in (_smem, _bwd_smem):
        plan = kr.cluster_plan(bsz, smem, cap)
        assert plan.rows in kr.ROWS and plan.cluster in kr.CLUSTERS
        assert plan.tiles == -(-bsz // plan.rows)
        assert plan.tiles <= cap(plan.rows, plan.cluster)
        assert plan.tiles * plan.cluster <= kr.N_SMS
        assert smem(plan.rows) <= kr.SMEM_LIMIT
        # no plan that fits one wave costs less
        for c in kr.CLUSTERS:
            for r in kr.ROWS:
                if -(-bsz // r) <= cap(r, c) \
                        and -(-bsz // r) * c <= kr.N_SMS:
                    assert cost(r, c) >= cost(plan.rows, plan.cluster)


def test_plan_examples():
    h100 = lambda r, c: H100_CLUSTERS[c]  # noqa: E731
    for resident in (None, h100):
        assert kr.cluster_plan(160, _smem, resident) == kr.Plan(12, 8, 14)
        assert kr.cluster_plan(100, _bwd_smem, resident) == kr.Plan(8, 8, 13)
        assert kr.cluster_plan(1600, _smem, resident) == kr.Plan(16, 1, 100)
        # beyond one wave even at C = 1: the largest R, several waves
        assert kr.cluster_plan(4000, _smem, resident) == kr.Plan(16, 1, 250)
    # the card's own cluster occupancy bounds the wave: 16 clusters of 8
    # fit 132 SMs, the H100 holds 15 of those at once (of 8-row tiles, two
    # blocks an SM, 30: the wave still takes one block an SM)
    assert kr.cluster_plan(128, _bwd_smem) == kr.Plan(8, 8, 16)
    assert kr.cluster_plan(128, _bwd_smem, h100) == kr.Plan(12, 8, 11)
    assert kr.cluster_plan(128, _bwd_smem, lambda r, c: 30) == \
        kr.Plan(8, 8, 16)
    assert kr.cluster_plan(160, _smem, lambda r, c: 30) == kr.Plan(12, 8, 14)
    # shared memory: two buffers of 4096 hidden units fit 4 rows at most
    wide = lambda r: kr.smem_bytes(r, 20, 20, 4096)  # noqa: E731
    assert kr.cluster_plan(160, wide).rows == 4
    with pytest.raises(ValueError, match="shared memory"):
        kr.cluster_plan(160, lambda r: kr.smem_bytes(r, 20, 20, 16384))


def test_unschedulable_plan_raises(monkeypatch):
    """The wrapper's guard: a plan the card holds no cluster of raises (a
    stand-in for the library's cudaOccupancyMaxActiveClusters query, and
    for the card)."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "card")

    def query(ny, nz, hmax, rows, cluster, n):
        n._obj.value = 0 if cluster == 16 else 3
        return 0
    query.__name__ = "fake_clusters"
    dev = torch.device("cuda", 7)
    assert kr.check_schedulable(query, (1, 2, 3), kr.Plan(4, 8, 1), dev) == 3
    assert kr.max_clusters(query, (1, 2, 3), 4, 8, dev) == 3
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        kr.check_schedulable(query, (1, 2, 3), kr.Plan(4, 16, 1), dev)


def _fake_cuda(monkeypatch):
    """Stand-ins for the card around the wrappers' occupancy query: device
    7, no device switch, a fresh cache of the query's answers."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "card")
    monkeypatch.setattr(kr, "_max_clusters", {})
    monkeypatch.setattr(krt, "_wgrad_occupancy", {})
    monkeypatch.setattr(krt, "_wgrad_plans", {})
    return torch.device("cuda", 7)


def _fake_query(resident, asked):
    """A stand-in for the library's srvp_train_rollout_fwd_clusters that
    answers resident[C] and records its arguments in `asked`."""
    def query(ny, nz, nh_inf, hmax, rows, cluster, n):
        asked.append((ny, nz, nh_inf, hmax, rows, cluster))
        n._obj.value = resident.get(cluster, 0)
        return 0
    query.__name__ = "fake_fwd_clusters"
    return query


@pytest.mark.parametrize("bsz,ny,plan", [(128, 20, kr.Plan(12, 8, 11)),
                                         (100, 50, kr.Plan(8, 8, 13)),
                                         (1600, 20, kr.Plan(16, 1, 100))])
def test_fwd_plan_examples(monkeypatch, bsz, ny, plan):
    """The forward's plan at the training steps' batches (dcgan B = 128,
    KTH B = 100) with the H100's cluster occupancy (15 clusters of 8), and
    a batch past one wave; the card is asked with the forward's widths."""
    dev = _fake_cuda(monkeypatch)
    asked = []
    monkeypatch.setattr(krt, "_lib", lambda: SimpleNamespace(
        srvp_train_rollout_fwd_clusters=_fake_query(H100_CLUSTERS, asked)))
    assert krt.fwd_plan(bsz, ny, ny, 256, 512, dev) == plan
    assert asked and all(a[:4] == (ny, ny, 256, 512) for a in asked)
    # every plan asks for at least the shared memory of one block an SM
    assert krt.fwd_smem_bytes(4, 20, 20, 256, 512) == kr.ONE_BLOCK_SMEM
    assert krt.fwd_smem_bytes(12, 20, 20, 256, 512) == 48 * 3408
    assert krt.fwd_smem_bytes(16, 50, 50, 256, 512) <= kr.SMEM_LIMIT


@pytest.mark.parametrize("cluster,schedulable", [(8, True), (16, False)])
def test_fwd_unschedulable_plan_raises(monkeypatch, cluster, schedulable):
    """The forward's wrapper asks the card for its plan's cluster before
    the launch: a plan it holds none of raises and launches nothing; one it
    holds is launched as given (the C entry's arguments in its order)."""
    dev = _fake_cuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: dev.index)
    launched = []

    def launch(*args):
        launched.append(args)
        return 0
    asked = []
    monkeypatch.setattr(krt, "_lib", lambda: SimpleNamespace(
        srvp_train_rollout_fwd_clusters=_fake_query({8: 15, 16: 0}, asked),
        srvp_train_rollout_fwd=launch))
    monkeypatch.setattr(krt, "_stream", lambda device: 0)
    gen = torch.Generator().manual_seed(0)
    dims = [(NH_INF, 2 * NZ), (NY, NH), (NH, 2 * NZ), (NY + NZ, NH),
            (NH, NY)]
    layers = [(torch.randn(o, i, generator=gen), torch.randn(o, generator=gen))
              for i, o in dims]
    y0, hxz, eps = (torch.randn(*shape, generator=gen) for shape in
                    ((BSZ, NY), (3, BSZ, NH_INF), (3, BSZ, NZ)))
    plan = kr.Plan(4, cluster, 2)
    before = krt.fwd_launches
    if not schedulable:
        with pytest.raises(RuntimeError, match="cannot be scheduled"):
            krt._forward(layers, 2, y0, hxz, eps, 1, plan)
        assert not launched and krt.fwd_launches == before
        return
    outs = krt._forward(layers, 2, y0, hxz, eps, 1, plan)
    assert krt.fwd_launches == before + 1
    (args,) = launched
    assert len(args) == 24
    assert args[2:4] == (2, 2)                          # n_pz, n_dyn
    assert args[14:] == (BSZ, NY, NZ, NH_INF, 3, 1, NH, 4, cluster, 0)
    assert [o.shape for o in outs] == [
        (3, BSZ, NY), (3, BSZ, NY), (3, BSZ, 2 * NZ), (3, BSZ, 2 * NZ),
        (3, BSZ, NZ), (3, BSZ, NH), (3, BSZ, NH)]
    assert list(args[7:14]) == [o.data_ptr() for o in outs]


# -- the weight-gradient pass's tiles and plan --------------------------------

def _model_shapes(ny, nz, nh_inf=256, nh=512, nlayers=4):
    """(out, in) of q, p_z's and the dynamics' layers at these widths."""
    def mlp(din, dout):
        dims = [din] + [nh] * (nlayers - 1) + [dout]
        return [(b, a) for a, b in zip(dims, dims[1:])]
    return tuple([(2 * nz, nh_inf)] + mlp(ny, 2 * nz) + mlp(ny + nz, ny))


DCGAN_SHAPES = _model_shapes(20, 20)
KTH_SHAPES = _model_shapes(50, 50)
TINY_SHAPES = _model_shapes(NY, NZ, NH_INF, NH, NLAYERS)


@pytest.mark.parametrize("shapes", [DCGAN_SHAPES, KTH_SHAPES, TINY_SHAPES],
                         ids=["dcgan", "kth", "tiny"])
def test_wgrad_tiles_write_each_element_once(shapes):
    """Every dW and db element of the flat gradient buffer is written by
    exactly one tile (db by the tiles at i0 = 0); the tiles of a job follow
    each other from tile0."""
    n_pz = (len(shapes) - 1) // 2
    jobs, sizes, n_grads, n_tiles = krt._wgrad_jobs(shapes, n_pz)
    assert n_tiles == krt.wgrad_n_tiles(shapes)
    written = np.zeros(n_grads, np.int64)
    tile = 0
    for job, shape in zip(jobs, shapes):
        *_, w_off, b_off, din, dout, tile0, to, ti = job
        assert (dout, din) == shape and tile0 == tile
        tiles_i = -(-din // ti)
        for t in range(-(-dout // to) * tiles_i):
            o0, i0 = (t // tiles_i) * to, (t % tiles_i) * ti
            assert o0 < dout and i0 < din          # no tile is all padding
            o = np.arange(o0, min(o0 + to, dout))
            i = np.arange(i0, min(i0 + ti, din))
            written[w_off + (o[:, None] * din + i).reshape(-1)] += 1
            if i0 == 0:
                written[b_off + o] += 1
            tile += 1
    assert tile == n_tiles
    np.testing.assert_array_equal(written, 1)


@pytest.mark.parametrize("n_rows", [1, 15, 16, 17, 28, 100, 1792, 3800])
@pytest.mark.parametrize("split", kr.CLUSTERS)
def test_wgrad_rank_rows_partition(n_rows, split):
    """The ranks' row ranges are contiguous, chunk-aligned, in rank order,
    cover [0, N) once (N not a multiple of the chunk, or below S chunks:
    some ranks get none), and differ by at most one chunk."""
    ranks = krt.wgrad_rank_chunks(n_rows, split)
    chunk = krt.WGRAD_CHUNK
    assert len(ranks) == split
    rows = [np.arange(c0 * chunk, min(c1 * chunk, n_rows)) for c0, c1 in ranks]
    np.testing.assert_array_equal(np.concatenate(rows), np.arange(n_rows))
    assert ranks[0][0] == 0 and ranks[-1][1] == -(-n_rows // chunk)
    assert all(a[1] == b[0] for a, b in zip(ranks, ranks[1:]))
    sizes = [c1 - c0 for c0, c1 in ranks]
    assert max(sizes) - min(sizes) <= 1
    # no chunk starts past N
    assert all(c0 * chunk < n_rows for c0, c1 in ranks if c1 > c0)


@pytest.mark.parametrize("shapes", [DCGAN_SHAPES, KTH_SHAPES],
                         ids=["dcgan", "kth"])
def test_wgrad_tiles_fit_the_layers(shapes):
    """The 512 x 512 layers get 128 x 64 tiles; every block of a thin layer
    (q, and each MLP's first and last) is at most half padding."""
    tiles = krt.wgrad_tiles(shapes)
    for shape, tile in zip(shapes, tiles):
        assert tile in krt.WGRAD_TILES and tile[0] * tile[1] == \
            krt.WGRAD_AREA
        if shape == (512, 512):
            assert tile == (128, 64)
        useful = shape[0] * shape[1] / (krt._n_tiles(shape, tile)
                                        * krt.WGRAD_AREA)
        assert useful >= 0.5, (shape, tile, useful)
    n_tiles = krt.wgrad_n_tiles(shapes)
    assert n_tiles == (142 if shapes == DCGAN_SHAPES else 156)


# H100 80GB HBM3: the weight-gradient pass's occupancy, (clusters of S
# blocks the card holds at once, blocks an SM), by S (its occupancy
# queries; PERF.md)
WGRAD_H100 = {1: (264, 2), 2: (132, 2), 4: (62, 2), 8: (30, 2), 16: (14, 2)}


def _fake_wgrad_query(resident, asked):
    """A stand-in for the library's srvp_train_rollout_wgrad_occupancy that
    answers resident[S] and records S in `asked`."""
    def query(split, clusters, per_sm):
        asked.append(split)
        clusters._obj.value, per_sm._obj.value = resident.get(split, (0, 0))
        return 0
    return query


@pytest.mark.parametrize("shapes,n_rows,split", [
    (DCGAN_SHAPES, 128 * 14, 4),      # the dcgan training step
    (KTH_SHAPES, 100 * 38, 8),        # the KTH training step
    (TINY_SHAPES, 28, 2),             # two chunks: one a rank
])
def test_wgrad_plan_examples(monkeypatch, shapes, n_rows, split):
    """The weight-gradient pass's plan at the training steps' rows with the
    H100's occupancy: the split of least wgrad_cost over wgrad_tiles'
    tiles; the card is asked once per split, then the plan is kept."""
    dev = _fake_cuda(monkeypatch)
    asked = []
    monkeypatch.setattr(krt, "_lib", lambda: SimpleNamespace(
        srvp_train_rollout_wgrad_occupancy=_fake_wgrad_query(WGRAD_H100,
                                                             asked)))
    plan = krt.wgrad_plan(shapes, n_rows, dev)
    assert plan == split
    assert sorted(asked) == sorted(kr.CLUSTERS)
    assert krt.wgrad_plan(shapes, n_rows, dev) == plan
    assert len(asked) == len(kr.CLUSTERS)
    n_tiles = krt.wgrad_n_tiles(shapes)
    costs = {s: krt.wgrad_cost(n_tiles, n_rows, s, *WGRAD_H100[s])
             for s in kr.CLUSTERS}
    assert costs[split] == min(costs.values())


def test_wgrad_cost():
    """Blocks over the SMs that the clusters fill, each its rank's chunks
    and the fixed cost: at dcgan's 142 tiles and 112 chunks, S = 4 runs 5
    blocks an SM of 28 chunks on the 124 SMs of 62 clusters; no cluster, no
    cost."""
    over = krt.WGRAD_OVERHEAD_CHUNKS
    assert krt.wgrad_cost(142, 1792, 4, 62, 2) == 5 * (28 + over)
    assert krt.wgrad_cost(142, 1792, 1, 264, 2) == 2 * (112 + over)
    assert krt.wgrad_cost(142, 1792, 8, 15, 1) == 10 * (14 + over)
    assert krt.wgrad_cost(142, 1792, 16, 0, 0) is None


def test_wgrad_unschedulable_plan_raises(monkeypatch):
    """A split the card holds no cluster of raises at the launch's guard;
    a card that holds none at any split has no plan."""
    dev = _fake_cuda(monkeypatch)
    resident = {1: (132, 1), 2: (66, 1)}
    monkeypatch.setattr(krt, "_lib", lambda: SimpleNamespace(
        srvp_train_rollout_wgrad_occupancy=_fake_wgrad_query(resident, [])))
    assert krt.wgrad_resident(2, dev) == 66
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        krt.wgrad_resident(16, dev)
    assert krt.wgrad_plan(DCGAN_SHAPES, 1792, dev) in (1, 2)
    monkeypatch.setattr(krt, "_wgrad_occupancy", {})
    monkeypatch.setattr(krt, "_lib", lambda: SimpleNamespace(
        srvp_train_rollout_wgrad_occupancy=_fake_wgrad_query({}, [])))
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        krt.wgrad_plan(KTH_SHAPES, 3800, dev)


# -- column slices and the packed layout -------------------------------------

@pytest.mark.parametrize("dout", [2 * NZ, NY, NH, 40, 512, 1])
@pytest.mark.parametrize("n_ranks", RANKS)
def test_slices_cover_each_column_once(dout, n_ranks):
    slices = kr.column_slices(dout, n_ranks)
    assert len(slices) == n_ranks
    cols = np.concatenate([c0 + np.arange(w) for c0, w in slices])
    np.testing.assert_array_equal(cols, np.arange(dout))
    # every slice but the last non-empty one is whole groups of 4
    widths = [w for _, w in slices if w]
    assert all(w % 4 == 0 for w in widths[:-1])
    assert max(widths) - min(widths) <= 4 + (-dout % 4)


@pytest.mark.parametrize("transposed,with_bias", [(True, True),
                                                  (False, False)])
@pytest.mark.parametrize("n_ranks", RANKS)
def test_packed_slices_hold_the_weights(transposed, with_bias, n_ranks):
    gen = torch.Generator().manual_seed(0)
    dims = [(NY, NH), (NH, NH), (NH, 2 * NZ), (NH_INF, 2 * NZ)]
    layers = [(torch.randn(o, i, generator=gen), torch.randn(o, generator=gen))
              for i, o in dims]
    params, meta = kr.pack(layers, n_ranks, transposed, with_bias)
    params, meta = params.numpy(), meta.numpy()
    assert meta.shape == (len(layers) * n_ranks, 6)
    for il, (w, b) in enumerate(layers):
        mat = (w.t() if transposed else w).numpy()     # (din, dout)
        for c, (din, width, w_off, b_off, c0, dout) in enumerate(
                meta[il * n_ranks:(il + 1) * n_ranks]):
            assert (din, dout) == mat.shape
            assert (c0, width) == kr.column_slices(dout, n_ranks)[c]
            assert w_off % 4 == 0                       # 16-byte aligned
            np.testing.assert_array_equal(
                params[w_off:w_off + din * width].reshape(din, width),
                mat[:, c0:c0 + width])
            if with_bias:
                assert b_off % 4 == 0
                np.testing.assert_array_equal(
                    params[b_off:b_off + width], b.numpy()[c0:c0 + width])
            else:
                assert b_off == -1


# -- the column-split schedule, emulated rank by rank -------------------------

def _slice(params, m):
    din, width, w_off, b_off, c0, _ = (int(v) for v in m)
    w = params[w_off:w_off + din * width].reshape(din, width)
    b = params[b_off:b_off + width] if b_off >= 0 else 0.0
    return w, b, c0, width


def _cluster_dense(params, meta, h, dst, epi=None):
    """One layer: each rank (meta rows in rank order) computes its columns
    from its packed slice and its own copy of the input h[c] ((R, din)),
    and writes them into dst[q] of every rank q; epi(c0, cols, v) may
    transform them first. Checks that every column was written once."""
    n = len(meta)
    for q in range(n):
        dst[q][:] = np.nan
    for c in range(n):
        w, b, c0, width = _slice(params, meta[c])
        if width == 0:
            continue
        v = (h[c] @ w + b).astype(np.float32)
        if epi is not None:
            v = epi(c0, np.arange(c0, c0 + width), v)
        for q in range(n):
            assert np.all(np.isnan(dst[q][:, c0:c0 + width]))
            dst[q][:, c0:c0 + width] = v
    assert not any(np.isnan(d).any() for d in dst)


def emulate_prior(pz, dyn, y0, eps, n_ranks, rows):
    """csrc/rollout.cu's schedule on tiles of `rows` rows."""
    layers = pz + dyn
    params, meta = kr.pack(layers, n_ranks, True, True)
    params, meta = params.numpy(), meta.numpy()
    n_pz = len(pz)
    bsz = y0.shape[0]
    out = np.zeros((eps.shape[0], bsz, NY), np.float32)
    for row0 in range(0, bsz, rows):
        sl = slice(row0, min(bsz, row0 + rows))
        n = sl.stop - sl.start

        def pad(a):
            return np.concatenate([a, np.zeros((rows - n,) + a.shape[1:],
                                               np.float32)])
        yz = [np.concatenate([pad(y0[sl]), np.zeros((rows, NZ), np.float32)],
                             1) for _ in range(n_ranks)]

        def mlp(first, n_layers, h):
            for il in range(n_layers):
                ms = meta[(first + il) * n_ranks:(first + il + 1) * n_ranks]
                dout = int(ms[0][5])
                dst = [np.empty((rows, dout), np.float32)
                       for _ in range(n_ranks)]
                relu = il < n_layers - 1
                _cluster_dense(params, ms, h, dst,
                               (lambda c0, j, v: np.maximum(v, 0)) if relu
                               else None)
                h = dst
            return h

        for t in range(eps.shape[0]):
            if t % O == 0:
                p = mlp(0, n_pz, [a[:, :NY] for a in yz])
                e = pad(eps[t][sl])
                for c in range(n_ranks):
                    sp = np.logaddexp(0, p[c][:, NZ:]).astype(np.float32)
                    yz[c][:, NY:] = p[c][:, :NZ] + e * (sp + np.float32(1e-8))
            res = mlp(n_pz, len(dyn), yz)
            for c in range(n_ranks):
                yz[c][:, :NY] += np.float32(1.0 / O) * res[c]
            for c in range(1, n_ranks):     # every rank holds the same tile
                np.testing.assert_array_equal(yz[c], yz[0])
            out[t, sl] = yz[0][:n, :NY]
    return out


def emulate_train_forward(q, pz, dyn, y0, hxz, eps, n_ranks, rows,
                          oversampling=O):
    """csrc/rollout_train.cu's forward on tiles of `rows` rows: each rank
    computes its columns of every layer from its packed slice and its own
    copy of the layer's input; the owner of a column stores it (q, p and
    the hidden pre-activations, each element once), rank 0 stores z, y and
    the residual. q reaches the other ranks only on the substeps that draw
    z from it; p_z's last layer reaches none. Returns (ys, res, q_par,
    p_par, zs, stash_p, stash_d)."""
    layers = [q] + pz + dyn
    n_pz, n_dyn = len(pz), len(dyn)
    params, meta = kr.pack(layers, n_ranks, True, True)
    params, meta = params.numpy(), meta.numpy()
    rows_of = lambda first: meta[first * n_ranks:(first + 1) * n_ranks]  # noqa
    k_steps, bsz = hxz.shape[:2]
    dt = np.float32(1.0 / oversampling)
    widths = (NY, NY, 2 * NZ, 2 * NZ, NZ,
              sum(w.shape[0] for w, _ in pz[:-1]),
              sum(w.shape[0] for w, _ in dyn[:-1]))
    outs = [np.full((k_steps, bsz, w), np.nan, np.float32) for w in widths]
    ys, res, q_par, p_par, zs, st_p, st_d = outs

    def store(dst, cols, v):
        """dst: the tile's valid rows of an output; every element once."""
        assert np.all(np.isnan(dst[:, cols]))
        dst[:, cols] = v[:dst.shape[0]]

    def mlp(first, n, h, stash, out):
        """mlp_fwd: a hidden layer's owner stashes its columns and pushes
        their ReLU; the last layer is stored to `out` (not pushed), or
        pushed when out is None."""
        off = 0
        for il in range(n):
            ms = rows_of(first + il)
            dout = int(ms[0][5])
            dst = [np.empty((rows, dout), np.float32) for _ in range(n_ranks)]
            if il < n - 1:
                def epi(c0, j, v, off=off):
                    store(stash, off + j, v)
                    return np.maximum(v, 0)
                off += dout
            elif out is not None:
                def epi(c0, j, v):
                    store(out, j, v)
                    return v
            else:
                epi = None
            _cluster_dense(params, ms, h, dst, epi)
            h = dst
        return h

    for row0 in range(0, bsz, rows):
        sl = slice(row0, min(bsz, row0 + rows))
        n = sl.stop - sl.start

        def pad(a):
            return np.concatenate([a, np.zeros((rows - n,) + a.shape[1:],
                                               np.float32)])
        yz = [np.concatenate([pad(y0[sl]), np.zeros((rows, NZ), np.float32)],
                             1) for _ in range(n_ranks)]
        for k in range(k_steps):
            qb = [np.empty((rows, 2 * NZ), np.float32)
                  for _ in range(n_ranks)]
            _cluster_dense(params, rows_of(0), [pad(hxz[k][sl])] * n_ranks,
                           qb, lambda c0, j, v: (store(q_par[k, sl], j, v),
                                                 v)[1])
            if k % oversampling == 0:
                e = pad(eps[k][sl])
                for c in range(n_ranks):
                    sp = np.logaddexp(0, qb[c][:, NZ:]).astype(np.float32)
                    yz[c][:, NY:] = qb[c][:, :NZ] + e * (sp + np.float32(1e-8))
            zs[k, sl] = yz[0][:n, NY:]
            mlp(1, n_pz, [a[:, :NY] for a in yz], st_p[k, sl], p_par[k, sl])
            r = mlp(1 + n_pz, n_dyn, yz, st_d[k, sl], None)
            for c in range(n_ranks):
                yz[c][:, :NY] += dt * r[c]
            for c in range(1, n_ranks):     # every rank holds the same tile
                np.testing.assert_array_equal(yz[c], yz[0])
            ys[k, sl] = yz[0][:n, :NY]
            res[k, sl] = (dt * r[0])[:n]
    assert not any(np.isnan(a).any() for a in outs)
    return outs


def emulate_train_backward(q, pz, dyn, y0, hxz, eps, cots, n_ranks, rows,
                           split=None):
    """csrc/rollout_train.cu's carry pass on tiles of `rows` rows (the
    forward and its stashes in numpy, as kernel 2 computes them), then the
    weight-gradient pass by the wrapper's job table in clusters of `split`
    blocks (emulate_wgrad; default n_ranks). Returns the gradients of y0,
    hxz and every weight and bias, in flat (w, b) order."""
    layers = [q] + pz + dyn
    n_pz, n_dyn = len(pz), len(dyn)
    npl = [(w.numpy(), b.numpy()) for w, b in layers]
    k_steps, bsz = hxz.shape[:2]
    dt = np.float32(1.0 / O)
    # forward, with the hidden pre-activations stashed per substep
    y, z = y0.copy(), None
    ys, zs, qs, st_p, st_d = [], [], [], [], []
    for k in range(k_steps):
        qk = hxz[k] @ npl[0][0].T + npl[0][1]
        if k % O == 0:
            z = qk[:, :NZ] + eps[k] * (np.logaddexp(0, qk[:, NZ:]) + 1e-8)
        stash = []
        for first, n, h in ((1, n_pz, y), (1 + n_pz, n_dyn,
                                           np.concatenate([y, z], 1))):
            part = []
            for il in range(n):
                w, b = npl[first + il]
                h = h @ w.T + b
                if il < n - 1:
                    part.append(h)
                    h = np.maximum(h, 0)
            stash.append(np.concatenate(part, 1))
        y = y + dt * h
        ys.append(y), zs.append(z), qs.append(qk)
        st_p.append(stash[0]), st_d.append(stash[1])
    ys, zs, qs = (np.stack(a).astype(np.float32) for a in (ys, zs, qs))
    st_p, st_d = np.stack(st_p), np.stack(st_d)
    c_ys, c_res, c_q, c_p, c_zs = cots

    params, meta = kr.pack(layers, n_ranks, False, False)
    params, meta = params.numpy(), meta.numpy()
    rows_of = lambda first: meta[first * n_ranks:(first + 1) * n_ranks]  # noqa
    gw_p = sum(w.shape[0] for w, _ in pz)
    gw_d = sum(w.shape[0] for w, _ in dyn)
    g_q = np.zeros((k_steps, bsz, 2 * NZ), np.float32)
    g_pz = np.full((k_steps, bsz, gw_p), np.nan, np.float32)
    g_dyn = np.full((k_steps, bsz, gw_d), np.nan, np.float32)
    g_hxz = np.full((k_steps, bsz, NH_INF), np.nan, np.float32)
    g_y0 = np.zeros((bsz, NY), np.float32)

    def mlp_bwd(first, n, g, stash, G):
        """mlp_bwd of the carry pass: g, every rank's copy of the top
        layer's output cotangent (R, dout); stash, the tile's hidden
        pre-activations (R, ...); G, the tile's valid rows of the G buffer
        (written by columns, rank by rank)."""
        cur = g
        for il in range(n - 1, -1, -1):
            ms = rows_of(first + il)
            din = int(ms[0][5])
            dst = [np.empty((rows, din), np.float32) for _ in range(n_ranks)]
            if il > 0:
                off = sum(int(rows_of(first + i)[0][0]) for i in range(il)) \
                    - din

                def epi(c0, j, v):
                    v = np.where(stash[:, off + j] > 0, v, 0)
                    G[:, off + j] = v[:G.shape[0]]
                    return v
                _cluster_dense(params, ms, cur, dst, epi)
            else:
                _cluster_dense(params, ms, cur, dst)
            cur = dst
        return cur

    for row0 in range(0, bsz, rows):
        sl = slice(row0, min(bsz, row0 + rows))
        n = sl.stop - sl.start

        def pad(a):
            return np.concatenate([a, np.zeros((rows - n,) + a.shape[1:],
                                               a.dtype)])
        gy = [np.zeros((rows, NY), np.float32) for _ in range(n_ranks)]
        gz = [np.zeros((rows, NZ), np.float32) for _ in range(n_ranks)]
        for k in range(k_steps - 1, -1, -1):
            g1 = [a + pad(c_ys[k][sl]) for a in gy]
            gy = g1
            top = [dt * (pad(c_res[k][sl]) + a) for a in g1]
            g_dyn[k, sl, gw_d - NY:] = top[0][:n]        # rank 0
            gyz = mlp_bwd(1 + n_pz, n_dyn, top, pad(st_d[k][sl]),
                          g_dyn[k][sl])
            gq = []
            for c in range(n_ranks):
                gzt = gyz[c][:, NY:] + gz[c] + pad(c_zs[k][sl])
                raw = pad(qs[k][sl][:, NZ:])
                if k % O == 0:
                    gl = gzt
                    gr = gzt * pad(eps[k][sl]) / (1 + np.exp(-raw))
                    gz[c] = np.zeros_like(gzt)
                else:
                    gl, gr = np.zeros_like(gzt), np.zeros_like(gzt)
                    gz[c] = gzt
                gq.append(np.concatenate([gl, gr], 1) + pad(c_q[k][sl]))
            g_q[k, sl] = gq[0][:n]
            for c, m in enumerate(rows_of(0)):          # dL/dhxz by columns
                w, _, c0, width = _slice(params, m)
                g_hxz[k, sl, c0:c0 + width] = (gq[c] @ w)[:n]
            top = [pad(c_p[k][sl]) for _ in range(n_ranks)]
            g_pz[k, sl, gw_p - 2 * NZ:] = top[0][:n]
            gyp = mlp_bwd(1, n_pz, top, pad(st_p[k][sl]), g_pz[k][sl])
            gy = [(gy[c] + gyz[c][:, :NY]) + gyp[c] for c in range(n_ranks)]
        g_y0[sl] = gy[0][:n]
    assert not any(np.isnan(a).any() for a in (g_pz, g_dyn, g_hxz))

    # the weight-gradient pass, tile by tile and rank by rank
    y_in = np.concatenate([y0[None], ys[:-1]])
    a_src = [hxz, np.concatenate([y_in, zs], -1), st_p, st_d]
    flat = emulate_wgrad(krt._shapes(layers), n_pz, a_src,
                         [g_q, g_pz, g_dyn], split or n_ranks)
    return [g_y0, g_hxz] + flat


def _kahan(s, c, x):
    """csrc kahan_add on float32 arrays, elementwise."""
    y = (x - c).astype(np.float32)
    t = (s + y).astype(np.float32)
    return t, ((t - s) - y).astype(np.float32)


def emulate_wgrad(shapes, n_pz, a_src, g_src, split):
    """The weight-gradient pass (train_rollout_wgrad_kernel) by the
    wrapper's job table: every tile of every job, each of the `split` ranks
    of its cluster summing its chunks of rows (krt.wgrad_rank_chunks) in
    order, fp32 products within a chunk and the chunks Kahan-summed; db on
    the tiles at i0 = 0, each column's 256 / TO threads taking every
    (256 / TO)-th row of a chunk; then each element combined from the ranks'
    partials in rank order (compensations summed, then the sums
    Kahan-added). Checks that every element of the gradient buffer is
    written once. Returns [dW, db] per layer."""
    jobs, sizes, n_grads, n_tiles = krt._wgrad_jobs(shapes, n_pz)
    n_rows = g_src[0].shape[0] * g_src[0].shape[1]
    ranks = krt.wgrad_rank_chunks(n_rows, split)
    chunk = krt.WGRAD_CHUNK
    grads = np.full(n_grads, np.nan, np.float32)
    count = 0
    for (a_i, a_ld, a_off, relu, g_i, g_ld, g_off, w_off, b_off, din, dout,
         tile0, to, ti) in jobs:
        assert tile0 == count
        a = a_src[a_i].reshape(-1, a_ld)[:, a_off:a_off + din]
        a = np.maximum(a, 0) if relu else a
        g = g_src[g_i].reshape(-1, g_ld)[:, g_off:g_off + dout]
        dw = grads[w_off:w_off + dout * din].reshape(dout, din)
        db = grads[b_off:b_off + dout]
        tiles_i = -(-din // ti)
        n_job = -(-dout // to) * tiles_i
        count += n_job
        n_thr = krt.WGRAD_THREADS // to         # threads a column of db
        for t in range(n_job):
            o0, i0 = (t // tiles_i) * to, (t % tiles_i) * ti
            gt, at = g[:, o0:o0 + to], a[:, i0:i0 + ti]
            shape_w, shape_b = (gt.shape[1], at.shape[1]), (n_thr, gt.shape[1])
            parts = []
            for c0, c1 in ranks:
                acc, comp = (np.zeros(shape_w, np.float32) for _ in range(2))
                dacc, dcomp = (np.zeros(shape_b, np.float32) for _ in range(2))
                for c in range(c0, c1):
                    rows_c = slice(c * chunk, min((c + 1) * chunk, n_rows))
                    part = (gt[rows_c].T @ at[rows_c]).astype(np.float32)
                    acc, comp = _kahan(acc, comp, part)
                    if i0 == 0:
                        dpart = np.zeros(shape_b, np.float32)
                        for kk, row in enumerate(range(rows_c.start,
                                                       rows_c.stop)):
                            dpart[kk % n_thr] += gt[row]
                        dacc, dcomp = _kahan(dacc, dcomp, dpart)
                parts.append((acc, comp, dacc, dcomp))
            c = np.zeros(shape_w, np.float32)
            for part in parts:
                c = (c + part[1]).astype(np.float32)
            total = np.zeros(shape_w, np.float32)
            for part in parts:
                total, c = _kahan(total, c, part[0])
            dst = dw[o0:o0 + to, i0:i0 + ti]
            assert np.isnan(dst).all()
            dst[:] = total
            if i0 == 0:
                c, total = (np.zeros(shape_b[1], np.float32)
                            for _ in range(2))
                for part in parts:
                    for q in range(n_thr):
                        c = (c + part[3][q]).astype(np.float32)
                for part in parts:
                    for q in range(n_thr):
                        total, c = _kahan(total, c, part[2][q])
                assert np.isnan(db[o0:o0 + to]).all()
                db[o0:o0 + to] = total
    assert count == n_tiles and not np.isnan(grads).any()
    flat = []
    for w_off, dout, din, b_off in sizes:
        flat += [grads[w_off:w_off + dout * din].reshape(dout, din),
                 grads[b_off:b_off + dout]]
    return flat


def _loss(outs):
    ys, res, qp, pp, zs = outs
    return ((ys * 0.3).sum() + (res ** 2).sum() + torch.tanh(qp).sum()
            + (pp * 0.1).sum() + (zs * 0.05).sum())


def _jax_loss(outs):
    ys, res, qp, pp, zs = outs
    return (jnp.sum(ys * 0.3) + jnp.sum(res ** 2) + jnp.sum(jnp.tanh(qp))
            + jnp.sum(pp * 0.1) + jnp.sum(zs * 0.05))


def _torch_layer(p):
    return (torch.from_numpy(np.asarray(p["kernel"]).T.copy()),
            torch.from_numpy(np.asarray(p["bias"]).copy()))


def _linear(rng, din, dout):
    return {"kernel": (rng.randn(din, dout) / np.sqrt(din)).astype(np.float32),
            "bias": (0.1 * rng.randn(dout)).astype(np.float32)}


def _mlp_params(rng, din, dout):
    dims = [din] + [NH] * (NLAYERS - 1) + [dout]
    return [_linear(rng, a, b) for a, b in zip(dims, dims[1:])]


@pytest.fixture(scope="module")
def case():
    """Weights and draws made with numpy at tiny widths, the JAX Pallas
    kernels' results on them in interpret mode (jitted: one compile each),
    and the same weights as torch layers."""
    rng = np.random.RandomState(3)
    q_p = _linear(rng, NH_INF, 2 * NZ)
    pz_p = _mlp_params(rng, NY, 2 * NZ)
    dyn_p = _mlp_params(rng, NY + NZ, NY)
    y0 = (0.5 * rng.randn(BSZ, NY)).astype(np.float32)
    hxz = rng.randn(N_STEPS, BSZ, NH_INF).astype(np.float32)
    eps = rng.randn(N_STEPS, BSZ, NZ).astype(np.float32)
    prior = jax.jit(lambda pz, dyn, y, e: prior_rollout_fused(
        pz, dyn, y, e, NY, NZ, O, interpret=True))(pz_p, dyn_p, y0, eps)
    fused = make_train_rollout(NY, NZ, NH_INF, NH, N_STEPS, O,
                               interpret=True)
    g_q, g_pz, g_dyn, g_y0, g_hxz = jax.jit(jax.grad(
        lambda *a: _jax_loss(fused(*a, eps)), argnums=(0, 1, 2, 3, 4)))(
        q_p, pz_p, dyn_p, y0, hxz)
    jax_grads = [g_y0, g_hxz] + [
        np.asarray(g[k]).T if k == "kernel" else g[k]
        for g in [g_q, *g_pz, *g_dyn] for k in ("kernel", "bias")]
    return dict(q=_torch_layer(q_p), pz=[_torch_layer(p) for p in pz_p],
                dyn=[_torch_layer(p) for p in dyn_p], y0=y0, hxz=hxz,
                eps=eps, prior=np.asarray(prior),
                jax_grads=[np.asarray(g) for g in jax_grads])


@pytest.fixture(scope="module", params=[1, 2], ids=["o=1", "o=2"])
def fwd_case(request):
    """The training forward's case at oversampling o: weights and draws
    made with numpy at tiny widths (q 10 -> 8, MLPs of 30 hidden units: a
    partial last column group, and ranks with no columns at 16 ranks), and
    the JAX Pallas forward's outputs on them in interpret mode."""
    o = request.param
    n_steps = o * (NT - 1)
    rng = np.random.RandomState(5)
    q_p = _linear(rng, NH_INF, 2 * NZ)
    pz_p = _mlp_params(rng, NY, 2 * NZ)
    dyn_p = _mlp_params(rng, NY + NZ, NY)
    y0 = (0.5 * rng.randn(BSZ, NY)).astype(np.float32)
    hxz = rng.randn(n_steps, BSZ, NH_INF).astype(np.float32)
    eps = rng.randn(n_steps, BSZ, NZ).astype(np.float32)
    fused = make_train_rollout(NY, NZ, NH_INF, NH, n_steps, o,
                               interpret=True)
    outs = jax.jit(fused)(q_p, pz_p, dyn_p, y0, hxz, eps)
    return dict(o=o, q=_torch_layer(q_p), pz=[_torch_layer(p) for p in pz_p],
                dyn=[_torch_layer(p) for p in dyn_p], y0=y0, hxz=hxz,
                eps=eps, jax=[np.asarray(a) for a in outs])


@pytest.mark.parametrize("rows", [4, 12])
@pytest.mark.parametrize("n_ranks", RANKS)
def test_cluster_train_forward_matches_references(fwd_case, n_ranks, rows):
    c = fwd_case
    got = emulate_train_forward(c["q"], c["pz"], c["dyn"], c["y0"],
                                c["hxz"], c["eps"], n_ranks, rows, c["o"])
    ref = krt.train_rollout_reference(
        c["q"], c["pz"], c["dyn"], torch.from_numpy(c["y0"]),
        torch.from_numpy(c["hxz"]), torch.from_numpy(c["eps"]), c["o"],
        stash=True)
    names = ["ys", "res", "q", "p", "z", "stash_p", "stash_d"]
    assert [a.shape for a in got] == [tuple(b.shape) for b in ref]
    assert ref[5].shape[-1] == ref[6].shape[-1] == (NLAYERS - 1) * NH
    for a, b, name in zip(got, ref, names):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=FWD_RTOL,
                                   atol=FWD_ATOL, err_msg=f"plain {name}")
    for a, b, name in zip(got, c["jax"], names):
        np.testing.assert_allclose(a, b, rtol=FWD_RTOL, atol=FWD_ATOL,
                                   err_msg=f"jax {name}")


def test_train_forward_stash_is_the_hidden_pre_activations(fwd_case):
    """The plain version's stash, which the emulated kernel is held to:
    each hidden layer's pre-activation at each substep's input state, the
    layers side by side; its five outputs are train_rollout's."""
    c = fwd_case
    args = (c["q"], c["pz"], c["dyn"], torch.from_numpy(c["y0"]),
            torch.from_numpy(c["hxz"]), torch.from_numpy(c["eps"]), c["o"])
    with torch.no_grad():
        outs = krt.train_rollout_reference(*args, stash=True)
        plain = krt.train_rollout(*args)
        fwd = krt.train_rollout_forward(*args)
    for a, b in zip(outs, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(outs, fwd):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ys, zs = outs[0], outs[4]
    y_in = torch.cat([torch.from_numpy(c["y0"])[None], ys[:-1]])
    for mlp, h, stash in ((c["pz"], y_in, outs[5]),
                          (c["dyn"], torch.cat([y_in, zs], -1), outs[6])):
        pre = []
        for il, (w, b) in enumerate(mlp[:-1]):
            h = h @ w.T + b
            pre.append(h)
            h = torch.relu(h)
        torch.testing.assert_close(stash, torch.cat(pre, -1), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("n_ranks,rows", [(1, 4), (2, 8), (8, 4), (16, 8)])
def test_cluster_prior_rollout_matches_references(case, n_ranks, rows):
    out = emulate_prior(case["pz"], case["dyn"], case["y0"], case["eps"],
                        n_ranks, rows)
    ref = kr.prior_rollout_reference(
        case["pz"], case["dyn"], torch.from_numpy(case["y0"]),
        torch.from_numpy(case["eps"]), NY, NZ, O).numpy()
    for other in (ref, case["prior"]):
        np.testing.assert_allclose(out, other, rtol=ROLLOUT_RTOL,
                                   atol=ROLLOUT_ATOL)


@pytest.mark.parametrize("n_ranks,rows", [(1, 4), (2, 8), (8, 4), (16, 8)])
def test_cluster_carry_pass_matches_references(case, n_ranks, rows):
    q, pz, dyn = case["q"], case["pz"], case["dyn"]
    leaves = [torch.from_numpy(case["y0"]).requires_grad_(),
              torch.from_numpy(case["hxz"]).requires_grad_()]
    flat = [t.clone().requires_grad_() for w, b in [q, *pz, *dyn]
            for t in (w, b)]
    pairs = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
    outs = krt.train_rollout_reference(
        pairs[0], pairs[1:1 + NLAYERS], pairs[1 + NLAYERS:], leaves[0],
        leaves[1], torch.from_numpy(case["eps"]), O)
    ref = torch.autograd.grad(_loss(outs), leaves + flat)
    cots = [c.detach().numpy() for c in torch.autograd.grad(
        _loss(outs), outs)]
    got = emulate_train_backward(q, pz, dyn, case["y0"], case["hxz"],
                                 case["eps"], cots, n_ranks, rows)
    assert len(got) == len(ref) == len(case["jax_grads"])
    for i, (a, b, c) in enumerate(zip(got, ref, case["jax_grads"])):
        for other, name in ((b.numpy(), "autograd"), (c, "jax")):
            np.testing.assert_allclose(a, other, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{name} {i}")


# (out, in) of layers wider than a tile (two 128 x 64 tiles, a 64 x 128
# one, a 256 x 32 one) and narrower, all with ragged edges
WIDE_SHAPES = ((2 * NZ, 70), (70, NY), (70, 70), (2 * NZ, 70),
               (70, NY + NZ), (300, 70), (NY, 300))


def _wgrad_against_plain(n_steps, bsz, split):
    """emulate_wgrad on seeded N(0, 1) sources of WIDE_SHAPES, against
    weight_gradients (the plain version on CPU tensors) and a float64 run
    of it, at rtol 5e-4 / atol 5e-6."""
    rng = np.random.RandomState(11)
    n_pz = 3
    shapes = WIDE_SHAPES
    widths_a, widths_g = krt.wgrad_source_widths(shapes, n_pz)
    a_src = [rng.randn(n_steps, bsz, w).astype(np.float32) for w in widths_a]
    g_src = [rng.randn(n_steps, bsz, w).astype(np.float32) for w in widths_g]
    got = emulate_wgrad(shapes, n_pz, a_src, g_src, split)
    plain = krt.weight_gradients([tuple(s) for s in shapes], n_pz,
                                 [torch.from_numpy(a) for a in a_src],
                                 [torch.from_numpy(g) for g in g_src])
    f64 = krt.weight_gradients_reference(
        shapes, n_pz, [torch.from_numpy(a).double() for a in a_src],
        [torch.from_numpy(g).double() for g in g_src])
    assert [x.shape for x in got] == [tuple(x.shape) for x in plain]
    for i, (a, b, c) in enumerate(zip(got, plain, f64)):
        for other, name in ((b.numpy(), "plain"), (c.numpy(), "float64")):
            np.testing.assert_allclose(a, other, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{name} {i}")


@pytest.mark.parametrize("n_steps,bsz", [(3, 37), (2, 5), (5, 64)])
@pytest.mark.parametrize("split", kr.CLUSTERS)
def test_cluster_wgrad_pass_matches_plain(n_steps, bsz, split):
    """The weight-gradient pass emulated tile by tile and rank by rank (N =
    111, 10 and 320 rows: a partial last chunk, fewer chunks than ranks,
    whole chunks) against its plain version and a float64 run of the same
    products, at rtol 5e-4 / atol 5e-6, on stash sources with negative
    values (the ReLU) and layers spanning several tiles."""
    _wgrad_against_plain(n_steps, bsz, split)


@pytest.mark.parametrize("job,field,delta", [
    (2, 3, -1),     # p_z's second layer without its ReLU
    (5, 2, 4),      # the dynamics' second layer, stash columns moved
    (4, 6, 4),      # the dynamics' first layer, cotangent columns moved
], ids=["relu", "a_off", "g_off"])
def test_wgrad_plain_catches_a_wrong_route(monkeypatch, job, field, delta):
    """The plain version takes each layer's columns from the layer shapes,
    not from the kernel's job table: a job that reads the wrong source
    columns, or drops its ReLU, disagrees with it."""
    real = krt._wgrad_jobs.__wrapped__

    def moved(*args):
        jobs, sizes, n_grads, n_tiles = real(*args)
        jobs = [list(j) for j in jobs]
        jobs[job][field] += delta
        return tuple(map(tuple, jobs)), sizes, n_grads, n_tiles
    monkeypatch.setattr(krt, "_wgrad_jobs", moved)
    with pytest.raises(AssertionError):
        _wgrad_against_plain(2, 5, 2)


def test_wgrad_emulation_catches_a_wrong_tile(monkeypatch):
    """The emulation reads the tiles through the job table: a job whose
    first tile is off by one fails it."""
    real = krt._wgrad_jobs.__wrapped__

    def shifted(*args):
        jobs, sizes, n_grads, n_tiles = real(*args)
        jobs = [list(j) for j in jobs]
        jobs[2][11] += 1
        return tuple(map(tuple, jobs)), sizes, n_grads, n_tiles
    monkeypatch.setattr(krt, "_wgrad_jobs", shifted)
    rng = np.random.RandomState(0)
    a_src = [rng.randn(1, 10, w).astype(np.float32) for w in (70, 10, 140, 370)]
    g_src = [rng.randn(1, 10, w).astype(np.float32) for w in (8, 148, 376)]
    with pytest.raises(AssertionError):
        emulate_wgrad(WIDE_SHAPES, 3, a_src, g_src, 2)


def test_emulation_catches_a_wrong_slice(case, monkeypatch):
    """The emulation reads the packed slices through the meta rows: one
    rank's column offset moved by a group of 4 fails it."""
    real = kr._packing.__wrapped__

    def shifted(*args):
        index, meta = real(*args)
        meta = meta.clone()
        meta[1, 4] += 4                 # rank 1 of layer 0 writes elsewhere
        return index, meta
    monkeypatch.setattr(kr, "_packing", shifted)
    with pytest.raises(AssertionError):
        emulate_prior(case["pz"], case["dyn"], case["y0"], case["eps"], 8, 4)


@pytest.mark.parametrize("n_ranks,row,shift", [
    (2, 1, -4),     # q head, rank 1 stores over rank 0's columns
    (8, 9, 4),      # p_z's first layer, rank 1 over rank 2's
])
def test_forward_emulation_catches_a_wrong_slice(fwd_case, monkeypatch,
                                                  n_ranks, row, shift):
    """As test_emulation_catches_a_wrong_slice, for the training forward:
    one rank's column offset moved by a group of 4 fails it."""
    real = kr._packing.__wrapped__

    def shifted(*args):
        index, meta = real(*args)
        meta = meta.clone()
        meta[row, 4] += shift
        return index, meta
    monkeypatch.setattr(kr, "_packing", shifted)
    c = fwd_case
    with pytest.raises(AssertionError):
        emulate_train_forward(c["q"], c["pz"], c["dyn"], c["y0"], c["hxz"],
                              c["eps"], n_ranks, 4, c["o"])
