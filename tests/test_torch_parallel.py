"""The port's data-parallel modules (srvp_tpu_torch/parallel, the sharded
loader, the distributed batch statistics, the global batch's noise) on the
CPU against the JAX package:

  * the loader's rank slices of every batch concatenate bit for bit to the
    unsharded batch and to the JAX loader's slices, dense and parts
    batches, through every batch hook, across an epoch and `fast_forward`
    (the twins of tests/test_multihost.py:42-116);
  * `pad_to_multiple` is the JAX function, and the rank rows are
    [r B/N, (r + 1) B/N);
  * the training and evaluation noise drawn for the global batch and cut to
    a rank's rows is what the model draws for those videos;
  * two gloo ranks, each on half a batch, give the JAX batch norm's output
    on the whole batch, its running statistics, and the JAX gradients of a
    loss over both halves, in float32 and bfloat16.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu.data import device_compose as jcompose
from srvp_tpu.data.base import collate_uint8 as jcollate_uint8
from srvp_tpu.data.loader import DataLoader as JaxLoader
from srvp_tpu.models import layers as jlayers
from srvp_tpu.parallel import mesh as jmesh
from srvp_tpu_torch import eval_lib, train_lib
from srvp_tpu_torch.config import SRVPConfig
from srvp_tpu_torch.data import device_compose
from srvp_tpu_torch.data.base import collate_uint8
from srvp_tpu_torch.data.loader import DataLoader, PartsView
from srvp_tpu_torch.models.srvp import SRVP
from srvp_tpu_torch.parallel import mesh, multihost

from test_torch_loader import FewItems, Parts, datasets
from tests.test_torch_bf16 import strict, tpu_like_bf16  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4          # global; 3 batches an epoch of test_torch_loader's 12
RANKS = 2
RANK_TIMEOUT_S = 120
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-5       # tests/test_grad_parity.py:100


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class TimeMajor:
    """A dataset whose only batch hook is `get_batch_timemajor_u8` (as
    KTH's and BAIR's): each item is its index and seed written into the
    frames, so a batch made with other positions' seeds differs."""

    def __len__(self):
        return 12

    def get_item(self, index, rng):
        return np.full((3, 2, 2, 1), index, np.uint8) \
            + rng.randint(0, 200, (3, 2, 2, 1)).astype(np.uint8)

    def get_batch_timemajor_u8(self, indices, seeds, n_threads):
        return collate_uint8([self.get_item(i, np.random.RandomState(s))
                              for i, s in zip(indices, seeds)])


def loaders(kind, seed, **shard):
    """(port loader, JAX loader) of one batch path, sharded as asked."""
    ours, ref = datasets()
    if kind == "parts":
        return (DataLoader(PartsView(FewItems(ours)), BATCH, seed=seed,
                           collate_fn=device_compose.parts_collate,
                           num_workers=2, **shard),
                JaxLoader(Parts(FewItems(ref, native=False)), BATCH,
                          seed=seed, num_workers=2,
                          collate_fn=jcompose.parts_collate, **shard))
    if kind == "timemajor":
        return (DataLoader(TimeMajor(), BATCH, seed=seed, num_workers=2,
                           **shard),
                JaxLoader(TimeMajor(), BATCH, seed=seed, num_workers=2,
                          collate_fn=jcollate_uint8, **shard))
    return (DataLoader(FewItems(ours, native=kind == "native"), BATCH,
                       seed=seed, collate_fn=collate_uint8, num_workers=2,
                       **shard),
            JaxLoader(FewItems(ref, native=False), BATCH, seed=seed,
                      num_workers=2, collate_fn=jcollate_uint8, **shard))


def concat(parts):
    """Rank slices of one batch joined on the batch axis (axis 0 of a
    parts dict's leaves, 1 of dense frames)."""
    if isinstance(parts[0], dict):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts, axis=1)


def assert_batches_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("skip", [0, 4])      # from the start; in epoch 1
@pytest.mark.parametrize("kind", ["native", "pool", "parts", "timemajor"])
def test_sharded_loader_concatenates_to_unsharded(kind, skip):
    """Every rank's slices of every batch, over two epochs (after
    `fast_forward(skip)` on every loader), join to the unsharded batch bit
    for bit, and each slice is the JAX loader's slice of that rank."""
    full, _ = loaders(kind, seed=7)
    shards = [loaders(kind, seed=7, shard_rank=r, shard_count=RANKS)
              for r in range(RANKS)]
    for dl in [full] + [s for pair in shards for s in pair]:
        dl.fast_forward(skip)
    for _ in range(2):
        ours = [iter(s[0]) for s in shards]
        theirs = [iter(s[1]) for s in shards]
        n = 0
        for ref in full:
            got = [next(g) for g in ours]
            assert_batches_equal(concat(got), ref)
            for g, want in zip(got, (next(t) for t in theirs)):
                assert_batches_equal(g, want)
            n += 1
        assert n == len(full) - (skip % len(full))
        skip = 0
        for g in ours + theirs:
            assert next(g, None) is None   # the same batches an epoch


def test_sharded_loader_rejects_bad_configs():
    ours, _ = datasets()
    with pytest.raises(ValueError, match="divide evenly"):
        DataLoader(ours, 9, shard_rank=0, shard_count=2)
    with pytest.raises(ValueError, match="out of range"):
        DataLoader(ours, 8, shard_rank=2, shard_count=2)


def test_rank_rows_and_the_loader_check():
    """Rows [r B/N, (r + 1) B/N) of the global batch; the loader of this
    process (no group: one rank) passes validate_loader_slices, a loader
    made for another rank does not."""
    assert [multihost.local_batch_slice(12, r, 3) for r in range(3)] == [
        (0, 4), (4, 8), (8, 12)]
    assert multihost.local_batch_slice(12) == (0, 12)
    with pytest.raises(ValueError, match="does not divide"):
        multihost.local_batch_slice(10, 0, 3)
    ours, _ = datasets()
    multihost.validate_loader_slices(DataLoader(ours, 8))
    with pytest.raises(ValueError, match="rank 0 of 1"):
        multihost.validate_loader_slices(
            DataLoader(ours, 8, shard_rank=1, shard_count=2))


@pytest.mark.parametrize("case", ["dense", "dense-even", "parts",
                                  "parts-even"])
def test_pad_to_multiple_is_the_jax_function(case):
    rng = np.random.RandomState(0)
    b = 8 if case.endswith("even") else 5
    if case.startswith("parts"):
        batch = {"digits": rng.randint(0, 255, (b, 2, 3, 3), np.uint8),
                 "pos": rng.randint(0, 9, (b, 2, 4, 2), np.int32)}
    else:
        batch = rng.rand(3, b, 4, 4, 1).astype(np.float32)
    ours, n_ours = mesh.pad_to_multiple(batch, 4)
    ref, n_ref = jmesh.pad_to_multiple(batch, 4)
    assert n_ours == n_ref == b
    if case.startswith("parts"):
        assert all(v.shape[0] == 8 for v in ours.values())
    else:
        assert ours.shape[1] == 8
    assert_batches_equal(ours, ref)
    with pytest.raises(ValueError, match="disagree"):
        mesh.pad_to_multiple({"a": np.zeros(3), "b": np.zeros(4)}, 2)


@pytest.mark.parametrize("over,o", [({}, 1),
                                    (dict(archi="vgg", skipco=True), 2)],
                         ids=["dcgan", "vgg-skipco-o2"])
def test_training_draws_are_the_model_draws(over, o):
    """train_lib.training_draws makes the calls SRVP.forward makes in
    training (the same generator state after them, the same outputs), and
    the rows it keeps (a rank's) are those videos' draws of the whole
    batch."""
    cfg = SRVPConfig(nf=4, nhx=8, ny=4, nz=4, nt_inf=2, nh_inf=8,
                     nlayers_inf=2, nh_res=16, nlayers_res=2, **over)
    torch.manual_seed(0)
    model = SRVP(cfg).train()
    nt, bsz = 4, 4
    x = torch.rand(nt, bsz, 64, 64, 1)
    g_model, g_ours = (torch.Generator().manual_seed(5) for _ in range(2))
    with torch.no_grad():
        ref = model(x, nt, o, generator=g_model)
        draws = train_lib.training_draws(cfg, nt, bsz, o, g_ours, "cpu")
        got = model(x, nt, o, **draws)
        rows = train_lib.training_draws(
            cfg, nt, bsz, o, torch.Generator().manual_seed(5), "cpu",
            rows=(2, 4))
    assert torch.equal(g_model.get_state(), g_ours.get_state())
    for k in ("y", "z", "w", "q_y_0_params", "res"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for k, v in rows.items():
        whole = draws[k]
        want = whole[2:4] if k in ("skip_t", "eps_y") else whole[:, 2:4]
        assert torch.equal(v, want), k


def test_chunk_noise_rows_are_the_batch_rows():
    """A rank's chunk noise (rows lo..hi of B videos, S samples each,
    video-major) is those videos' rows of the whole batch's draws, and the
    generator ends where the whole batch's draws leave it."""
    cfg = SRVPConfig(ny=3, nz=2)
    args = (cfg, 4, 3, 5, 9, 2, 1)
    gens = [torch.Generator().manual_seed(1) for _ in range(2)]
    whole = eval_lib.chunk_noise(*args, gens[0], "cpu")
    part = eval_lib.chunk_noise(*args, gens[1], "cpu", rows=(1, 3))
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert torch.equal(part[0], whole[0][3:9])
    for a, b in zip(part[1:], whole[1:]):
        assert torch.equal(a, b[:, 3:9])
    assert [t.shape[-2 if t.ndim == 3 else 0] for t in part] == [6, 6, 6]


# ---------------------------------------------------------------------------
# Batch statistics over two gloo ranks against the JAX layer
# ---------------------------------------------------------------------------

BN_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    from srvp_tpu_torch.models.layers import BN_EPS, BatchNorm2d
    from srvp_tpu_torch.parallel import mesh, multihost

    rank, init, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    dist.init_process_group("gloo", init_method=init, world_size=2,
                            rank=rank)
    d = np.load(inp)
    half = d["x"].shape[0] // 2
    rows = slice(rank * half, (rank + 1) * half)
    res = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        bn = BatchNorm2d(d["x"].shape[1], eps=BN_EPS).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(d["scale"]))
            bn.bias.copy_(torch.from_numpy(d["bias"]))
        x = torch.from_numpy(d["x"][rows]).to(dtype).requires_grad_()
        y = bn(x)
        # this rank's part of the loss; the ranks' parts add up to it
        loss = (y.float() * torch.from_numpy(d["w_out"][rows])).sum()
        loss.backward()
        mesh.all_reduce_grads(bn)    # the mean of the ranks' parts
        res.update({f"{name}_y": y.detach().float().numpy(),
                    f"{name}_dx": x.grad.float().numpy(),
                    f"{name}_dscale": bn.weight.grad.numpy(),
                    f"{name}_dbias": bn.bias.grad.numpy(),
                    f"{name}_mean": bn.running_mean.numpy(),
                    f"{name}_var": bn.running_var.numpy()})
    np.savez(out, world=multihost.process_count(), **res)
    dist.destroy_process_group()
""")


def run_ranks(script, tmp_path, *args):
    """`script` in RANKS processes (argv: rank, a file:// rendezvous,
    *args, its output path); each has its own timeout and is killed on
    expiry. Returns the ranks' npz outputs."""
    init = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [tmp_path / f"rank{r}.npz" for r in range(RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), init, *map(str, args),
         str(outs[r])], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    return [dict(np.load(o)) for o in outs]


def test_distributed_batch_norm_is_the_jax_layer_on_the_whole_batch(
        tmp_path, tpu_like_bf16):
    """BatchNorm2d at two ranks (training, fp32 and bf16) against JAX's
    bn_apply on the whole batch (two-pass variance, and bf16 sums and
    rounding as the bf16 parity tests compile them): each rank's output is
    its rows of JAX's, each rank's input gradient its rows of the JAX
    gradient of the whole loss, the averaged
    scale and bias gradients the JAX gradients of the ranks' mean loss (the
    same bits on both ranks), all at the gradient parity tolerance against
    JAX in the same dtype, and both ranks' running statistics JAX's new
    state. A forward-only reduction of the statistics would leave each
    rank's input gradient without the other rank's terms and fail here; in
    bf16, so would rounding each rank's partial sums of the scale's and
    shift's gradients before their reduction (they reach the input
    gradient through the statistics)."""
    rng = np.random.RandomState(0)
    n, c = 6, 5
    inputs = dict(x=(3 + 2 * rng.randn(n, c, 6, 6)).astype(np.float32),
                  scale=(rng.rand(c) + .5).astype(np.float32),
                  bias=rng.randn(c).astype(np.float32),
                  w_out=rng.randn(n, c, 6, 6).astype(np.float32))
    np.savez(tmp_path / "in.npz", **inputs)
    ranks = run_ranks(BN_RANK, tmp_path, tmp_path / "in.npz")
    assert all(int(r["world"]) == RANKS for r in ranks)

    state = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    w_out = jnp.asarray(inputs["w_out"].transpose(0, 2, 3, 1))
    params = {"scale": jnp.asarray(inputs["scale"]),
              "bias": jnp.asarray(inputs["bias"])}
    x = jnp.asarray(inputs["x"].transpose(0, 2, 3, 1))
    nchw = lambda a: np.asarray(a, np.float32).transpose(  # noqa: E731
        0, 3, 1, 2)
    ref = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        def loss(params, x, dtype=dtype):
            y, new = jlayers.bn_apply(params, state, x.astype(dtype), True)
            return (y.astype(jnp.float32) * w_out).sum(), (y, new)
        (_, (y, new)), (g_p, g_x) = strict(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True), params, x)
        ref[name] = {"y": nchw(y), "dx": nchw(g_x),
                     "dscale": np.asarray(g_p["scale"]) / RANKS,
                     "dbias": np.asarray(g_p["bias"]) / RANKS,
                     "mean": np.asarray(new["mean"]),
                     "var": np.asarray(new["var"])}
    for name in ("f32", "bf16"):
        got = {k: np.concatenate([r[f"{name}_{k}"] for r in ranks])
               for k in ("y", "dx")}
        for k in ("dscale", "dbias", "mean", "var"):
            assert np.array_equal(ranks[0][f"{name}_{k}"],
                                  ranks[1][f"{name}_{k}"]), (name, k)
            got[k] = ranks[0][f"{name}_{k}"]
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], ref[name][k], rtol=1e-5,
                                       atol=1e-6,
                                       err_msg=f"{name} running {k}")
        for k in ("y", "dx", "dscale", "dbias"):
            np.testing.assert_allclose(got[k], ref[name][k], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{name} {k}")
