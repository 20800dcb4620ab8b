"""The port's dispatch windows (`--steps_per_dispatch k`,
train_lib.WindowStep) on the CPU at tiny widths, where a window runs its k
steps eagerly through the code that the card captures as one CUDA graph:
a window against k single steps (dense and Moving MNIST parts batches, the
lr burn-in inside the window), against the JAX package's
`make_train_step(steps_per_call=3)` on the same weights and draws, the
trainer CLI at K = 2 against K = 1 (with an unaligned resume), the flag's
checks, the capture-safe Adam step that the card's windows take, the
launch counts, and the kernel wrappers' first-call caches, which a capture
must find warm."""

import contextlib
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu import train_lib as jtrain
from srvp_tpu.models import layers as jlayers
from srvp_tpu_torch import train_lib, train_main
from srvp_tpu_torch.config import SRVPConfig
from srvp_tpu_torch.data.device_compose import stack_batches, to_device
from srvp_tpu_torch.kernels import launches
from srvp_tpu_torch.kernels import rollout as krollout
from srvp_tpu_torch.kernels import rollout_train as krollout_train
from srvp_tpu_torch.models import srvp as msrvp
from srvp_tpu_torch.utils.weights import (bn_state_from_port,
                                          state_dict_from_jax)
from tests.torch_port_util import configs, jax_draws, jax_model, port_model, t

from test_torch_train import (GRAD_ATOL, GRAD_RTOL, LOSS_KW, LOSS_RTOL,
                              assert_bn_close, two_pass_bn_stats)
from test_torch_train_cli import parse

# a window against single steps (tests/test_train.py:70-75)
RTOL, ATOL = 1e-5, 1e-7
# the CLI at K = 2 against K = 1 (tests/test_roundtrip.py:96-127)
CLI_RTOL, CLI_ATOL = 2e-5, 1e-6
CFG = SRVPConfig(nf=4, nhx=8, ny=4, nz=4, nt_inf=2, nh_inf=8, nlayers_inf=2,
                 nh_res=16, nlayers_res=2)
# the burn-in ends inside the window: its steps run at 1, 1, 0.75, 0.5
HP = train_lib.TrainHParams(nt_cond=3, lr=1e-3, lr_burnin=2, lr_decay_iter=4)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def fresh_state(seed=0):
    torch.manual_seed(seed)
    ts = train_lib.init_train_state(CFG, HP, "cpu")
    ts.generator = torch.Generator().manual_seed(seed)
    return ts


def dense_batch(k, nt=6, bsz=3):
    return np.random.RandomState(k).randint(
        0, 256, (nt, bsz, 64, 64, 1)).astype(np.uint8)


def parts_batch(k, nt=6, bsz=3):
    rng = np.random.RandomState(k)
    return {"digits": rng.randint(0, 256, (bsz, 2, 28, 28), dtype=np.uint8),
            "pos": rng.randint(0, 64 - 28, (bsz, 2, nt, 2)).astype(np.int32)}


def state_tensors(ts):
    """{name: tensor} of the parameters, buffers and Adam's state."""
    out = dict(ts.model.state_dict())
    for i, st in ts.optimizer.state_dict()["state"].items():
        out.update({f"adam/{i}/{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("make", [dense_batch, parts_batch],
                         ids=["dense", "parts"])
def test_window_matches_single_steps(make):
    """Four steps as one window land where four train_steps do, drawing
    the same noise from the generator: parameters, batch-norm statistics,
    Adam's moments and steps, the last step's metrics, the step count and
    the schedule."""
    k = 4
    batches = [make(j) for j in range(k)]
    singles = fresh_state()
    for b in batches:
        ref = train_lib.train_step(singles, to_device(b, "cpu"), HP,
                                   generator=singles.generator)
    windowed = fresh_state()
    window = train_lib.WindowStep(windowed, HP, k)
    got = window(to_device(stack_batches(batches), "cpu"))

    assert windowed.step == singles.step == k
    assert windowed.scheduler.last_epoch == k
    assert windowed.scheduler.get_last_lr() == singles.scheduler.get_last_lr()
    assert got["lr"] == ref["lr"] == 0.5e-3
    assert torch.equal(windowed.generator.get_state(),
                       singles.generator.get_state())
    for name in ("loss", "nll", "kl_y_0", "kl_z", "l2_res"):
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    a, b = state_tensors(windowed), state_tensors(singles)
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_allclose(a[name].double().numpy(),
                                   b[name].double().numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_window_matches_jax_steps_per_call(monkeypatch):
    """A window of three Adam steps from the JAX weights on the JAX draws
    (fold_in(rng, step), as the scan body draws them) against
    make_train_step(steps_per_call=3) (test_three_adam_steps_match_jax's
    tolerances; JAX batch statistics in two passes)."""
    monkeypatch.setattr(jlayers, "_bn_stats_fwd", two_pass_bn_stats)
    jcfg, cfg = configs()
    params, state = jax_model(jcfg, seed=2, conv_gain=10.0)
    hp_j = jtrain.TrainHParams(lr=1e-3, lr_burnin=2, lr_decay_iter=4,
                               **LOSS_KW)
    hp = train_lib.TrainHParams(lr=1e-3, lr_burnin=2, lr_decay_iter=4,
                                **LOSS_KW)
    nt, bsz, k = 4, 3, 3
    xs = np.stack([np.random.RandomState(s).rand(nt, bsz, 64, 64, 1)
                   .astype(np.float32) for s in range(k)])
    base = jax.random.PRNGKey(5)

    ts = train_lib.make_train_state(port_model(params, state, cfg).train(),
                                    hp)
    draws = [jax_draws(jax.random.fold_in(base, step), jcfg, nt, bsz, 1)
             for step in range(k)]
    m = train_lib.WindowStep(ts, hp, k)(t(xs), draws=draws)

    # the window's jit donates the train state, its key included
    ts_j = jtrain.TrainState(params, state,
                             jtrain.make_optimizer(hp_j).init(params),
                             jnp.zeros((), jnp.int32), base)
    multi = jtrain.make_train_step(jcfg, hp_j, steps_per_call=k)
    ts_j, m_j = multi(ts_j, jnp.asarray(xs))

    assert ts.step == int(ts_j.step) == k
    np.testing.assert_allclose(m["lr"], float(m_j["lr"]), rtol=1e-6)
    for name in ("loss", "nll", "kl_y_0", "kl_z", "l2_res"):
        np.testing.assert_allclose(m[name].item(), float(m_j[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     ts_j.params),
                              ts_j.bn_state, cfg)
    for name, p in ts.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert_bn_close(bn_state_from_port(ts.model.state_dict(), cfg),
                    ts_j.bn_state)


def cli_run(tmp_path, name, spd, n_iter, resume=False):
    """The trainer CLI (tests/test_roundtrip.py:96's flags); returns its
    model.pt and its logged training rows."""
    save = tmp_path / name
    opt = parse(save, "--device", "cpu", "--n_iter", str(n_iter),
                "--steps_per_dispatch", str(spd), "--log_interval", "2",
                "--val_interval", "6", "--n_workers", "1",
                *(["--resume"] if resume else []))
    assert train_main.main(opt) == 0
    with open(save / "xp" / "metrics.jsonl") as f:
        rows = [r for r in map(json.loads, f) if "loss" in r]
    return torch.load(save / "xp" / "model.pt"), rows


def assert_runs_close(ref, got):
    (sd_r, rows_r), (sd_g, rows_g) = ref, got
    assert sd_r.keys() == sd_g.keys()
    for k in sd_r:
        np.testing.assert_allclose(sd_g[k].double().numpy(),
                                   sd_r[k].double().numpy(), rtol=CLI_RTOL,
                                   atol=CLI_ATOL, err_msg=k)
    assert [r["step"] for r in rows_g] == [r["step"] for r in rows_r]
    for a, b in zip(rows_r, rows_g):
        for key in ("loss", "nll", "kl_y_0", "kl_z", "l2_res", "lr"):
            np.testing.assert_allclose(b[key], a[key], rtol=CLI_RTOL,
                                       atol=CLI_ATOL, err_msg=key)


def test_cli_window_matches_single_dispatch(tmp_path):
    """--steps_per_dispatch 2 through the CLI takes the steps of the K = 1
    run (windows 1-2, 3-4, 5-6, then a single step 7); and 3 steps at
    K = 1 resumed to 7 at K = 2 (singles to the grid, a window, the ragged
    tail) land there too (tests/test_roundtrip.py:96-127)."""
    ref = cli_run(tmp_path, "k1", 1, 7)
    assert [r["step"] for r in ref[1]] == [2, 4, 6]
    assert_runs_close(ref, cli_run(tmp_path, "k2", 2, 7))
    cli_run(tmp_path, "resumed", 1, 3)
    assert_runs_close(ref, cli_run(tmp_path, "resumed", 2, 7, resume=True))


@pytest.mark.parametrize("interval", ["--log_interval", "--val_interval",
                                      "--chkpt_interval"])
def test_window_must_divide_the_intervals(tmp_path, interval):
    """The JAX trainer's ValueError (srvp_tpu/train_main.py:174-180)."""
    opt = parse(tmp_path, "--device", "cpu", "--n_iter", "4",
                "--steps_per_dispatch", "2", "--log_interval", "2",
                "--val_interval", "4", "--chkpt_interval", "4",
                interval, "3")
    with pytest.raises(ValueError, match=f"must divide {interval} 3"):
        train_main.main(opt)


def test_profile_dir_forces_single_steps(tmp_path, capsys):
    """--profile_dir traces single steps: K falls to 1 with the JAX
    trainer's message, before the intervals are checked."""
    opt = parse(tmp_path, "--device", "cpu", "--n_iter", "2",
                "--steps_per_dispatch", "4", "--log_interval", "1",
                "--val_interval", "2", "--profile_dir",
                str(tmp_path / "trace"))
    assert train_main.dispatch_width(opt) == 1
    assert "steps_per_dispatch forced to 1" in capsys.readouterr().out
    assert train_main.main(opt) == 0


def test_graph_safe_adam_follows_adam():
    """graph_safe_adam, Adam's step with its host scalars (adam_scalars)
    read from a device tensor, against Adam's own step from a fresh state
    over steps of changing learning rate and gradients of every scale: on
    the CPU to the last bits of float32 (CPU kernels round otherwise; on
    the card bit for bit, tests/test_torch_cuda.py); the step counts are
    left to the caller; Adam off its defaults is refused."""
    torch.manual_seed(0)
    shapes = [(16, 1, 4, 4), (16,), (40, 24), (7,)]
    ref = [torch.randn(s, requires_grad=True) for s in shapes]
    got = [p.detach().clone().requires_grad_() for p in ref]
    adam, safe = torch.optim.Adam(ref), torch.optim.Adam(got)
    for step, lr in enumerate([3e-4, 3e-4, 2e-4, 1e-4, 1e-3]):
        for p, q in zip(ref, got):
            p.grad = torch.randn_like(p) * 10.0 ** (step % 4 * -3)
            q.grad = p.grad.clone()
        adam.param_groups[0]["lr"] = lr
        adam.step()
        scalars, = train_lib.adam_scalars(safe, [lr])
        train_lib.graph_safe_adam(safe, torch.tensor(scalars))
        assert all(float(st["step"]) == step for st in safe.state.values())
        for st in safe.state.values():
            st["step"] += 1
    a, b = adam.state_dict()["state"], safe.state_dict()["state"]
    for i in a:
        assert a[i]["step"] == b[i]["step"] == 5
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(b[i][key].numpy(), a[i][key].numpy(),
                                       rtol=1e-6, atol=0)
    for p, q in zip(ref, got):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-6, atol=1e-9)
    ts = fresh_state()
    ts.optimizer.param_groups[0]["amsgrad"] = True
    with pytest.raises(ValueError, match="a window runs Adam at"):
        train_lib.WindowStep(ts, HP, 2)


def count_host_tensors(monkeypatch):
    """Counts the host arrays and lists turned into tensors, and the
    occupancy queries made, from now on."""
    seen = {"tensors": 0, "queries": 0}

    def counted(fn):
        def wrapper(*a, **kw):
            seen["tensors"] += 1
            return fn(*a, **kw)
        return wrapper

    for name in ("tensor", "from_numpy", "as_tensor"):
        monkeypatch.setattr(torch, name, counted(getattr(torch, name)))
    return seen


class FakeLib:
    """The occupancy queries of the kernel library, counted."""

    def __init__(self, seen):
        self.seen = seen
        self.srvp_train_rollout_fwd_clusters = self.query
        self.srvp_train_rollout_wgrad_occupancy = self.wgrad_query

    def query(self, *args):
        self.seen["queries"] += 1
        args[-1]._obj.value = 4
        return 0

    def wgrad_query(self, split, clusters, per_sm):
        self.seen["queries"] += 1
        clusters._obj.value, per_sm._obj.value = 8, 2
        return 0


def test_kernel_caches_copy_nothing_on_a_second_call(monkeypatch):
    """The first call of each wrapper helper builds its tables (a host
    array sent to the device, a driver query); a second call on the same
    shapes makes neither, so a window captured after an eager one meets no
    host copy: the packed-weight layout (kernels/rollout.py `_packing`),
    the weight-gradient job table (`_wgrad_table`), the occupancy queries
    behind the plans (`max_clusters`, `wgrad_occupancy`, `wgrad_plan`) and
    the model's rollout indices (models/srvp.py `_take`)."""
    device = torch.device("cpu")
    torch.manual_seed(0)
    layers = [(torch.randn(16, 12), torch.randn(16)),
              (torch.randn(8, 16), torch.randn(8))]
    # q (2 nz, nh_inf), p_z's two layers, the dynamics' two (ny 6, nz 4)
    shapes = ((8, 11), (16, 6), (8, 16), (16, 10), (6, 16))
    gpu = torch.device("cuda", 0)
    krollout._packing.cache_clear()
    krollout_train._wgrad_table.cache_clear()
    for module, name in ((krollout, "_max_clusters"),
                         (krollout_train, "_wgrad_occupancy"),
                         (krollout_train, "_wgrad_plans"),
                         (msrvp, "_INDICES")):
        monkeypatch.setattr(module, name, {})
    seen = count_host_tensors(monkeypatch)
    lib = FakeLib(seen)
    monkeypatch.setattr(krollout_train, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    ys = torch.randn(6, 2, 4)
    idx = np.flatnonzero(np.arange(6) % 2 == 1)

    def calls():
        krollout.pack(layers, 2, True, True)
        krollout_train._wgrad_table(shapes, 2, device)
        krollout.max_clusters(lib.query, (4, 4, 8, 16), 12, 2, gpu)
        krollout_train.wgrad_plan(shapes, 96, gpu)
        return msrvp._take(ys, idx)

    first = calls()
    assert seen["tensors"] > 0 and seen["queries"] > 0
    seen.update(tensors=0, queries=0)
    second = calls()
    assert seen == {"tensors": 0, "queries": 0}
    assert torch.equal(first, second) and torch.equal(first, ys[1::2])


def test_launch_counts_advance_as_one_dict():
    """kernels/launches.py reads, takes back and advances every wrapper's
    count: what a window does around its capture and each replay."""
    before = launches.counts()
    assert "train_rollout_bwd" in before and "maxpool_fwd_bf16" in before
    krollout_train.bwd_launches += 2
    delta = launches.since(before)
    assert delta["train_rollout_bwd"] == 2 and sum(delta.values()) == 2
    launches.set_counts(before)
    assert launches.counts() == before
    launches.add(delta)
    launches.add(delta)
    assert launches.since(before) == {k: 2 * v for k, v in delta.items()}
    launches.set_counts(before)


def test_device_batches_follow_the_window_grid():
    """srvp_tpu/train_main.py:199's schedule: from step 3 to n_iter 11 at
    K = 4, single steps to the grid (4), windows on it while a whole one
    fits (4-8), the ragged tail singly (9-11); a window stacks K batches
    in loader order, leaf-wise for parts dicts."""
    class Loader:
        def __iter__(self):
            return iter(parts_batch(j) for j in range(100))

    widths, firsts = [], []
    for width, batch in train_main.device_batches(Loader(), "cpu", 4, 3,
                                                  11):
        if sum(widths) >= 8:
            break
        widths.append(width)
        digits = batch["digits"]
        assert digits.shape[0] == width if width > 1 else digits.dim() == 4
        firsts.append(digits[0] if width > 1 else digits)
    assert widths == [1, 4, 1, 1, 1]
    expect = [0, 1, 5, 6, 7]   # the loader batch each item starts with
    for got, j in zip(firsts, expect):
        assert torch.equal(got, torch.from_numpy(parts_batch(j)["digits"]))


def test_training_loader_holds_two_windows(tmp_path):
    """The trainer's loader makes two dispatches' batches ahead, so that a
    window's K batches are made while the previous window runs; the
    batches do not depend on it."""
    def first_batches(spd):
        train, _ = train_main.loaders(parse(
            tmp_path, "--device", "cpu", "--steps_per_dispatch", str(spd),
            "--n_workers", "1"))
        it = iter(train)
        try:
            return train.prefetch, [next(it) for _ in range(3)]
        finally:
            it.close()

    (depth1, ref), (depth4, got) = first_batches(1), first_batches(4)
    assert (depth1, depth4) == (2, 8)
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
