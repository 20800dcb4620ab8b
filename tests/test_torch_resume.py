"""The port's trainer run control on the CPU at tiny widths: the full train
state round-trips bit for bit, a run stopped by SIGTERM and resumed gives
the weights and metrics rows of a run never stopped, a worse validation
after a resume leaves model_best.pt alone, MetricsLogger truncates as the
JAX package's does, the background checkpoint writer reports its errors
and saves what was snapshotted, stale temporary files go at startup, and
`--profile_dir` writes a trace."""

import json
import os
import signal

import numpy as np
import pytest

import torch

from srvp_tpu.utils.runtime import MetricsLogger as JaxMetricsLogger
from srvp_tpu_torch import train_lib, train_main
from srvp_tpu_torch.config import SRVPConfig
from srvp_tpu_torch.utils import checkpoint as ckpt
from srvp_tpu_torch.utils.runtime import MetricsLogger

from test_torch_train_cli import parse

CFG = SRVPConfig(nf=4, nhx=8, ny=4, nz=4, nt_inf=2, nh_inf=8, nlayers_inf=2,
                 nh_res=16, nlayers_res=2)
HP = train_lib.TrainHParams(nt_cond=3, n_samples_test=2, val_samples_chunk=2,
                            lr_burnin=2, lr_decay_iter=4)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def fresh_state(seed):
    torch.manual_seed(seed)
    ts = train_lib.init_train_state(CFG, HP, "cpu")
    ts.generator = torch.Generator().manual_seed(seed)
    return ts


def batch(k):
    return torch.from_numpy(np.random.RandomState(k).randint(
        0, 256, (6, 3, 64, 64, 1)).astype(np.uint8))


def flat(tree, prefix=""):
    """{path: leaf} of a nested dict/list."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}"))
    return out


def test_train_state_round_trips_bit_for_bit(tmp_path):
    ts = fresh_state(0)
    for k in range(3):
        train_lib.train_step(ts, batch(k), HP, generator=ts.generator)
    ckpt.save_train_state(str(tmp_path), train_lib.state_dict(ts),
                          extra={"best_val_metric": -1.5})
    other = fresh_state(1)
    state, info = ckpt.load_train_state(str(tmp_path))
    assert info == {"step": 3, "best_val_metric": -1.5}
    train_lib.load_state_dict(other, state)

    a, b = flat(train_lib.state_dict(ts)), flat(train_lib.state_dict(other))
    assert a.keys() == b.keys()
    names = {"exp_avg", "exp_avg_sq", "step", "last_epoch", "generator",
             "num_batches_tracked", "running_mean", "running_var"}
    assert names <= {p.split("/")[-1].split(".")[-1] for p in a}
    for path in a:
        if isinstance(a[path], torch.Tensor):
            assert a[path].dtype == b[path].dtype, path
            assert torch.equal(a[path], b[path]), path
        else:
            assert a[path] == b[path], path
    assert other.step == 3 and other.scheduler.last_epoch == 3
    assert other.scheduler.get_last_lr() == ts.scheduler.get_last_lr()

    losses = [train_lib.train_step(s, batch(3), HP,
                                   generator=s.generator)["loss"]
              for s in (ts, other)]
    assert losses[0].item() == losses[1].item()
    assert ts.scheduler.get_last_lr() == other.scheduler.get_last_lr()


def rows(xp):
    return [json.loads(line)
            for line in (xp / "metrics.jsonl").read_text().splitlines()]


def meta(xp):
    return json.loads((xp / "train_state.json").read_text())


def without_times(rows_):
    return [{k: v for k, v in r.items() if k not in ("wall_s", "fps")}
            for r in rows_]


def stop_at(monkeypatch, step, raise_=None):
    """Makes the trainer receive SIGTERM (or raise `raise_`) right after
    its step `step`."""
    real = train_lib.train_step

    def step_then_stop(ts, *args, **kw):
        out = real(ts, *args, **kw)
        if ts.step == step:
            if raise_ is not None:
                raise raise_
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    monkeypatch.setattr(train_lib, "train_step", step_then_stop)


FLAGS = ["--device", "cpu", "--n_iter", "6", "--val_interval", "6",
         "--chkpt_interval", "2"]


def test_sigterm_then_resume_gives_the_uninterrupted_run(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    whole, part = tmp_path / "whole", tmp_path / "part"
    assert train_main.main(parse(whole, *FLAGS)) == 0
    prev = signal.getsignal(signal.SIGTERM)
    with monkeypatch.context() as m:
        stop_at(m, 3)
        assert train_main.main(parse(part, *FLAGS)) == 143
    assert signal.getsignal(signal.SIGTERM) is prev
    xp = part / "xp"
    assert meta(xp)["step"] == 3
    assert [r["step"] for r in rows(xp)] == [1, 2, 3]
    capsys.readouterr()
    assert train_main.main(parse(part, *FLAGS, "--resume")) == 0
    assert "Resumed from step 3" in capsys.readouterr().out
    assert meta(xp)["step"] == 6

    ref = rows(whole / "xp")
    assert [r["step"] for r in ref] == [1, 2, 3, 4, 5, 6, 6]
    assert without_times(rows(xp)) == without_times(ref)
    for name in ("model.pt", "model_6.pt", "model_4.pt"):
        a, b = (torch.load(d / "xp" / name) for d in (whole, part))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)


def test_a_worse_validation_after_resume_keeps_model_best(tmp_path,
                                                          monkeypatch):
    readings = iter([-10.0, -5.0, -4.0])
    monkeypatch.setattr(train_lib, "evaluate",
                        lambda *a, **k: next(readings))
    flags = FLAGS[:4] + ["--val_interval", "2"]
    xp = tmp_path / "xp"
    with monkeypatch.context() as m:
        stop_at(m, 3)
        assert train_main.main(parse(tmp_path, *flags)) == 143
    best = (xp / "model_best.pt").read_bytes()
    assert meta(xp) == {
        "step": 3, "best_val_metric": -10.0}
    assert train_main.main(parse(tmp_path, *flags, "--resume")) == 0
    assert (xp / "model_best.pt").read_bytes() == best
    assert meta(xp)["best_val_metric"] == -10.0
    assert [r["val_metric"] for r in rows(xp) if "val_metric" in r] == [
        -10.0, -5.0, -4.0]


def test_keyboard_interrupt_saves_and_returns_130(tmp_path, monkeypatch):
    stop_at(monkeypatch, 2, raise_=KeyboardInterrupt())
    assert train_main.main(parse(tmp_path, *FLAGS)) == 130
    assert meta(tmp_path / "xp")["step"] == 2
    assert (tmp_path / "xp" / "model.pt").exists()


def test_metrics_truncation_matches_jax(tmp_path):
    lines = [json.dumps({"step": s, "wall_s": 0.1 * s, "loss": 1.0 / s})
             for s in range(1, 6)]
    lines.insert(3, json.dumps({"step": 3, "wall_s": 0.35,
                                "val_metric": -2.0}))
    text = "\n".join(lines) + '\n{"step": 6, "wall_'
    for after in (3, 0, 9):
        paths = [tmp_path / f"{who}_{after}.jsonl" for who in ("ours", "jax")]
        for path, logger in zip(paths, (MetricsLogger, JaxMetricsLogger)):
            path.write_text(text)
            logger(str(path), truncate_after=after).close()
        assert paths[0].read_text() == paths[1].read_text()
    kept = [json.loads(x) for x in
            (tmp_path / "ours_3.jsonl").read_text().splitlines()]
    assert [r["step"] for r in kept] == [1, 2, 3, 3]
    logger = MetricsLogger(str(tmp_path / "new.jsonl"))
    logger.log(7, loss=torch.tensor(2.5), note="x")
    logger.close()
    row = json.loads((tmp_path / "new.jsonl").read_text())
    assert (row["step"], row["loss"], row["note"]) == (7, 2.5, "x")
    assert set(row) == {"step", "wall_s", "loss", "note"}


def test_async_checkpointer_reports_errors_and_saves_the_snapshot(tmp_path):
    writer = ckpt.AsyncCheckpointer()
    writer.submit(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="checkpoint save failed") as e:
        writer.wait()
    assert isinstance(e.value.__cause__, ZeroDivisionError)
    writer.wait()       # reported once

    w = torch.nn.Parameter(torch.ones(3))
    snap = ckpt.Snapshot({"w": w, "meta": [1, {"t": torch.zeros(2)}]})
    with torch.no_grad():
        w.add_(1.0)
    writer.submit(lambda: ckpt.save_model(str(tmp_path), "snap",
                                          snap.host()))
    writer.wait()
    saved = torch.load(tmp_path / "snap.pt")
    assert torch.equal(saved["w"], torch.ones(3))
    assert saved["meta"][0] == 1 and torch.equal(saved["meta"][1]["t"],
                                                 torch.zeros(2))


def test_stale_temporary_files_go_at_startup(tmp_path):
    xp = tmp_path / "xp"
    xp.mkdir()
    for name in ("model_best.pt.tmp", "train_state.json.tmp",
                 "metrics.jsonl.tmp"):
        (xp / name).write_text("cut short")
    (xp / "notes.txt").write_text("kept")
    assert train_main.main(parse(tmp_path, "--device", "cpu", "--n_iter",
                                 "1", "--val_interval", "1")) == 0
    assert not list(xp.glob("*.tmp"))
    assert (xp / "notes.txt").read_text() == "kept"


def test_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    assert train_main.main(parse(tmp_path, "--device", "cpu", "--n_iter",
                                 "16", "--log_interval", "8",
                                 "--val_interval", "16",
                                 "--profile_dir", str(prof))) == 0
    traces = list(prof.glob("*.json"))
    assert [t.name for t in traces] == ["trace_steps_10-15.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(ev.get("name")) for ev in events)
