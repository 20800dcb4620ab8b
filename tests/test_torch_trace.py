"""The port's spans and counters (srvp_tpu_torch/utils/trace.py): free when
off, totals and self time when on, the profiler's thread, the loader's
producer thread, and the benchmark's readers of them
(perfbench/metrics/). The `cuda` test times spans on the card and holds
the capture guard under a dispatch window's CUDA graph."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import srvp_tpu_torch.utils
from perfbench import core
from srvp_tpu_torch import train_lib
from srvp_tpu_torch.config import SRVPConfig
from srvp_tpu_torch.data.device_compose import stack_batches, to_device
from srvp_tpu_torch.data.loader import DataLoader
from srvp_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def clean_registry():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _refuse(*args, **kwargs):
    raise AssertionError("called while tracing is off")


def test_off_calls_no_clock_and_no_record_function(monkeypatch):
    monkeypatch.setattr(trace, "clock", _refuse)
    monkeypatch.setattr(trace, "record_function", _refuse)
    assert not trace.active()
    for on in (None, False):
        s = trace.span("srvp.test.off", on=on)
        assert s is trace.OFF
        with s:
            with trace.span("srvp.test.inner"):
                pass
    trace.count("srvp.test.n", 3)
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}


def test_enabled_totals_and_self_time(monkeypatch):
    ticks = iter([0.0, 1.0, 3.0, 4.0, 8.0, 10.0])
    monkeypatch.setattr(trace, "clock", lambda: next(ticks))
    trace.enable()
    with trace.span("srvp.test.outer"):
        for _ in range(2):
            with trace.span("srvp.test.inner"):
                pass
        trace.count("srvp.test.items", 5)
        trace.count("srvp.test.items")
    spans = trace.snapshot()["spans"]
    outer, inner = spans["srvp.test.outer"], spans["srvp.test.inner"]
    assert (outer["count"], outer["host_s"], outer["self_s"]) == (1, 10, 4)
    assert (inner["count"], inner["host_s"], inner["self_s"]) == (2, 6, 6)
    assert outer["parents"] == [] and inner["parents"] == ["srvp.test.outer"]
    assert inner["device_s"] is None      # no CUDA here
    assert trace.snapshot()["counters"] == {"srvp.test.items": 6}
    trace.reset()
    assert trace.snapshot()["spans"] == {}


def test_snapshot_carries_the_programs_counts():
    from srvp_tpu_torch.data import native
    from srvp_tpu_torch.kernels import launches
    snap = trace.snapshot()
    assert snap["launches"] == launches.counts()
    assert snap["native"] == {"served": native.served,
                              "decoded": native.decoded}


def test_profiler_thread_records_and_nothing_outside():
    with trace.span("srvp.test.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.active()
        with trace.span("srvp.test.a"):
            with trace.span("srvp.test.b"):
                torch.ones(4).sum()
        trace.count("srvp.test.n")
    with trace.span("srvp.test.after"):
        pass
    names = {ev.name for ev in prof.events()}
    assert {"srvp.test.a", "srvp.test.b"} <= names
    snap = trace.snapshot()
    assert set(snap["spans"]) == {"srvp.test.a", "srvp.test.b"}
    assert snap["spans"]["srvp.test.b"]["parents"] == ["srvp.test.a"]
    assert snap["counters"] == {"srvp.test.n": 1}


class _Frames:
    """16 uint8 videos of 3 frames of 4 x 4."""

    def __len__(self):
        return 16

    def get_item(self, index, rng):
        return rng.randint(0, 256, (3, 4, 4)).astype(np.uint8)


def test_loader_producer_records_under_the_profiler():
    loader = DataLoader(_Frames(), batch_size=2, seed=3, num_workers=1)
    with profile(activities=[ProfilerActivity.CPU]):
        batches = list(loader)
    assert len(batches) == 8
    snap = trace.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    # the batches made before the first take were made untraced
    assert 1 <= spans["srvp.data.produce"]["count"] <= 8
    assert spans["srvp.data.produce"]["parents"] == []
    # eight batches and the epoch's end
    assert spans["srvp.data.wait"]["count"] == 9
    assert counters["srvp.data.takes"] == 9
    assert 0 <= counters["srvp.data.ready"] <= 2 * 9


# (metric, the registry's snapshot, its value on a 2 s sub-window of 4
# units; the readers under perfbench/metrics/)
SPANS = {"srvp.data.wait": (4, 0.1, None),
         "srvp.data.produce": (6, 0.3, None),
         "srvp.train.forward": (4, 0.5, 0.4),
         "srvp.train.backward": (4, 0.25, 0.6),
         "srvp.train.optimizer": (4, 0.2, 0.1),
         "srvp.serve.input": (4, 0.004, 0.002),
         "srvp.serve.module": (4, 0.1, 0.3),
         "srvp.eval.batch": (1, 2.0, 1.6),
         "srvp.eval.decode": (10, 0.2, 1.2),
         "srvp.eval.score": (10, 0.1, 0.2)}
COUNTERS = {"srvp.data.takes": 4, "srvp.data.ready": 6}
READERS = [("loader_wait_pct.train_loader", ["srvp.data.wait"], 5.0),
           ("loader_ready_batches.train_loader", ["srvp.data.takes"], 1.5),
           ("loader_busy_pct.train_loader", ["srvp.data.produce"], 10.0),
           ("forward_host_pct.train_loader", ["srvp.train.forward"], 25.0),
           ("backward_host_pct.train_loader", ["srvp.train.backward"],
            12.5),
           ("optimizer_host_pct.train_loader", ["srvp.train.optimizer"],
            10.0),
           ("serve_input_ms.serve", ["srvp.serve.input"], 1.0),
           ("serve_enqueue_ms.serve", ["srvp.serve.module"], 25.0),
           ("decode_device_pct.eval", ["srvp.eval.decode",
                                       "srvp.eval.batch"], 75.0),
           ("score_device_pct.eval", ["srvp.eval.score",
                                      "srvp.eval.batch"], 12.5)]


def _records():
    rec = core.Records("train")
    rec.trace = SimpleNamespace(window_s=2.0, units=4)
    return rec


def _snapshot(drop=()):
    spans = {n: {"count": c, "host_s": h, "self_s": h, "device_s": d,
                 "parents": []}
             for n, (c, h, d) in SPANS.items() if n not in drop}
    counters = {n: v for n, v in COUNTERS.items() if n not in drop}
    return {"spans": spans, "counters": counters, "launches": {},
            "native": {}}


@pytest.mark.parametrize("metric,needs,value", READERS,
                         ids=[r[0] for r in READERS])
def test_reader_value(monkeypatch, metric, needs, value):
    monkeypatch.setattr(trace, "snapshot", _snapshot)
    assert core.reader(metric)(_records()) == pytest.approx(value)


@pytest.mark.parametrize("metric,needs,value", READERS,
                         ids=[r[0] for r in READERS])
def test_reader_none_without_its_span(monkeypatch, metric, needs, value):
    for name in needs:
        monkeypatch.setattr(trace, "snapshot",
                            lambda name=name: _snapshot(drop=(name,)))
        assert core.reader(metric)(_records()) is None


@pytest.mark.parametrize("metric", [r[0] for r in READERS])
def test_reader_none_without_the_registry(monkeypatch, metric):
    """A program without utils/trace.py (the benchmark laid over an older
    checkout) reads as None, and does not raise."""
    monkeypatch.delattr(srvp_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "srvp_tpu_torch.utils.trace", None)
    assert core.reader(metric)(_records()) is None


@pytest.mark.cuda
def test_device_seconds_and_the_capture_guard(monkeypatch):
    """On the card: a span's device seconds (its CUDA events' stream time)
    hold its work and sit within its parent's, and a dispatch window's
    CUDA graph, captured and replayed, adds no span: only its first,
    eager window's two steps are timed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trace.enable()
    x = torch.randn(2048, 2048, device="cuda")
    with trace.span("srvp.test.outer"):
        with trace.span("srvp.test.mm"):
            for _ in range(20):
                x = torch.tanh(x @ x)
    spans = trace.snapshot()["spans"]
    mm, outer = spans["srvp.test.mm"], spans["srvp.test.outer"]
    assert 0 < mm["device_s"] <= outer["device_s"]

    trace.reset()
    cfg = SRVPConfig(nf=4, nhx=8, ny=4, nz=4, nt_inf=2, nh_inf=8,
                     nlayers_inf=2, nh_res=16, nlayers_res=2)
    hp = train_lib.TrainHParams(nt_cond=3, lr=1e-3)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.manual_seed(0)
    ts = train_lib.init_train_state(cfg, hp, "cuda")
    ts.generator = torch.Generator(device="cuda").manual_seed(0)
    window = train_lib.WindowStep(ts, hp, 2)
    for j in range(3):
        batches = [np.random.RandomState(2 * j + i).randint(
            0, 256, (6, 3, 64, 64, 1)).astype(np.uint8) for i in range(2)]
        window(to_device(stack_batches(batches), "cuda"))
    assert window.graph is not None
    spans = trace.snapshot()["spans"]
    for name in ("srvp.train.forward", "srvp.train.backward"):
        assert spans[name]["count"] == 2, name
        assert spans[name]["device_s"] > 0, name
