"""The port's spans and counters: phase-level host and device time, and
counts, kept in memory and read as one snapshot.

    with trace.span("srvp.train.forward"):
        ...
    trace.count("srvp.data.takes")
    trace.snapshot()  # {"spans": {...}, "counters": {...}, ...}

Spans are named `srvp.<layer>.<phase>` and sit at phase boundaries only,
never inside a loop over frames, layers, substeps or samples.

Tracing is off by default. Off, `span` returns one shared object that does
nothing, after a module flag and the thread's profiler state are read: no
clock, no `record_function`, no allocation; `count` returns at once. It is
on in a thread whose `torch.profiler` is running (the profiler's state is
per thread), and in every thread after `enable()` until `disable()`. A
thread that works for another (the loader's producer) passes the state
that thread handed it as `on`.

On, a span:

- enters a `torch.profiler.record_function` of its name, so that under
  the profiler it sits on the host timeline beside the device trace (a
  span opened in a thread the profiler does not follow reaches the totals
  alone);
- adds its host seconds and its count to its name's totals, and its host
  seconds to its parent's children (the enclosing span of the same
  thread), so that self time is total minus children;
- where CUDA is initialised and the span's own thread opened it (no
  `on`), records a CUDA event on the current stream as it opens and as it
  closes; `snapshot` waits for the device and sums the pairs' stream time
  per name. Two events on one stream measure the stream's progress between
  them, idle time included.

A span records nothing while the current stream is capturing a CUDA graph
(train_lib.WindowStep's capture: an event cannot be timed there, and the
capture runs nothing).

`snapshot()` also returns the kernels' launch counts (kernels/launches.py)
and the native data libraries' counts (data/native.py `served`,
`decoded`), read where they live. `reset()` clears the spans and counters.
"""

import threading
import time

import torch
from torch.profiler import record_function

clock = time.perf_counter
_profiling = torch._C._autograd._profiler_enabled
# pairs of CUDA events kept before the finished ones are summed
_FOLD_AT = 1024


class _Off:
    """The span that tracing off hands out: one object, no work."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Registry:
    """Totals of the process's spans and counters."""

    def __init__(self):
        self.enabled = False
        self.lock = threading.Lock()
        self.local = threading.local()   # each thread's open span names
        self.clear()

    def clear(self):
        with self.lock:
            # name: [count, host s, children's host s, {parent names}]
            self.spans = {}
            self.counters = {}
            self.device = {}    # name: device s of the summed pairs
            self.pairs = []     # (name, start event, end event)

    def stack(self):
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, name, parent, host_s):
        with self.lock:
            tot = self.spans.setdefault(name, [0, 0.0, 0.0, set()])
            tot[0] += 1
            tot[1] += host_s
            tot[3].add(parent)
            if parent is not None:
                self.spans.setdefault(parent, [0, 0.0, 0.0, set()])[2] += \
                    host_s

    def add_pair(self, name, start, end):
        with self.lock:
            self.pairs.append((name, start, end))
            if len(self.pairs) >= _FOLD_AT:
                self._fold(wait=False)

    def _fold(self, wait):
        """Sums the pairs whose end the device has reached (all of them
        after a synchronise, with `wait`) into their names' device s."""
        if wait and self.pairs:
            torch.cuda.synchronize()
        keep = []
        for name, start, end in self.pairs:
            if wait or end.query():
                self.device[name] = self.device.get(name, 0.0) \
                    + start.elapsed_time(end) * 1e-3
            else:
                keep.append((name, start, end))
        self.pairs = keep


_reg = _Registry()


class _Span:
    __slots__ = ("name", "timed", "rf", "parent", "events", "t0")

    def __init__(self, name, timed):
        self.name = name
        self.timed = timed

    def __enter__(self):
        self.rf = None
        cuda = torch.cuda.is_initialized()
        if cuda and torch.cuda.is_current_stream_capturing():
            return self
        stack = _reg.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.events = None
        if cuda and self.timed:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        if self.rf is None:
            return False
        host_s = clock() - self.t0
        if self.events is not None:
            self.events[1].record()
            _reg.add_pair(self.name, *self.events)
        self.rf.__exit__(*exc)
        _reg.stack().pop()
        _reg.add(self.name, self.parent, host_s)
        return False


def active():
    """Whether tracing is on in this thread."""
    return _reg.enabled or _profiling()


def span(name, on=None):
    """A context manager that times the phase `name` while tracing is on
    (`on`: a state handed over from the thread the work serves; its spans
    are timed on the host alone)."""
    if on is None:
        return _Span(name, True) if active() else OFF
    return _Span(name, False) if on else OFF


def count(name, n=1):
    """Adds n to the counter `name` while tracing is on in this thread."""
    if not active():
        return
    with _reg.lock:
        _reg.counters[name] = _reg.counters.get(name, 0) + n


def enable():
    """Turns tracing on in every thread, profiler or not."""
    _reg.enabled = True


def disable():
    _reg.enabled = False


def reset():
    """Clears every span's and counter's totals."""
    _reg.clear()


def snapshot():
    """{"spans": {name: {count, host_s, self_s, device_s, parents}},
    "counters": {name: n}, "launches": launches.counts(), "native":
    {"served": ..., "decoded": ...}}. Waits for the device where spans
    recorded CUDA events; device_s is None for a span that recorded
    none."""
    from srvp_tpu_torch.data import native
    from srvp_tpu_torch.kernels import launches
    with _reg.lock:
        _reg._fold(wait=True)
        spans = {name: {"count": n, "host_s": host, "self_s": host - kids,
                        "device_s": _reg.device.get(name),
                        "parents": sorted(p for p in parents if p)}
                 for name, (n, host, kids, parents) in _reg.spans.items()}
        counters = dict(_reg.counters)
    return {"spans": spans, "counters": counters,
            "launches": launches.counts(),
            "native": {"served": dict(native.served),
                       "decoded": dict(native.decoded)}}
