"""What every cell shares: BENCHMARK.json and the files it names, the
seeds, seeded synthetic frames, the records a run leaves for the metric
readers, the device trace, and the result line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(`configs/<config>.json`, found through the `configs` entry's `file`) and
a traffic mix (`traffic/<traffic>.json`), whose `driver` names the code
that runs it (`drivers/<driver>.py`). Every metric is read by a reader
(`metrics/<name>.py`, or `metrics/<name before the first dot>.py` when the
metric has none of its own) with a function `read(rec)` that returns the
value or None. The comparison's limits are `limits/<cell>.json`.
"""

import importlib
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level module names that may not be loaded in a benchmark process
FORBIDDEN = ("jax", "jaxlib", "flax", "srvp_tpu")
clock = time.perf_counter


def load_benchmark():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic,
    driver, metrics and limits."""

    def __init__(self, name, bench=None):
        bench = bench or load_benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.traffic = load_json(HERE / "traffic" /
                                 f"{self.entry['traffic']}.json")
        self.driver = importlib.import_module(
            f"perfbench.drivers.{self.traffic['driver']}")
        self.chips = self.entry["chips"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]
        limits = HERE / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.exists() else None


def reader(metric_name):
    """The `read` function of a metric's reader file."""
    for stem in (metric_name, metric_name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"perfbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {metric_name!r} under "
                     f"perfbench/metrics/")


def build_kernels(ctx):
    """Builds the port's CUDA kernel library, or finds it built."""
    from srvp_tpu_torch.kernels import build
    build.build()


def sub_seeds(seed, n):
    """n independent 63-bit seeds derived from `seed` (any size)."""
    words = np.random.SeedSequence(int(seed)).generate_state(2 * n,
                                                             np.uint64)
    return [int(w) >> 1 for w in words[::2]]


def synthetic_frames(n_videos, nt, nx, nc, gen, device):
    """uint8 (nt, n_videos, nx, nx, nc) videos from `gen`: a smooth random
    pattern per video drifting across the frame, under a slowly changing
    smooth shading, in a few large calls on the device."""
    big = torch.rand((n_videos, nc, 12, 12), generator=gen, device=device)
    pattern = torch.nn.functional.interpolate(big, size=(2 * nx, 2 * nx),
                                              mode="bicubic",
                                              align_corners=False)
    vel = torch.randint(-3, 4, (n_videos, 2), generator=gen, device=device)
    start = torch.randint(0, nx // 2, (n_videos, 2), generator=gen,
                          device=device)
    t = torch.arange(nt, device=device)
    off = (start[:, None] + vel[:, None] * t[None, :, None]) % nx
    ar = torch.arange(nx, device=device)
    rows = (off[..., 0:1] + ar) % (2 * nx)               # (V, T, nx)
    cols = (off[..., 1:2] + ar) % (2 * nx)
    v = torch.arange(n_videos, device=device)[:, None, None, None]
    moving = pattern.permute(0, 2, 3, 1)[v, rows[..., :, None],
                                         cols[..., None, :]]
    shade = torch.rand((n_videos, nc, nt, 3, 3), generator=gen,
                       device=device)
    shade = torch.nn.functional.interpolate(
        shade, size=(nt, nx, nx), mode="trilinear", align_corners=True)
    video = 0.7 * moving + 0.3 * shade.permute(0, 2, 3, 4, 1)
    return (video.clamp(0, 1) * 255).to(torch.uint8).transpose(0, 1)


class Records:
    """What a run leaves for the readers.

    kind: "train", "eval" or "serve"; window_s: the measured window's
    length; units: whole units (steps, batches, calls) in it; frames:
    the frames they produced; latencies_s: each call's latency (serve);
    peak_bytes: the device's allocated peak over the window; setup_s;
    spans: {name: seconds in the window}; trace: a Trace of the traced
    sub-window or None; flops_per_unit and peak_flops (the reference
    model's count and the dtype's peak); bound_s_per_unit: the port's own
    kernels' least time for one unit (the frozen yardstick)."""

    def __init__(self, kind):
        self.kind = kind
        self.window_s = self.units = self.frames = None
        self.latencies_s = []
        self.peak_bytes = self.setup_s = None
        self.spans = {}
        self.trace = None
        self.flops_per_unit = self.peak_flops = None
        self.bound_s_per_unit = None


class Trace:
    """A torch.profiler sub-window reduced to what the readers need:
    device operations (name, start us, end us), host ops (name, start,
    end), the window's bounds, and the units it held."""

    def __init__(self, prof, units):
        self.units = units
        self.device_ops, self.host_ops = [], []
        for ev in prof.events():
            tr = ev.time_range
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                # a host span (record_function) shows on the device's
                # timeline too: it is no operation
                if getattr(ev, "is_user_annotation", False) or \
                        ev.name.startswith("perfbench."):
                    continue
                if tr.end > tr.start:
                    self.device_ops.append((ev.name, tr.start, tr.end))
            else:
                self.host_ops.append((ev.name, tr.start, tr.end))
        self.device_ops.sort(key=lambda e: e[1])
        # the traced window: the harness's own span around it
        span = [e for e in self.host_ops if e[0] == "perfbench.traced"]
        self.t0, self.t1 = min(e[1] for e in span), max(e[2] for e in span)
        self.device_ops = [(n, max(a, self.t0), min(b, self.t1))
                           for n, a, b in self.device_ops
                           if b > self.t0 and a < self.t1]

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    def kernels(self):
        return [e for e in self.device_ops
                if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self):
        """The union of the device operations' intervals."""
        out = []
        for _, a, b in self.device_ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def by_name(self):
        tot = {}
        for name, a, b in self.device_ops:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return tot

    def gaps(self):
        """[(start us, end us)] of the window's idle stretches."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def longest_gaps(self, n=10):
        """[(what the host was doing, seconds)] of the n longest idle
        stretches, each named by the innermost host op that covers at
        least half as much of it as the op covering most of it."""
        out = []
        for a, b in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]:
            cover = [(min(b, e[2]) - max(a, e[1]), e[1], e[0])
                     for e in self.host_ops if e[1] < b and e[2] > a]
            name = "host (no op open)"
            if cover:
                most = max(c[0] for c in cover)
                name = max((c for c in cover if c[0] >= most / 2),
                           key=lambda c: c[1])[2]
            out.append((name, (b - a) * 1e-6))
        return out

    def breakdown(self):
        top = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = self.longest_gaps()
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def profile(run_units, units, device):
    """Runs `run_units()` (which does `units` units) under torch.profiler
    (CPU and CUDA activity), inside a host span; returns the Trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from torch.profiler import record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with torch_profile(activities=acts) as prof:
        with record_function("perfbench.traced"):
            run_units()
            sync(device)
    return Trace(prof, units)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_flops(precision):
    from perfbench.yardstick.peaks import PEAK_BY_DTYPE
    return PEAK_BY_DTYPE[precision]


def forbidden_modules():
    import sys
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
