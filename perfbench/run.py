"""Runs one cell of the benchmark once and prints its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--device cpu --tiny]

From the root of a checkout. Set-up (weights and inputs from the seed,
the program built and warmed on every shape the cell uses) counts as
`setup_s`; the window then measures for `--seconds`. With `--trace 1` a
short traced sub-window follows, and the line carries the cell's
per-layer metrics and the trace's breakdown; with `--trace 0` its
end-to-end metrics. The build of the port's native libraries (nvcc,
g++; found built after a cell's first run in a checkout) counts in
`setup_s` and is also given apart, as the line's `build_s` and on
standard error. Once the window has closed and the program's state is
freed, the plain reference (perfbench/reference/) checks what the window
produced; the numbers compared and their limits are the line's last key
and the last lines on standard error.

Exits non-zero with no result line when the cell's chips are not there,
when the check cannot run, or when jax, jaxlib, flax or srvp_tpu is loaded
in the process. `--device cpu --tiny` rehearses a cell on the CPU at tiny
sizes (the tests): no device metric is measured there.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
# torch's extension build cache at a fixed path inside the checkout; the
# port's own libraries are built under build/ there (kernels/build.py,
# data/native.py), so that only a cell's first run in a checkout builds
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import core  # noqa: E402

# --tiny: widths and shapes for a rehearsal on the CPU
TINY_MODEL = dict(nf=4, nhx=8, ny=4, nz=4, nh_inf=8, nh_res=16,
                  nlayers_inf=2, nlayers_res=2)
# shapes; the evaluation and serving predict 3 frames
TINY_PROTO = {"train": dict(batch=4, seq_len=6), "eval": {}, "serve": {}}
TINY_TRAFFIC = {"train": dict(pool_batches=3, n_workers=2, trace_units=2),
                "eval": dict(videos=2, samples=4, chunk=2, pool_batches=2,
                             trace_units=1),
                "serve": dict(batch=2, pool_batches=2, trace_units=2,
                              check_stride=2)}


class Context:
    """What a driver is given: the cell's configuration (its `model`
    widths, its `protocol` for the driver's kind), its traffic, the seed
    and the device."""

    def __init__(self, cell, args, device):
        self.cell = cell
        self.config = cell.config
        kind = cell.traffic["driver"]
        self.model = dict(cell.config["model"])
        self.proto = dict(cell.config["protocol"][kind],
                          nt_cond=cell.config["protocol"]["nt_cond"])
        self.traffic = dict(cell.traffic)
        if args.tiny:
            self.model.update(TINY_MODEL)
            self.proto.update(TINY_PROTO[kind])
            if "nt_gen" in self.proto:
                self.proto["nt_gen"] = self.proto["nt_cond"] + 3
            self.traffic.update(TINY_TRAFFIC[kind])
        self.seed = args.seed
        self.device = device
        self.data_dir = CACHE / "no-data"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda",
                   help="'cpu' rehearses the cell on the CPU")
    p.add_argument("--tiny", action="store_true",
                   help="tiny widths and shapes (a rehearsal on the CPU)")
    return p.parse_args(argv)


def device_info(device, chips, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak)}


def fail(msg):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main(argv=None):
    args = parse(argv)
    cell = core.Cell(args.workload)
    if args.device == "cpu":
        if not args.tiny:
            fail("--device cpu runs only with --tiny")
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            fail("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            fail(f"the cell needs {cell.chips} devices, "
                 f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
    if cell.limits is None:
        fail(f"no limits file perfbench/limits/{cell.name}.json")
    drv = cell.driver
    ctx = Context(cell, args, device)
    rec = core.Records(drv.KIND)

    t_imported = core.clock()
    on_card = device.type == "cuda"
    build_s = 0.0
    if on_card:
        getattr(drv, "build", core.build_kernels)(ctx)
        build_s = core.clock() - t_imported
    st = drv.setup(ctx)
    core.sync(device)
    # what set-up left behind (the export's graphs among it) is collected
    # now and kept out of the collector's later passes, not in the window
    gc.collect()
    gc.freeze()
    rec.setup_s = core.clock() - T_START
    print(f"setup: {t_imported - T_START:.3f} s imports and device checks, "
          f"{build_s:.3f} s building the port's libraries, "
          f"{rec.setup_s - (t_imported - T_START) - build_s:.3f} s the "
          f"driver's set-up", file=sys.stderr, flush=True)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    drv.window(st, rec, args.seconds)
    if on_card:
        rec.peak_bytes = torch.cuda.max_memory_allocated(device)
    attempted, failed = rec.units, getattr(st, "failed", 0)
    print(f"window: {rec.units} units in {rec.window_s:.3f} s"
          + "".join(f", {k} {v:.3f} s" for k, v in rec.spans.items()),
          file=sys.stderr, flush=True)
    if rec.latencies_s:
        q = np.percentile(rec.latencies_s, [50, 90, 95, 99, 100]) * 1e3
        print("latency ms p50 %.3f p90 %.3f p95 %.3f p99 %.3f max %.3f"
              % tuple(q), file=sys.stderr, flush=True)
    if args.trace:
        n = ctx.traffic["trace_units"]
        rec.trace = core.profile(drv.traced(st, n), n, device)
    peak = max(setup_peak, rec.peak_bytes or 0)
    prog = drv.program_outputs(st)
    drv.release(st)
    if on_card:
        torch.cuda.empty_cache()

    ref = drv.reference_outputs(ctx, st)
    numbers = drv.compare(prog, ref)
    # the numbers the cell's limits name are compared
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and failed == 0

    if args.trace:
        rec.flops_per_unit, rec.bound_s_per_unit = drv.unit_work(ctx)
        rec.peak_flops = core.peak_flops(ctx.traffic["precision"])
    values = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = core.reader(m["name"])(rec)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not args.trace and on_card:
            fail(f"end-to-end metric {m['name']} has no value")

    _join_threads()
    found = core.forbidden_modules()
    if found:
        fail(f"forbidden modules loaded in the process: {found}")
    # a CPU rehearsal measures no device metric: its readings go apart
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed, "metrics": values if on_card else {},
            "device": device_info(device, cell.chips, peak)}
    if not on_card:
        line["rehearsal"] = values
    if args.trace and on_card:
        line["device"]["busy_s"] = rec.trace.busy_s
        line["device"]["window_s"] = rec.trace.window_s
        line["breakdown"] = rec.trace.breakdown()
    line["build_s"] = build_s
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line


def _join_threads():
    """Waits for the threads the program started (the loader's producer
    ends once its iteration is closed)."""
    for t in threading.enumerate():
        if t is not threading.main_thread() and t.name.startswith("srvp"):
            t.join(timeout=30)
            if t.is_alive():
                fail(f"thread {t.name} still running")


if __name__ == "__main__":
    main()
