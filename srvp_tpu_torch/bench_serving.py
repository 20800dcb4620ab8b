"""Serving benchmark: latency and throughput of the exported artifact
(export.py) on one GPU (counterpart of scripts/bench_serving.py).

Times the deployed inference path as a server runs it: each configuration
is exported once at its full width with seeded random weights (bf16 on the
card, fp32 on the CPU, as the JAX script exports bf16 on its accelerator),
loaded with `export.load_serving` (no model code), fed uint8 conditioning
frames from the host, and timed at each request batch:

  * first_call_s: the first call at that batch;
  * device latency: from the call to the end of the device's work
    (torch.cuda.synchronize), the frames' copy to the card included;
  * end-to-end latency: the device latency and the uint8 frames' copy back
    to the host;
  * p50 / p95 of both over --iters calls, and frames/s (nt_gen * batch /
    p50) of both.

    python -m srvp_tpu_torch.bench_serving [--configs smmnist-dcgan kth-vgg]
        [--batches 1 16 128] [--iters 20] [--nt_gen N] [--out PATH]
        [--device cuda|cpu] [--tiny]

The horizons are the reference test protocol's: 25 frames at smmnist, 30
at kth. Prints one JSON line with the card's name and power limit (as
nvidia-smi gives them). Without CUDA it raises unless --device cpu;
--tiny uses bench.py's TINY widths (a test on the CPU).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from srvp_tpu_torch import bench
from srvp_tpu_torch import export as ex
from srvp_tpu_torch.config import SRVPConfig, resolve_device, strict_fp32
from srvp_tpu_torch.kernels.peaks import nvidia_smi_line
from srvp_tpu_torch.models.srvp import SRVP


def percentile_ms(seconds, q):
    return 1e3 * float(np.percentile(seconds, q))


def bench_one(name, batches, iters, device, nt_gen=None, tiny=False,
              work_dir=None):
    """Exports, loads and times one configuration; returns its record."""
    c = bench.config(name, tiny)
    cfg = SRVPConfig(**c["kwargs"])
    torch.manual_seed(0)
    model = SRVP(cfg).to(device).eval()
    nt_cond = c["nt_cond"]
    # the reference test protocol's horizons: smmnist 25 total frames,
    # kth 30
    nt_gen = nt_gen or (25 if name.startswith("smmnist") else 30)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    t0 = time.perf_counter()
    blob = ex.export_serving(cfg, model, nt_cond, nt_gen,
                             oversampling=c["oversampling"],
                             compute_dtype=dtype)
    export_s = time.perf_counter() - t0
    del model
    path = os.path.join(work_dir, f"bench_serving_{name}.srvptex")
    ex.save_serving(path, blob)
    t0 = time.perf_counter()
    fn, header = ex.load_serving(path, device.type)
    load_s = time.perf_counter() - t0

    out = {"artifact_bytes": len(blob), "export_s": export_s,
           "load_s": load_s, "compute_dtype": ex.dtype_name(dtype)}
    out.update(time_artifact(fn, header, batches, iters, device, name))
    return out


def time_artifact(fn, header, batches, iters, device, name="artifact"):
    """Times a loaded artifact (load_serving's fn and header) at each batch
    on random uint8 frames from the host (module docstring). Returns
    {"nt_cond", "nt_gen", "batches": {batch: its record}}."""
    nt_cond, nt_gen = header["nt_cond"], header["nt_gen"]
    nx, nc = header["nx"], header["nc"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {"nt_cond": nt_cond, "nt_gen": nt_gen, "batches": {}}
    rng = np.random.RandomState(0)
    for b in batches:
        x = rng.randint(0, 256, size=(nt_cond, b, nx, nx, nc),
                        dtype=np.uint8)
        t0 = time.perf_counter()
        y = fn(x, 0).cpu().numpy()
        first_s = time.perf_counter() - t0
        if y.shape != (nt_gen, b, nx, nx, nc):
            raise RuntimeError(f"{name}: frames {y.shape} at batch {b}")
        for w in range(2):
            fn(x, w + 1).cpu()
        lat_dev, lat = [], []
        for i in range(iters):
            t0 = time.perf_counter()
            y = fn(x, i)
            sync()
            t1 = time.perf_counter()
            y.cpu().numpy()
            t2 = time.perf_counter()
            lat_dev.append(t1 - t0)
            lat.append(t2 - t0)
        p50, p50_dev = np.median(lat), np.median(lat_dev)
        out["batches"][str(b)] = {
            "latency_p50_ms": percentile_ms(lat, 50),
            "latency_p95_ms": percentile_ms(lat, 95),
            "device_latency_p50_ms": percentile_ms(lat_dev, 50),
            "device_latency_p95_ms": percentile_ms(lat_dev, 95),
            "frames_per_sec": nt_gen * b / float(p50),
            "device_frames_per_sec": nt_gen * b / float(p50_dev),
            "first_call_s": first_s,
        }
        print(f"{name} batch {b}: {out['batches'][str(b)]}",
              file=sys.stderr, flush=True)
    return out


def create_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--configs", nargs="+",
                   default=["smmnist-dcgan", "kth-vgg"])
    p.add_argument("--batches", nargs="+", type=int, default=[1, 16, 128])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--nt_gen", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--tiny", action="store_true",
                   help="bench.py's TINY widths (a test on the CPU)")
    return p


def main(argv=None):
    a = create_args().parse_args(argv)
    device = resolve_device(a.device)
    strict_fp32()
    on_card = device.type == "cuda"
    record = {"metric": "serving", "backend": device.type,
              "device_kind": (torch.cuda.get_device_name(device) if on_card
                              else "cpu"),
              "nvidia_smi": nvidia_smi_line() if on_card else None,
              "torch": torch.__version__, "iters": a.iters, "configs": {}}
    with tempfile.TemporaryDirectory() as work_dir:
        for name in a.configs:
            record["configs"][name] = bench_one(
                name, a.batches, a.iters, device, nt_gen=a.nt_gen,
                tiny=a.tiny, work_dir=work_dir)
    line = json.dumps(record)
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return record


if __name__ == "__main__":
    main()
