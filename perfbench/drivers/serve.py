"""Serving traffic: the port's exported generation program, called by one
client in a closed loop, as a server calls it.

Set-up makes the weights from the seed, exports the serving program with
`srvp_tpu_torch.export.export_serving` (the traffic's precision, a
symbolic batch), writes the artifact under TMPDIR and loads it with
`export.load_serving` (no model code), then makes `warmup_calls` calls.
The artifact holds the weights, so every seed exports anew. Each call of
the window sends `batch` videos of the configuration's conditioning frames
(uint8 on the host, from a pool of `pool_batches` batches made from the
seed) with a seed of its own, and takes the uint8 frames back to the host;
its latency runs from the call to the frames on the host. The window ends
with the first call that ends after `--seconds`.
"""

import math
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import core, weights
from perfbench.count import count_unit, meta_model
from perfbench.yardstick import bounds

KIND = "serve"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def setup(ctx):
    from srvp_tpu_torch import export
    from srvp_tpu_torch.config import SRVPConfig, strict_fp32
    from srvp_tpu_torch.models.srvp import SRVP
    w_seed, call_seed, data_seed, pick_seed = core.sub_seeds(ctx.seed, 4)
    strict_fp32()
    p, tr = ctx.proto, ctx.traffic
    dev = ctx.device
    state = weights.make_state(ctx.model, ctx.config["init"], w_seed, dev)
    with torch.device("meta"):
        model = SRVP(SRVPConfig(**ctx.model))
    model = model.to_empty(device=dev)
    model.load_state_dict(state)
    model.eval()
    blob = export.export_serving(
        SRVPConfig(**ctx.model), model, p["nt_cond"], p["nt_gen"],
        oversampling=p["oversampling"],
        compute_dtype=DTYPES[tr["precision"]])
    del model
    fd, path = tempfile.mkstemp(suffix=".srvptex")
    os.close(fd)
    try:
        export.save_serving(path, blob)
        fn, _ = export.load_serving(path, dev.type)
    finally:
        os.unlink(path)
    g = torch.Generator(device=dev).manual_seed(data_seed)
    n, b = tr["pool_batches"], tr["batch"]
    vids = core.synthetic_frames(n * b, p["nt_cond"], ctx.model["nx"],
                                 ctx.model["nc"], g, dev).cpu().numpy()
    pool = [np.ascontiguousarray(vids[:, i * b:(i + 1) * b])
            for i in range(n)]
    st = SimpleNamespace(fn=fn, pool=pool, state=state,
                         call_seed=call_seed % (2 ** 62),
                         pick_seed=pick_seed, kept={}, ctx=ctx,
                         failed=0)
    for i in range(tr["warmup_calls"]):
        st.fn(pool[i % n], st.call_seed + 10 ** 6 + i).cpu()
    return st


def _call(st, i):
    """Call i of the window: (pool index, seed, frames on the host)."""
    k = i % len(st.pool)
    seed = st.call_seed + i
    return k, seed, st.fn(st.pool[k], seed).cpu().numpy()


def window(st, rec, seconds):
    clock = core.clock
    rng = np.random.default_rng(st.pick_seed)
    # the calls the comparison reads: the first, and one in every
    # `stride` from an offset drawn from the seed
    stride = st.ctx.traffic["check_stride"]
    offset = int(rng.integers(stride))
    lat = []
    t0 = clock()
    i = 0
    while True:
        a = clock()
        try:
            k, seed, frames = _call(st, i)
        except RuntimeError:
            st.failed += 1
            frames = None
        lat.append(clock() - a)
        if frames is not None and (i == 0 or i % stride == offset):
            st.kept[i] = (k, seed, frames)
        i += 1
        if clock() - t0 >= seconds:
            break
    rec.window_s = clock() - t0
    rec.units = i
    rec.latencies_s = lat
    p = st.ctx.proto
    rec.frames = i * st.ctx.traffic["batch"] * p["nt_gen"]


def traced(st, n):
    from torch.profiler import record_function

    def run():
        for i in range(n):
            with record_function("perfbench.call"):
                _call(st, 10 ** 7 + i)
    return run


def program_outputs(st):
    return {i: v for i, v in sorted(st.kept.items())}


def release(st):
    st.fn = None


def reference_outputs(ctx, st, quant=None):
    from perfbench.reference import evaluate
    from perfbench.reference import serve as ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = ctx.proto
    model = evaluate.reference_model(ctx.model, st.state, ctx.device, quant)
    out = {}
    for i, (k, seed, _) in sorted(st.kept.items()):
        x = torch.from_numpy(st.pool[k]).to(ctx.device)
        out[i] = (k, seed, ref.serve(model, x, seed, p["nt_gen"],
                                     p["oversampling"]).cpu().numpy())
    return out


def compare(prog, ref):
    """The numbers compared, worst over the checked calls: the mean
    absolute difference of a video's frames (uint8 levels) and the share
    of its pixels more than 8 levels off."""
    gap = far = 0.0
    for i, (_, _, frames) in prog.items():
        d = np.abs(frames.astype(np.int16) - ref[i][2].astype(np.int16))
        per_video = d.transpose(1, 0, 2, 3, 4).reshape(d.shape[1], -1)
        gap = max(gap, float(per_video.mean(1).max()))
        far = max(far, float((per_video > 8).mean(1).max()))
    if not prog:
        gap = math.inf
    return {"frame_gap": gap, "far_pixels": far}


def unit_work(ctx):
    """(FLOPs of one call, least seconds of the port's kernels in one
    call) from the reference model and the yardstick."""
    cfg, p, tr = ctx.model, ctx.proto, ctx.traffic
    model = meta_model(cfg).eval()
    meta = torch.device("meta")
    b, o = tr["batch"], p["oversampling"]
    nt_pred = p["nt_gen"] - p["nt_cond"]

    def run():
        with torch.no_grad():
            x = torch.empty((p["nt_cond"], b, cfg["nx"], cfg["nx"],
                             cfg["nc"]), device=meta)
            hx, skips = model.encode(x)
            w = model.infer_w(hx)
            hx_z = model.inf_z(hx)
            y0, _ = model.infer_y(hx, torch.empty((b, cfg["ny"]),
                                                  device=meta))
            y_inf = model.rollout(y0, p["nt_cond"], o, torch.empty(
                (o * (p["nt_cond"] - 1), b, cfg["nz"]), device=meta),
                hx_z)[0]
            y_gen = model.rollout(y_inf[-1], nt_pred + 1, o, torch.empty(
                (o * nt_pred, b, cfg["nz"]), device=meta))[0]
            model.decode(w, torch.cat([y_inf, y_gen[1:]]), skips)
    flops, sites = count_unit(model, run)
    pz = [(m.weight, m.bias) for m in model.p_z.module.modules()
          if isinstance(m, torch.nn.Linear)]
    dyn = [(m.weight, m.bias) for m in model.dynamics.module.modules()
           if isinstance(m, torch.nn.Linear)]
    bound_ms = bounds.rollout_bound_ms(pz, dyn, b, o * nt_pred, o,
                                       cfg["ny"], cfg["nz"])[0]
    es = torch.empty((), dtype=DTYPES[tr["precision"]]).element_size()
    for kind, n_in in sites:
        bound_ms += bounds.spatial_bound_ms(f"{kind}_fwd", n_in, es)
    return flops, bound_ms * 1e-3
