"""Evaluation traffic: the port's best-of-N evaluation, whole batches, as
its evaluation CLI runs it.

The program is `srvp_tpu_torch.eval_lib.run_test` on the live model (the
benchmark's weights, eval mode) under `config.cudnn_deterministic`, TF32
off: `videos` videos a batch, `samples` samples in chunks of `chunk`, the
configuration's conditioning and predicted frames, PSNR and SSIM. The
test videos are `pool_batches` batches made from the seed (cycled), the
sampling generator is seeded from the seed. Set-up runs one chunk of one
batch, which meets every shape of the window. The window is one run_test
call over batches handed out until `--seconds` have passed: it closes at
the end of the first batch that ends after them.
"""

import math
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import core, weights
from perfbench.count import count_unit, meta_model
from perfbench.yardstick import bounds

KIND = "eval"


def _model(ctx, state):
    from srvp_tpu_torch.config import SRVPConfig
    from srvp_tpu_torch.models.srvp import SRVP
    with torch.device("meta"):
        model = SRVP(SRVPConfig(**ctx.model))
    model = model.to_empty(device=ctx.device)
    model.load_state_dict(state)
    return model.eval()


def setup(ctx):
    from srvp_tpu_torch.config import strict_fp32
    w_seed, sample_seed, data_seed, pick_seed = core.sub_seeds(ctx.seed, 4)
    strict_fp32()
    p, tr = ctx.proto, ctx.traffic
    state = weights.make_state(ctx.model, ctx.config["init"], w_seed,
                               ctx.device)
    g = torch.Generator(device=ctx.device).manual_seed(data_seed)
    n, v = tr["pool_batches"], tr["videos"]
    vids = core.synthetic_frames(n * v, p["nt_gen"], ctx.model["nx"],
                                 ctx.model["nc"], g, ctx.device)
    pool = (vids.float() / 255.0).cpu().numpy()
    pool = [np.ascontiguousarray(pool[:, i * v:(i + 1) * v])
            for i in range(n)]
    st = SimpleNamespace(state=state, pool=pool, sample_seed=sample_seed,
                         pick_seed=pick_seed, model=_model(ctx, state),
                         ctx=ctx, out=None, handed=0)
    _run(st, [pool[0]], ctx.traffic["chunk"],
         torch.Generator(device=ctx.device).manual_seed(sample_seed + 1))
    return st


def _run(st, batches, n_samples, generator):
    from srvp_tpu_torch import eval_lib
    from srvp_tpu_torch.config import cudnn_deterministic
    p, tr = st.ctx.proto, st.ctx.traffic
    with cudnn_deterministic():
        return eval_lib.run_test(
            st.model, batches, p["nt_cond"], p["nt_gen"], n_samples,
            tr["chunk"], generator, p["oversampling"], p["oversampling"],
            pad_to=tr["videos"])


def window(st, rec, seconds):
    clock = core.clock
    gen = torch.Generator(device=st.ctx.device).manual_seed(st.sample_seed)

    def batches():
        i = 0
        while i == 0 or clock() - t0 < seconds:
            yield st.pool[i % len(st.pool)]
            i += 1
            st.handed = i
    t0 = clock()
    st.out = _run(st, batches(), st.ctx.traffic["samples"], gen)
    rec.window_s = clock() - t0
    rec.units = st.handed
    p, tr = st.ctx.proto, st.ctx.traffic
    rec.frames = st.handed * tr["videos"] * tr["samples"] * (
        p["nt_gen"] - p["nt_cond"])


def traced(st, n):
    from torch.profiler import record_function
    gen = torch.Generator(device=st.ctx.device).manual_seed(
        st.sample_seed + 2)

    def run():
        with record_function("perfbench.batches"):
            _run(st, st.pool[:n], st.ctx.traffic["samples"], gen)
    return run


def checked_batches(st):
    """The window's batches the comparison reads: `checked_batches` of
    them drawn from the seed."""
    k = min(st.ctx.traffic["checked_batches"], st.handed)
    rng = np.random.default_rng(st.pick_seed)
    return sorted(rng.choice(st.handed, size=k, replace=False).tolist())


def program_outputs(st):
    results, samples = st.out[0], st.out[1]
    v = st.ctx.traffic["videos"]
    out = []
    for b in checked_batches(st):
        sl = slice(b * v, (b + 1) * v)
        out.append({"batch": b, "psnr": results["psnr"][sl],
                    "ssim": results["ssim"][sl],
                    "random_1": samples["random_1"][sl]})
    return out


def release(st):
    st.model = st.out = None


def reference_outputs(ctx, st, quant=None):
    """The reference's answers for the checked batches, on the window's
    noise: the generator is replayed through every chunk of the batches
    before."""
    from perfbench.reference import evaluate as ref
    torch.backends.cuda.matmul.allow_tf32 = quant == "tf32"
    torch.backends.cudnn.allow_tf32 = quant == "tf32"
    p, tr = ctx.proto, ctx.traffic
    model = ref.reference_model(ctx.model, st.state, ctx.device,
                                None if quant == "tf32" else quant)
    gen = torch.Generator(device=ctx.device).manual_seed(st.sample_seed)
    o = p["oversampling"]
    n_chunks = tr["samples"] // tr["chunk"]
    picks = checked_batches(st)
    out = []
    for b in range(max(picks) + 1):
        noises = [ref.chunk_noise(ctx.model, tr["videos"], tr["chunk"],
                                  p["nt_cond"], p["nt_gen"], o, o, gen,
                                  ctx.device) for _ in range(n_chunks)]
        if b not in picks:
            continue
        x = torch.from_numpy(st.pool[b % len(st.pool)]).to(ctx.device)
        r = ref.best_of_n(model, x, p["nt_cond"], tr["chunk"], o, o, noises)
        out.append(dict(r, batch=b))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return out


def compare(prog, ref):
    """The numbers compared, worst over the checked videos: the gap of the
    best PSNR (dB) and of the best SSIM, and the mean absolute difference
    of sample 0's predicted frames (uint8 levels) of a video."""
    psnr = ssim = frames = 0.0
    for p, r in zip(prog, ref):
        psnr = max(psnr, float(np.max(np.abs(p["psnr"] - r["psnr"]))))
        ssim = max(ssim, float(np.max(np.abs(p["ssim"] - r["ssim"]))))
        d = np.abs(p["random_1"].astype(np.float64)
                   - r["random_1"].astype(np.float64))
        frames = max(frames, float(d.reshape(d.shape[0], -1).mean(1).max()))
    if not all(np.isfinite(p["psnr"]).all() for p in prog):
        psnr = math.inf
    return {"psnr_gap_db": psnr, "ssim_gap": ssim, "frame_gap": frames}


def unit_work(ctx):
    """(FLOPs of one batch, least seconds of the port's kernels in one
    batch) from the reference model and the yardstick."""
    from perfbench.reference import evaluate as ref
    cfg, p, tr = ctx.model, ctx.proto, ctx.traffic
    model = meta_model(cfg).eval()
    meta = torch.device("meta")
    v, s, o = tr["videos"], tr["chunk"], p["oversampling"]
    t_pred = p["nt_gen"] - p["nt_cond"]

    x = torch.empty((p["nt_gen"], v, cfg["nx"], cfg["nx"], cfg["nc"]),
                    device=meta)
    _, skips = model.encode(x[:p["nt_cond"]])
    eps = (torch.empty((v * s, cfg["ny"]), device=meta),
           torch.empty((o * (p["nt_cond"] - 1), v * s, cfg["nz"]),
                       device=meta),
           torch.empty((o * t_pred, v * s, cfg["nz"]), device=meta))

    def run():
        with torch.no_grad():
            pred = ref.sample_chunk(model, x[:p["nt_cond"]], t_pred, o, o,
                                    eps, s)
            # the conditioning frames' reconstruction of sample 0
            model.decode(torch.empty((v, cfg["nh_inf"]), device=meta),
                         torch.empty((p["nt_cond"], v, cfg["ny"]),
                                     device=meta), skips)
            tgt = x[p["nt_cond"]:].repeat_interleave(s, 1)
            ref.psnr(pred, tgt)
            ref.ssim(pred, tgt)
    flops, sites = count_unit(model, run)
    n_chunks = tr["samples"] // tr["chunk"]
    pz = [(m.weight, m.bias) for m in model.p_z.module.modules()
          if isinstance(m, torch.nn.Linear)]
    dyn = [(m.weight, m.bias) for m in model.dynamics.module.modules()
           if isinstance(m, torch.nn.Linear)]
    bound_ms = bounds.rollout_bound_ms(pz, dyn, v * s, o * t_pred, o,
                                       cfg["ny"], cfg["nz"])[0]
    for kind, n_in in sites:
        bound_ms += bounds.spatial_bound_ms(f"{kind}_fwd", n_in, 4)
    return flops * n_chunks, bound_ms * 1e-3 * n_chunks
