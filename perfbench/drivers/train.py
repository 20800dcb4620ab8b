"""Training traffic: the port's optimisation step, closed loop, one step a
batch, as its trainer runs it.

The program is `srvp_tpu_torch.train_lib.train_step` on a train state
built around the benchmark's weights (Adam, the LambdaLR schedule, a
generator on the device for the step's noise) with the trainer's
numerics switches (TF32 off). Batches come from the traffic's `feed`:

- "loader": the trainer's own loader and copy, `train_main.loaders` and
  `train_main.device_batches` (Moving MNIST parts from the native
  generator, `n_workers` threads, composited on the device), seeded by
  the run's seed;
- "resident": `pool_batches` distinct uint8 batches made from the seed on
  the device, cycled, so the data layer is bypassed.

Set-up drives the state through `warmup_steps` steps of the window's own
call and feed; the first three are recorded for the comparison: the
first step's reconstructed frames (the model's forward output inside the
step), each step's loss and its reconstruction and KL_z terms, every
parameter's first gradient as Adam holds it after step 1 (exp_avg /
(1 - b1), kept on the host), and the norm of every parameter's change
after step 3. The window then runs steps until
`--seconds` have passed and closes on reading the last loss.
"""

import math
import statistics
from types import SimpleNamespace

import torch

from perfbench import core, weights
from perfbench.count import count_unit, meta_model
from perfbench.yardstick import bounds

KIND = "train"
RECORDED = 3     # the steps the reference follows
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def hparams(ctx):
    """The reference's hyperparameters (a dict)."""
    h = ctx.config["hparams"]
    return dict(h, oversampling=ctx.proto["oversampling"])


def build(ctx):
    """Builds the port's CUDA kernels and, for the loader's feed, its
    native Moving MNIST generator, or finds them built."""
    core.build_kernels(ctx)
    if ctx.traffic["feed"] == "loader":
        from srvp_tpu_torch.data import native
        native.build()


def _feed(ctx, data_seed):
    """An iterator of device batches, and what to close after."""
    from srvp_tpu_torch import train_main
    proto, traffic = ctx.proto, ctx.traffic
    if traffic["feed"] == "loader":
        data = ctx.config["data"]
        opt = SimpleNamespace(
            dataset=data["dataset"], data_dir=str(ctx.data_dir),
            nx=ctx.model["nx"], seq_len=proto["seq_len"],
            max_speed=data["max_speed"],
            deterministic=data["deterministic"], ndigits=data["ndigits"],
            allow_synthetic=True, seq_len_test=None, steps_per_dispatch=1,
            no_device_compose=False, batch_size=proto["batch"],
            batch_size_test=proto["batch"], seed=data_seed % (2 ** 31 - 1),
            n_workers=traffic["n_workers"])
        train, _ = train_main.loaders(opt)
        gen = train_main.device_batches(train, ctx.device)
        return (batch for _, batch in gen), gen
    g = torch.Generator(device=ctx.device).manual_seed(data_seed)
    n, nt, bsz = traffic["pool_batches"], proto["seq_len"], proto["batch"]
    pool = core.synthetic_frames(n * bsz, nt, ctx.model["nx"],
                                 ctx.model["nc"], g, ctx.device)
    pool = pool.reshape(nt, n, bsz, *pool.shape[2:]).transpose(0, 1)

    def cycle():
        i = 0
        while True:
            yield pool[i % n]
            i += 1
    return cycle(), None


def _clone(batch):
    if isinstance(batch, dict):
        return {k: v.clone() for k, v in batch.items()}
    return batch.clone()


def setup(ctx):
    from srvp_tpu_torch import train_lib
    from srvp_tpu_torch.config import SRVPConfig, strict_fp32
    from srvp_tpu_torch.models.srvp import SRVP
    w_seed, noise_seed, data_seed = core.sub_seeds(ctx.seed, 3)
    strict_fp32()
    dev = ctx.device
    state0 = weights.make_state(ctx.model, ctx.config["init"], w_seed, dev)
    with torch.device("meta"):
        model = SRVP(SRVPConfig(**ctx.model))
    model = model.to_empty(device=dev)
    model.load_state_dict(state0)
    model.train()
    h = ctx.config["hparams"]
    hp = train_lib.TrainHParams(
        oversampling=ctx.proto["oversampling"], obs_scale=h["obs_scale"],
        beta_y=h["beta_y"], beta_z=h["beta_z"], l2_res=h["l2_res"],
        lr=h["lr"], lr_burnin=h["lr_burnin"],
        lr_decay_iter=h["lr_decay_iter"], nt_cond=ctx.proto["nt_cond"],
        compute_dtype=DTYPES[ctx.traffic["precision"]])
    ts = train_lib.make_train_state(model, hp)
    ts.generator = torch.Generator(device=dev).manual_seed(noise_seed)
    feed, closer = _feed(ctx, data_seed)
    st = SimpleNamespace(ts=ts, hp=hp, feed=feed, closer=closer,
                         state0=state0, noise_seed=noise_seed, kept=[],
                         terms=[], grads=None, change=None, last=None,
                         recon=None, nx=ctx.model["nx"])
    params = [p for _, p in model.named_parameters()]
    start = [state0[n] for n, _ in model.named_parameters()]
    beta1 = ts.optimizer.param_groups[0]["betas"][0]
    # the first step's reconstructed frames, as the model's forward
    # returns them inside the step, kept on the host
    hook = model.register_forward_hook(lambda mod, args, out: setattr(
        st, "recon", out.x_.detach().float().cpu()))
    for i in range(max(ctx.traffic["warmup_steps"], RECORDED)):
        batch = next(feed)
        if i < RECORDED:
            st.kept.append(_clone(batch))
        m = train_lib.train_step(ts, batch, hp, generator=ts.generator)
        hook.remove()
        if i < RECORDED:
            st.terms.append((m["loss"], m["nll"], m["kl_z"]))
        if i == 0:
            # a parameter that Adam has not stepped holds no moment
            st.grads = [(ts.optimizer.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p)) / (1 - beta1)).float().cpu()
                for p in params]
        if i == RECORDED - 1:
            with torch.no_grad():
                st.change = torch.stack(torch._foreach_norm(
                    torch._foreach_sub(params, start)))
        st.last = m["loss"]
    float(st.last)
    return st


def window(st, rec, seconds):
    from srvp_tpu_torch import train_lib
    ts, hp = st.ts, st.hp
    clock = core.clock
    n, wait = 0, 0.0
    t0 = clock()
    while True:
        a = clock()
        batch = next(st.feed)
        wait += clock() - a
        m = train_lib.train_step(ts, batch, hp, generator=ts.generator)
        n += 1
        if clock() - t0 >= seconds:
            break
    st.last = m["loss"]
    st.last_value = float(st.last)     # waits for every step queued
    rec.window_s = clock() - t0
    rec.units = n
    rec.frames = n * _frames_per_step(st)
    rec.spans["data_wait"] = wait


def _pixels_per_video(st):
    batch = st.kept[0]
    if isinstance(batch, dict):
        return batch["pos"].shape[2] * st.nx * st.nx
    return batch.shape[0] * batch[0, 0].numel()


def _frames_per_step(st):
    batch = st.kept[0]
    if isinstance(batch, dict):
        return batch["pos"].shape[0] * batch["pos"].shape[2]
    return batch.shape[0] * batch.shape[1]


def traced(st, n):
    """A callable that runs n steps under the harness's spans."""
    from torch.profiler import record_function

    from srvp_tpu_torch import train_lib

    def run():
        for _ in range(n):
            with record_function("perfbench.next_batch"):
                batch = next(st.feed)
            with record_function("perfbench.step"):
                train_lib.train_step(st.ts, batch, st.hp,
                                     generator=st.ts.generator)
    return run


def program_outputs(st):
    losses, nlls, kl_zs = ([float(v) for v in col] for col in zip(*st.terms))
    return {"losses": losses, "nlls": nlls, "kl_zs": kl_zs,
            "recon": st.recon, "grads": st.grads,
            "change": st.change.tolist(),
            "finite": math.isfinite(st.last_value),
            "pixels": _pixels_per_video(st)}


def release(st):
    if st.closer is not None:
        st.closer.close()
    st.ts = st.feed = st.closer = None


def reference_outputs(ctx, st, quant=None):
    from perfbench.reference import train as ref
    out = ref.steps(ctx.model, hparams(ctx), st.state0, st.kept,
                    st.noise_seed, ctx.device, quant)
    names = weights.param_names(ctx.model)
    return {**out, "grads": [out["grads"][k] for k in names],
            "split": [out["split"][k] for k in names],
            "change": [out["change"][k] for k in names], "finite": True,
            "pixels": _pixels_per_video(st)}


def leaf_gaps(prog, ref):
    """Per leaf, over the leaves compared: (index, relative gap of the
    first gradient's norm, 1 - cosine of the first gradients, relative
    gap of the change's norm, the first gradients' distance in units of
    the reference's even-odd split). A norm's gap is taken against the
    larger of the reference's norm of that leaf and the median leaf's;
    the leaves whose reference gradient is under a thousandth of the
    median leaf's (round-off alone moves them under Adam) are left out
    of the others."""
    g_p = [float(g.norm()) for g in prog["grads"]]
    g_r = [float(g.norm()) for g in ref["grads"]]
    g_med = statistics.median(g_r)
    keep = [i for i, g in enumerate(g_r) if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][i] for i in keep)
    rows = []
    for i in range(len(g_r)):
        grad = abs(g_p[i] - g_r[i]) / max(g_r[i], g_med)
        cos = change = rows_gap = None
        if i in keep:
            dot = float((prog["grads"][i].double()
                         * ref["grads"][i].double()).sum())
            # a gradient that is all zeros points nowhere: gap 1
            cos = 1.0 - dot / (g_p[i] * g_r[i]) if g_p[i] > 0 else 1.0
            change = abs(prog["change"][i] - ref["change"][i]) \
                / max(ref["change"][i], c_med)
            split = float(ref["split"][i].norm())
            if split > 0:
                rows_gap = float((prog["grads"][i] - ref["grads"][i])
                                 .norm()) / split
        rows.append((i, grad, cos, change, rows_gap))
    return rows


def compare(prog, ref):
    """The numbers compared: the mean absolute gap of the first step's
    reconstructed frames (in [0, 1]; a sum of no cancelling terms, so
    steady from seed to seed); the worst gap of a step's reconstruction
    term (the NLL, a video's) in nats per pixel of a video (the whole
    loss is not compared: where a seed's prior scale falls near its floor
    one element of the KL term dominates it and magnifies any rounding
    before it); the worst leaf's relative gap of the first gradient's
    norm and of a parameter's change over the three steps (leaf_gaps);
    the median leaf's 1 - cosine between the program's first gradient
    and the reference's; and the median leaf's distance between them in
    units of the reference's own split of that gradient into its even and
    odd videos' parts (grad_rows_gap), which moves with which rows reach
    the loss: a mean over half of the videos lies about one such unit
    from the mean over all, whatever its norm."""
    a, b = prog["recon"].cpu(), ref["recon"].cpu()
    # frames of another shape are no answer to these inputs
    recon_gap = (float((a - b).abs().mean()) if a.shape == b.shape
                 else math.inf)
    nll_gap = max(abs(p - r) for p, r in zip(prog["nlls"], ref["nlls"])) \
        / ref["pixels"]
    rows = leaf_gaps(prog, ref)
    out = {"recon_gap": recon_gap, "nll_gap": nll_gap,
           "grad_gap": max(r[1] for r in rows),
           "grad_cos_gap": statistics.median(
               r[2] for r in rows if r[2] is not None),
           "update_gap": max(r[3] for r in rows if r[3] is not None),
           "grad_rows_gap": statistics.median(
               r[4] for r in rows if r[4] is not None)}
    if not prog["finite"]:
        out = dict.fromkeys(out, math.inf)
    return out


def unit_work(ctx):
    """(FLOPs of one step, least seconds of the port's kernels in one
    step, the MFU's peak) from the reference model and the yardstick."""
    from perfbench.reference.model import elbo, training_draws
    cfg, proto = ctx.model, ctx.proto
    nt, bsz, o = proto["seq_len"], proto["batch"], proto["oversampling"]
    model = meta_model(cfg).train()
    meta = torch.device("meta")

    def run():
        x = torch.empty((nt, bsz, cfg["nx"], cfg["nx"], cfg["nc"]),
                        device=meta)
        draws = training_draws(cfg, nt, bsz, o, None, meta)
        elbo(model, x, hparams(ctx), draws)[0].backward()
    flops, sites = count_unit(model, run)
    pz = [(m.weight, m.bias) for m in model.p_z.module.modules()
          if isinstance(m, torch.nn.Linear)]
    dyn = [(m.weight, m.bias) for m in model.dynamics.module.modules()
           if isinstance(m, torch.nn.Linear)]
    layers = [(model.q_z.weight, model.q_z.bias)] + pz + dyn
    b = bounds.train_rollout_bounds_ms(
        layers, bsz, o * (nt - 1), bounds.stash_width(pz, dyn),
        cfg["nh_inf"], cfg["ny"], cfg["nz"])
    bound_ms = b["fwd"][0] + b["carry"][0] + b["wgrad"][0]
    es = torch.empty((), dtype=DTYPES[ctx.traffic["precision"]]) \
        .element_size()
    for kind, n_in in sites:
        bound_ms += bounds.spatial_bound_ms(f"{kind}_fwd", n_in, es)
        bound_ms += bounds.spatial_bound_ms(f"{kind}_bwd", n_in, es)
    return flops, bound_ms * 1e-3

