"""SRVP training CLI on one GPU or several (counterpart of
srvp_tpu/train_main.py and the repository's train.py).

    python -m srvp_tpu_torch.train_main --dataset smmnist --data_dir DATA \
        --save_path XP --nc 1 --ny 20 --nz 20 --nt_inf 5 --seq_len 15 \
        --nt_cond 5 [--allow_synthetic] [--device cpu] [--resume]

Trains on Stochastic Moving MNIST generated on the fly (digits and
trajectories from the native generator, frames composited on the device;
`--no_device_compose` composites them on the host), on KTH (windows of a
packed video tree, or of its PNG tree through the native PNG decoder,
data/kth.py), on BAIR (30-frame RGB videos, PNG or packed tree,
data/bair.py) or on Human3.6M (RGB videos held in memory, a frame every
`--subsampling`, data/human.py), with the dcgan or vgg encoder and decoder;
the training rollout goes through its CUDA kernels unless `--fused_rollout
off`, and the vgg pools and upsamples always do. Batches are made
`--n_workers` threads wide ahead of the step, and copied to the card one
step ahead. Logs loss, nll, kl_y_0, kl_z, lr and frames/s every
`--log_interval` steps (printed, and appended to XP/metrics.jsonl as
{"step", "wall_s", ...} rows), validates best-of-N prediction PSNR every
`--val_interval` steps (a row of its own; XP/model_best.pt on improvement),
saves XP/model_<step>.pt and the full train state (XP/train_state.pt and
.json: model, Adam, schedule, step, generator) every `--chkpt_interval`
steps from a background thread (keeping the `--keep_chkpt` newest
snapshots), and XP/model.pt and the train state at the end, beside
XP/config.json. `--steps_per_dispatch K` runs K steps a dispatch: on the
K-grid, with a whole window before `--n_iter`, K batches go to the card
in one copy and train as one window (train_lib.WindowStep: on the card
one replay of a CUDA graph of K steps, captured after the first window;
the steps of K = 1, bit for bit); other steps run singly (after an
unaligned resume, and the ragged tail). The graph is freed before a
validation or a single step and captured again at the next window, so
that its memory and eager work's never add up; such a run's CUDA
allocator uses expandable segments (train_lib.expandable_segments). K
must divide the log, validation and checkpoint intervals, whose actions
run between windows; `--profile_dir` forces K = 1. `--resume` continues from XP's train state: the same steps,
losses and weights as a run never stopped, given the same `--seed` (the
data stream is seeded by it) and, on the card, cuDNN's deterministic
algorithms (`torch.backends.cudnn.deterministic`). SIGTERM stops the run at the next step
boundary, saves the train state and exits with 143. `--profile_dir DIR`
writes a torch.profiler trace of steps 10-15 to DIR; it carries the
program's `srvp.*` spans (utils/trace.py) of the main thread beside the
operators and kernels: the data wait and copy, the step's forward,
backward and optimizer. `--config FILE`
(configs/*.yaml) sets the flags' defaults; `--precision bfloat16` (or
`--torch_amp`, `--apex_amp`) runs the encoder and decoder in bfloat16, the
latent model and the loss in float32. The `.pt` model files are float32
state_dicts in the reference key names: `test_main --model_name model.pt`
evaluates them.

Several cards, one process a card (parallel/): `--n_devices N` alone starts
N local ranks (rank r on cuda:r; `--device cuda:K` puts them all on card K
under gloo); under torchrun pass `--coordinator_address auto`; or give each
process `--coordinator_address host:port --num_processes N --process_id r
[--local_rank l]`. `--batch_size` and `--batch_size_test` are the global
batches: each rank trains on its contiguous slice of every batch (the
one-process stream's rows), with the global batch's noise and batch
statistics, and averages its gradients with the others' before Adam, so
the parameters stay equal on every rank. A random seed is rank 0's. Rank 0
alone writes config.json, metrics.jsonl (the loss terms averaged over the
ranks) and the checkpoints; every rank reads the train state on
`--resume`. SIGTERM to any rank stops every rank at the same step boundary
(the ranks agree on it there), all with 143. `--steps_per_dispatch K > 1`
on the cards needs NCCL (its all-reduce is captured in the window's graph);
gloo cannot be captured, so K > 1 raises where the ranks share a card.
`--n_dcn` must stay 1.
"""

import os
import random
import signal
import sys
import time

import torch

from srvp_tpu_torch import train_lib
from srvp_tpu_torch.args import check_ported, compute_dtype, create_args
from srvp_tpu_torch.config import model_config, resolve_device, strict_fp32
from srvp_tpu_torch.data.base import collate_uint8, load_dataset
from srvp_tpu_torch.data.device_compose import (parts_collate, stack_batches,
                                                to_device)
from srvp_tpu_torch.data.loader import (PREFETCH, DataLoader, PartsView,
                                         infinite_batches)
from srvp_tpu_torch.parallel import mesh, multihost
from srvp_tpu_torch.utils import checkpoint as ckpt
from srvp_tpu_torch.utils import trace
from srvp_tpu_torch.utils.runtime import MetricsLogger

PROFILE_STEPS = (10, 15)


def train_hparams(opt):
    return train_lib.TrainHParams(
        oversampling=opt.n_euler_steps, obs_scale=opt.obs_scale,
        beta_y=opt.beta_y, beta_z=opt.beta_z, l2_res=opt.l2_res, lr=opt.lr,
        lr_burnin=opt.lr_scheduling_burnin,
        lr_decay_iter=opt.lr_scheduling_n_iter, nt_cond=opt.nt_cond,
        n_samples_test=opt.n_samples_test,
        val_samples_chunk=opt.val_samples_chunk,
        compute_dtype=compute_dtype(opt),
        use_kernel=opt.fused_rollout != "off")


def loaders(opt, rank=0, ranks=1):
    """(train, val) loaders of the dataset's folds for rank `rank` of
    `ranks` (each feeds the rank's slice of every global batch), validation at
    seq_len_test (Human3.6M: frames of the same stride, so a validation
    video spans (seq_len_test - 1) * subsampling + 1 frames), each
    `opt.n_workers` threads wide. Moving MNIST training batches are digits
    and trajectories (composited on the device) unless
    `opt.no_device_compose`; the others are whole uint8 frames, (T, B, H,
    W, nc). The training loader makes two dispatches' batches ahead (at
    least PREFETCH), so that a window of --steps_per_dispatch batches is
    ready when the trainer takes it."""
    dataset = load_dataset(opt)
    trainset, valset = dataset.get_fold("train"), dataset.get_fold("val")
    if opt.seq_len_test is not None:
        valset.change_seq_len(opt.seq_len_test)
    prefetch = max(PREFETCH, 2 * (opt.steps_per_dispatch or 1))
    if opt.dataset == "smmnist" and not opt.no_device_compose:
        trainset, collate = PartsView(trainset), parts_collate
    else:
        collate = collate_uint8
    shard = dict(shard_rank=rank, shard_count=ranks)
    train = DataLoader(trainset, opt.batch_size, seed=opt.seed,
                       collate_fn=collate, num_workers=opt.n_workers,
                       prefetch=prefetch, **shard)
    val = DataLoader(valset, opt.batch_size_test, seed=opt.seed + 1,
                     collate_fn=collate_uint8, num_workers=opt.n_workers,
                     **shard)
    return train, val


def device_batches(loader, device, spd=1, start=0, n_iter=None):
    """(width, batch) pairs of the loader's batches, cycled, on `device`,
    for a run at step `start` (srvp_tpu/train_main.py:199): with spd > 1,
    at a step on the spd-grid with a whole window before n_iter, spd
    batches stacked (stack_batches) and sent in one copy, width spd;
    otherwise one batch, width 1. The next item's copy is queued before
    this one is handed out, so the host never waits for a transfer. The
    stacking, pinning and the copy's enqueue are a `srvp.data.to_device`
    span (utils/trace.py)."""
    it = infinite_batches(loader)

    def fetch(i):
        width = spd if spd > 1 and i % spd == 0 and i + spd <= n_iter else 1
        host = [next(it) for _ in range(width)]
        with trace.span("srvp.data.to_device"):
            batch = stack_batches(host) if width > 1 else host[0]
            return width, to_device(batch, device)

    i = start
    nxt = fetch(i)
    while True:
        cur = nxt
        i += cur[0]
        nxt = fetch(i)
        yield cur


def dispatch_width(opt):
    """The steps a window (--steps_per_dispatch), checked as the JAX
    trainer checks it (srvp_tpu/train_main.py:169-180)."""
    spd = opt.steps_per_dispatch or 1
    if spd > 1 and opt.profile_dir:
        print("steps_per_dispatch forced to 1: --profile_dir traces "
              "individual steps", flush=True)
        spd = 1
    if spd > 1:
        for nm in ("log_interval", "val_interval", "chkpt_interval"):
            iv = getattr(opt, nm)
            if iv and iv % spd:
                raise ValueError(
                    f"--steps_per_dispatch {spd} must divide --{nm} {iv} "
                    f"(boundary actions fire between dispatch windows)")
    return spd


def start_profile(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof, profile_dir):
    """Stops `prof` and writes its Chrome trace into profile_dir; returns
    the trace's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace_steps_%d-%d.json" % PROFILE_STEPS)
    prof.export_chrome_trace(path)
    print(f"Profiler trace written to {path}", flush=True)
    return path


def main(opt):
    """Trains; returns the exit status: 0, or 143 when SIGTERM stopped the
    run (after saving its train state), or 130 after a KeyboardInterrupt.
    With `--n_devices N` and no coordinator, starts the N local ranks and
    returns their common status."""
    check_ported(opt)
    n = opt.n_devices or 1
    if n > 1 and not opt.coordinator_address:
        return mesh.spawn(main, n, opt)
    spd = dispatch_width(opt)
    device = resolve_device(multihost.rank_device(opt))
    with multihost.process_group(opt, device) as backend:
        if spd > 1 and device.type == "cuda" and backend == "gloo":
            raise ValueError(
                f"--steps_per_dispatch {spd} on a card needs NCCL: a window "
                "is one CUDA graph, and gloo's collectives (ranks sharing "
                "one card) cannot be captured in it")
        return train(opt, device, spd)


def train(opt, device, spd):
    """main's run on this rank, in its process group (if any)."""
    primary = multihost.is_primary()
    say = print if primary else (lambda *a, **k: None)
    if opt.seed is None:
        opt.seed = random.randint(1, 10000)
    # a seed drawn at random differs per rank, and the parameters are made
    # from it, not broadcast
    opt.seed = multihost.broadcast_seed(opt.seed)
    strict_fp32()
    ranks = multihost.process_count()
    say(f"Learning on {device} (seed: {opt.seed}, compute dtype "
        f"{str(compute_dtype(opt)).split('.')[-1]})"
        + (f" [{ranks} ranks]" if ranks > 1 else ""), flush=True)

    say("Loading data...", flush=True)
    train_loader, val_loader = loaders(opt, multihost.process_index(), ranks)
    for loader in (train_loader, val_loader):
        multihost.validate_loader_slices(loader)

    say("Building model...", flush=True)
    cfg = model_config(vars(opt))
    hp = train_hparams(opt)
    opt.n_iter = opt.n_iter or (opt.lr_scheduling_burnin
                                + opt.lr_scheduling_n_iter)
    torch.manual_seed(opt.seed)
    if spd > 1 and device.type == "cuda":
        train_lib.expandable_segments()
    ts = train_lib.init_train_state(cfg, hp, device, res_gain=opt.res_gain)
    ts.generator = torch.Generator(device=device).manual_seed(opt.seed)
    resumed_step = best_val_metric = None
    if opt.resume and ckpt.has_train_state(opt.save_path):
        state, meta = ckpt.load_train_state(opt.save_path)
        train_lib.load_state_dict(ts, state)
        resumed_step = ts.step
        # without it, a worse first validation would overwrite
        # model_best.pt
        best_val_metric = meta.get("best_val_metric")
        train_loader.fast_forward(resumed_step)
        say(f"Resumed from step {resumed_step}", flush=True)
    eval_batch = train_lib.make_eval_batch(
        cfg, hp, nt=opt.seq_len_test or opt.seq_len)
    mlog = writer = None
    if primary:
        os.makedirs(opt.save_path, exist_ok=True)
        ckpt.remove_stale_tmp(opt.save_path)
        ckpt.save_config(opt.save_path, vars(opt))
        mlog = MetricsLogger(os.path.join(opt.save_path, "metrics.jsonl"),
                             truncate_after=resumed_step)
        writer = ckpt.AsyncCheckpointer()

    itr = ts.step
    val_metric = prof = None
    status = 0
    frames_per_batch = opt.seq_len * opt.batch_size
    t_last, itr_last = time.perf_counter(), itr
    # the ranks agree on the stop at each step (or window) boundary
    # (multihost.agree_stop): a rank that stopped alone would leave the
    # others waiting in a collective
    stop_requested = []
    prev_handler = signal.signal(
        signal.SIGTERM, lambda *_: stop_requested.append(True))
    # the writer's copy stream must be idle while a graph is captured
    window = (train_lib.WindowStep(
        ts, hp, spd, before_capture=writer.wait if writer else None)
        if spd > 1 else None)
    try:
        for width, batch in device_batches(train_loader, device, spd, itr,
                                           opt.n_iter):
            if itr >= opt.n_iter or multihost.agree_stop(stop_requested):
                break
            itr += width
            if opt.profile_dir and itr == PROFILE_STEPS[0]:
                prof = start_profile(device)
            if width > 1:
                metrics = window(batch)
            else:
                if window is not None:
                    window.release()   # the ragged tail
                metrics = train_lib.train_step(ts, batch, hp,
                                               generator=ts.generator)
            if prof is not None and itr == PROFILE_STEPS[1]:
                stop_profile(prof, opt.profile_dir)
                prof = None

            if itr % opt.log_interval == 0:
                # the global batch's loss terms; synchronises
                m = {k: float(v)
                     for k, v in mesh.reduce_metrics(metrics).items()}
                now = time.perf_counter()
                fps = frames_per_batch * (itr - itr_last) / (now - t_last)
                t_last, itr_last = now, itr
                say(f"[{itr}/{opt.n_iter}] loss={m['loss']:.4f} "
                    f"nll={m['nll']:.4f} kl_y_0={m['kl_y_0']:.4f} "
                    f"kl_z={m['kl_z']:.4f} lr={m['lr']:.2e} "
                    f"fps={fps:.0f} val={val_metric} "
                    f"best={best_val_metric}", flush=True)
                if mlog:
                    mlog.log(itr, fps=fps, **m)

            if itr % opt.val_interval == 0:
                if window is not None:
                    window.release()
                val_gen = torch.Generator(device=device).manual_seed(
                    opt.seed + 123 + itr)
                # the same metric on every rank, so the same decision
                val_metric = train_lib.evaluate(
                    eval_batch, ts.model, iter(val_loader), opt.n_iter_test,
                    val_gen, device)
                say(f"[{itr}] val_metric (-PSNR): {val_metric:.4f}",
                    flush=True)
                if mlog:
                    mlog.log(itr, val_metric=val_metric)
                if best_val_metric is None or val_metric < best_val_metric:
                    best_val_metric = val_metric
                    if writer:
                        snap = ckpt.Snapshot(ts.model.state_dict())
                        writer.submit(lambda s=snap: ckpt.save_model(
                            opt.save_path, "model_best", s.host()))
                t_last = time.perf_counter()

            if writer and opt.chkpt_interval \
                    and itr % opt.chkpt_interval == 0:
                snap = ckpt.Snapshot(train_lib.state_dict(ts))

                def save_periodic(s=snap, i=itr, best=best_val_metric):
                    state = s.host()
                    ckpt.save_model(opt.save_path, f"model_{i}",
                                    state["model"])
                    ckpt.save_train_state(opt.save_path, state,
                                          extra={"best_val_metric": best})
                    # after the new snapshot landed: it is never pruned
                    ckpt.prune_periodic(opt.save_path, opt.keep_chkpt)
                writer.submit(save_periodic)
    except KeyboardInterrupt:
        status = 130
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        if mlog:
            mlog.close()
        if prof is not None:
            stop_profile(prof, opt.profile_dir)
    # once more after the loop (on every rank, however it ended): a SIGTERM
    # during the last step stops too
    if status != 130 and multihost.agree_stop(stop_requested):
        say("SIGTERM received: checkpointing and exiting", flush=True)
        status = 143

    if writer:
        print("Saving...", flush=True)
        writer.wait()   # an earlier save must not land after this one
        ckpt.save_model(opt.save_path, "model", ts.model.state_dict())
        ckpt.save_train_state(opt.save_path, train_lib.state_dict(ts),
                              extra={"best_val_metric": best_val_metric})
    say("Done", flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main(create_args().parse_args()))
