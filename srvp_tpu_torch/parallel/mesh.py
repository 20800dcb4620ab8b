"""Data parallelism over the ranks (counterpart of the parts of
srvp_tpu/parallel/mesh.py that carry a meaning on GPUs).

The JAX package shards the video batch over a device mesh, and GSPMD
reduces the gradients and makes the batch statistics global. In the port
each rank holds the whole model and its slice of the batch
(parallel/multihost.py): `all_reduce_grads` averages the parameters'
gradients between backward and the optimizer, so that Adam takes the same
step on every rank and the parameters stay equal, and models/layers.py's
batch norm reduces its sums over the ranks. There is no DDP wrapper: it
would prefix every state_dict key with `module.`, and the `.pt` files keep
the reference's names (utils/weights.py).

`--n_dcn` (the JAX package's 2-D mesh for multi-slice TPU pods, mesh.py:28-50)
has no counterpart: NCCL picks its own algorithms within and across nodes,
so there is no second mesh axis to build. `check_dcn` refuses it.
"""

import argparse
import ctypes
import multiprocessing
import os
import shutil
import signal
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from srvp_tpu_torch.parallel import multihost

# exit status of a rank stopped by SIGTERM (train_main)
STOPPED = 143


def check_dcn(n_dcn):
    """Raises for a 2-D (dcn, data) mesh: NCCL has no such axis to give."""
    if n_dcn != 1:
        raise ValueError(
            f"--n_dcn {n_dcn}: the port has no 2-D mesh. NCCL picks its own "
            "algorithms within and across nodes, so there is no dcn axis to "
            "build: give every card a rank (--n_devices, or one process per "
            "card under torchrun) and leave --n_dcn at 1")


def pad_to_multiple(batch, n, batch_axis=1):
    """Pads the batch axis up to a multiple of n by repeating the last
    element; returns (padded, n_valid).

    A ragged final test batch then still divides over the ranks. Callers
    slice their per-example outputs back to `n_valid`. Dense video batches
    carry batch on `batch_axis`; parts dicts carry it on axis 0 of every
    leaf."""
    def pad_arr(v, ax):
        b = v.shape[ax]
        r = (-b) % n
        if r == 0:
            return v, b
        v = np.asarray(v)
        idx = [slice(None)] * v.ndim
        idx[ax] = slice(b - 1, b)
        return np.concatenate(
            [v, np.repeat(v[tuple(idx)], r, axis=ax)], axis=ax), b
    if isinstance(batch, dict):
        if not batch:
            raise ValueError("pad_to_multiple: empty parts dict")
        sizes = {k: v.shape[0] for k, v in batch.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(
                f"pad_to_multiple: parts dict leaves disagree on batch "
                f"size: {sizes}")
        out, n_valid = {}, None
        for k, v in batch.items():  # parts dicts: batch is axis 0 by contract
            out[k], n_valid = pad_arr(v, 0)
        return out, n_valid
    return pad_arr(batch, batch_axis)


def all_reduce_grads(model):
    """Averages the gradients of `model`'s parameters over the ranks, in
    place: one flat buffer in the parameters' order, summed by one
    all-reduce and divided by the rank count. Nothing happens outside a
    process group; in one of a single rank the buffer goes through the
    collective unchanged (the sum of one rank, divided by 1). On the cards
    the NCCL all-reduce runs on the current stream's order, so that a CUDA
    graph captures it (train_lib.WindowStep)."""
    if not dist.is_initialized():
        return
    grads = [p.grad for p in model.parameters()]
    if any(g is None for g in grads):
        raise ValueError("all_reduce_grads: a parameter has no gradient")
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def reduce_metrics(metrics):
    """`metrics` with each tensor replaced by its mean over the ranks (the
    global batch's loss terms: each rank's are means over its equal share);
    other values as they are."""
    if multihost.process_count() == 1:
        return metrics
    names = [k for k, v in metrics.items() if torch.is_tensor(v)]
    buf = torch.stack([metrics[k].float().reshape(()) for k in names])
    dist.all_reduce(buf)
    buf.div_(multihost.process_count())
    return {**metrics, **dict(zip(names, buf.unbind()))}


def _die_with_parent():
    """Linux: SIGKILL this process when the process that spawned it dies,
    so that a rank never outlives a launcher killed at its time limit."""
    if sys.platform.startswith("linux"):
        pr_set_pdeathsig = 1
        ctypes.CDLL(None, use_errno=True).prctl(pr_set_pdeathsig,
                                                signal.SIGKILL)


def _rank_entry(fn, opt, threads):
    _die_with_parent()
    torch.set_num_threads(threads)
    sys.exit(fn(opt))


def spawn(fn, n, opt):
    """Runs fn(rank_opt) in n local processes (the `spawn` start method)
    and returns their common exit status: the local ranks of `--n_devices
    n` on one host without a launcher, as the JAX CLIs' --n_devices takes n
    local devices. rank_opt is `opt` with the flags of rank r of a group of
    n (--coordinator_address: a rendezvous file in a temporary directory of
    its own, --num_processes n, --process_id r, --local_rank r); fn must
    be a module-level function that returns the rank's exit status. Each
    rank takes this process's intra-op thread count. SIGTERM to this
    process goes on to every rank. A rank that fails (an exit status other
    than 0 and STOPPED) kills the others, and then, as when the ranks end
    with different statuses, this raises."""
    ctx = multiprocessing.get_context("spawn")
    rdv = tempfile.mkdtemp(prefix="srvp_rendezvous_")
    init = "file://" + os.path.join(rdv, "store")
    procs = [ctx.Process(target=_rank_entry, name=f"srvp-rank-{r}", args=(
        fn, argparse.Namespace(**{
            **vars(opt), "coordinator_address": init, "num_processes": n,
            "process_id": r, "local_rank": r}), torch.get_num_threads()))
        for r in range(n)]
    forward = threading.current_thread() is threading.main_thread()
    if forward:
        prev = signal.signal(signal.SIGTERM, lambda *_: [
            p.terminate() for p in procs if p.exitcode is None])
    failed = None
    try:
        for p in procs:
            p.start()
        while failed is None and any(p.exitcode is None for p in procs):
            time.sleep(0.05)
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0, STOPPED)), None)
    finally:
        for p in procs:
            if p.pid is None:     # never started
                continue
            if p.exitcode is None:
                p.kill()
            p.join()
        if forward:
            signal.signal(signal.SIGTERM, prev)
        shutil.rmtree(rdv, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if failed is not None:
        raise RuntimeError(f"rank {failed} of {n} exited with status "
                           f"{codes[failed]}; the other ranks were killed "
                           f"(statuses {codes})")
    if len(set(codes)) != 1:
        raise RuntimeError(f"the {n} ranks ended with statuses {codes}")
    return codes[0]
