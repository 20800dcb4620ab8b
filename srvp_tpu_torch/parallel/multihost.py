"""Several processes, one a card (counterpart of
srvp_tpu/parallel/multihost.py).

The JAX package joins one process per host into one SPMD mesh. The port
runs one process per card, as the reference SRVP did (its train.py:214-219,
309-316): `torch.distributed` with NCCL between cards, and
gloo on the CPU or where the ranks share one card (NCCL refuses two ranks
on one device). On the cards the default group is "cpu:gloo,cuda:nccl": a
collective on a CUDA tensor goes through NCCL, one on a host tensor (the
seed, the stop flag, the validation metric, a gathered object) through
gloo, so that the host's small collectives never wait behind the device's
queue.

What each rank must do:
  (a) feed its contiguous slice of every global batch (`local_batch_slice`;
      data/loader.DataLoader's shard_rank and shard_count), and
  (b) leave the writes to rank 0 (`is_primary`).
The loader's item seeds depend only on (seed, epoch, position), so the
ranks' slices concatenate bit for bit to a one-process run's batch.

The rest of a rank's work is in parallel/mesh.py (gradients, metrics, the
local ranks of `--n_devices`), models/layers.py (batch statistics over the
ranks), train_lib.py (the global batch's noise) and eval_lib.py (the
evaluation's videos over the ranks).
"""

import contextlib
import os

import torch
import torch.distributed as dist

# what `--coordinator_address auto` reads: the environment of torchrun (or
# any launcher that sets the same names)
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def local_rank(opt):
    """The rank's card on its host: LOCAL_RANK under `--coordinator_address
    auto`, else `--local_rank` (the reference's meaning of the flag)."""
    if getattr(opt, "coordinator_address", None) == "auto":
        return int(os.environ.get("LOCAL_RANK", 0))
    return getattr(opt, "local_rank", 0) or 0


def rank_device(opt):
    """The rank's torch device, not checked for existence: `--device cuda`
    is the card of the local rank (cuda:<local rank>, or the current card
    at local rank 0); a device with an index is that device on every
    rank."""
    dev = torch.device(opt.device)
    rank = local_rank(opt)
    if dev.type == "cuda" and dev.index is None and rank:
        dev = torch.device("cuda", rank)
    return dev


def initialize_from_opt(opt, device):
    """Joins the process group that the flags ask for; returns its backend,
    or None for a run of one process without a group.

    `--coordinator_address host:port` (or an init method URL such as
    file:///path) with `--num_processes N --process_id r`:
    init_process_group(init_method="tcp://host:port", world_size=N,
    rank=r). `--coordinator_address auto` takes them from the launcher's
    environment (LAUNCHER_ENV, as torchrun sets them). Ranks given without
    an address, or with `auto`, raise: they would otherwise be ignored. A
    `--device` with an index at more than one rank puts every rank on that
    card, under gloo."""
    addr = getattr(opt, "coordinator_address", None)
    n = getattr(opt, "num_processes", None)
    rank = getattr(opt, "process_id", None)
    if not addr:
        if n is not None or rank is not None:
            raise ValueError(
                "--num_processes and --process_id need --coordinator_address"
                " host:port (they would be ignored)")
        return None
    if addr == "auto":
        if n is not None or rank is not None:
            raise ValueError(
                "--coordinator_address auto takes the ranks from the "
                "launcher's environment; drop --num_processes and "
                "--process_id")
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        if missing:
            raise ValueError(
                f"--coordinator_address auto needs the launcher's "
                f"environment (torchrun sets {', '.join(LAUNCHER_ENV)}); "
                f"missing: {', '.join(missing)}")
        init, n, rank = ("env://", int(os.environ["WORLD_SIZE"]),
                         int(os.environ["RANK"]))
    else:
        if n is None or rank is None:
            raise ValueError(
                "--coordinator_address host:port needs --num_processes and "
                "--process_id (or 'auto' under a launcher that sets them)")
        init = addr if "://" in addr else f"tcp://{addr}"
    if not 0 <= rank < n:
        raise ValueError(f"--process_id {rank} is not a rank of "
                         f"--num_processes {n}")
    n_devices = getattr(opt, "n_devices", None)
    if n_devices not in (None, n):
        raise ValueError(f"--n_devices {n_devices} differs from the "
                         f"{n} processes of the group")
    # gloo on the CPU or where the ranks share one card, else NCCL for the
    # cards' tensors and gloo for the host's
    shared = torch.device(opt.device).index is not None and n > 1
    backend = ("gloo" if device.type == "cpu" or shared
               else "cpu:gloo,cuda:nccl")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=rank)
    if is_primary():
        print(f"process group: {n} ranks, {backend}, {init}", flush=True)
    return backend


@contextlib.contextmanager
def process_group(opt, device):
    """initialize_from_opt for the body; after it every rank meets at a
    barrier and leaves the group (after an exception it leaves without the
    barrier, which the other ranks might never reach)."""
    backend = initialize_from_opt(opt, device)
    try:
        yield backend
        sync()
    finally:
        if backend is not None:
            dist.destroy_process_group()


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary():
    """True on the rank that writes checkpoints, config and metrics (the
    reference's rank-0 guard)."""
    return process_index() == 0


def sync():
    """Global barrier (e.g. 'checkpoint written' before the ranks exit)."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_seed(seed):
    """Rank 0's `seed` on every rank: a seed drawn at random would
    otherwise differ per rank, and with it the initial parameters, which
    are made, not broadcast."""
    if process_count() == 1:
        return int(seed)
    t = torch.tensor([int(seed)], dtype=torch.int64)
    dist.broadcast(t, src=0)
    return int(t)


def host_sum(values):
    """The sums over the ranks of a few host numbers, in float64 (the same
    on every rank)."""
    if process_count() == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.all_reduce(t)
    return t.tolist()


def agree_stop(requested):
    """True on every rank when any rank asked to stop (SIGTERM): the ranks
    take the decision together at a step or window boundary, so that none
    leaves the others waiting in a collective (a stop decided by each rank
    alone races)."""
    if process_count() == 1:
        return bool(requested)
    t = torch.tensor([1 if requested else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t)


def gather_to_primary(obj):
    """[every rank's obj, in rank order] on rank 0, None elsewhere (through
    the host: gloo has no all_gather of CUDA tensors)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count() if is_primary() else None
    dist.gather_object(obj, out, dst=0)
    return out


def local_batch_slice(global_batch_size, rank=None, count=None):
    """(start, stop) rows of the global batch axis that a rank owns: rows
    [r B/N, (r + 1) B/N) of rank r of N (this rank's by default)."""
    rank = process_index() if rank is None else rank
    count = process_count() if count is None else count
    if global_batch_size % count:
        raise ValueError(
            f"global batch {global_batch_size} does not divide over "
            f"{count} ranks (every rank must own a batch slice)")
    per = global_batch_size // count
    return rank * per, (rank + 1) * per


def validate_loader_slices(loader):
    """Raises unless the loader feeds this rank's rows of each of its
    global batches (`local_batch_slice`): a loader made with another rank
    would train every rank on other data."""
    want = local_batch_slice(loader.batch_size)
    got = loader.rows(0)
    if (loader.shard_count, got) != (process_count(), want):
        raise ValueError(
            f"rank {process_index()} of {process_count()}: the loader feeds "
            f"rows {got} of {loader.shard_count} shards, the rank owns rows "
            f"{want}")
