"""Experiment-directory writes of the trainer (counterpart of
srvp_tpu/utils/checkpoint.py): model state_dicts, the full train state and
config.json. A model state_dict uses the reference checkpoint key names, so
the port's test_main loads it with `--model_name <name>.pt`;
train_state.pt holds train_lib.state_dict's output (model, Adam, schedule,
step, generator) and train_state.json its step and the best validation
metric, which `--resume` restores. Files are written to a temporary name
and renamed, so a directory only ever holds complete files;
`AsyncCheckpointer` writes them from a background thread."""

import json
import os
import threading

import torch

TRAIN_STATE_FILE = "train_state.pt"
TRAIN_META_FILE = "train_state.json"


def _replace(path, write):
    tmp = f"{path}.tmp"
    write(tmp)
    os.replace(tmp, path)


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _tensors(tree):
    out = []
    _map_tensors(out.append, tree)
    return out


def to_cpu(tree):
    """A nested dict/list of tensors with every tensor on the CPU."""
    return _map_tensors(lambda t: t.detach().cpu(), tree)


class Snapshot:
    """A copy of a nested dict/list of tensors, made on each tensor's device
    on the current stream, so that the stream orders it before any later
    in-place update (the optimizer's). `host()` waits for the copy's event
    and brings it to the CPU on a stream of its own, so that a writer
    thread neither reads an unfinished copy nor waits behind the training
    steps queued after it."""

    def __init__(self, tree):
        self.tree = _map_tensors(lambda t: t.detach().clone(), tree)
        self.event = None
        if any(t.is_cuda for t in _tensors(self.tree)):
            self.event = torch.cuda.Event()
            self.event.record()

    def host(self):
        if self.event is None:
            return to_cpu(self.tree)
        self.event.synchronize()
        with torch.cuda.stream(torch.cuda.Stream()):
            return to_cpu(self.tree)


class AsyncCheckpointer:
    """Background checkpoint writer, one save in flight at a time
    (srvp_tpu/utils/checkpoint.py:21). The loop takes a `Snapshot` of the
    state and `submit`s a function that writes it from a thread while
    training goes on; a submit waits for the save before it, and `wait()`
    precedes the final synchronous save. A failed save raises on the next
    submit or wait, so a write error cannot pass unseen."""

    def __init__(self):
        self._thread = None
        self._error = None

    def submit(self, fn):
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:   # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="srvp-ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint save failed") from err


def remove_stale_tmp(save_path):
    """Deletes the *.tmp files that a save cut short left behind."""
    for f in os.listdir(save_path):
        if f.endswith(".tmp"):
            os.remove(os.path.join(save_path, f))


def save_model(save_path, name, state_dict):
    """Writes a model's state_dict (tensors moved to the CPU) to
    save_path/name.pt; returns the path."""
    path = os.path.join(save_path, f"{name}.pt")
    sd = to_cpu(dict(state_dict))
    _replace(path, lambda p: torch.save(sd, p))
    return path


def prune_periodic(save_path, keep):
    """Deletes all but the `keep` most recent model_<step>.pt snapshots
    (srvp_tpu/utils/checkpoint.py:79); model.pt, model_best.pt and
    temporary files stay. Nothing when keep is None."""
    if keep is None:
        return
    if keep < 0:
        raise ValueError(f"--keep_chkpt must be >= 0, got {keep}")
    steps = sorted(int(f[len("model_"):-len(".pt")])
                   for f in os.listdir(save_path)
                   if f.startswith("model_") and f.endswith(".pt")
                   and f[len("model_"):-len(".pt")].isdigit())
    for step in steps[:-keep] if keep > 0 else steps:
        try:
            os.remove(os.path.join(save_path, f"model_{step}.pt"))
        except FileNotFoundError:
            pass


def save_config(save_path, config):
    """Writes the experiment's flags to save_path/config.json."""
    path = os.path.join(save_path, "config.json")

    def write(p):
        with open(p, "w") as f:
            json.dump(config, f, indent=2, sort_keys=True)
    _replace(path, write)
    return path


def save_train_state(save_path, state, extra=None):
    """Writes train_lib.state_dict's output to save_path/train_state.pt and
    its step, with `extra` (the best validation metric), to
    train_state.json; the state file lands first, so the JSON never names a
    step that the state file does not hold."""
    state = to_cpu(state)
    _replace(os.path.join(save_path, TRAIN_STATE_FILE),
             lambda p: torch.save(state, p))
    meta = {"step": int(state["step"]), **(extra or {})}

    def write(p):
        with open(p, "w") as f:
            json.dump(meta, f)
    _replace(os.path.join(save_path, TRAIN_META_FILE), write)


def load_train_state(save_path):
    """(the state saved by save_train_state, tensors on the CPU; its JSON
    meta)."""
    state = torch.load(os.path.join(save_path, TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=True)
    meta_path = os.path.join(save_path, TRAIN_META_FILE)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def has_train_state(save_path):
    return os.path.exists(os.path.join(save_path, TRAIN_STATE_FILE))
