"""Experiment-directory writes of the trainer: model state_dicts and
config.json. A state_dict uses the reference checkpoint key names, so the
port's test_main loads it with `--model_name <name>.pt`. Files are written
to a temporary name and renamed, so a directory only ever holds complete
files."""

import json
import os

import torch


def _replace(path, write):
    tmp = f"{path}.tmp"
    write(tmp)
    os.replace(tmp, path)


def save_model(save_path, name, model):
    """Writes `model`'s state_dict (tensors on the CPU) to
    save_path/name.pt; returns the path."""
    path = os.path.join(save_path, f"{name}.pt")
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
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
