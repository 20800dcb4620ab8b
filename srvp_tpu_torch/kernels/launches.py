"""The launch counts of the port's kernel wrappers, read, set and advanced
as one dict.

Each wrapper adds one to its own count where it launches its kernel
(rollout.py `launches`; rollout_train.py `fwd_launches`, `bwd_launches`;
spatial.py `launches[kernel, dtype]`; conv_stage.py `block_launches`,
`clamped_launches`). A CUDA graph replays the kernels that its capture
launched without calling the wrappers, and a capture itself runs nothing:
so train_lib.WindowStep takes what its capture counted back, and `add`s it
once per replay.
"""

import torch

from srvp_tpu_torch.kernels import conv_stage, rollout, rollout_train, spatial

# each scalar count: its name, its module and attribute
_SCALARS = {"prior_rollout": (rollout, "launches"),
            "train_rollout_fwd": (rollout_train, "fwd_launches"),
            "train_rollout_bwd": (rollout_train, "bwd_launches"),
            "conv3x3_block": (conv_stage, "block_launches"),
            "conv3x3_clamped": (conv_stage, "clamped_launches")}
# the name of each spatial kernel (spatial.py's key); "_bf16" for bfloat16
_SPATIAL = {"pool_fwd": "maxpool_fwd", "pool_bwd": "maxpool_bwd",
            "up_fwd": "upsample_fwd", "up_bwd": "upsample_bwd"}


def _spatial_name(kernel, dtype):
    return _SPATIAL[kernel] + ("_bf16" if dtype == torch.bfloat16 else "")


def counts():
    """{kernel name: its launches so far}, the spatial kernels once per
    dtype."""
    out = {name: getattr(m, attr) for name, (m, attr) in _SCALARS.items()}
    out.update({_spatial_name(k, d): n
                for (k, d), n in spatial.launches.items()})
    return out


def set_counts(values):
    """Sets every count to its entry of `values` (a `counts()` dict)."""
    for name, (m, attr) in _SCALARS.items():
        setattr(m, attr, values[name])
    for k, d in spatial.launches:
        spatial.launches[k, d] = values[_spatial_name(k, d)]


def reset():
    set_counts(dict.fromkeys(counts(), 0))


def since(before):
    """The launches counted since `before` (a `counts()` dict)."""
    return {k: v - before[k] for k, v in counts().items()}


def add(delta):
    """Adds `delta` ({kernel name: launches}) to the counts."""
    set_counts({k: v + delta.get(k, 0) for k, v in counts().items()})
