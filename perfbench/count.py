"""Work of one unit (a training step, an evaluation batch, a serving call)
counted on the reference model, on the meta device: its FLOPs (torch's
FlopCounterMode: the matmuls and convolutions, forward and backward) and
the input sizes of its pool and upsample sites. Nothing runs on a device
and no program code is involved, so a change to the program cannot move
the count."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.model import Pool, Up


def count_unit(model, run):
    """(FLOPs, [(kind, input elements)]) of `run()` on `model` (the
    reference on the meta device); kind "pool" or "up", once per forward
    of a site. Backward passes of the sites are the caller's to add."""
    sites = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: sites.append(
            ("pool" if isinstance(mod, Pool) else "up", args[0].numel())))
        for m in model.modules() if isinstance(m, (Pool, Up))]
    try:
        with FlopCounterMode(display=False) as counter:
            run()
    finally:
        for h in hooks:
            h.remove()
    return float(counter.get_total_flops()), sites


def meta_model(cfg):
    from perfbench.reference.model import SRVP
    with torch.device("meta"):
        return SRVP(cfg)
