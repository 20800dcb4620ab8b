"""Pre-activation ReLU MLP (counterpart of srvp_tpu/models/mlp.py).

Layer il applies ReLU BEFORE its linear map for il > 0; there is no
activation before the first linear nor after the last. Nesting matches the
reference checkpoints: `module.0.0.*` for the first layer and
`module.{il}.1.*` for the later ones.
"""

import torch.nn as nn


def mlp_dims(n_inp, n_hid, n_out, n_layers):
    if n_hid != 0 and n_layers <= 1:
        raise ValueError("an MLP with a hidden width needs n_layers > 1")
    return [
        (n_inp if il == 0 else n_hid, n_out if il == n_layers - 1 else n_hid)
        for il in range(n_layers)
    ]


class MLP(nn.Module):
    def __init__(self, n_inp, n_hid, n_out, n_layers):
        super().__init__()
        blocks = []
        for il, (d_in, d_out) in enumerate(mlp_dims(n_inp, n_hid, n_out,
                                                    n_layers)):
            mods = ([] if il == 0 else [nn.ReLU()]) + [nn.Linear(d_in, d_out)]
            blocks.append(nn.Sequential(*mods))
        self.module = nn.Sequential(*blocks)

    def forward(self, x):
        return self.module(x)

    def linears(self):
        """The (weight (out, in), bias (out,)) pairs, first layer first."""
        return [(blk[-1].weight, blk[-1].bias) for blk in self.module]
