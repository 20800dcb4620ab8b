"""The SRVP training initialisation (counterpart of srvp_tpu/ops/init.py and
the init split of srvp_tpu/models/srvp.py:96-121).

Encoder and decoder conv kernels ~ N(0, 0.02), their batch-norm scales
~ N(1, 0.02) with zero shifts; the dynamics MLP's weights orthogonal with
gain `res_gain` and zero biases; every other module keeps torch's defaults
(nn.Linear and nn.LSTM: U(-1/sqrt(fan_in), 1/sqrt(fan_in))), which a freshly
built SRVP already has. Draws come from torch's global generator.
"""

import torch
import torch.nn as nn

CONV_STD = 0.02


@torch.no_grad()
def init_srvp_(model, res_gain=1.41):
    """Re-initialises `model` (an SRVP) in place; returns it."""
    for net in (model.encoder, model.decoder):
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.normal_(m.weight, 0.0, CONV_STD)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.normal_(m.weight, 1.0, CONV_STD)
                nn.init.zeros_(m.bias)
    for w, b in model.dynamics.linears():
        nn.init.orthogonal_(w, gain=res_gain)
        nn.init.zeros_(b)
    return model
