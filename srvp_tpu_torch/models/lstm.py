"""z-inference LSTM (counterpart of srvp_tpu/models/lstm.py).

torch's nn.LSTM already has the JAX package's semantics: gate order
(input, forget, cell, output) along the stacked 4*hidden axis, both b_ih and
b_hh, and zero initial h and c.
"""

import torch.nn as nn


def make_lstm(n_in, n_hid):
    return nn.LSTM(n_in, n_hid, 1)


def lstm_apply(lstm, x):
    """x: (T, B, n_in) time-major -> hidden states (T, B, n_hid)."""
    return lstm(x)[0]
