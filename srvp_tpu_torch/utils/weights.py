"""Loads JAX srvp_tpu checkpoints into the port's modules.

JAX parameters are nested dicts/lists (pytrees); a `model.npz` written by the
JAX package's checkpointing holds each leaf under its key path as printed by
`jax.tree_util.keystr`, e.g. "['params']['encoder']['stages'][0][0]['conv']
['kernel']". `load_jax_model_npz` parses those paths back into nested
containers without jax, and `state_dict_from_jax` turns the pytrees into the
port's state_dict (the reference checkpoint's key names):

  * conv kernels HWIO -> OIHW
  * convT kernels: stored spatially pre-flipped in JAX, so un-flip, then
    (kh, kw, Cin, Cout) -> (Cin, Cout, kh, kw)
  * linear kernels (in, out) -> weight (out, in)
  * LSTM w_ih / w_hh (in, 4h) -> (4h, in)
  * batch norm scale/bias -> weight/bias; state mean/var -> running stats

`bn_state_from_port` maps a port state_dict's running statistics back to the
JAX bn_state layout.
"""

import re

import numpy as np
import torch

from srvp_tpu_torch.models.conv import decoder_spec, encoder_spec
from srvp_tpu_torch.models.layers import is_raw

_KEY_PART = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def conv_w(kernel):
    """A JAX conv kernel, HWIO (kh, kw, cin, cout), as torch's OIHW."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _convt_w(kernel):
    return _t(np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _block(sd, prefix, spec, params, state):
    """One conv block; `state` is only read when the block has BN."""
    k = params["conv"]["kernel"]
    w = _convt_w(k) if spec.kind == "convt" else conv_w(k)
    sd[f"{prefix}.weight" if is_raw(spec) else f"{prefix}.0.weight"] = w
    if spec.bn:
        bn, bn_state = params["bn"], state["bn"]
        sd[f"{prefix}.1.weight"] = _t(bn["scale"])
        sd[f"{prefix}.1.bias"] = _t(bn["bias"])
        sd[f"{prefix}.1.running_mean"] = _t(bn_state["mean"])
        sd[f"{prefix}.1.running_var"] = _t(bn_state["var"])
        sd[f"{prefix}.1.num_batches_tracked"] = torch.tensor(0)


def _mlp(sd, prefix, layers):
    for il, layer in enumerate(layers):
        _linear(sd, f"{prefix}.module.{il}.{0 if il == 0 else 1}", layer)


def _at(node, i):
    """node[i] of a state list; {} where a JAX checkpoint stored nothing
    (npz files omit the empty state of blocks without BN)."""
    return node[i] if isinstance(node, list) and i < len(node) else {}


def op_prefix(prefix, ops, j):
    """Key prefix of op j of a stage: the stage itself when its one op is
    a block (dcgan), else its entry j (models/conv.stage_module)."""
    return prefix if len(ops) == 1 and ops[0][0] == "block" \
        else f"{prefix}.{j}"


def _stage(sd, prefix, ops, params, state):
    """The blocks of one stage; pools and upsamples hold no parameters."""
    for j, ((op, spec), p) in enumerate(zip(ops, params)):
        if op == "block":
            _block(sd, op_prefix(prefix, ops, j), spec, p, _at(state, j))


def _networks(cfg):
    """[(prefix, ops, (net, part, index or None))] of every stage of the
    encoder and decoder, in state_dict order."""
    enc_stages, enc_last = encoder_spec(cfg.archi, cfg.nc, cfg.nhx, cfg.nf)
    dec_first, dec_stages = decoder_spec(cfg.archi, cfg.nc,
                                         cfg.nh_inf + cfg.ny, cfg.nf,
                                         cfg.skipco)
    return ([(f"encoder.conv.{i}", ops, ("encoder", "stages", i))
             for i, ops in enumerate(enc_stages)]
            + [("encoder.last_conv", enc_last, ("encoder", "last", None)),
               ("decoder.first_upconv", dec_first,
                ("decoder", "first", None))]
            + [(f"decoder.conv.{i}", ops, ("decoder", "stages", i))
               for i, ops in enumerate(dec_stages)])


def state_dict_from_jax(params, bn_state, cfg):
    """JAX (params, bn_state) pytrees of numpy arrays -> the port's
    state_dict (torch tensors)."""
    sd = {}
    for prefix, ops, (net, part, i) in _networks(cfg):
        p, s = params[net][part], bn_state[net][part]
        if i is not None:
            p, s = p[i], _at(s, i)
        _stage(sd, prefix, ops, p, s)

    _linear(sd, "w_proj.0", params["w_proj"])
    _linear(sd, "w_inf.0", params["w_inf"])
    _mlp(sd, "q_y", params["q_y"])
    lstm = params["inf_z"]
    sd["inf_z.weight_ih_l0"] = _t(np.asarray(lstm["w_ih"]).T)
    sd["inf_z.weight_hh_l0"] = _t(np.asarray(lstm["w_hh"]).T)
    sd["inf_z.bias_ih_l0"] = _t(lstm["b_ih"])
    sd["inf_z.bias_hh_l0"] = _t(lstm["b_hh"])
    _linear(sd, "q_z", params["q_z"])
    _mlp(sd, "p_z", params["p_z"])
    _mlp(sd, "dynamics", params["dynamics"])
    return sd


def bn_state_from_port(state_dict, cfg):
    """The batch-norm running statistics of a port state_dict as the JAX
    package's bn_state pytree (numpy arrays): the inverse of the statistics
    part of state_dict_from_jax, for carrying a trained model's state back
    and for holding it against the JAX train step's state."""
    def op_state(prefix, ops, j):
        op, spec = ops[j]
        if op != "block" or not spec.bn:
            return {}
        key = f"{op_prefix(prefix, ops, j)}.1.running_"
        return {"bn": {k: state_dict[key + k].detach().cpu().numpy()
                       for k in ("mean", "var")}}

    tree = {"encoder": {"stages": []}, "decoder": {"stages": []}}
    for prefix, ops, (net, part, i) in _networks(cfg):
        states = [op_state(prefix, ops, j) for j in range(len(ops))]
        if i is None:
            tree[net][part] = states
        else:
            tree[net][part].append(states)
    return tree


def _parse_keypath(key):
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            break
        parts.append(m.group(1) if m.group(2) is None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"not a pytree key path: {key!r}")
    return parts


def _listify(node):
    """Dicts keyed by ints become lists; indices with no leaves (empty
    subtrees, which npz files do not store) become empty dicts."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node.get(i, {}) for i in range(max(node) + 1)]
    return node


def unflatten_keypaths(flat):
    """{keystr path: array} -> nested dicts/lists."""
    root = {}
    for key, value in flat.items():
        parts = _parse_keypath(key)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _listify(root)


def load_jax_model_npz(path):
    """Reads a JAX model snapshot (model.npz) -> (params, bn_state) of
    numpy arrays."""
    with np.load(path) as arc:
        tree = unflatten_keypaths({k: arc[k] for k in arc.files})
    return tree["params"], tree["bn_state"]


def load_checkpoint(model, path):
    """Loads a JAX `.npz` snapshot, or a reference `.pt` state_dict, into
    `model` (strict: every key must match)."""
    if str(path).endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    else:
        params, bn_state = load_jax_model_npz(path)
        sd = state_dict_from_jax(params, bn_state, model.cfg)
    model.load_state_dict(sd, strict=True)
    return model
