"""Shared fixtures of the srvp_tpu_torch parity tests: tiny configurations,
JAX weights carried into the port, and the JAX noise draws as torch
tensors."""

import numpy as np

import jax
import torch

from srvp_tpu.models import srvp as jsrvp
from srvp_tpu_torch.config import SRVPConfig
from srvp_tpu_torch.models.srvp import SRVP
from srvp_tpu_torch.utils.weights import state_dict_from_jax

ATOL = 2e-4                     # module forward parity (test_model_parity)
ROLLOUT_RTOL, ROLLOUT_ATOL = 1e-4, 1e-5   # rollouts (test_pallas)


def tiny_kwargs(**over):
    kw = dict(nx=64, nc=1, nf=8, nhx=16, ny=6, nz=4, skipco=False, nt_inf=3,
              nh_inf=12, nlayers_inf=2, nh_res=24, nlayers_res=3,
              archi="dcgan")
    kw.update(over)
    return kw


def configs(**over):
    """(JAX SRVPConfig, port SRVPConfig) with the same fields."""
    kw = tiny_kwargs(**over)
    return jsrvp.SRVPConfig(**kw), SRVPConfig(**kw)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# one compile instead of an eager compile per random op
_jit_init = jax.jit(jsrvp.init, static_argnums=(1,))


def jax_model(jcfg, seed=0, res_gain=1.41, conv_gain=1.0):
    """JAX (params, state) as numpy trees, with random (non-trivial) batch
    norm running statistics. conv_gain scales every conv kernel (their
    normal(0.02) init otherwise leaves decoded frames almost constant)."""
    params, state = to_np(_jit_init(jax.random.PRNGKey(seed), jcfg,
                                    res_gain))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * np.float32(conv_gain)
        if any(getattr(k, "key", None) == "conv" for k in path) else v,
        params)
    rng = np.random.RandomState(seed + 100)

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"mean", "var"}:
                n = node["mean"].shape
                return {"mean": (0.1 * rng.randn(*n)).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            return {k: perturb(v) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        return node

    return params, perturb(state)


def port_model(params, state, cfg):
    """Eval-mode port SRVP on the CPU holding the JAX weights."""
    model = SRVP(cfg)
    model.load_state_dict(state_dict_from_jax(params, state, cfg), strict=True)
    return model.eval()


def t(x):
    return torch.from_numpy(np.array(x))


def step_noise(key, n_steps, bsz, nz):
    """The per-substep draws of srvp.generate for rng=key:
    (eps_pri, eps_pos), each (n_steps, bsz, nz)."""
    keys = jax.random.split(key, n_steps)
    pri, pos = [], []
    for k in range(n_steps):
        k_pri, k_pos = jax.random.split(keys[k])
        pri.append(np.asarray(jax.random.normal(k_pri, (bsz, nz))))
        pos.append(np.asarray(jax.random.normal(k_pos, (bsz, nz))))
    return t(np.stack(pri)), t(np.stack(pos))


def chunk_noise(key, cfg, rows, nt_cond, t_pred, o_inf, o_gen):
    """(eps_y, eps_inf, eps_gen) that eval_lib's compute draws from
    keys[0] = key: split into (k_y, k_inf, k_gen)."""
    k_y, k_inf, k_gen = jax.random.split(key, 3)
    eps_y = t(jax.random.normal(k_y, (rows, cfg.ny)))
    eps_inf = step_noise(k_inf, o_inf * (nt_cond - 1), rows, cfg.nz)[1]
    eps_gen = step_noise(k_gen, o_gen * t_pred, rows, cfg.nz)[0]
    return eps_y, eps_inf, eps_gen


def jax_draws(key, jcfg, nt, bsz, oversampling):
    """The randomness of srvp.forward(train=True, rng=key) as torch
    tensors: skip frame (B,), infer_w frames (nt_inf, B), eps_y, eps_pos."""
    k_skip, k_w, k_y, k_gen = jax.random.split(key, 4)
    skip_t = jax.random.randint(k_skip, (bsz,), 0, nt)
    perms = jax.vmap(lambda k: jax.random.permutation(k, nt)[:jcfg.nt_inf])(
        jax.random.split(k_w, bsz))
    eps_y = jax.random.normal(k_y, (bsz, jcfg.ny))
    eps_pos = step_noise(k_gen, oversampling * (nt - 1), bsz, jcfg.nz)[1]
    return dict(skip_t=t(skip_t).long(), frame_idx=t(perms.T).long(),
                eps_y=t(eps_y), eps_pos=eps_pos)
