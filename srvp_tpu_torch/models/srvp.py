"""SRVP model in PyTorch (counterpart of srvp_tpu/models/srvp.py).

Public functions keep the JAX layouts: videos (T, B, H, W, C), latent
sequences (T, B, n). Time is folded into the batch batch-major (row
b*nt + t) for the frame-wise convs, as in the JAX package.

Training mode follows the module's `training` flag (`model.train()`): batch
norm uses batch statistics, the skip connections come from a random frame
per video, `infer_w` reads a random subset of frames, and `forward` rolls
out with posterior z on every substep.

Every stochastic function takes its randomness as an argument (eps_y,
eps_pri/eps_pos per Euler substep, eps for the prior rollout, the skip frame
index, the infer_w frame indices) so tests can feed it the JAX draws; when
one is None it is drawn from the given torch.Generator, in a fixed order
that does not depend on the rollout route.

Precision follows the JAX package's `compute_dtype`: `forward` casts the
frames to it before the encoder, the encodings back to float32 after it,
and w and y to it before the decoder; the inference networks, the z-LSTM,
the rollouts and the parameters stay float32 (`encode` and `decode` compute
in their inputs' dtype).

State-space recap: content w (permutation-invariant over frames), initial
state y_1 ~ q(y | x_{1:nt_inf}), dynamics y' = y + dt * f(y, z), with
z ~ q(z | LSTM(hx)_t) while observed and z ~ p(z | y) after.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from srvp_tpu_torch.config import SRVPConfig
from srvp_tpu_torch.kernels.rollout import prior_rollout
from srvp_tpu_torch.kernels.rollout_train import train_rollout
from srvp_tpu_torch.models.conv import Decoder, Encoder
from srvp_tpu_torch.models.lstm import lstm_apply, make_lstm
from srvp_tpu_torch.models.mlp import MLP
from srvp_tpu_torch.ops.dists import rsample


class GenerateOutput(NamedTuple):
    y: torch.Tensor                       # (L, B, ny); L = nt or (nt-1)*o + 1
    z: Optional[torch.Tensor]             # (nt-1, B, nz) or None
    q_z_params: Optional[torch.Tensor]    # (n_obs, B, 2nz) or None
    p_z_params: Optional[torch.Tensor]    # (nt-1, B, 2nz) or None
    res: torch.Tensor                     # (o*(nt-1), B, ny)


class ForwardOutput(NamedTuple):
    x_: torch.Tensor                      # (L, B, H, W, C) in [0, 1]
    y: torch.Tensor
    z: Optional[torch.Tensor]
    w: torch.Tensor                       # (B, nh_inf)
    q_y_0_params: torch.Tensor            # (B, 2ny)
    q_z_params: Optional[torch.Tensor]
    p_z_params: Optional[torch.Tensor]
    res: torch.Tensor


def rollout_masks(nt, oversampling, nt_hx):
    """Static per-substep decisions of the Euler rollout.

    Substep k = 1..o*(nt-1) targets integer frame t_data = ceil(k/o); a new z
    is drawn at the first substep of each integer frame and reused for the
    following o-1 substeps, from the posterior while t_data < nt_hx.
    """
    o = oversampling
    step_ids = np.arange(1, o * (nt - 1) + 1)
    t_data = (step_ids + o - 1) // o
    new_step = (step_ids - 1) % o == 0
    use_post = t_data < nt_hx
    keep_integer = step_ids % o == 0
    return t_data, new_step, use_post, keep_integer


_INDICES = {}


def _take(t, idx):
    """t[idx] for a numpy index array, the index kept on t's device after
    its first use: a host index would be copied to the card on every call,
    which a CUDA graph cannot capture (train_lib.WindowStep). Under
    torch.compile or torch.export the index becomes a constant of the
    traced program instead, and the cache is neither read nor written (it
    must not hold a traced tensor)."""
    if torch.compiler.is_compiling():
        return t[torch.as_tensor(idx, dtype=torch.long, device=t.device)]
    key = (idx.tobytes(), t.device)
    if key not in _INDICES:
        _INDICES[key] = torch.as_tensor(idx, dtype=torch.long,
                                        device=t.device)
    return t[_INDICES[key]]


def _noise(eps, shape, like, generator):
    if eps is not None:
        return eps
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=like.dtype)


class SRVP(nn.Module):
    """Attribute names give the reference checkpoint's state_dict keys."""

    def __init__(self, cfg: SRVPConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg.archi, cfg.nc, cfg.nhx, cfg.nf)
        self.decoder = Decoder(cfg.archi, cfg.nc, cfg.nh_inf + cfg.ny, cfg.nf,
                               cfg.skipco)
        self.w_proj = nn.Sequential(nn.Linear(cfg.nhx, cfg.nh_inf), nn.ReLU())
        self.w_inf = nn.Sequential(nn.Linear(cfg.nh_inf, cfg.nh_inf),
                                   nn.Tanh())
        self.q_y = MLP(cfg.nhx * cfg.nt_inf, cfg.nh_inf, cfg.ny * 2,
                       cfg.nlayers_inf)
        self.inf_z = make_lstm(cfg.nhx, cfg.nh_inf)
        self.q_z = nn.Linear(cfg.nh_inf, cfg.nz * 2)
        self.p_z = MLP(cfg.ny, cfg.nh_res, cfg.nz * 2, cfg.nlayers_res)
        self.dynamics = MLP(cfg.ny + cfg.nz, cfg.nh_res, cfg.ny,
                            cfg.nlayers_res)

    # -- encode / decode ----------------------------------------------------

    def encode(self, x, skip_t=None, generator=None):
        """x: (T, B, H, W, C) -> (hx (T, B, nhx), skips or None), in x's
        dtype.

        Skips are per video, (B, c, h, w) NCHW: from frame skip_t[b] in
        training mode (drawn uniformly when None) and from the last frame
        otherwise."""
        nt, bsz = x.shape[0], x.shape[1]
        x_flat = x.transpose(0, 1).reshape((bsz * nt,) + x.shape[2:])
        hx_flat, skips = self.encoder(x_flat.permute(0, 3, 1, 2).contiguous())
        hx = hx_flat.reshape(bsz, nt, self.cfg.nhx).transpose(0, 1)
        if not self.cfg.skipco:
            return hx, None
        if not self.training:
            return hx, [s[nt - 1::nt] for s in skips]
        if skip_t is None:
            skip_t = torch.randint(0, nt, (bsz,), generator=generator,
                                   device=x.device)
        rows = torch.arange(bsz, device=x.device) * nt + skip_t.to(x.device)
        return hx, [s[rows] for s in skips]

    def decode(self, w, y, skips):
        """Decodes (w, y_t) pairs in w's dtype (y and the skips are cast to
        it). w: (B, nh_inf), y: (L, B, ny), skips: None or per-video
        (B, c, h, w) tensors, shared by the L frames. Returns (L, B, H, W, C)
        in [0, 1]."""
        nt, bsz = y.shape[0], y.shape[1]
        y_flat = y.transpose(0, 1).reshape(bsz * nt, self.cfg.ny)
        w_flat = w[:, None].expand(bsz, nt, w.shape[-1]).reshape(bsz * nt, -1)
        x_flat = self.decoder(torch.cat([w_flat, y_flat.to(w_flat.dtype)],
                                        dim=-1), skips, nt)
        x_flat = x_flat.permute(0, 2, 3, 1)
        return x_flat.reshape((bsz, nt) + x_flat.shape[1:]).transpose(0, 1)

    # -- inference networks -------------------------------------------------

    def infer_w(self, hx, frame_idx=None, generator=None):
        """Content variable. hx: (T, B, nhx). Training mode reads nt_inf
        frames per video drawn without replacement, frame_idx (nt_inf, B)
        when given; otherwise the last nt_inf frames."""
        nt_inf = self.cfg.nt_inf
        if self.training:
            if frame_idx is None:
                keys = torch.rand((hx.shape[1], hx.shape[0]),
                                  generator=generator, device=hx.device)
                frame_idx = keys.argsort(dim=1)[:, :nt_inf].T
            idx = frame_idx.to(hx.device)[..., None].expand(-1, -1,
                                                            hx.shape[2])
            h = torch.gather(hx, 0, idx)
        else:
            h = hx[-nt_inf:]
        return self.w_inf(self.w_proj(h).sum(0))

    def infer_y(self, hx, eps_y=None, generator=None):
        """q(y_1 | x_{1:nt_inf}). hx: (nt_inf, B, nhx) -> (y_0, q params)."""
        bsz = hx.shape[1]
        flat = hx.permute(1, 0, 2).reshape(bsz, self.cfg.nt_inf * self.cfg.nhx)
        q_y_0_params = self.q_y(flat)
        eps_y = _noise(eps_y, (bsz, self.cfg.ny), q_y_0_params, generator)
        return rsample(q_y_0_params, eps_y), q_y_0_params

    # -- full pass ----------------------------------------------------------

    def forward(self, x, nt, oversampling=1, skip_t=None, frame_idx=None,
                eps_y=None, eps_pri=None, eps_pos=None, generator=None,
                use_kernel=False, compute_dtype=None):
        """Full model pass (srvp_tpu/models/srvp.py `forward`).

        x: (T, B, H, W, C) in [0, 1]. Returns ForwardOutput with nt frames,
        x_ in `compute_dtype` (the encoder's and decoder's dtype, x's when
        None); the latent model runs in x's dtype (float32 in training).
        Randomness not given is drawn in the order skip_t, frame_idx, eps_y,
        rollout eps.
        `use_kernel` routes an all-posterior rollout through the training
        rollout kernels.
        """
        compute_dtype = compute_dtype or x.dtype
        hx, skips = self.encode(x.to(compute_dtype), skip_t, generator)
        hx = hx.to(x.dtype)
        w = self.infer_w(hx, frame_idx, generator)
        y_0, q_y_0_params = self.infer_y(hx[:self.cfg.nt_inf], eps_y,
                                         generator)
        gen = self.generate(y_0, hx, nt, oversampling, eps_pri=eps_pri,
                            eps_pos=eps_pos, generator=generator,
                            use_kernel=use_kernel)
        x_ = self.decode(w.to(compute_dtype), gen.y.to(compute_dtype), skips)
        return ForwardOutput(x_, gen.y, gen.z, w, q_y_0_params,
                             gen.q_z_params, gen.p_z_params, gen.res)

    # -- rollouts -----------------------------------------------------------

    def generate(self, y_0, hx, nt, oversampling=1, eps_pri=None,
                 eps_pos=None, remove_intermediate=True, hx_z=None,
                 generator=None, use_kernel=False):
        """Euler rollout of the latent state.

        y_0: (B, ny); hx: (nt_hx, B, nhx) frame encodings or None (pure
        prior); hx_z optionally gives the z-LSTM outputs (nt_hx, B, nh_inf)
        instead of hx. eps_pri / eps_pos: (o*(nt-1), B, nz) noise per substep;
        only the first substep of each frame reads them.

        The rollout is an eager per-substep loop, unless `use_kernel` is set
        and every frame has an observation (training): then it goes through
        the training-rollout kernels (kernels/rollout_train.py) on the same
        noise. In training mode every frame must have an observation.
        """
        cfg = self.cfg
        dt = 1.0 / oversampling
        bsz = y_0.shape[0]
        nt_hx = (hx_z.shape[0] if hx_z is not None
                 else (0 if hx is None else hx.shape[0]))
        t_data, new_step, use_post, keep_integer = rollout_masks(
            nt, oversampling, nt_hx)
        n_steps = len(t_data)
        if n_steps == 0:
            return GenerateOutput(y_0[None], None, None, None,
                                  y_0.new_zeros((0, bsz, cfg.ny)))
        if nt_hx > 0 and hx_z is None:
            hx_z = lstm_apply(self.inf_z, hx)
        shape = (n_steps, bsz, cfg.nz)
        if np.any(new_step & ~use_post):
            eps_pri = _noise(eps_pri, shape, y_0, generator)
        if np.any(new_step & use_post):
            eps_pos = _noise(eps_pos, shape, y_0, generator)
        if self.training and not np.all(use_post):
            raise ValueError("a training rollout needs an observation for "
                             "every generated frame")
        if use_kernel and np.all(use_post):
            ys, res, q_pars, p_pars, zs = train_rollout(
                (self.q_z.weight, self.q_z.bias), self.p_z.linears(),
                self.dynamics.linears(), y_0, _take(hx_z, t_data), eps_pos,
                oversampling)
            if remove_intermediate:
                ys = _take(ys, np.flatnonzero(keep_integer))
            new = np.flatnonzero(new_step)
            return GenerateOutput(torch.cat([y_0[None], ys]), _take(zs, new),
                                  _take(q_pars, new), _take(p_pars, new),
                                  res)

        y, z = y_0, None
        ys, res, zs, p_pars, q_pars = [], [], [], [], []
        for k in range(n_steps):
            if new_step[k]:
                p_par = self.p_z(y)
                p_pars.append(p_par)
                if use_post[k]:
                    q_par = self.q_z(hx_z[t_data[k]])
                    q_pars.append(q_par)
                    z = rsample(q_par, eps_pos[k])
                else:
                    z = rsample(p_par, eps_pri[k])
                zs.append(z)
            r = dt * self.dynamics(torch.cat([y, z], dim=-1))
            y = y + r
            ys.append(y)
            res.append(r)
        ys = torch.stack(ys)
        if remove_intermediate:
            y_out = torch.cat([y_0[None],
                               _take(ys, np.flatnonzero(keep_integer))])
        else:
            y_out = torch.cat([y_0[None], ys])
        stack = lambda lst: torch.stack(lst) if lst else None  # noqa: E731
        return GenerateOutput(y_out, stack(zs), stack(q_pars), stack(p_pars),
                              torch.stack(res))

    def generate_prior(self, y_0, nt, oversampling=1, eps=None,
                       remove_intermediate=True, generator=None):
        """Pure-prior rollout through the prior-rollout kernel
        (kernels/rollout.py). Samples the same trajectory as `generate`
        with hx=None for the same eps; z/q/p params are not returned."""
        cfg = self.cfg
        n_steps = oversampling * (nt - 1)
        bsz = y_0.shape[0]
        if n_steps == 0:
            return GenerateOutput(y_0[None], None, None, None,
                                  y_0.new_zeros((0, bsz, cfg.ny)))
        eps = _noise(eps, (n_steps, bsz, cfg.nz), y_0, generator)
        y_0 = y_0.contiguous()
        ys = prior_rollout(self.p_z.linears(), self.dynamics.linears(), y_0,
                           eps.contiguous(), cfg.ny, cfg.nz, oversampling)
        y_all = torch.cat([y_0[None], ys])
        res = ys - y_all[:-1]
        if remove_intermediate:
            keep = rollout_masks(nt, oversampling, 0)[3]
            y_all = torch.cat([y_0[None], _take(ys, np.flatnonzero(keep))])
        return GenerateOutput(y_all, None, None, None, res)
