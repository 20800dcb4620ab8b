"""The reference's serving call: frames = f(x_cond uint8, seed), with the
noise worked out again from the seed.

The port's serving program draws its noise inside the program with
Philox4x32-10 (Salmon et al., SC 2011) keyed by the int64 seed, the
counter (unit // 4, row, substep, stream), each group of four words turned
into four normals by the Box-Muller transform in float64 and rounded once
to float32; streams 0, 1 and 2 give eps_y, the posterior rollout's and the
prior rollout's noise. This file computes the same draws with its own code
(a frozen copy of the algorithm), then the plain model's sample: encode,
w, z-LSTM, y_0, the posterior rollout over the conditioning frames, the
prior rollout, decode of every frame, round(clip(x, 0, 1) * 255).
"""

import math

import torch

M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m, x):
    p0 = x * (m & 0xFFFF)
    p1 = x * (m >> 16)
    low = (p0 & M32) + ((p1 & 0xFFFF) << 16)
    return ((p0 >> 32) + (p1 >> 16) + (low >> 32)) & M32, low & M32


def philox(counter, key):
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & M32, (k1 + PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def normals(seed, stream, n_steps, bsz, n_units, device):
    """float32 (n_steps, bsz, n_units) standard normals of one stream."""
    groups = -(-n_units // 4)
    ar = lambda n: torch.arange(n, device=device, dtype=torch.int64)  # noqa
    g, b, k = torch.broadcast_tensors(ar(groups)[None, None, :],
                                      ar(bsz)[None, :, None],
                                      ar(n_steps)[:, None, None])
    s = torch.tensor(seed, dtype=torch.int64, device=device)
    words = philox((g.reshape(-1), b.reshape(-1), k.reshape(-1),
                    torch.full_like(g.reshape(-1), stream)),
                   (s & M32, (s >> 32) & M32))
    u = [(w.double() + 0.5) * 2.0 ** -32 for w in words]
    out = []
    for a, c in ((u[0], u[1]), (u[2], u[3])):
        r = torch.sqrt(-2.0 * torch.log(a))
        out += [r * torch.cos(2.0 * math.pi * c), r * torch.sin(
            2.0 * math.pi * c)]
    z = torch.stack(out, dim=-1).float()
    return z.reshape(n_steps, bsz, 4 * groups)[..., :n_units]


@torch.no_grad()
def serve(model, x_u8, seed, nt_gen, o):
    """The frames (nt_gen, B, H, W, C) uint8 of one call."""
    cfg = model.cfg
    nt_cond, bsz = x_u8.shape[:2]
    dev = x_u8.device
    eps_y = normals(seed, 0, 1, bsz, cfg["ny"], dev)[0]
    eps_inf = normals(seed, 1, o * (nt_cond - 1), bsz, cfg["nz"], dev)
    eps_gen = normals(seed, 2, o * (nt_gen - nt_cond), bsz, cfg["nz"], dev)
    x = x_u8.float() / 255.0
    hx, skips = model.encode(x)
    w = model.infer_w(hx)
    hx_z = model.inf_z(hx)
    y0, _ = model.infer_y(hx, eps_y)
    y_inf, _, _, _ = model.rollout(y0, nt_cond, o, eps_inf, hx_z)
    y_gen, _, _, _ = model.rollout(y_inf[-1], nt_gen - nt_cond + 1, o,
                                   eps_gen)
    y = torch.cat([y_inf, y_gen[1:]])
    frames = model.decode(w, y, skips).clamp(0.0, 1.0)
    return torch.round(frames * 255.0).to(torch.uint8)
