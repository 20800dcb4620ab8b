"""Standard-normal noise drawn from a seed inside a program.

`torch.export` takes no torch.Generator, so the serving program
(export.py) draws its noise from its int64 seed tensor with the
counter-based generator Philox4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011), written in integer tensor ops on
int64 masked to 32 bits: its bits are the same on the CPU and the card,
and it traces with a symbolic batch. Each group of 4 outputs becomes 4
normals by the Box-Muller transform (in float64, rounded once to float32).

A draw is keyed by (seed, stream, substep, batch row, unit): the seed is
Philox's key, the rest its counter (unit // 4, row, substep, stream), so a
row's noise does not depend on the batch size.
"""

import math

import torch

M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10
# the streams of the serving noise (eval_lib.chunk_noise's three tensors),
# and the one fold_in uses
STREAM_Y, STREAM_INF, STREAM_GEN, STREAM_FOLD = 0, 1, 2, 3


def _mulhilo(m, x):
    """(hi, lo) 32-bit halves of the product of the constant m and x
    (int64 holding 32-bit values), in 16-bit pieces so that nothing passes
    2^49."""
    p0 = x * (m & 0xFFFF)
    p1 = x * (m >> 16)
    low = (p0 & M32) + ((p1 & 0xFFFF) << 16)
    return ((p0 >> 32) + (p1 >> 16) + (low >> 32)) & M32, low & M32


def philox4x32(counter, key):
    """Philox4x32-10 of the counter words (c0, c1, c2, c3) under the key
    words (k0, k1): int64 tensors (or ints) holding 32-bit values, which
    broadcast together. Returns the 4 output words, int64 in [0, 2^32)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & M32, (k1 + PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed):
    """Philox's key words of an int64 seed tensor."""
    return seed & M32, (seed >> 32) & M32


def _counters(stream, n_steps, bsz, n_units, device):
    """The flat counter words of (n_steps, bsz, ceil(n_units / 4)) groups."""
    ar = lambda n: torch.arange(n, device=device,  # noqa: E731
                                dtype=torch.int64)
    groups = -(-n_units // 4)
    grid = torch.broadcast_tensors(ar(groups)[None, None, :],
                                   ar(bsz)[None, :, None],
                                   ar(n_steps)[:, None, None])
    return [t.reshape(-1) for t in grid] + [
        torch.full_like(grid[0].reshape(-1), stream)]


def _box_muller(words):
    """Standard normals from 4 output words: (n, 4) float32."""
    u = [(w.to(torch.float64) + 0.5) * 2.0 ** -32 for w in words]
    out = []
    for a, b in ((u[0], u[1]), (u[2], u[3])):
        r = torch.sqrt(-2.0 * torch.log(a))
        theta = (2.0 * math.pi) * b
        out += [r * torch.cos(theta), r * torch.sin(theta)]
    return torch.stack(out, dim=-1).to(torch.float32)


def normals(seed, draws, bsz, device):
    """Standard normals for several streams at once.

    seed: int64 scalar tensor; draws: [(stream, n_steps, n_units)];
    bsz: the batch (an int, or a symbolic size under export). Returns one
    float32 (n_steps, bsz, n_units) tensor per draw, unit u of row b at
    substep k from Philox group u // 4, output u % 4, of the counter
    (u // 4, b, k, stream)."""
    parts = [_counters(s, n, bsz, u, device) for s, n, u in draws]
    counter = [torch.cat([p[i] for p in parts]) for i in range(4)]
    z = _box_muller(philox4x32(counter, seed_key(seed)))
    out, start = [], 0
    for _, n_steps, n_units in draws:
        groups = -(-n_units // 4)
        size = n_steps * bsz * groups
        out.append(z[start:start + size].reshape(
            n_steps, bsz, 4 * groups)[..., :n_units])
        start = start + size
    return out


def serving_noise(seed, bsz, ny, nz, nt_cond, nt_gen, o_inf, o_gen,
                  device):
    """The three tensors of eval_lib.chunk_noise for one sample (S = 1):
    eps_y (B, ny), eps_inf (o_inf * (nt_cond - 1), B, nz) and eps_gen
    (o_gen * (nt_gen - nt_cond), B, nz), from streams STREAM_Y, STREAM_INF
    and STREAM_GEN of `seed`."""
    eps_y, eps_inf, eps_gen = normals(
        seed, [(STREAM_Y, 1, ny), (STREAM_INF, o_inf * (nt_cond - 1), nz),
               (STREAM_GEN, o_gen * (nt_gen - nt_cond), nz)], bsz, device)
    return eps_y[0], eps_inf, eps_gen


def fold_in(seed, data):
    """A new seed from (seed, data), both Python ints: Philox's first two
    words of the counter (data, 0, 0, STREAM_FOLD) under seed's key, as a
    non-negative int64. `generate` uses fold_in(seed, s) for sample s."""
    key = seed_key(torch.tensor(seed, dtype=torch.int64))
    c = [torch.tensor(v, dtype=torch.int64)
         for v in (data & M32, 0, 0, STREAM_FOLD)]
    x0, x1, _, _ = philox4x32(c, key)
    return int(((x1 & 0x7FFFFFFF) << 32) | x0)
