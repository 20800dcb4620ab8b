"""Plain SRVP in float32 PyTorch: the benchmark's reference model.

A frozen copy of the port's eager model (srvp_tpu_torch/models/{srvp,conv,
layers,mlp}.py, objectives.py, ops/dists.py) written with torch's own
modules only: nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d, F.max_pool2d,
nearest upsampling, nn.Linear, an LSTM written out gate by gate, and the
rollouts as plain Python loops. It imports nothing of the program, so no
change to the program can move it. Its parameters carry the port's
state_dict keys, so the benchmark hands one set of weights to both.

Layouts follow the port: videos (T, B, H, W, C), latent sequences
(T, B, n), time folded into the batch batch-major (row b*T + t) for the
convolutions.

`quant` (None or "fp8") is the lower-precision control, the conv towers
computed in fp8 where the program computes them in bfloat16 (the step a
later change might take below bfloat16): every conv's input and weight,
and every output of a conv, batch norm, activation and of the decoder,
rounded to float8 e4m3 with one scale per tensor (the largest magnitude
mapped to 448), the products in float32; the gradient of each conv's
output rounded to float8 e5m2 (one scale per tensor) before the backward
products, every other gradient passed through. `quant` "bf16" rounds the
same tensors and gradients to bfloat16 instead: the program's own
precision in the towers, a witness for what rounding there alone does.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
EPS = 1e-8
LOG_2PI = math.log(2.0 * math.pi)
FP8_MAX = 448.0


FP8_GRAD_MAX = 57344.0


def _fp8(x, dtype, top):
    """x rounded to the float8 `dtype` at one scale for the tensor (its
    largest magnitude mapped to `top`), back in x's dtype."""
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def _to(x, quant, grad=False):
    """x rounded as `quant` has it ("fp8": e4m3, or e5m2 for a gradient;
    "bf16": bfloat16), back in x's dtype."""
    if quant == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if grad:
        return _fp8(x, torch.float8_e5m2, FP8_GRAD_MAX)
    return _fp8(x, torch.float8_e4m3fn, FP8_MAX)


def qround(x, quant):
    """x rounded as `quant` has it in the forward, its gradient passed
    through unrounded (a straight-through estimator)."""
    with torch.no_grad():
        q = _to(x, quant)
    return x + (q - x).detach()


class _GradRound(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded as `quant` has it
    (the backward's precision)."""

    @staticmethod
    def forward(ctx, x, quant):
        ctx.quant = quant
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _to(g, ctx.quant, grad=True), None


# -- conv towers --------------------------------------------------------------

def _block(kind, cin, cout, k, s, p, act="leaky_relu", bn=True):
    return ("block", (kind, cin, cout, k, s, p, act, bn))


def _c3(cin, cout):
    return _block("conv", cin, cout, 3, 1, 1)


POOL, UP = ("pool", None), ("up", None)


def encoder_spec(archi, nc, nh, nf):
    if archi == "dcgan":
        stages = [[_block("conv", nc, nf, 4, 2, 1, bn=False)],
                  [_block("conv", nf, nf * 2, 4, 2, 1)],
                  [_block("conv", nf * 2, nf * 4, 4, 2, 1)],
                  [_block("conv", nf * 4, nf * 8, 4, 2, 1)]]
        return stages, [_block("conv", nf * 8, nh, 4, 1, 0, act="tanh")]
    if archi == "vgg":
        stages = [[_c3(nc, nf), _c3(nf, nf)],
                  [POOL, _c3(nf, nf * 2), _c3(nf * 2, nf * 2)],
                  [POOL, _c3(nf * 2, nf * 4), _c3(nf * 4, nf * 4),
                   _c3(nf * 4, nf * 4)],
                  [POOL, _c3(nf * 4, nf * 8), _c3(nf * 8, nf * 8),
                   _c3(nf * 8, nf * 8)]]
        return stages, [POOL, _block("conv", nf * 8, nh, 4, 1, 0, act="tanh")]
    raise ValueError(f"no encoder {archi!r}")


def decoder_spec(archi, nc, n_in, nf, skip):
    m = 2 if skip else 1
    if archi == "dcgan":
        first = [_block("convt", n_in, nf * 8, 4, 1, 0)]
        stages = [[_block("convt", nf * 8 * m, nf * 4, 4, 2, 1)],
                  [_block("convt", nf * 4 * m, nf * 2, 4, 2, 1)],
                  [_block("convt", nf * 2 * m, nf, 4, 2, 1)],
                  [_block("convt", nf * m, nc, 4, 2, 1, act="none", bn=False)]]
        return first, stages
    if archi == "vgg":
        first = [_block("convt", n_in, nf * 8, 4, 1, 0), UP]
        stages = [[_c3(nf * 8 * m, nf * 8), _c3(nf * 8, nf * 8),
                   _c3(nf * 8, nf * 4), UP],
                  [_c3(nf * 4 * m, nf * 4), _c3(nf * 4, nf * 4),
                   _c3(nf * 4, nf * 2), UP],
                  [_c3(nf * 2 * m, nf * 2), _c3(nf * 2, nf), UP],
                  [_c3(nf * m, nf),
                   _block("convt", nf, nc, 3, 1, 1, act="none", bn=False)]]
        return first, stages
    raise ValueError(f"no decoder {archi!r}")


class Conv(nn.Module):
    """A bias-free conv or transposed conv; `weight` as torch stores it."""

    def __init__(self, kind, cin, cout, k, s, p):
        super().__init__()
        self.kind, self.stride, self.padding = kind, s, p
        shape = (cout, cin, k, k) if kind == "conv" else (cin, cout, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.quant = None

    def apply_w(self, x, w):
        if self.quant:
            x, w = qround(x, self.quant), qround(w, self.quant)
        if self.kind == "conv":
            y = F.conv2d(x, w, None, self.stride, self.padding)
        else:
            y = F.conv_transpose2d(x, w, None, self.stride, self.padding)
        # the output's gradient enters the backward products in e5m2
        return _GradRound.apply(y, self.quant) if self.quant else y

    def forward(self, x):
        return self.apply_w(x, self.weight)

    def skip_forward(self, x, skip, nt):
        """conv([x ; skip repeated over the nt frames of each video]),
        written as conv(x, W_x) + conv(skip, W_skip) per video."""
        cx = x.shape[1]
        w = self.weight
        wx, ws = (w[:, :cx], w[:, cx:]) if self.kind == "conv" else \
            (w[:cx], w[cx:])
        hx, hs = self.apply_w(x, wx), self.apply_w(skip, ws)
        bsz = hs.shape[0]
        return (hx.view((bsz, nt) + hx.shape[1:]) + hs[:, None]).view(
            hx.shape)


class Act(nn.Module):
    def __init__(self, name):
        super().__init__()
        self.name = name

    def forward(self, x):
        if self.name == "leaky_relu":
            return F.leaky_relu(x, 0.2)
        return torch.tanh(x)


class Pool(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x, 2)


class Up(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")


class Block(nn.Sequential):
    """conv -> [BN] -> [activation]; under the fp8 control each op's
    output is rounded to fp8, as the program's bf16 towers round each to
    bfloat16."""
    quant = None

    def forward(self, x):
        for m in self:
            x = m(x)
            if self.quant:
                x = qround(x, self.quant)
        return x


def _block_module(spec):
    kind, cin, cout, k, s, p, act, bn = spec
    conv = Conv(kind, cin, cout, k, s, p)
    if not bn and act == "none":
        return conv
    mods = [conv]
    if bn:
        mods.append(nn.BatchNorm2d(cout, eps=BN_EPS))
    if act != "none":
        mods.append(Act(act))
    return Block(*mods)


def _stage(ops):
    if len(ops) == 1 and ops[0][0] == "block":
        return _block_module(ops[0][1])
    return nn.Sequential(*[_block_module(spec) if op == "block"
                           else (Pool() if op == "pool" else Up())
                           for op, spec in ops])


def _first_conv(stage):
    mods = list(stage) if isinstance(stage, nn.Sequential) else [stage]
    if isinstance(mods[0], nn.Sequential):
        mods = list(mods[0]) + mods[1:]
    return mods[0], mods[1:]


class Encoder(nn.Module):
    def __init__(self, archi, nc, nh, nf):
        super().__init__()
        stages, last = encoder_spec(archi, nc, nh, nf)
        self.conv = nn.ModuleList([_stage(ops) for ops in stages])
        self.last_conv = _stage(last)
        self.nh = nh

    def forward(self, x):
        skips, h = [], x
        for stage in self.conv:
            h = stage(h)
            skips.append(h)
        return self.last_conv(h).reshape(-1, self.nh), skips[::-1]


class Decoder(nn.Module):
    quant = None

    def __init__(self, archi, nc, n_in, nf, skip):
        super().__init__()
        first, stages = decoder_spec(archi, nc, n_in, nf, skip)
        self.first_upconv = _stage(first)
        self.conv = nn.ModuleList([_stage(ops) for ops in stages])

    def forward(self, z, skips=None, nt=1):
        h = self.first_upconv(z.reshape(z.shape[0], z.shape[1], 1, 1))
        for i, stage in enumerate(self.conv):
            if skips is None:
                h = stage(h)
                continue
            conv, rest = _first_conv(stage)
            h = conv.skip_forward(h, skips[i], nt)
            for m in rest:
                h = m(h)
        out = torch.sigmoid(h)
        return qround(out, self.quant) if self.quant else out


# -- latent model -------------------------------------------------------------

class MLP(nn.Module):
    """ReLU before every linear map but the first."""

    def __init__(self, n_in, n_hid, n_out, n_layers):
        super().__init__()
        blocks = []
        for il in range(n_layers):
            d_in = n_in if il == 0 else n_hid
            d_out = n_out if il == n_layers - 1 else n_hid
            mods = ([] if il == 0 else [nn.ReLU()]) + [nn.Linear(d_in, d_out)]
            blocks.append(nn.Sequential(*mods))
        self.module = nn.Sequential(*blocks)

    def forward(self, x):
        return self.module(x)


class LSTM(nn.Module):
    """One-layer LSTM, gates (input, forget, cell, output), zero initial
    state, time-major, written out step by step."""

    def __init__(self, n_in, n_hid):
        super().__init__()
        self.n_hid = n_hid
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * n_hid, n_in))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * n_hid, n_hid))
        self.bias_ih_l0 = nn.Parameter(torch.empty(4 * n_hid))
        self.bias_hh_l0 = nn.Parameter(torch.empty(4 * n_hid))

    def forward(self, x):
        pre = F.linear(x, self.weight_ih_l0, self.bias_ih_l0)
        h = x.new_zeros(x.shape[1], self.n_hid)
        c = torch.zeros_like(h)
        out = []
        for t in range(x.shape[0]):
            g = pre[t] + F.linear(h, self.weight_hh_l0, self.bias_hh_l0)
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out)


def split_raw(raw):
    loc, raw_scale = raw.chunk(2, dim=-1)
    return loc, F.softplus(raw_scale) + EPS


def rsample(raw, eps):
    loc, scale = split_raw(raw)
    return loc + eps * scale


def kl_normal(loc_q, scale_q, loc_p, scale_p):
    ratio = (scale_q / scale_p) ** 2
    t1 = ((loc_q - loc_p) / scale_p) ** 2
    return 0.5 * (ratio + t1 - 1.0 - torch.log(ratio))


class SRVP(nn.Module):
    """cfg: a dict of the configuration's widths (configs/*.json)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.encoder = Encoder(c["archi"], c["nc"], c["nhx"], c["nf"])
        self.decoder = Decoder(c["archi"], c["nc"], c["nh_inf"] + c["ny"],
                               c["nf"], c["skipco"])
        self.w_proj = nn.Sequential(nn.Linear(c["nhx"], c["nh_inf"]),
                                    nn.ReLU())
        self.w_inf = nn.Sequential(nn.Linear(c["nh_inf"], c["nh_inf"]),
                                   nn.Tanh())
        self.q_y = MLP(c["nhx"] * c["nt_inf"], c["nh_inf"], c["ny"] * 2,
                       c["nlayers_inf"])
        self.inf_z = LSTM(c["nhx"], c["nh_inf"])
        self.q_z = nn.Linear(c["nh_inf"], c["nz"] * 2)
        self.p_z = MLP(c["ny"], c["nh_res"], c["nz"] * 2, c["nlayers_res"])
        self.dynamics = MLP(c["ny"] + c["nz"], c["nh_res"], c["ny"],
                            c["nlayers_res"])

    def set_quant(self, quant):
        """None (float32), "fp8" or "bf16" for every conv."""
        for m in self.modules():
            if isinstance(m, (Conv, Block, Decoder)):
                m.quant = quant
        return self

    def encode(self, x, skip_t=None):
        """x (T, B, H, W, C) -> (hx (T, B, nhx), skips or None). Skips come
        from frame skip_t[b] of each video in training, else the last."""
        nt, bsz = x.shape[:2]
        flat = x.transpose(0, 1).reshape((bsz * nt,) + x.shape[2:])
        h, skips = self.encoder(flat.permute(0, 3, 1, 2).contiguous())
        hx = h.reshape(bsz, nt, -1).transpose(0, 1)
        if not self.cfg["skipco"]:
            return hx, None
        if skip_t is None:
            return hx, [s[nt - 1::nt] for s in skips]
        rows = torch.arange(bsz, device=x.device) * nt + skip_t
        return hx, [s[rows] for s in skips]

    def decode(self, w, y, skips):
        """w (B, nh_inf), y (L, B, ny) -> frames (L, B, H, W, C)."""
        nt, bsz = y.shape[:2]
        y_flat = y.transpose(0, 1).reshape(bsz * nt, -1)
        w_flat = w[:, None].expand(bsz, nt, w.shape[-1]).reshape(bsz * nt, -1)
        out = self.decoder(torch.cat([w_flat, y_flat], -1), skips, nt)
        out = out.permute(0, 2, 3, 1)
        return out.reshape((bsz, nt) + out.shape[1:]).transpose(0, 1)

    def infer_w(self, hx, frame_idx=None):
        """Training reads frames frame_idx (nt_inf, B); otherwise the last
        nt_inf frames."""
        if frame_idx is None:
            h = hx[-self.cfg["nt_inf"]:]
        else:
            h = torch.gather(hx, 0, frame_idx[..., None].expand(
                -1, -1, hx.shape[2]))
        return self.w_inf(self.w_proj(h).sum(0))

    def infer_y(self, hx, eps_y):
        bsz = hx.shape[1]
        raw = self.q_y(hx[:self.cfg["nt_inf"]].permute(1, 0, 2).reshape(
            bsz, -1))
        return rsample(raw, eps_y), raw

    def rollout(self, y0, nt, o, eps, hx_z=None):
        """Euler rollout with o substeps a frame: z drawn at the first
        substep of each frame, from q(z | hx_z[t]) while t < len(hx_z),
        else from p(z | y); eps (o (nt - 1), B, nz), only the first substep
        of each frame read. Returns (y at every frame (nt, B, ny), q params,
        p params, residuals (o (nt - 1), B, ny))."""
        n_obs = 0 if hx_z is None else hx_z.shape[0]
        y, z = y0, None
        ys, res, qs, ps = [y0], [], [], []
        for k in range(1, o * (nt - 1) + 1):
            t = (k + o - 1) // o
            if (k - 1) % o == 0:
                p = self.p_z(y)
                ps.append(p)
                if t < n_obs:
                    q = self.q_z(hx_z[t])
                    qs.append(q)
                    z = rsample(q, eps[k - 1])
                else:
                    z = rsample(p, eps[k - 1])
            r = self.dynamics(torch.cat([y, z], -1)) / o
            y = y + r
            res.append(r)
            if k % o == 0:
                ys.append(y)
        stack = lambda v: torch.stack(v) if v else None  # noqa: E731
        return torch.stack(ys), stack(qs), stack(ps), torch.stack(res)


# -- the training objective ---------------------------------------------------

def training_draws(cfg, nt, bsz, o, generator, device):
    """The noise of one training step, drawn from `generator` with the
    calls, shapes and order of the port's training forward: skip frame
    (with skip connections), infer_w's frame keys, eps_y, then the
    posterior rollout's eps."""
    d = {}
    if cfg["skipco"]:
        d["skip_t"] = torch.randint(0, nt, (bsz,), generator=generator,
                                    device=device)
    keys = torch.rand((bsz, nt), generator=generator, device=device)
    d["frame_idx"] = keys.argsort(dim=1)[:, :cfg["nt_inf"]].T
    d["eps_y"] = torch.randn((bsz, cfg["ny"]), generator=generator,
                             device=device)
    d["eps_pos"] = torch.randn((o * (nt - 1), bsz, cfg["nz"]),
                               generator=generator, device=device)
    return d


def elbo(model, x, hp, draws):
    """The ELBO of the port's objectives.py over frames x (T, B, H, W, C)
    in [0, 1], in float32: (the loss, its reconstruction term and its
    KL_z term, each a video's, the reconstructed frames, and each video's
    own terms (B,) over the batch size, which sum to the loss)."""
    nt, bsz = x.shape[:2]
    o = hp["oversampling"]
    hx, skips = model.encode(x, draws.get("skip_t"))
    w = model.infer_w(hx, draws["frame_idx"])
    y0, q_y0 = model.infer_y(hx, draws["eps_y"])
    hx_z = model.inf_z(hx)
    ys, qs, ps, res = model.rollout(y0, nt, o, draws["eps_pos"], hx_z)
    x_ = model.decode(w, ys, skips)
    s = hp["obs_scale"]
    z = (x - x_) / s
    nll_el = 0.5 * z * z + math.log(s) + 0.5 * LOG_2PI
    loc, scale = split_raw(q_y0)
    kl_y_el = kl_normal(loc, scale, 0.0, 1.0)              # (B, ny)
    kl_z_el = kl_normal(*split_raw(qs), *split_raw(ps))    # (T', B, nz)
    l2_el = torch.linalg.vector_norm(res, dim=2)           # (T'', B)
    nll, kl_z = nll_el.sum(), kl_z_el.sum()
    loss = nll + hp["beta_y"] * kl_y_el.sum() + hp["beta_z"] * kl_z \
        + hp["l2_res"] * l2_el.sum()
    rows = nll_el.sum(dim=(0, 2, 3, 4)) + hp["beta_y"] * kl_y_el.sum(1) \
        + hp["beta_z"] * kl_z_el.sum(dim=(0, 2)) \
        + hp["l2_res"] * l2_el.sum(0)
    return loss / bsz, nll / bsz, kl_z / bsz, x_, rows / bsz


def composite(digits, pos, size):
    """Moving MNIST frames (T, B, size, size, 1) uint8 from digit images
    digits (B, D, h, w) uint8 placed with their top-left corners pos
    (B, D, T, 2) (row, column), summed and clamped at 255."""
    bsz, nd, h, w = digits.shape
    nt = pos.shape[2]
    dev = digits.device
    frames = torch.zeros(bsz, nt, size, size, dtype=torch.float32,
                         device=dev)
    r = pos[..., 0].long()[..., None, None] + torch.arange(
        h, device=dev)[:, None]
    c = pos[..., 1].long()[..., None, None] + torch.arange(
        w, device=dev)[None, :]
    r, c = torch.broadcast_tensors(r, c)           # (B, D, T, h, w)
    b = torch.arange(bsz, device=dev).view(bsz, 1, 1, 1, 1).expand_as(r)
    t = torch.arange(nt, device=dev).view(1, 1, nt, 1, 1).expand_as(r)
    vals = digits.float()[:, :, None].expand(bsz, nd, nt, h, w)
    keep = (r >= 0) & (r < size) & (c >= 0) & (c < size)
    frames.index_put_((b[keep], t[keep], r[keep], c[keep]), vals[keep],
                      accumulate=True)
    return frames.clamp(max=255).to(torch.uint8).transpose(0, 1)[..., None]
