"""The reference's best-of-N evaluation: the plain model samples, scores and
selects as the port's eval_lib.run_test does, on noise drawn from the same
generator in the same calls.

Per batch of B videos and each chunk of S samples (folded into the batch
video-major, row b*S + s): encode the conditioning frames, w from the last
nt_inf encodings, y_0 and the posterior rollout over the conditioning
frames (o_inf substeps a frame), the prior rollout of the predicted frames
(o_gen), decode, clip to [0, 1]; PSNR and SSIM per sample, the best of
each per video (strictly better replaces: the first sample wins ties).
"""

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.model import SRVP


def chunk_noise(cfg, bsz, n_samples, nt_cond, nt_test, o_inf, o_gen,
                generator, device):
    """(eps_y, eps_inf, eps_gen) of one chunk, drawn in that order."""
    rows = bsz * n_samples
    draw = lambda *shape: torch.randn(shape, generator=generator,  # noqa
                                      device=device)
    return (draw(rows, cfg["ny"]),
            draw(o_inf * (nt_cond - 1), rows, cfg["nz"]),
            draw(o_gen * (nt_test - nt_cond), rows, cfg["nz"]))


def psnr(pred, target):
    """(T, N, H, W, C) pairs -> PSNR per frame, video and channel."""
    d = pred - target
    return 10.0 * torch.log10(1.0 / (d * d).mean(dim=(2, 3)))


def ssim_window(size=11, sigma=1.5):
    """The port's SSIM window: a softmax over -(x^2 + y^2) / (2 sigma^2)."""
    c = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = -(c[None, :] ** 2 + c[:, None] ** 2) / (2.0 * sigma ** 2)
    e = np.exp(g - g.max())
    return (e / e.sum()).astype(np.float32)


def ssim(pred, target, k1=0.01, k2=0.03):
    """(T, N, H, W, C) pairs -> SSIM per frame, video and channel: the
    map of valid 11x11 windows averaged over the pixels."""
    t, n = pred.shape[:2]
    ch = pred.shape[-1]
    win = torch.from_numpy(ssim_window()).to(pred)
    win = win.expand(ch, 1, 11, 11).contiguous()
    x = pred.reshape((t * n,) + pred.shape[2:]).permute(0, 3, 1, 2)
    y = target.reshape((t * n,) + target.shape[2:]).permute(0, 3, 1, 2)
    conv = lambda a: F.conv2d(a, win, groups=ch)  # noqa: E731
    mu1, mu2 = conv(x), conv(y)
    s11 = conv(x * x) - mu1 * mu1
    s22 = conv(y * y) - mu2 * mu2
    s12 = conv(x * y) - mu1 * mu2
    c1, c2 = k1 ** 2, k2 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean(dim=(2, 3)).reshape(t, n, ch)


def sample_chunk(model, x_cond, nt_pred, o_inf, o_gen, eps, n_samples):
    """Frames (nt_pred, B*S, H, W, C) in [0, 1] of S samples of every
    video."""
    fold = lambda t, d: t.repeat_interleave(n_samples, dim=d)  # noqa: E731
    eps_y, eps_inf, eps_gen = eps
    hx, skips = model.encode(x_cond)
    w = model.infer_w(hx)
    hx_z = model.inf_z(hx)
    y0, _ = model.infer_y(fold(hx, 1), eps_y)
    nt_cond = x_cond.shape[0]
    y_inf, _, _, _ = model.rollout(y0, nt_cond, o_inf, eps_inf,
                                   fold(hx_z, 1))
    y_gen, _, _, _ = model.rollout(y_inf[-1], nt_pred + 1, o_gen, eps_gen)
    skips_f = None if skips is None else [fold(s, 0) for s in skips]
    return model.decode(fold(w, 0), y_gen[1:], skips_f).clamp(0.0, 1.0)


@torch.no_grad()
def best_of_n(model, x, nt_cond, chunk, o_inf, o_gen, noises):
    """One batch x (T, B, H, W, C) float32 in [0, 1]. noises: one
    chunk_noise tuple per chunk. Returns {"psnr", "ssim": best value per
    video (B,), "random_1": sample 0's frames (B, T_pred, H, W, C) uint8
    (truncated)}."""
    x_cond, x_target = x[:nt_cond], x[nt_cond:]
    bsz, t_pred = x.shape[1], x_target.shape[0]
    best = {"psnr": None, "ssim": None}
    first = None
    for c, eps in enumerate(noises):
        pred = sample_chunk(model, x_cond, t_pred, o_inf, o_gen, eps, chunk)
        tgt = x_target.repeat_interleave(chunk, dim=1)
        scores = {"psnr": psnr(pred, tgt).mean(2).mean(0),
                  "ssim": ssim(pred, tgt).mean(2).mean(0)}
        if c == 0:
            first = (pred[:, ::chunk] * 255.0).to(torch.uint8).transpose(0, 1)
        for name, v in scores.items():
            v = v.reshape(bsz, chunk)
            for s in range(chunk):
                cur = best[name]
                best[name] = v[:, s].clone() if cur is None else torch.where(
                    v[:, s] > cur, v[:, s], cur)
    return {"psnr": best["psnr"].cpu().numpy(),
            "ssim": best["ssim"].cpu().numpy(),
            "random_1": first.cpu().numpy()}


def reference_model(cfg, state, device, quant=None):
    model = SRVP(cfg).to(device)
    model.load_state_dict(state)
    return model.set_quant(quant).eval()
