"""Best/worst-of-N evaluation (counterpart of srvp_tpu/eval_lib.py).

Per batch of videos: encode the conditioning frames once, then N stochastic
rollouts in chunks; per sample PSNR and SSIM (and LPIPS when given) per
video; keep on the device the best and worst sample per metric and video
(strictly better replaces, so the first sample wins ties; LPIPS is better
lower, the others higher), the first five samples, and sample 0's
reconstruction of the conditioning frames. Only the selection goes to the
host.

Within a chunk of S samples the sample axis is folded into the batch,
video-major (row b*S + s). The inference rollout over the conditioning
frames uses the training Euler step count, the generation rollout the
evaluation one; the generation rollout is the pure-prior kernel
(kernels/rollout.py) unless `use_kernel_rollout` is False, in which case the
eager `SRVP.generate` loop runs on the same noise. Frames are encoded and
decoded in `compute_dtype` (the frames' own dtype, float32, by default, as
the evaluation CLI runs), the latent model in the frames' dtype; the
predictions are clipped and scored in float32.
"""

import time

import numpy as np
import torch

from srvp_tpu_torch.config import strict_fp32
from srvp_tpu_torch.metrics.pixel import frame_mse, psnr_from_mse
from srvp_tpu_torch.metrics.ssim import video_ssim
from srvp_tpu_torch.models.lstm import lstm_apply

LOWER_BETTER = {"lpips": True, "psnr": False, "ssim": False}


def chunk_noise(cfg, bsz, n_samples, nt_cond, nt_test, o_inf, o_gen,
                generator, device):
    """(eps_y, eps_inf, eps_gen) for one chunk, drawn in that order:
    (B*S, ny), (o_inf*(nt_cond-1), B*S, nz), (o_gen*(nt_test-nt_cond), B*S,
    nz)."""
    rows = bsz * n_samples
    draw = lambda *shape: torch.randn(shape, generator=generator,  # noqa: E731
                                      device=device)
    return (draw(rows, cfg.ny),
            draw(o_inf * (nt_cond - 1), rows, cfg.nz),
            draw(o_gen * (nt_test - nt_cond), rows, cfg.nz))


def _to_u8(x):
    """float [0, 1] (T, B, H, W, C) -> uint8 (B, T, H, W, C), truncating."""
    return (x * 255.0).to(torch.uint8).transpose(0, 1)


def fold(t, n_samples, dim):
    """Each video's entry repeated n_samples times, video-major."""
    return t.repeat_interleave(n_samples, dim=dim)


def sample_rollout(model, hx, hx_z, n_samples, nt_gen, o_inf, o_gen, eps,
                   use_kernel_rollout=True):
    """The latent states of n_samples samples of every video, folded into
    the batch video-major (row b*S + s): y_0 inferred from hx[:nt_inf], the
    posterior rollout over the nt_cond = hx.shape[0] conditioning frames,
    then the pure-prior rollout of nt_gen - 1 frames from its last state
    (kernel 1 unless use_kernel_rollout is off). hx: (nt_cond, B, nhx),
    hx_z its z-LSTM outputs; eps: chunk_noise(...). Returns (y_inf
    (nt_cond, B*S, ny), y_gen (nt_gen, B*S, ny)), y_gen[0] = y_inf[-1]."""
    eps_y, eps_inf, eps_gen = eps
    y_0, _ = model.infer_y(fold(hx, n_samples, 1)[:model.cfg.nt_inf], eps_y)
    gen_inf = model.generate(y_0, None, hx.shape[0], oversampling=o_inf,
                             eps_pos=eps_inf,
                             hx_z=fold(hx_z, n_samples, 1))
    if use_kernel_rollout:
        gen = model.generate_prior(gen_inf.y[-1], nt_gen, oversampling=o_gen,
                                   eps=eps_gen)
    else:
        gen = model.generate(gen_inf.y[-1], None, nt_gen, oversampling=o_gen,
                             eps_pri=eps_gen)
    return gen_inf.y, gen.y


def sample_latents(model, x_cond, n_samples, nt_gen, o_inf, o_gen, eps,
                   use_kernel_rollout=True, compute_dtype=None):
    """The conditioning work of a chunk, then its samples' latent states:
    encode x_cond (nt_cond, B, H, W, C) in compute_dtype (default: its
    own), w and the z-LSTM in x_cond's dtype, then sample_rollout. Returns
    (w (B, nh_inf) in compute_dtype, y_inf, y_gen as sample_rollout gives
    them, the encoder's skips or None). compute_chunk and the serving core
    (export.ServingModule, at S = 1) both run it."""
    compute_dtype = compute_dtype or x_cond.dtype
    hx, skips = model.encode(x_cond.to(compute_dtype))
    hx = hx.to(x_cond.dtype)
    w = model.infer_w(hx)
    hx_z = lstm_apply(model.inf_z, hx)
    y_inf, y_gen = sample_rollout(model, hx, hx_z, n_samples, nt_gen, o_inf,
                                  o_gen, eps, use_kernel_rollout)
    return w.to(compute_dtype), y_inf, y_gen, skips


@torch.no_grad()
def compute_chunk(model, x_cond, x_target, n_samples, o_inf, o_gen, eps,
                  use_kernel_rollout=True, compute_dtype=None, lpips_fn=None):
    """One chunk of S = n_samples samples for every video of the batch.

    x_cond: (nt_cond, B, H, W, C), x_target: (T_pred, B, H, W, C) in [0, 1];
    eps: chunk_noise(...); lpips_fn: metrics.lpips.make_video_lpips(...) or
    None. Returns (x_pred_u8 (S, B, T_pred, H, W, C), x_rec_u8 (B, nt_cond,
    H, W, C), {psnr, ssim[, lpips]: (S, B)}).
    """
    bsz = x_cond.shape[1]
    compute_dtype = compute_dtype or x_cond.dtype
    w_c, y_inf, y_gen, skips = sample_latents(
        model, x_cond, n_samples, x_target.shape[0] + 1, o_inf, o_gen, eps,
        use_kernel_rollout, compute_dtype)
    # conditioning reconstruction of sample 0 only: rows b*S + 0
    x_rec = model.decode(w_c, y_inf[:, ::n_samples].to(compute_dtype),
                         skips).float()
    skips_f = (None if skips is None
               else [fold(s, n_samples, 0) for s in skips])
    x_pred = model.decode(fold(w_c, n_samples, 0),
                          y_gen[1:].to(compute_dtype),
                          skips_f).float().clamp(0.0, 1.0)

    t_pred = x_pred.shape[0]
    x_target_f = fold(x_target, n_samples, 1)
    psnr = psnr_from_mse(frame_mse(x_pred, x_target_f)).mean(2).mean(0)
    ssim_v = video_ssim(x_pred, x_target_f).mean(2).mean(0)
    metrics = {"psnr": psnr.reshape(bsz, n_samples).T,
               "ssim": ssim_v.reshape(bsz, n_samples).T}
    if lpips_fn is not None:
        metrics["lpips"] = lpips_fn(x_pred, x_target_f).mean(0) \
            .reshape(bsz, n_samples).T
    x_pred_u8 = ((x_pred * 255.0).to(torch.uint8)
                 .reshape((t_pred, bsz, n_samples) + x_pred.shape[2:])
                 .permute(2, 1, 0, 3, 4, 5))
    return x_pred_u8, _to_u8(x_rec), metrics


def init_select_carry(metric_names, bsz, t_pred, t_cond, hw_c, n_random,
                      device):
    """Device state of the per-video selection."""
    u8 = lambda *shape: torch.zeros(shape, dtype=torch.uint8,  # noqa: E731
                                    device=device)
    carry = {"random": u8(n_random, bsz, t_pred, *hw_c),
             "rec": u8(bsz, t_cond, *hw_c)}
    for name in metric_names:
        sign = 1.0 if LOWER_BETTER[name] else -1.0
        carry[f"{name}_best_val"] = torch.full((bsz,), sign * np.inf,
                                               device=device)
        carry[f"{name}_worst_val"] = torch.full((bsz,), -sign * np.inf,
                                                device=device)
        carry[f"{name}_best_frm"] = u8(bsz, t_pred, *hw_c)
        carry[f"{name}_worst_frm"] = u8(bsz, t_pred, *hw_c)
    return carry


def select_update(carry, x_pred_u8, x_rec_u8, metrics, chunk_start):
    """Folds one chunk into the selection carry, sample by sample; strictly
    better replaces, so the first sample wins ties."""
    carry = dict(carry)
    if chunk_start == 0:
        carry["rec"] = x_rec_u8
    n_rand = carry["random"].shape[0]
    for s in range(x_pred_u8.shape[0]):
        gid = chunk_start + s
        frm = x_pred_u8[s]
        if gid < n_rand:
            carry["random"] = carry["random"].clone()
            carry["random"][gid] = frm
        for name, vals in metrics.items():
            v, best, worst = (vals[s], carry[f"{name}_best_val"],
                              carry[f"{name}_worst_val"])
            if LOWER_BETTER[name]:
                better, worse = v < best, v > worst
            else:
                better, worse = v > best, v < worst
            bmask = better.reshape((-1,) + (1,) * (frm.ndim - 1))
            wmask = worse.reshape((-1,) + (1,) * (frm.ndim - 1))
            carry[f"{name}_best_val"] = torch.where(
                better, v, carry[f"{name}_best_val"])
            carry[f"{name}_best_frm"] = torch.where(
                bmask, frm, carry[f"{name}_best_frm"])
            carry[f"{name}_worst_val"] = torch.where(
                worse, v, carry[f"{name}_worst_val"])
            carry[f"{name}_worst_frm"] = torch.where(
                wmask, frm, carry[f"{name}_worst_frm"])
    return carry


def select_chunk(carry, model, x_cond, x_target, n_samples, chunk_start,
                 o_inf, o_gen, eps, use_kernel_rollout=True,
                 compute_dtype=None, lpips_fn=None):
    """compute_chunk followed by select_update."""
    x_pred_u8, x_rec_u8, metrics = compute_chunk(
        model, x_cond, x_target, n_samples, o_inf, o_gen, eps,
        use_kernel_rollout=use_kernel_rollout, compute_dtype=compute_dtype,
        lpips_fn=lpips_fn)
    return select_update(carry, x_pred_u8, x_rec_u8, metrics, chunk_start)


def _host_u8(x):
    """float (T, B, H, W, C) numpy -> uint8 (B, T, H, W, C)."""
    return np.transpose((np.asarray(x) * 255.0).astype(np.uint8),
                        (1, 0, 2, 3, 4))


def run_test(model, batches, nt_cond, nt_test, n_samples, chunk, generator,
             o_inf, o_gen, pad_to=None, use_kernel_rollout=True,
             compute_dtype=None, lpips_fn=None):
    """Evaluation loop over host batches (T, B, H, W, C) float32 on one
    device (the model's). Ragged batches are edge-padded to `pad_to` videos
    and the padding is dropped on the host. With `lpips_fn` (on the model's
    device) LPIPS is a third metric.

    Returns (results {name: (N,) best value per video}, samples {artifact
    name: uint8 array}, cond, gt) like the JAX run_test_device, plus the
    wall-clock seconds of each batch.
    """
    strict_fp32()
    device = next(model.parameters()).device
    cfg = model.cfg
    chunk = min(chunk, n_samples)
    if n_samples % chunk:
        raise ValueError(f"samples_chunk {chunk} must divide n_samples "
                         f"{n_samples}")
    n_chunks = n_samples // chunk
    n_random = min(5, n_samples)
    t_pred = nt_test - nt_cond
    metric_names = ["psnr", "ssim"] + (["lpips"] if lpips_fn else [])
    random_samples = [[] for _ in range(n_random)]
    cond, cond_rec, gt, batch_seconds = [], [], [], []
    results = {name: [] for name in metric_names}
    best = {name: [] for name in metric_names}
    worst = {name: [] for name in metric_names}

    for b_idx, batch in enumerate(batches):
        t0 = time.perf_counter()
        x = np.asarray(batch)[:nt_test]
        real_bsz = bsz = x.shape[1]
        if pad_to is not None:
            if real_bsz > pad_to:
                raise ValueError(f"batch of {real_bsz} > pad_to {pad_to}")
            bsz = pad_to
            x = np.pad(x, ((0, 0), (0, bsz - real_bsz))
                       + ((0, 0),) * (x.ndim - 2), mode="edge")
        x_dev = torch.from_numpy(x).to(device)
        x_cond, x_target = x_dev[:nt_cond], x_dev[nt_cond:]
        cond.append(_host_u8(x[:nt_cond, :real_bsz]))
        gt.append(_host_u8(x[nt_cond:, :real_bsz]))

        carry = init_select_carry(metric_names, bsz, t_pred, nt_cond,
                                  x.shape[2:], n_random, device)
        for c in range(n_chunks):
            eps = chunk_noise(cfg, bsz, chunk, nt_cond, nt_test, o_inf, o_gen,
                              generator, device)
            carry = select_chunk(carry, model, x_cond, x_target, chunk,
                                 c * chunk, o_inf, o_gen, eps,
                                 use_kernel_rollout=use_kernel_rollout,
                                 compute_dtype=compute_dtype,
                                 lpips_fn=lpips_fn)
        carry = {k: v[:, :real_bsz] if k == "random" else v[:real_bsz]
                 for k, v in carry.items()}
        carry = {k: v.cpu().numpy() for k, v in carry.items()}
        cond_rec.append(carry["rec"])
        for r in range(n_random):
            random_samples[r].append(carry["random"][r])
        for name in metric_names:
            results[name].append(carry[f"{name}_best_val"])
            best[name].append(carry[f"{name}_best_frm"])
            worst[name].append(carry[f"{name}_worst_frm"])
        batch_seconds.append(time.perf_counter() - t0)
        print(f"  batch {b_idx + 1} done in {batch_seconds[-1]:.3f} s",
              flush=True)

    samples = {f"random_{i + 1}": np.concatenate(random_samples[i])
               for i in range(n_random)}
    samples["cond_rec"] = np.concatenate(cond_rec)
    for name in metric_names:
        samples[f"{name}_best"] = np.concatenate(best[name])
        samples[f"{name}_worst"] = np.concatenate(worst[name])
        results[name] = np.concatenate(results[name]).astype(np.float32)
    return results, samples, np.concatenate(cond), np.concatenate(gt), \
        batch_seconds
