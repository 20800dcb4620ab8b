"""SRVP training CLI on one GPU (counterpart of srvp_tpu/train_main.py and
the repository's train.py).

    python -m srvp_tpu_torch.train_main --dataset smmnist --data_dir DATA \
        --save_path XP --nc 1 --ny 20 --nz 20 --nt_inf 5 --seq_len 15 \
        --nt_cond 5 [--allow_synthetic] [--device cpu]

Trains on Stochastic Moving MNIST generated on the fly (digits and
trajectories on the host, frames composited on the device) or on KTH
(windows of a packed video tree, data/kth.py), with the dcgan or vgg
encoder and decoder; the training rollout goes through its CUDA kernels
unless `--fused_rollout off`, and the vgg pools and upsamples always do.
Logs loss, nll, kl_y_0, kl_z, lr and frames/s every `--log_interval` steps
(printed, and appended to XP/metrics.jsonl), validates best-of-N prediction
PSNR every `--val_interval` steps (saving XP/model_best.pt on improvement),
saves XP/model_<step>.pt every `--chkpt_interval` steps (keeping the
`--keep_chkpt` newest) and XP/model.pt at the end, beside XP/config.json;
`--config FILE` (configs/*.yaml) sets the flags' defaults;
`--precision bfloat16` (or `--torch_amp`, `--apex_amp`) runs the encoder
and decoder in bfloat16, the latent model and the loss in float32. The `.pt`
files are float32 state_dicts in the reference key names: `test_main
--model_name model.pt` evaluates them. Not ported yet (ROADMAP.md): resume,
dispatch windows, several GPUs, Human3.6M and BAIR, KTH's PNG tree.
"""

import json
import os
import random
import time

import torch

from srvp_tpu_torch import train_lib
from srvp_tpu_torch.args import check_ported, compute_dtype, create_args
from srvp_tpu_torch.config import model_config, resolve_device, strict_fp32
from srvp_tpu_torch.data.base import collate_uint8, load_dataset
from srvp_tpu_torch.data.device_compose import parts_collate, to_device
from srvp_tpu_torch.data.loader import DataLoader, PartsView, infinite_batches
from srvp_tpu_torch.utils import checkpoint as ckpt


def train_hparams(opt):
    return train_lib.TrainHParams(
        oversampling=opt.n_euler_steps, obs_scale=opt.obs_scale,
        beta_y=opt.beta_y, beta_z=opt.beta_z, l2_res=opt.l2_res, lr=opt.lr,
        lr_burnin=opt.lr_scheduling_burnin,
        lr_decay_iter=opt.lr_scheduling_n_iter, nt_cond=opt.nt_cond,
        n_samples_test=opt.n_samples_test,
        val_samples_chunk=opt.val_samples_chunk,
        compute_dtype=compute_dtype(opt),
        use_kernel=opt.fused_rollout != "off")


def loaders(opt):
    """(train, val) loaders of the dataset's folds, validation at
    seq_len_test. Moving MNIST training batches are digits and trajectories
    (composited on the device), the others whole uint8 frames."""
    dataset = load_dataset(opt)
    trainset, valset = dataset.get_fold("train"), dataset.get_fold("val")
    if opt.seq_len_test is not None:
        valset.change_seq_len(opt.seq_len_test)
    if opt.dataset == "smmnist":
        train = DataLoader(PartsView(trainset), opt.batch_size, seed=opt.seed,
                           collate_fn=parts_collate)
    else:
        train = DataLoader(trainset, opt.batch_size, seed=opt.seed,
                           collate_fn=collate_uint8)
    val = DataLoader(valset, opt.batch_size_test, seed=opt.seed + 1,
                     collate_fn=collate_uint8)
    return train, val


def main(opt):
    """Trains; returns the logged metrics, one dict per log line."""
    check_ported(opt)
    device = resolve_device(opt.device)
    if opt.seed is None:
        opt.seed = random.randint(1, 10000)
    strict_fp32()
    print(f"Learning on {device} (seed: {opt.seed}, compute dtype "
          f"{str(compute_dtype(opt)).split('.')[-1]})", flush=True)

    print("Loading data...", flush=True)
    train_loader, val_loader = loaders(opt)

    print("Building model...", flush=True)
    cfg = model_config(vars(opt))
    hp = train_hparams(opt)
    opt.n_iter = opt.n_iter or (opt.lr_scheduling_burnin
                                + opt.lr_scheduling_n_iter)
    torch.manual_seed(opt.seed)
    ts = train_lib.init_train_state(cfg, hp, device, res_gain=opt.res_gain)
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    eval_batch = train_lib.make_eval_batch(
        cfg, hp, nt=opt.seq_len_test or opt.seq_len)
    os.makedirs(opt.save_path, exist_ok=True)
    ckpt.save_config(opt.save_path, vars(opt))
    log_path = os.path.join(opt.save_path, "metrics.jsonl")
    open(log_path, "w").close()

    history = []
    val_metric = best_val_metric = None
    frames_per_batch = opt.seq_len * opt.batch_size
    t_last, itr_last = time.perf_counter(), 0
    for itr, batch in enumerate(infinite_batches(train_loader), 1):
        if itr > opt.n_iter:
            break
        metrics = train_lib.train_step(ts, to_device(batch, device), hp,
                                       generator=generator)

        if itr % opt.log_interval == 0:
            m = {k: float(v) for k, v in metrics.items()}   # synchronises
            now = time.perf_counter()
            m["fps"] = frames_per_batch * (itr - itr_last) / (now - t_last)
            t_last, itr_last = now, itr
            print(f"[{itr}/{opt.n_iter}] loss={m['loss']:.4f} "
                  f"nll={m['nll']:.4f} kl_y_0={m['kl_y_0']:.4f} "
                  f"kl_z={m['kl_z']:.4f} lr={m['lr']:.2e} "
                  f"fps={m['fps']:.0f} val={val_metric} "
                  f"best={best_val_metric}", flush=True)
            history.append(dict(itr=itr, **m))
            with open(log_path, "a") as f:
                f.write(json.dumps(history[-1]) + "\n")

        if itr % opt.val_interval == 0:
            val_gen = torch.Generator(device=device).manual_seed(
                opt.seed + 123 + itr)
            val_metric = train_lib.evaluate(eval_batch, ts.model,
                                            iter(val_loader),
                                            opt.n_iter_test, val_gen, device)
            print(f"[{itr}] val_metric (-PSNR): {val_metric:.4f}",
                  flush=True)
            if best_val_metric is None or val_metric < best_val_metric:
                best_val_metric = val_metric
                ckpt.save_model(opt.save_path, "model_best", ts.model)
            t_last = time.perf_counter()

        if opt.chkpt_interval and itr % opt.chkpt_interval == 0:
            ckpt.save_model(opt.save_path, f"model_{itr}", ts.model)
            ckpt.prune_periodic(opt.save_path, opt.keep_chkpt)

    print("Saving...", flush=True)
    ckpt.save_model(opt.save_path, "model", ts.model)
    print("Done", flush=True)
    return history


if __name__ == "__main__":
    main(create_args().parse_args())
