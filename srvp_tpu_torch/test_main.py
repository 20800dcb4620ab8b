"""SRVP evaluation CLI on one GPU (counterpart of the repository's test.py).

Loads config.json and a checkpoint from --xp_dir (a JAX `model.npz`
snapshot, or a reference `.pt` state_dict), runs best/worst-of-N stochastic
prediction with PSNR and SSIM on the test fold of the config's dataset,
prints mean +/- 95% CI and writes `results.npz` and one `<name>.npz` per
artifact with the keys, dtypes and shapes test.py writes. The test folds,
read in order at nt_gen frames: Moving MNIST's
`{s}mmnist_test_{n}digits_{nx}.npz`, KTH's `svg_test_set_{nt_gen}.npz`,
Human3.6M's clips `test_set_{nt_gen}_{subsampling}/` (the config's
subsampling) and BAIR's `test` fold (PNG or packed tree), the last three
through the dataset classes (data/base.load_dataset), as test.py reads
them.

    python -m srvp_tpu_torch.test_main --xp_dir XP --data_dir DATA

LPIPS and FVD need pretrained weights that the repository does not hold yet;
their flags raise.
"""

import argparse
import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from srvp_tpu_torch.config import model_config, resolve_device
from srvp_tpu_torch.data.base import load_dataset
from srvp_tpu_torch.data.loader import dataset_batches
from srvp_tpu_torch.data.mmnist_test import iterate_batches, load_test_sequences
from srvp_tpu_torch.eval_lib import run_test
from srvp_tpu_torch.models.srvp import SRVP
from srvp_tpu_torch.utils.weights import load_checkpoint


def create_test_args():
    p = argparse.ArgumentParser(
        prog="Stochastic Latent Residual Video Prediction (testing, GPU)",
        description="Evaluates a trained SRVP model: PSNR and SSIM; saves "
                    "best/worst/random prediction npz artifacts.")
    p.add_argument("--xp_dir", type=str, metavar="DIR", required=True,
                   help="Directory with the model checkpoint and its "
                        "config.json.")
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True,
                   help="Directory where the dataset is saved.")
    p.add_argument("--lpips_dir", type=str, metavar="DIR", default=None,
                   help="Not supported yet (LPIPS weights are not in the "
                        "repository).")
    p.add_argument("--n_euler_steps", type=int, metavar="STEPS", default=None,
                   help="Euler steps per frame for prediction (default: "
                        "training value).")
    p.add_argument("--nt_cond", type=int, metavar="COND", default=None,
                   help="Number of conditioning frames.")
    p.add_argument("--nt_gen", type=int, metavar="GEN", default=None,
                   help="Total number of frames (conditioning + predicted). "
                        "Defaults to the config's seq_len_test, else 25.")
    p.add_argument("--batch_size", type=int, metavar="BATCH", default=16,
                   help="Batch size used to compute metrics.")
    p.add_argument("--n_samples", type=int, metavar="NB_SAMPLES", default=100,
                   help="Number of predictions per sequence for best-of-N "
                        "metrics.")
    p.add_argument("--model_name", type=str, metavar="FILE",
                   default="model.npz",
                   help="Checkpoint file in xp_dir (.npz JAX snapshot, .pt "
                        "reference state_dict).")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path.")
    p.add_argument("--n_devices", type=int, metavar="NB", default=None,
                   help="Only 1 is supported: evaluation runs on one card.")
    p.add_argument("--fvd", action="store_true",
                   help="Not supported yet (I3D weights are not in the "
                        "repository).")
    p.add_argument("--test_seed", type=int, metavar="SEED", default=1,
                   help="Seed of the sampling generator.")
    p.add_argument("--samples_chunk", type=int, metavar="NB", default=10,
                   help="Samples evaluated per chunk.")
    p.add_argument("--fused_rollout", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="Prior rollout through the rollout kernel (auto/on) "
                        "or the eager per-step loop (off).")
    return p


def resolve_nt_test(opt, xp_config):
    """CLI --nt_gen > config seq_len_test > 25."""
    nt_test = opt.nt_gen if opt.nt_gen is not None else \
        xp_config.get("seq_len_test")
    return 25 if nt_test is None else nt_test


def main(opt):
    """Runs the evaluation; returns the per-batch wall-clock seconds."""
    if opt.lpips_dir:
        raise NotImplementedError(
            "LPIPS is not ported yet: its weights are not in the repository")
    if opt.fvd:
        raise NotImplementedError(
            "FVD is not ported yet: the I3D weights are not in the repository")
    if opt.n_devices not in (None, 1):
        raise ValueError("--n_devices: evaluation runs on one card")
    device = resolve_device(opt.device)
    with open(os.path.join(opt.xp_dir, "config.json")) as f:
        xp_config = json.load(f)
    nt_cond = opt.nt_cond if opt.nt_cond is not None else xp_config["nt_cond"]
    nt_test = resolve_nt_test(opt, xp_config)
    o_inf = xp_config["n_euler_steps"]
    o_gen = opt.n_euler_steps if opt.n_euler_steps is not None else o_inf

    print("Loading data...")
    if xp_config["dataset"] == "smmnist":
        batches = iterate_batches(
            load_test_sequences(opt.data_dir, xp_config["nx"],
                                xp_config["ndigits"],
                                xp_config["deterministic"]), opt.batch_size)
    else:
        testset = load_dataset(SimpleNamespace(
            **{**xp_config, "data_dir": opt.data_dir, "seq_len": nt_test}),
            train=False)
        batches = dataset_batches(testset, opt.batch_size)

    print("Loading model...")
    cfg = model_config(xp_config)
    model = load_checkpoint(SRVP(cfg),
                            os.path.join(opt.xp_dir, opt.model_name))
    model = model.to(device).eval()

    print("Evaluation...")
    generator = torch.Generator(device=device)
    generator.manual_seed(opt.test_seed)
    results, samples, _, _, batch_seconds = run_test(
        model, batches, nt_cond, nt_test,
        opt.n_samples, opt.samples_chunk, generator, o_inf, o_gen,
        pad_to=opt.batch_size, use_kernel_rollout=opt.fused_rollout != "off")

    print("\n")
    print("Results:")
    for name, res in results.items():
        print(name, res.mean(), "+/-", 1.960 * res.std() / np.sqrt(len(res)))
    np.savez_compressed(os.path.join(opt.xp_dir, "results.npz"), **results)
    for name, res in samples.items():
        np.savez_compressed(os.path.join(opt.xp_dir, f"{name}.npz"),
                            samples=res)
    return batch_seconds


if __name__ == "__main__":
    main(create_test_args().parse_args())
