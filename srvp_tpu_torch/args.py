"""Training CLI flags (counterpart of srvp_tpu/args.py): every flag of the
JAX trainer with its name, type, default and `required`, `--config FILE`
included, plus `--fused_rollout`. `--device` is the torch device here (the
JAX package's `--device` is a list of ints that it ignores). `--n_dcn`, the
JAX package's 2-D mesh, is accepted and, set away from 1, rejected by
`check_ported` with its reason (parallel/mesh.check_dcn). The mixed
precision flags are the JAX trainer's: `--precision bfloat16`,
`--torch_amp` and `--apex_amp` select bfloat16 compute (`compute_dtype`),
and the apex options are accepted and ignored."""

import torch

from srvp_tpu_torch import configlib
from srvp_tpu_torch.parallel import mesh

ARCH_TYPES = ["dcgan", "vgg"]
DATASETS = ["smmnist", "kth", "human", "bair"]
PRECISIONS = ["float32", "bfloat16"]


def _nonneg_int(value):
    i = int(value)
    if i < 0:
        raise ValueError(f"must be >= 0, got {value}")
    return i


def create_args():
    p = configlib.ArgumentParser(
        prog="Stochastic Latent Residual Video Prediction (training, GPU)",
        description="Trains SRVP on one GPU or several (PyTorch/CUDA).")
    p.add_argument("--seed", type=int, metavar="SEED", default=None,
                   help="Manual seed. If None, it is chosen randomly.")
    p.add_argument("--save_path", type=str, metavar="PATH", required=True,
                   help="Path where models should be saved.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path.")
    p.add_argument("--fused_rollout", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="Training rollout through its CUDA kernels "
                        "(auto/on) or the eager per-step loop (off).")

    amp_p = p.add_argument_group(
        "Mixed precision",
        "bfloat16 compute of the conv encoder and decoder; the legacy "
        "torch/apex flags select it. No loss scaling.")
    amp_p.add_argument("--precision", type=str, default="float32",
                       choices=PRECISIONS,
                       help="Compute dtype for conv encoder/decoder "
                            "(latents stay fp32).")
    amp = amp_p.add_mutually_exclusive_group()
    amp.add_argument("--torch_amp", action="store_true",
                     help="Legacy alias: enables bfloat16 compute.")
    amp.add_argument("--apex_amp", action="store_true",
                     help="Legacy alias: enables bfloat16 compute.")
    amp_p.add_argument("--amp_opt_lvl", type=str, metavar="OPT_LVL",
                       default="O1", choices=["O0", "O1", "O2", "O3"],
                       help="Accepted for compatibility; ignored.")
    amp_p.add_argument("--keep_batchnorm_fp32", action="store_true",
                       default=None,
                       help="Accepted for compatibility; BN statistics are "
                            "always fp32.")
    amp_p.add_argument("--apex_verbose", action="store_true",
                       help="Accepted for compatibility; ignored.")

    g = p.add_argument_group(
        "Several cards",
        "Data parallelism, one process a card (parallel/): the global "
        "batch split over the ranks, global batch statistics, gradients "
        "averaged; rank 0 writes.")
    g.add_argument("--n_devices", type=int, metavar="NB", default=None,
                   help="Ranks: without --coordinator_address the trainer "
                        "starts NB local ranks itself (rank r on cuda:r).")
    g.add_argument("--local_rank", type=int, metavar="RANK", default=0,
                   help="This rank's card on its host: --device cuda is "
                        "cuda:<local_rank>.")
    g.add_argument("--n_dcn", type=int, metavar="NB", default=1,
                   help="The JAX package's multi-slice mesh; only 1: NCCL "
                        "has no such axis.")
    g.add_argument("--coordinator_address", type=str, metavar="ADDR",
                   default=None,
                   help="Join a process group: host:port with "
                        "--num_processes and --process_id, or 'auto' to "
                        "read torchrun's environment.")
    g.add_argument("--num_processes", type=int, metavar="NB", default=None,
                   help="Ranks of the group of an explicit "
                        "--coordinator_address.")
    g.add_argument("--process_id", type=int, metavar="RANK", default=None,
                   help="This process's rank (0..num_processes-1) for an "
                        "explicit --coordinator_address.")

    r = p.add_argument_group("Run control")
    r.add_argument("--steps_per_dispatch", type=int, metavar="K", default=1,
                   help="Run K optimization steps per dispatch (on the "
                        "card one replay of a CUDA graph of K steps over "
                        "K stacked batches): the steps of K = 1, bit for "
                        "bit. Must divide the log/val/chkpt intervals.")
    r.add_argument("--n_workers", type=int, metavar="NB", default=4,
                   help="Loader threads (the batches do not depend on "
                        "them).")
    r.add_argument("--profile_dir", type=str, metavar="DIR", default=None,
                   help="Write a torch.profiler trace of steps 10-15 to "
                        "DIR, with the program's srvp.* spans of the "
                        "main thread.")
    r.add_argument("--resume", action="store_true",
                   help="Continue from the train state in save_path (same "
                        "--seed for the same data stream).")
    r.add_argument("--no_device_compose", action="store_true",
                   help="Moving MNIST: composite frames on the host, not "
                        "on the device.")

    m = p.add_argument_group("Model Configuration")
    m.add_argument("--nhx", type=int, metavar="SIZE", default=128,
                   help="Size of vectors encoding frames.")
    m.add_argument("--ny", type=int, metavar="SIZE", required=True,
                   help="Size of the state-space variable (y).")
    m.add_argument("--nz", type=int, metavar="SIZE", required=True,
                   help="Size of the auxiliary random variable (z).")
    m.add_argument("--n_euler_steps", type=int, metavar="STEPS", default=1,
                   help="Euler steps per frame in training and validation.")
    m.add_argument("--nt_inf", type=int, metavar="STEPS", required=True,
                   help="Number of time steps used to infer y at t = 1.")
    m.add_argument("--obs_scale", type=float, metavar="VAR", default=1,
                   help="Standard deviation of the observation model.")
    m.add_argument("--archi", type=str, metavar="ARCH", default="dcgan",
                   choices=ARCH_TYPES, help="Encoder and decoder "
                   "architecture.")
    m.add_argument("--skipco", action="store_true",
                   help="Skip connections from encoders to decoders.")
    m.add_argument("--nf", type=int, metavar="FILTERS", default=64,
                   help="Filters of the first encoder and last decoder "
                        "layers.")
    m.add_argument("--nh_res", type=int, metavar="SIZE", default=512,
                   help="Hidden size of the temporal model.")
    m.add_argument("--nlayers_res", type=int, metavar="NB", default=4,
                   help="Layers of the temporal model.")
    m.add_argument("--nh_inf", type=int, metavar="SIZE", default=256,
                   help="Hidden size of the inference networks.")
    m.add_argument("--nlayers_inf", type=int, metavar="NB", default=3,
                   help="Layers of the inference networks.")
    m.add_argument("--res_gain", type=float, metavar="GAIN", default=1.41,
                   help="Initialisation gain of the temporal model.")

    o = p.add_argument_group("Optimization Configuration")
    o.add_argument("--beta_y", type=float, metavar="BETA", default=1,
                   help="Weight of the KL term of y_1.")
    o.add_argument("--beta_z", type=float, metavar="BETA", default=1,
                   help="Weight of the KL term of z.")
    o.add_argument("--l2_res", type=float, metavar="LAMBDA", default=1,
                   help="Weight of the L2 regularisation of residuals.")
    o.add_argument("--batch_size", type=int, metavar="SIZE", default=128,
                   help="Training batch size.")
    o.add_argument("--lr", type=float, metavar="LR", default=0.0003,
                   help="Learning rate of the Adam optimizer.")
    o.add_argument("--lr_scheduling_burnin", type=int, metavar="STEPS",
                   default=1000000,
                   help="Optimisation steps before the lr decays.")
    o.add_argument("--lr_scheduling_n_iter", type=int, metavar="STEPS",
                   default=100000, help="Steps of the linear lr decay.")

    d = p.add_argument_group("Dataset")
    d.add_argument("--dataset", type=str, metavar="DATASET", required=True,
                   choices=DATASETS,
                   help="Dataset name.")
    d.add_argument("--data_dir", type=str, metavar="DIR", required=True,
                   help="Data directory.")
    d.add_argument("--seq_len", type=int, metavar="LEN", required=True,
                   help="Length of training sequences.")
    d.add_argument("--ndigits", type=int, metavar="DIGITS", default=2,
                   help="Moving MNIST: number of digits.")
    d.add_argument("--max_speed", type=int, metavar="SPEED", default=4,
                   help="Moving MNIST: maximum digit speed.")
    d.add_argument("--deterministic", action="store_true",
                   help="Moving MNIST: deterministic bounces.")
    d.add_argument("--subsampling", type=int, default=8,
                   help="Human3.6M only: video sampling rate.")
    d.add_argument("--nx", type=int, metavar="SIZE", default=64,
                   help="Frame size (width and height).")
    d.add_argument("--nc", type=int, metavar="CHANNELS", required=True,
                   help="Number of color channels.")
    d.add_argument("--allow_synthetic", action="store_true",
                   help="Moving MNIST: procedural digits when the MNIST "
                        "archive is absent (smoke tests only).")

    e = p.add_argument_group("Evaluation and logging")
    e.add_argument("--n_iter", type=int, metavar="STEPS", default=None,
                   help="Optimisation steps (default: burn-in + decay).")
    e.add_argument("--log_interval", type=int, metavar="STEPS", default=100,
                   help="Steps between metric log lines.")
    e.add_argument("--val_interval", type=int, metavar="STEPS",
                   default=20000,
                   help="Steps between validations / best-model saves.")
    e.add_argument("--chkpt_interval", type=int, metavar="STEPS",
                   default=None,
                   help="If set, save the model every given steps.")
    e.add_argument("--keep_chkpt", type=_nonneg_int, metavar="N",
                   default=None,
                   help="If set, keep only the N most recent "
                        "model_<step>.pt snapshots.")
    e.add_argument("--batch_size_test", type=int, metavar="SIZE", default=16,
                   help="Validation batch size.")
    e.add_argument("--n_iter_test", type=int, metavar="STEPS", default=25,
                   help="Batches per validation.")
    e.add_argument("--nt_cond", type=int, metavar="STEPS", required=True,
                   help="Conditioning frames at test time (>= nt_inf).")
    e.add_argument("--n_samples_test", type=int, metavar="NB", default=100,
                   help="Predictions per video during validation.")
    e.add_argument("--val_samples_chunk", type=int, metavar="NB", default=25,
                   help="Validation samples folded into one batch.")
    e.add_argument("--seq_len_test", type=int, metavar="LEN", default=None,
                   help="Length of validation sequences (default: "
                        "seq_len).")
    return p


def check_ported(opt):
    """Raises ValueError, with its reason, for `--n_dcn` other than 1: the
    one flag of the JAX trainer that has no meaning on GPUs."""
    mesh.check_dcn(opt.n_dcn)


def compute_dtype(opt):
    """The encoder's and decoder's dtype that the flags select
    (srvp_tpu/train_main.py `train_hparams`)."""
    bf16 = opt.precision == "bfloat16" or opt.torch_amp or opt.apex_amp
    return torch.bfloat16 if bf16 else torch.float32
