"""Serving export: a trained SRVP predictor as one self-contained artifact
(counterpart of srvp_tpu/export.py).

The generation program is traced once by `torch.export` with the weights
inside it and written as one file that `load_serving` runs without the
model code, the checkpoint or a re-trace:

  * self-contained: one file holds the program, the weights and the shape
    contract;
  * batch-polymorphic: exported with a symbolic batch dimension, so one
    artifact serves any request batch up to the header's max_batch (or
    pinned to one batch);
  * on the card and on the CPU: the rollout (kernel 1) and, at vgg, the
    pools and upsamples (kernels 4 and 6) are the custom ops
    `srvp::prior_rollout`, `srvp::max_pool2x2` and `srvp::upsample2x`
    (kernels/ops.py), single nodes of the program whose implementation
    is chosen where it runs: the kernels on the card, the plain versions
    on the CPU. `load_serving` moves the program to the device asked for.

The archive holds the program as `torch.export.export` gives it, not
after `run_decompositions()`: decomposing would replace ATen ops such as
the convolutions, batch norm and the LSTM by others, which round
differently from the live model, and an artifact must give the live
serving core's bits on the device it runs on.

Serving call contract (uint8 in, uint8 out):

    frames = f(x_cond, seed)
      x_cond: uint8 (nt_cond, B, H, W, C) conditioning frames
      seed:   int64 scalar tensor; the noise is drawn from it inside the
              program (ops/counter_rng.py), independent per batch row
      frames: uint8 (nt_gen, B, H, W, C), the reconstructed conditioning
              frames and the prediction, the reference protocol's frame
              indexing; round(clip(x, 0, 1) * 255).

File format: 8-byte magic 'SRVPTEX1' | u32 header length | JSON header
(the keys of the JAX package's header) | the `torch.export.save` archive.

    python -m srvp_tpu_torch.export --xp_dir XP \
        [--model_name model_best.npz|model.pt] [--nt_cond 5] [--nt_gen 25] \
        [--n_euler_steps O] [--platforms cuda cpu] [--batch_size N] \
        [--out serving.srvptex] [--selfcheck] [--device cuda|cpu]

--selfcheck reloads the written artifact and runs one batch on --device.
"""

import argparse
import copy
import io
import json
import os
import struct
import time
import warnings

import torch
import torch.nn as nn

from srvp_tpu_torch.config import cudnn_deterministic, no_tf32, resolve_device
from srvp_tpu_torch.utils import trace

MAGIC = b"SRVPTEX1"
FORMAT = "srvp-tpu-torch serving export v1"
PLATFORMS = ("cuda", "cpu")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the example batch a symbolic batch is traced at (not 0 or 1, which
# torch.export would take as special values)
EXAMPLE_BATCH = 2


class ServingModule(nn.Module):
    """The generation program of one sample, in eval mode, as
    eval_lib.compute_chunk runs it at S = 1 (eval_lib.sample_latents:
    encode, w, the z-LSTM, the posterior rollout over the conditioning
    frames and the prior rollout, kernel 1, with o_inf = o_gen =
    oversampling), then one decode of the nt_gen frames in compute_dtype.

    `forward(x_cond, seed)` is the serving call (module docstring);
    `serve_with_noise(x_u8, eps)` the same on given noise (`noise`'s three
    tensors, or eval_lib.chunk_noise's at S = 1); `predict` gives the
    frames before quantisation, and `latents` / `decode_frames` its two
    halves (swap.py decodes other pairs of them)."""

    def __init__(self, model, nt_gen, oversampling=1,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.model = model
        self.nt_gen = int(nt_gen)
        self.oversampling = int(oversampling)
        self.compute_dtype = compute_dtype

    def noise(self, seed, bsz, nt_cond):
        """(eps_y, eps_inf, eps_gen) for a batch of bsz from an int64 seed
        tensor (counter_rng.serving_noise)."""
        from srvp_tpu_torch.ops.counter_rng import serving_noise
        cfg, o = self.model.cfg, self.oversampling
        return serving_noise(seed, bsz, cfg.ny, cfg.nz, nt_cond, self.nt_gen,
                             o, o, seed.device)

    def latents(self, x_u8, eps, use_kernel_rollout=True):
        """x_u8: uint8 (nt_cond, B, H, W, C). Returns (w (B, nh_inf) in
        compute_dtype, y (nt_gen, B, ny) float32, skips or None); the
        prior rollout is kernel 1 unless use_kernel_rollout is off
        (eval_lib.sample_rollout)."""
        from srvp_tpu_torch.eval_lib import sample_latents
        o = self.oversampling
        x = x_u8.to(torch.float32) / 255.0
        w, y_inf, y_gen, skips = sample_latents(
            self.model, x, 1, self.nt_gen - x.shape[0] + 1, o, o, eps,
            use_kernel_rollout, self.compute_dtype)
        return w, torch.cat([y_inf, y_gen[1:]]), skips

    def decode_frames(self, w, y, skips):
        """Frames (L, B, H, W, C) float32 in [0, 1] of (w, y) pairs."""
        x_ = self.model.decode(w, y.to(self.compute_dtype), skips)
        return x_.to(torch.float32).clamp(0.0, 1.0)

    def predict(self, x_u8, eps, use_kernel_rollout=True):
        """The nt_gen frames before quantisation, float32 in [0, 1]."""
        return self.decode_frames(*self.latents(x_u8, eps,
                                                use_kernel_rollout))

    def serve_with_noise(self, x_u8, eps):
        return torch.round(self.predict(x_u8, eps) * 255.0).to(torch.uint8)

    def forward(self, x_cond, seed):
        return self.serve_with_noise(
            x_cond, self.noise(seed, x_cond.shape[1], x_cond.shape[0]))


def make_serving_fn(cfg, model, nt_gen, *, oversampling=1,
                    compute_dtype=torch.bfloat16):
    """The serving program of `model` (a copy of it in eval mode, which
    the program holds): a ServingModule. cfg must be the model's."""
    if cfg != model.cfg:
        raise ValueError(f"make_serving_fn: cfg {cfg} is not the model's "
                         f"{model.cfg}")
    model = copy.deepcopy(model).eval().requires_grad_(False)
    # a copy's LSTM weights are no longer one cuDNN buffer
    model.inf_z.flatten_parameters()
    return ServingModule(model, nt_gen, oversampling, compute_dtype).eval()


def dtype_name(dtype):
    return {v: k for k, v in DTYPES.items()}[dtype]


def export_serving(cfg, model, nt_cond, nt_gen, *, oversampling=1,
                   compute_dtype=torch.bfloat16, platforms=PLATFORMS,
                   batch_size=None):
    """The serving program of `model` as an artifact (bytes), traced on
    the model's device.

    batch_size=None exports a symbolic batch dimension, whose upper bound
    (if the trace finds one) the header gives as max_batch; an int pins
    it."""
    unknown = set(platforms) - set(PLATFORMS)
    if unknown:
        raise ValueError(f"platforms {sorted(unknown)}: the port serves on "
                         f"{list(PLATFORMS)}")
    from srvp_tpu_torch.kernels import ops  # noqa: F401  (the srvp ops)
    serve = make_serving_fn(cfg, model, nt_gen, oversampling=oversampling,
                            compute_dtype=compute_dtype)
    device = next(model.parameters()).device
    bsz = EXAMPLE_BATCH if batch_size is None else int(batch_size)
    x = torch.zeros((nt_cond, bsz, cfg.nx, cfg.nx, cfg.nc),
                    dtype=torch.uint8, device=device)
    seed = torch.zeros((), dtype=torch.int64, device=device)
    dynamic = None
    if batch_size is None:
        # the batch's upper bound is the trace's to find: on the card some
        # ops guard their sizes (32-bit indexing), which refines it
        dynamic = {"x_cond": {1: torch.export.Dim.DYNAMIC}, "seed": None}
    with torch.no_grad(), warnings.catch_warnings():
        # nn.LSTM re-points its _flat_weights list at the traced
        # parameters; the program reads the parameters themselves
        warnings.filterwarnings("ignore", message="The tensor attributes "
                                r"\S*_flat_weights")
        ep = torch.export.export(serve, (x, seed), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    header = {
        "format": FORMAT,
        "nt_cond": int(nt_cond),
        "nt_gen": int(nt_gen),
        "nx": int(cfg.nx), "nc": int(cfg.nc),
        "oversampling": int(oversampling),
        "compute_dtype": dtype_name(compute_dtype),
        "platforms": list(platforms),
        "batch": "symbolic" if batch_size is None else int(batch_size),
        "max_batch": max_batch(ep) if batch_size is None else None,
        "calling_convention": "f(x_cond uint8 (nt_cond,B,H,W,C), "
                              "seed int64[]) -> uint8 (nt_gen,B,H,W,C)",
        "torch": torch.__version__,
    }
    hdr = json.dumps(header).encode()
    return MAGIC + struct.pack("<I", len(hdr)) + hdr + buf.getvalue()


def max_batch(ep):
    """The largest batch an exported program with a symbolic batch takes
    (its range constraint), or None when unbounded."""
    x = next(n for n in ep.graph.nodes if n.op == "placeholder"
             and n.name == "x_cond")
    upper = ep.range_constraints[x.meta["val"].shape[1].node.expr].upper
    return int(upper) if upper.is_Integer else None


def save_serving(path, blob):
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def read_header(blob, path="artifact"):
    """(header, offset of the archive) of an artifact's bytes; raises on a
    wrong magic (a JAX `.srvpexp` included)."""
    if blob[:8] != MAGIC:
        raise ValueError(f"{path}: not a srvp-tpu-torch serving export "
                         f"(bad magic {blob[:8]!r})")
    (hlen,) = struct.unpack("<I", blob[8:12])
    return json.loads(blob[12:12 + hlen].decode()), 12 + hlen


LSTM_WEIGHTS = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


def flatten_lstm_weights(module):
    """Lays each z-LSTM's four CUDA parameters in `module` (a loaded
    program) out as one cuDNN weight buffer, as nn.LSTM.flatten_parameters
    does for the live model; loaded one by one, cuDNN would copy them into
    such a buffer at every call, with a warning.

    It makes nn.LSTM.flatten_parameters' calls (checked against torch
    2.11 and 2.13): torch._use_cudnn_rnn_flatten_weight, which is false
    when cuDNN is off (then there is nothing to flatten, as for the live
    model), and torch._cudnn_rnn_flatten_weight. A torch without them
    raises here."""
    from torch.backends.cudnn import rnn
    params = dict(module.named_parameters())
    if not any(p.is_cuda for p in params.values()):
        return
    for api in ("_use_cudnn_rnn_flatten_weight", "_cudnn_rnn_flatten_weight"):
        if not hasattr(torch, api):
            raise RuntimeError(f"flatten_lstm_weights: torch "
                               f"{torch.__version__} has no torch.{api}")
    if not torch._use_cudnn_rnn_flatten_weight():
        return
    for name, w_ih in params.items():
        if not (name.endswith(LSTM_WEIGHTS[0]) and w_ih.is_cuda):
            continue
        prefix = name[:-len(LSTM_WEIGHTS[0])]
        weights = [params[prefix + n] for n in LSTM_WEIGHTS]
        with torch.no_grad(), torch.cuda.device_of(w_ih):
            torch._cudnn_rnn_flatten_weight(
                weights, len(weights), w_ih.shape[1],
                rnn.get_cudnn_mode("LSTM"), weights[1].shape[1], 0, 1, False,
                False)


def load_serving(path, device="cuda"):
    """Loads an artifact; returns (fn, header).

    fn(x_cond, seed) runs the program on `device` (one of the header's
    platforms), under cuDNN's deterministic algorithms and without TF32
    (both set for the call alone), and returns the uint8 frames there;
    x_cond and seed may be numpy arrays, ints or tensors. Only
    kernels/ops.py is imported (to register the ops), not the model code.
    It raises for a batch other than a pinned one. A call is a
    `srvp.serve.call` span (utils/trace.py) holding `srvp.serve.input`
    (the frames' and the seed's copies to the device) and
    `srvp.serve.module` (the program's host enqueue; the frames are not
    waited for)."""
    from srvp_tpu_torch.kernels import ops  # noqa: F401  (the srvp ops)
    from torch.export.passes import move_to_device_pass

    with open(path, "rb") as f:
        blob = f.read()
    header, start = read_header(blob, path)
    dev = resolve_device(device)
    if dev.type not in header["platforms"]:
        raise ValueError(f"{path}: exported for {header['platforms']}, "
                         f"not {dev.type}")
    ep = torch.export.load(io.BytesIO(blob[start:]))
    module = move_to_device_pass(ep, dev).module()
    flatten_lstm_weights(module)
    shape = (header["nt_cond"], header["nx"], header["nx"], header["nc"])

    def fn(x_cond, seed):
        with trace.span("srvp.serve.call"):
            with trace.span("srvp.serve.input"):
                x = torch.as_tensor(x_cond, dtype=torch.uint8, device=dev)
                s = torch.as_tensor(seed, dtype=torch.int64,
                                    device=dev).reshape(())
            if x.dim() != 5 or (x.shape[0],) + tuple(x.shape[2:]) != shape:
                raise ValueError(f"x_cond has shape {tuple(x.shape)}, "
                                 f"expected ({shape[0]}, B, {shape[1]}, "
                                 f"{shape[2]}, {shape[3]})")
            if header["batch"] != "symbolic" and \
                    x.shape[1] != header["batch"]:
                raise ValueError(f"x_cond has batch {x.shape[1]}; the "
                                 f"artifact is pinned to {header['batch']}")
            if header.get("max_batch") and x.shape[1] > header["max_batch"]:
                raise ValueError(f"x_cond has batch {x.shape[1]}; the "
                                 f"artifact takes at most "
                                 f"{header['max_batch']}")
            with trace.span("srvp.serve.module"), torch.no_grad(), \
                    cudnn_deterministic(), no_tf32():
                return module(x, s)

    return fn, header


def load_xp_model(xp_dir, model_name, device):
    """(config.json as a dict, its SRVPConfig, the checkpoint's model in
    eval mode on `device`): the port's `.pt`, or a JAX `.npz` snapshot,
    as test_main reads them."""
    from srvp_tpu_torch.config import model_config
    from srvp_tpu_torch.models.srvp import SRVP
    from srvp_tpu_torch.utils.weights import load_checkpoint

    with open(os.path.join(xp_dir, "config.json")) as f:
        config = json.load(f)
    cfg = model_config(config)
    model = load_checkpoint(SRVP(cfg), os.path.join(xp_dir, model_name))
    return config, cfg, model.to(resolve_device(device)).eval()


def export_from_xp_dir(xp_dir, *, model_name="model_best.npz", nt_cond=None,
                       nt_gen=None, oversampling=None, platforms=PLATFORMS,
                       batch_size=None, out=None, device="cuda"):
    """Loads config.json and the checkpoint as test_main does (the port's
    `.pt`, or a JAX `.npz`), exports on `device` (bf16 when the config's
    precision is bfloat16) and writes <xp_dir>/serving.srvptex (or `out`).
    Returns the output path."""
    config, cfg, model = load_xp_model(xp_dir, model_name, device)
    nt_cond = nt_cond or config["nt_cond"]
    nt_gen = nt_gen or config.get("seq_len_test") or config["seq_len"]
    oversampling = oversampling or config["n_euler_steps"]
    compute_dtype = DTYPES[config.get("precision", "float32")]
    blob = export_serving(cfg, model, nt_cond, nt_gen,
                          oversampling=oversampling,
                          compute_dtype=compute_dtype, platforms=platforms,
                          batch_size=batch_size)
    out = out or os.path.join(xp_dir, "serving.srvptex")
    save_serving(out, blob)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--xp_dir", required=True)
    p.add_argument("--model_name", default="model_best.npz",
                   help=".npz JAX snapshot or .pt state_dict")
    p.add_argument("--nt_cond", type=int, default=None)
    p.add_argument("--nt_gen", type=int, default=None,
                   help="total frames incl. conditioning (default: config's "
                        "seq_len_test, else seq_len)")
    p.add_argument("--n_euler_steps", type=int, default=None)
    p.add_argument("--platforms", nargs="+", default=list(PLATFORMS))
    p.add_argument("--batch_size", type=int, default=None,
                   help="pin the batch dimension (default: symbolic — one "
                        "artifact serves any batch size)")
    p.add_argument("--out", default=None,
                   help="output path (default: <xp_dir>/serving.srvptex)")
    p.add_argument("--selfcheck", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where to export and self-check ('cpu' runs the "
                        "plain versions)")
    a = p.parse_args(argv)

    t0 = time.perf_counter()
    out = export_from_xp_dir(
        a.xp_dir, model_name=a.model_name, nt_cond=a.nt_cond,
        nt_gen=a.nt_gen, oversampling=a.n_euler_steps,
        platforms=tuple(a.platforms), batch_size=a.batch_size, out=a.out,
        device=a.device)
    print(f"Wrote {out} ({os.path.getsize(out)} bytes, exported in "
          f"{time.perf_counter() - t0:.1f} s)")

    if a.selfcheck:
        import numpy as np
        fn, hdr = load_serving(out, a.device)
        b = hdr["batch"] if isinstance(hdr["batch"], int) else 2
        x = np.zeros((hdr["nt_cond"], b, hdr["nx"], hdr["nx"], hdr["nc"]),
                     dtype=np.uint8)
        y = fn(x, 0)
        want = (hdr["nt_gen"], b, hdr["nx"], hdr["nx"], hdr["nc"])
        if tuple(y.shape) != want or y.dtype != torch.uint8:
            raise SystemExit(f"selfcheck: {tuple(y.shape)} {y.dtype}, "
                             f"expected {want} uint8")
        print(f"Selfcheck ok: f(({hdr['nt_cond']}, {b}, ...) uint8) -> "
              f"{tuple(y.shape)} uint8 on {a.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
