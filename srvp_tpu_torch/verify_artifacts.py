"""Checks an offline drop of pretrained weights and datasets before they are
used (the counterpart of scripts/verify_artifacts.py), on a machine without
JAX.

    python -m srvp_tpu_torch.verify_artifacts --drop DIR [--manifest OUT]
        [--check_manifest JSON] [--device cpu|cuda]

The drop's layout (every entry optional; whatever is present is checked):

    DROP/
      lpips/alex.pth                     # LPIPS v0.1 linear heads
      lpips/weights/v0.1/alex.pth        #  (or at the package's path)
      lpips/alexnet.pth                  # torchvision AlexNet backbone
      lpips/alexnet-owt-*.pth            #  (or its download name)
      i3d/i3d_kinetics400.npz            # I3D, the TF variable paths
      mnist/*ubyte*                      # MNIST IDX files (optionally .gz)
      checkpoints/<xp>/{model.pt,config.json}   # released models
      datasets/smmnist_test_2digits_64.npz
      datasets/mmnist_test_2digits_64.npz       # deterministic variant
      datasets/svg_test_set_40.npz              # KTH
      datasets/human/test_set_*/*.npz           # Human3.6M
      datasets/bair/processed_data/test/...     # BAIR PNG tree

Each artifact gives one JSON row {"artifact", "path", "detail", "status",
"sha256" (files only)}; the status is "ok" or "INVALID". The exit code is 0
only if every artifact present validates; a drop with none prints EMPTY and
exits 1. --manifest writes {"drop", "ok", "artifacts": rows};
--check_manifest re-checks the drop against such a manifest once accepted:
each artifact it lists must be present, valid and, for a file, of the same
sha256, else its row reads MISSING, INVALID or CHANGED. Rows, statuses,
hashes and manifests are those of scripts/verify_artifacts.py, so that a
manifest of either tool is accepted by the other.

A checkpoint is checked by the port's own model: SRVP of its config.json,
built on --device (cuda by default; without a card that raises rather than
use the CPU), loads its first `*.pt` strictly through
utils/weights.load_checkpoint, every key and shape. The `.pt` files are read
with torch.load(weights_only=True): a state_dict of tensors is accepted, a
pickled module is refused as INVALID (unpickling it could run any code).
"""

import argparse
import glob
import gzip
import hashlib
import json
import os
import struct
import sys

import numpy as np
import torch

from srvp_tpu_torch.config import model_config, resolve_device
from srvp_tpu_torch.data.bair import VIDEO_LEN
from srvp_tpu_torch.metrics.i3d import variable_specs
from srvp_tpu_torch.metrics.lpips import _ALEX_CONVS, _FEATURE_IDX
from srvp_tpu_torch.models.srvp import SRVP
from srvp_tpu_torch.utils.weights import load_checkpoint

# torchvision AlexNet's feature convs {index: (out, in, k, k)} and the
# LPIPS heads' channels
ALEX_FEATURES = {i: conv[:2] + conv[2:3] * 2
                 for i, conv in zip(_FEATURE_IDX, _ALEX_CONVS)}
LPIPS_CHANNELS = tuple(conv[0] for conv in _ALEX_CONVS)


class Invalid(Exception):
    """An artifact that does not hold what its consumer reads."""


def _torch_load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def check_lpips_lin(path):
    sd = _torch_load(path)
    for i, c in enumerate(LPIPS_CHANNELS):
        key = f"lin{i}.model.1.weight"
        if key not in sd:
            raise Invalid(f"missing key {key} (have {sorted(sd)[:8]}...)")
        got = tuple(sd[key].shape)
        if got != (1, c, 1, 1):
            raise Invalid(f"{key}: shape {got}, expected (1, {c}, 1, 1)")
        if not bool(torch.isfinite(sd[key]).all()):
            raise Invalid(f"{key}: non-finite values")
    return f"5 linear heads, channels {LPIPS_CHANNELS}"


def check_alexnet(path):
    sd = _torch_load(path)
    for i, shape in ALEX_FEATURES.items():
        for key, want in ((f"features.{i}.weight", shape),
                          (f"features.{i}.bias", shape[:1])):
            if key not in sd:
                raise Invalid(f"missing key {key}")
            got = tuple(sd[key].shape)
            if got != want:
                raise Invalid(f"{key}: shape {got}, expected {want}")
    return f"{len(ALEX_FEATURES)} feature convs"


def check_i3d(path):
    expected = variable_specs()
    with np.load(path) as arc:
        keys = set(arc.files)
        missing = [p for p, _ in expected if p not in keys]
        if missing:
            raise Invalid(f"{len(missing)} missing variables, first: "
                          f"{missing[:3]}")
        extra = keys - {p for p, _ in expected}
        if extra:
            raise Invalid(f"{len(extra)} unexpected keys, first: "
                          f"{sorted(extra)[:3]}")
        for p, shape in expected:
            got = tuple(arc[p].shape)
            if got != tuple(shape):
                raise Invalid(f"{p}: shape {got}, expected {tuple(shape)}")
    return f"{len(expected)} variables, full kinetics-400 inventory"


def check_checkpoint(xp_dir, device):
    """A released model's directory: config.json and a .pt that loads
    strictly into the port's model of that config on `device`."""
    cfg_path = os.path.join(xp_dir, "config.json")
    pt_candidates = sorted(glob.glob(os.path.join(xp_dir, "*.pt")))
    if not os.path.exists(cfg_path):
        raise Invalid("missing config.json")
    if not pt_candidates:
        raise Invalid("no .pt checkpoint found")
    with open(cfg_path) as f:
        cfg = model_config(json.load(f))
    name = os.path.basename(pt_candidates[0])
    model = SRVP(cfg).to(device)
    try:
        load_checkpoint(model, pt_candidates[0])
    except RuntimeError as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        raise Invalid(f"{name} does not load into the model of archi="
                      f"{cfg.archi}: {' '.join(lines[:2])[:300]}") from e
    return (f"{name}: {len(model.state_dict())} tensors, archi={cfg.archi}, "
            f"loaded on {device}")


def check_video_npz(path, min_len, time_axis, nx=64):
    """`sequences` uint8, time-major (T, N, H, W) [Moving MNIST, time_axis
    0] or video-major (N, T, H, W[, C]) [KTH, time_axis 1], at least
    min_len frames along its time axis (a real drop's video count always
    exceeds the protocol's length, so the other axis proves nothing)."""
    with np.load(path, allow_pickle=True) as arc:
        if "sequences" not in arc.files:
            raise Invalid(f"missing 'sequences' (have {arc.files})")
        seq = arc["sequences"]
    if seq.dtype != np.uint8:
        raise Invalid(f"sequences dtype {seq.dtype}, expected uint8")
    if seq.ndim not in (4, 5):
        raise Invalid(f"sequences ndim {seq.ndim}, expected 4 or 5")
    if nx not in seq.shape[2:4]:
        raise Invalid(f"sequences shape {seq.shape}: no {nx}px spatial dim")
    if seq.shape[time_axis] < min_len:
        raise Invalid(f"sequences shape {seq.shape}: time dim "
                      f"{seq.shape[time_axis]} shorter than protocol "
                      f"length {min_len}")
    return f"sequences {seq.shape} {seq.dtype}"


def check_mnist_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
    if magic == 2051:
        return f"idx3 images, n={n}"
    if magic == 2049:
        return f"idx1 labels, n={n}"
    raise Invalid(f"bad idx magic {magic}")


def check_human_dir(d):
    files = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    if not files:
        raise Invalid("no .npz videos")
    with np.load(os.path.join(d, files[0])) as arc:
        if "image" not in arc.files:
            raise Invalid(f"{files[0]}: missing 'image' (have {arc.files})")
        img = arc["image"]
    if img.dtype != np.uint8 or img.ndim != 4:
        raise Invalid(f"{files[0]}: image {img.shape} {img.dtype}, "
                      "expected uint8 (T, H, W, C)")
    return f"{len(files)} videos, first {img.shape}"


def check_bair_dir(d):
    """The first 4 videos of each of the first 4 directories of the test
    tree hold at least 30 PNG frames."""
    root = os.path.join(d, "processed_data", "test")
    if not os.path.isdir(root):
        raise Invalid("missing processed_data/test/")
    n = 0
    for d1 in sorted(os.listdir(root))[:4]:
        for d2 in sorted(os.listdir(os.path.join(root, d1)))[:4]:
            pngs = [f for f in os.listdir(os.path.join(root, d1, d2))
                    if f.endswith(".png")]
            if len(pngs) < VIDEO_LEN:
                raise Invalid(f"{d1}/{d2}: {len(pngs)} frames, expected "
                              f">={VIDEO_LEN}")
            n += 1
    if n == 0:
        raise Invalid("no video dirs under processed_data/test/")
    return f"sampled {n} video dirs, >={VIDEO_LEN} PNG frames each"


def sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def discover(drop):
    """Yields (artifact name, path, validator) in the JAX tool's order. The
    checkpoint validator also takes the device."""
    j = os.path.join
    for name, rel, fn in [
            ("lpips-linear-heads", "lpips/alex.pth", check_lpips_lin),
            ("lpips-linear-heads", "lpips/weights/v0.1/alex.pth",
             check_lpips_lin),
            ("i3d-kinetics400", "i3d/i3d_kinetics400.npz", check_i3d),
            ("smmnist-test-set", "datasets/smmnist_test_2digits_64.npz",
             lambda p: check_video_npz(p, min_len=25, time_axis=0)),
            ("mmnist-det-test-set", "datasets/mmnist_test_2digits_64.npz",
             lambda p: check_video_npz(p, min_len=100, time_axis=0)),
            ("kth-test-set", "datasets/svg_test_set_40.npz",
             lambda p: check_video_npz(p, min_len=40, time_axis=1)),
    ]:
        if os.path.exists(j(drop, rel)):
            yield name, j(drop, rel), fn
    for p in ([j(drop, "lpips", "alexnet.pth")]
              + sorted(glob.glob(j(drop, "lpips", "alexnet-owt-*.pth")))):
        if os.path.exists(p):
            yield "alexnet-backbone", p, check_alexnet
            break
    for p in sorted(glob.glob(j(drop, "mnist", "*ubyte*"))):
        yield "mnist-idx", p, check_mnist_idx
    for xp in sorted(glob.glob(j(drop, "checkpoints", "*"))):
        if os.path.isdir(xp):
            yield f"checkpoint:{os.path.basename(xp)}", xp, check_checkpoint
    hd = j(drop, "datasets", "human")
    if os.path.isdir(hd):
        for sub in sorted(os.listdir(hd)):
            if sub.startswith("test_set_"):
                yield "human-test-set", j(hd, sub), check_human_dir
    if os.path.isdir(j(drop, "datasets", "bair")):
        yield "bair-test-set", j(drop, "datasets", "bair"), check_bair_dir


def verify_drop(drop, device="cuda"):
    """Returns (rows, ok): a dict an artifact, ok if there is one and all
    are valid. Where the drop holds a checkpoint and `device` is absent,
    raises RuntimeError before checking anything."""
    found = list(discover(drop))
    if any(fn is check_checkpoint for _, _, fn in found):
        device = resolve_device(device)
    results = []
    for name, path, fn in found:
        row = {"artifact": name, "path": os.path.relpath(path, drop)}
        try:
            row["detail"] = (fn(path, device) if fn is check_checkpoint
                             else fn(path))
            row["status"] = "ok"
        except Invalid as e:
            row["status"], row["detail"] = "INVALID", str(e)
        except Exception as e:  # an unreadable or corrupt file
            row["status"] = "INVALID"
            row["detail"] = f"{type(e).__name__}: {e}"
        if os.path.isfile(path):
            row["sha256"] = sha256(path)
        results.append(row)
    ok = bool(results) and all(r["status"] == "ok" for r in results)
    return results, ok


def check_against_manifest(results, manifest_path):
    """A fresh pass's rows against an accepted manifest. Returns (rows, ok):
    a row for each artifact the manifest lists, ok if each is present,
    valid and, for a file, of the accepted sha256. Artifacts the manifest
    does not list are allowed: a drop may grow."""
    with open(manifest_path) as f:
        accepted = json.load(f)
    if not accepted.get("ok"):
        return [{"artifact": "<manifest>", "status": "REJECTED",
                 "detail": "accepted manifest has ok=false; re-record it "
                           "from a fully valid drop"}], False
    by_path = {r["path"]: r for r in results}
    rows, ok = [], True
    for a in accepted.get("artifacts", []):
        row = {"artifact": a["artifact"], "path": a["path"]}
        cur = by_path.get(a["path"])
        if cur is None:
            row["status"] = "MISSING"
            row["detail"] = ("listed in the accepted manifest but absent "
                             "from the drop")
        elif cur["status"] != "ok":
            row["status"], row["detail"] = "INVALID", cur["detail"]
        elif a.get("sha256") and a["sha256"] != cur.get("sha256"):
            row["status"] = "CHANGED"
            row["detail"] = (f"sha256 {cur.get('sha256', '')[:12]}... != "
                             f"accepted {a['sha256'][:12]}...")
        else:
            row["status"], row["detail"] = "ok", "matches accepted manifest"
        ok = ok and row["status"] == "ok"
        rows.append(row)
    return rows, ok


def create_args():
    p = argparse.ArgumentParser(
        prog="python -m srvp_tpu_torch.verify_artifacts",
        description="Checks an offline drop of weights and datasets.")
    p.add_argument("--drop", required=True, help="Drop directory to validate")
    p.add_argument("--manifest", help="Write sha256+status manifest JSON here")
    p.add_argument("--check_manifest", metavar="JSON",
                   help="Validate the drop against a previously accepted "
                        "manifest (presence + sha256 byte-identity)")
    p.add_argument("--device", default="cuda",
                   help="Device on which checkpoints are loaded (cpu to "
                        "check them without a card)")
    return p


def main(argv=None):
    """Prints a JSON line an artifact (and a manifest row), then the
    verdict; returns the exit code."""
    args = create_args().parse_args(argv)
    results, ok = verify_drop(args.drop, args.device)
    for r in results:
        print(json.dumps(r), flush=True)
    if not results:
        print(json.dumps({"status": "EMPTY",
                          "detail": f"no known artifacts under {args.drop}"}))
    if args.check_manifest:
        rows, mok = check_against_manifest(results, args.check_manifest)
        for r in rows:
            print(json.dumps({"manifest_check": r}), flush=True)
        ok = ok and mok
    if args.manifest:
        with open(args.manifest, "w") as f:
            json.dump({"drop": os.path.abspath(args.drop), "ok": ok,
                       "artifacts": results}, f, indent=2)
    print(json.dumps({"status": "ok" if ok else "FAILED",
                      "artifacts": len(results)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
