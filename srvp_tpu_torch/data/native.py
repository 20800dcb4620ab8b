"""The port's native data libraries, built from source on first use and
bound with ctypes (counterpart of srvp_tpu/native/loader.py):

- the Moving MNIST generator, `native/mmnist_gen.cpp`: every batch is
  bit-identical to the numpy generator's items drawn with
  `np.random.RandomState(seed)`;
- the PNG decoder of the KTH and BAIR frame trees,
  `srvp_tpu_torch/csrc/png_decode.cpp`: 8-bit gray or RGB frames, with its
  own inflate, so that it links no image library; its plain version is
  data/png.py.

Each source is compiled by path with g++ into `build/native/` at the
repository root, a library of its own (the generator gains no link
dependency). The build is `-march=native`, so a library's name carries a
hash of the compile flags, the source and the host's CPU feature flags: a
checkout copied to another CPU builds its own instead of loading one that
may not run there. A failed build raises, and so does a file the decoder
rejects, with its name and the reason; nothing falls back to numpy or to
another decoder, which stay as the plain versions that the tests hold
these against. The C functions run their own threads without the
interpreter lock.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "mmnist_gen.cpp"
PNG_SOURCE = ROOT / "srvp_tpu_torch" / "csrc" / "png_decode.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXXFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            "-pthread"]

_lock = threading.Lock()
_libs = {}
# batches served by the native generator in this process, by kind
served = {"parts": 0, "videos": 0}
# batches and frames decoded by the native PNG decoder in this process
decoded = {"batches": 0, "frames": 0}
# the decoder's codes for a rejected file (csrc/png_decode.cpp `Code`)
PNG_ERRORS = {1: "cannot be opened or read", 2: "is not a PNG file",
              3: "has a truncated chunk or no IHDR",
              4: "has another width or height than the frames read",
              5: "is not an 8-bit non-interlaced gray or RGB PNG",
              6: "holds a corrupt image stream",
              7: "has a row filter type above 4",
              8: "is gray where RGB frames are read"}


def _cpu_flags():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return platform.machine()


def library_path(source=SOURCE, stem="mmnist"):
    """Where the library of `source` for this host and these flags
    lives."""
    key = hashlib.sha256("|".join([" ".join(CXXFLAGS), _cpu_flags(),
                                   source.read_text()]).encode())
    return BUILD_DIR / f"libsrvp_{stem}_{key.hexdigest()[:16]}.so"


def build(source=SOURCE, stem="mmnist"):
    """Compiles `source` (by default the Moving MNIST generator) unless
    this host's library exists; returns its path. Raises RuntimeError when
    g++ fails."""
    path = library_path(source, stem)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{path.name}.{os.getpid()}.tmp"
    cmd = ["g++", *CXXFLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native library {source.name} needs g++: "
                           f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library():
    """The generator library, built on first use, with its C signatures
    set."""
    with _lock:
        if "mmnist" not in _libs:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            # (digit data, offsets, (h, w) a digit, n digits, frame size,
            # seq_len, max speed, deterministic, digits a video, seeds,
            # batch, out, threads)
            lib.mmnist_generate_batch.argtypes = [p, p, p] + [i] * 6 \
                + [p, i, p, i]
            lib.mmnist_generate_batch.restype = None
            # (..., seeds, batch, digit h, digit w, digits out, pos out,
            # threads)
            lib.mmnist_parts_batch.argtypes = [p, p, p] + [i] * 6 \
                + [p, i, i, i, p, p, i]
            lib.mmnist_parts_batch.restype = None
            _libs["mmnist"] = lib
    return _libs["mmnist"]


def load_png_library():
    """The PNG decoder library, built on first use, with its C signature
    set."""
    with _lock:
        if "png" not in _libs:
            lib = ctypes.CDLL(str(build(PNG_SOURCE, "png")))
            p, i = ctypes.c_void_p, ctypes.c_int
            # (paths, n, out, byte offsets or null, h, w, channels, codes,
            # threads) -> number of files rejected
            lib.srvp_png_decode.argtypes = [p, i, p, p, i, i, i, p, i]
            lib.srvp_png_decode.restype = i
            _libs["png"] = lib
    return _libs["png"]


class DigitPack:
    """Digit images flattened for the C functions. Raises ValueError when a
    digit does not fit the frame (numpy's randint would raise there)."""

    def __init__(self, digits, frame_size):
        self.n = len(digits)
        self.offsets = np.zeros(self.n, np.int64)
        self.hw = np.zeros((self.n, 2), np.int32)
        chunks, off = [], 0
        for k, d in enumerate(digits):
            d = np.ascontiguousarray(d, np.uint8)
            self.offsets[k] = off
            self.hw[k] = d.shape
            chunks.append(d.reshape(-1))
            off += d.size
        self.data = np.concatenate(chunks)
        if (self.hw > frame_size).any():
            raise ValueError(f"digit images up to {self.hw.max()} px do not "
                             f"fit the {frame_size} px frame")


def _count(kind):
    with _lock:
        served[kind] += 1


def _decode(paths, out, offsets, h, w, channels, n_threads):
    """Decodes `paths` into `out` (frame i at byte offsets[i], or packed in
    order when offsets is None); raises ValueError naming the first file
    the decoder rejected."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, not {channels}")
    lib = load_png_library()
    n = len(paths)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    codes = np.zeros(n, np.int32)
    if lib.srvp_png_decode(
            ctypes.cast(names, ctypes.c_void_p), n, out.ctypes.data,
            None if offsets is None else offsets.ctypes.data, h, w,
            channels, codes.ctypes.data, max(1, n_threads)):
        i = int(np.flatnonzero(codes)[0])
        raise ValueError(f"{paths[i]} {PNG_ERRORS[int(codes[i])]} "
                         f"({h} x {w} x {channels} frames read)")
    with _lock:
        decoded["batches"] += 1
        decoded["frames"] += n


def decode_png_batch(paths, h, w, channels, n_threads=4):
    """uint8 (N, h, w) for channels == 1 (a colour file's red channel) or
    (N, h, w, 3) for channels == 3: the frames of `paths` in order
    (data/png.decode_png_batch is the plain version)."""
    out = np.empty((len(paths), h, w, channels), np.uint8)
    _decode(paths, out, None, h, w, channels, n_threads)
    return out[..., 0] if channels == 1 else out


def decode_png_timemajor(paths, n_videos, seq_len, h, w, channels,
                         n_threads=4):
    """n_videos * seq_len frame files in video-major order (path b *
    seq_len + t), decoded straight into the collated uint8 batch (seq_len,
    n_videos, h, w, channels)."""
    if len(paths) != n_videos * seq_len:
        raise ValueError(f"{len(paths)} paths for {n_videos} videos of "
                         f"{seq_len} frames")
    out = np.empty((seq_len, n_videos, h, w, channels), np.uint8)
    b, t = np.divmod(np.arange(len(paths), dtype=np.int64), seq_len)
    offsets = np.ascontiguousarray((t * n_videos + b) * (h * w * channels))
    _decode(paths, out, offsets, h, w, channels, n_threads)
    return out


def mmnist_generate_batch(pack, frame_size, seq_len, max_speed,
                          deterministic, num_digits, seeds, n_threads=4):
    """(batch, seq_len, H, W) uint8 videos, video i drawn as
    MovingMNIST.get_item with RandomState(seeds[i])."""
    lib = load_library()
    seeds = np.ascontiguousarray(seeds, np.uint32)
    out = np.empty((len(seeds), seq_len, frame_size, frame_size), np.uint8)
    lib.mmnist_generate_batch(
        pack.data.ctypes.data, pack.offsets.ctypes.data, pack.hw.ctypes.data,
        pack.n, frame_size, seq_len, max_speed, int(deterministic),
        num_digits, seeds.ctypes.data, len(seeds), out.ctypes.data,
        max(1, n_threads))
    _count("videos")
    return out


def mmnist_parts_batch(pack, frame_size, seq_len, max_speed, deterministic,
                       num_digits, seeds, n_threads=4):
    """(digits (B, D, h, w) uint8, pos (B, D, T, 2) int32), video i drawn
    as MovingMNIST.get_item_parts with RandomState(seeds[i]). The digit
    images must share one shape."""
    if not (pack.hw == pack.hw[0]).all():
        raise ValueError("parts batches need digit images of one shape")
    lib = load_library()
    dh, dw = int(pack.hw[0][0]), int(pack.hw[0][1])
    seeds = np.ascontiguousarray(seeds, np.uint32)
    digits = np.empty((len(seeds), num_digits, dh, dw), np.uint8)
    pos = np.empty((len(seeds), num_digits, seq_len, 2), np.int32)
    lib.mmnist_parts_batch(
        pack.data.ctypes.data, pack.offsets.ctypes.data, pack.hw.ctypes.data,
        pack.n, frame_size, seq_len, max_speed, int(deterministic),
        num_digits, seeds.ctypes.data, len(seeds), dh, dw,
        digits.ctypes.data, pos.ctypes.data, max(1, n_threads))
    _count("parts")
    return digits, pos
