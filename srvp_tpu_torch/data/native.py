"""The port's binding of the native Moving MNIST generator,
`native/mmnist_gen.cpp` (counterpart of srvp_tpu/native/loader.py, without
its PNG decoder).

The source is compiled by path with g++ on first use into
`build/native/` at the repository root and bound with ctypes. The build is
`-march=native`, so the library's name carries a hash of the compile flags,
the source and the host's CPU feature flags: a checkout copied to another
CPU builds its own instead of loading one that may not run there. A failed
build raises; nothing falls back to the numpy generator, which stays as the
plain version that the tests hold this one against. The C functions run
their own threads without the interpreter lock, and every batch is
bit-identical to the numpy generator's items drawn with
`np.random.RandomState(seed)`.
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
BUILD_DIR = ROOT / "build" / "native"
CXXFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            "-pthread"]

_lock = threading.Lock()
_lib = None
# batches served by the native generator in this process, by kind
served = {"parts": 0, "videos": 0}


def _cpu_flags():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return platform.machine()


def library_path():
    """Where the library for this host, these flags and this source
    lives."""
    key = hashlib.sha256("|".join([" ".join(CXXFLAGS), _cpu_flags(),
                                   SOURCE.read_text()]).encode())
    return BUILD_DIR / f"libsrvp_mmnist_{key.hexdigest()[:16]}.so"


def build():
    """Compiles native/mmnist_gen.cpp unless this host's library exists;
    returns its path. Raises RuntimeError when g++ fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{path.name}.{os.getpid()}.tmp"
    cmd = ["g++", *CXXFLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native Moving MNIST generator needs g++: "
                           f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library():
    """The generator library, built on first use, with its C signatures
    set."""
    global _lib
    with _lock:
        if _lib is None:
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
            _lib = lib
    return _lib


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
