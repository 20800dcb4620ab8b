"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Every `srvp_tpu_torch/csrc/*.cu` file is compiled for sm_90a (Hopper; the
`a` target also admits wgmma and setmaxnreg) into an object file, all
sources in parallel, and the objects are linked into
`build/kernels/libsrvp_kernels.so` at the repository root. The sources
expose plain C functions, so no PyTorch headers are compiled and a build
takes seconds. Nothing here runs at import time: the library is built on the
first call of `load_library()` and rebuilt when a source is newer than it.
"""

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libsrvp_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib = None


def nvcc_path():
    """nvcc from the CUDA toolkit that torch found (CUDA_HOME), else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _stale():
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built
               for src in [*sources(), *CSRC_DIR.glob("*.cuh")])


def build(force=False, verbose=False):
    """Compiles csrc/*.cu (one nvcc per source, all at once) and links the
    shared library. Returns its path. `verbose` adds ptxas's register and
    shared-memory report to the output."""
    if not force and not _stale():
        return LIB_PATH
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    jobs = []
    for src in sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, *extra, "-c", str(src),
               "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out, flush=True)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}.tmp"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
            *[str(obj) for _, obj, _ in jobs]]
    proc = subprocess.run(link, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n"
                           f"{proc.stdout}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load_library():
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.srvp_prior_rollout.argtypes = [p, p, i, i, p, p, p] + [i] * 8 \
            + [p]
        lib.srvp_prior_rollout.restype = i
        # (ny, nz, hmax, rows, C, int* clusters)
        for name in ("srvp_prior_rollout_clusters",
                     "srvp_train_rollout_bwd_clusters"):
            getattr(lib, name).argtypes = [i] * 5 + [p]
            getattr(lib, name).restype = i
        # (ny, nz, nh_inf, hmax, rows, C, int* clusters)
        lib.srvp_train_rollout_fwd_clusters.argtypes = [i] * 6 + [p]
        lib.srvp_train_rollout_fwd_clusters.restype = i
        lib.srvp_train_rollout_fwd.argtypes = [p, p, i, i] + [p] * 10 \
            + [i] * 9 + [p]
        lib.srvp_train_rollout_fwd.restype = i
        lib.srvp_train_rollout_bwd.argtypes = [p, p, i, i] + [p] * 14 \
            + [i] * 9 + [p]
        lib.srvp_train_rollout_bwd.restype = i
        lib.srvp_train_rollout_wgrad.argtypes = [p, i, i] + [p] * 8 \
            + [i, i, p]
        lib.srvp_train_rollout_wgrad.restype = i
        # (S, int* clusters, int* blocks_per_sm)
        lib.srvp_train_rollout_wgrad_occupancy.argtypes = [i, p, p]
        lib.srvp_train_rollout_wgrad_occupancy.restype = i
        ll = ctypes.c_longlong
        for name, n_ptrs in (("srvp_maxpool2x2_fwd", 2),
                             ("srvp_maxpool2x2_bwd", 4),
                             ("srvp_upsample2x_fwd", 2),
                             ("srvp_upsample2x_bwd", 2)):
            for suffix in ("", "_bf16"):
                fn = getattr(lib, name + suffix)
                fn.argtypes = [p] * n_ptrs + [ll, ll, p]
                fn.restype = i
        # (pointers, bf16, n, cin, h, w, cout, then n_valid and act, or bh,
        # then the tile: rows, frames (kernel 8 only), cols; n_tiles)
        lib.srvp_conv3x3_block_fwd.argtypes = [p] * 7 + [i, ll, i, i, i, i,
                                                         ll, i, i, i, i, ll,
                                                         p]
        lib.srvp_conv3x3_block_fwd.restype = i
        lib.srvp_conv3x3_clamped_fwd.argtypes = [p] * 5 + [i, ll, i, i, i, i,
                                                           i, i, i, ll, p]
        lib.srvp_conv3x3_clamped_fwd.restype = i
        _lib = lib
    return _lib
