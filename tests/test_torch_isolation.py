"""The PyTorch port imports neither jax nor srvp_tpu, nor PIL (its PNG
frames go through its own decoder, its GIFs through its own writer), its
evaluation metrics (LPIPS, I3D, FVD), its serving export and tools, its
data-parallel modules and its data tools (the packers, the test-set makers,
the loader bench) included, and its entry points refuse CUDA
where there is none instead of falling back to the CPU."""

import os
import subprocess
import sys
import textwrap

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "srvp_tpu", "PIL")

    class Block:
        # refuse jax, the JAX package and PIL at import time
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import srvp_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        srvp_tpu_torch.__path__, "srvp_tpu_torch.")]
    assert {"srvp_tpu_torch.bench", "srvp_tpu_torch.data.png",
            "srvp_tpu_torch.data.bair", "srvp_tpu_torch.data.human",
            "srvp_tpu_torch.metrics.lpips", "srvp_tpu_torch.metrics.i3d",
            "srvp_tpu_torch.metrics.fvd", "srvp_tpu_torch.export",
            "srvp_tpu_torch.generate", "srvp_tpu_torch.swap",
            "srvp_tpu_torch.bench_serving", "srvp_tpu_torch.kernels.ops",
            "srvp_tpu_torch.ops.counter_rng",
            "srvp_tpu_torch.utils.gif", "srvp_tpu_torch.parallel",
            "srvp_tpu_torch.parallel.mesh",
            "srvp_tpu_torch.parallel.multihost",
            "srvp_tpu_torch.bench_loader", "srvp_tpu_torch.data.pack",
            "srvp_tpu_torch.data.synthetic",
            "srvp_tpu_torch.data.test_sets"} <= set(names)
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401  (its helpers; main() is not run)
    loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not loaded, loaded

    import torch
    from srvp_tpu_torch.config import SRVPConfig, resolve_device
    from srvp_tpu_torch.models.srvp import SRVP
    if not torch.cuda.is_available():
        try:
            resolve_device("cuda")
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("device='cuda' without CUDA must raise")
    cfg = SRVPConfig(nf=4, nhx=8, ny=4, nz=4, nt_inf=2, nh_inf=8,
                     nlayers_inf=2, nh_res=16, nlayers_res=2)
    model = SRVP(cfg).to(resolve_device("cpu")).eval()
    with torch.no_grad():
        out = model.generate_prior(torch.zeros(2, 4), 3,
                                   eps=torch.zeros(2, 2, 4))
    assert out.y.shape == (3, 2, 4)
    print("OK", len(names))
""")


def test_port_imports_no_jax_and_needs_explicit_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().startswith("OK")
    assert int(proc.stdout.split()[-1]) >= 15   # every module was imported


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        return
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
