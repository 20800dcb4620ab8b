"""The port's serving CLIs with --device cpu: `python -m
srvp_tpu_torch.export --selfcheck` (from the port's model.pt and from a
JAX model.npz), `generate` (GIFs read back by PIL, which the port itself
does not use), `swap` (its diagonal is generate's sample for the same
seed), `bench_serving` at the tiny widths; each accepts every flag of its
JAX script with the same default (but --platforms); `load_serving` does
not import the port's model code; without CUDA every tool raises unless
asked for the CPU.

The CLIs run in this process (their `main(argv)`), on a tiny Moving MNIST
experiment with skip connections and 3x-scaled weights, as
tests/test_swap.py builds it (a fresh init decodes every pixel to about
127).
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

import jax

from srvp_tpu_torch import bench_serving, generate, swap
from srvp_tpu_torch import export as ex
from srvp_tpu_torch.config import SRVPConfig
from srvp_tpu_torch.models.srvp import SRVP
from srvp_tpu_torch.ops.counter_rng import fold_in

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(nx=64, nc=1, nf=4, nhx=16, ny=4, nz=4, skipco=True, nt_inf=2,
           nh_inf=8, nlayers_inf=2, nh_res=16, nlayers_res=2, archi="dcgan")
XP_CONFIG = dict(dataset="smmnist", seq_len=6, seq_len_test=6, nt_cond=3,
                 n_euler_steps=1, ndigits=2, max_speed=4,
                 deterministic=False, subsampling=8, **CFG)
N_VIDEOS = 4


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def xp(tmp_path_factory):
    """(xp_dir with config.json, the port's model.pt and a JAX model.npz,
    data_dir with a Moving MNIST test archive of N_VIDEOS videos)."""
    from srvp_tpu.models import srvp as jsrvp
    from srvp_tpu.utils import checkpoint as jckpt

    root = tmp_path_factory.mktemp("serving_cli")
    xp_dir, data_dir = root / "xp", root / "data"
    xp_dir.mkdir()
    data_dir.mkdir()
    with open(xp_dir / "config.json", "w") as f:
        json.dump(XP_CONFIG, f)
    torch.manual_seed(3)
    model = SRVP(SRVPConfig(**CFG))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(3.0)
    torch.save(model.state_dict(), xp_dir / "model.pt")
    params, bn_state = jax.jit(jsrvp.init, static_argnums=(1,))(
        jax.random.PRNGKey(3), jsrvp.SRVPConfig(**CFG))
    jckpt.save_model(str(xp_dir), "model", params, bn_state)
    seqs = np.random.RandomState(0).randint(0, 256, (6, N_VIDEOS, 64, 64))
    np.savez_compressed(data_dir / "smmnist_test_2digits_64.npz",
                        sequences=seqs.astype(np.uint8))
    return xp_dir, data_dir


def common(xp, *extra):
    xp_dir, data_dir = xp
    return ["--xp_dir", str(xp_dir), "--data_dir", str(data_dir),
            "--model_name", "model.pt", "--device", "cpu", *extra]


def export_cli(xp, model_name, out, capsys):
    """The export CLI with --selfcheck on the CPU; returns what it
    printed."""
    assert ex.main(["--xp_dir", str(xp[0]), "--model_name", model_name,
                    "--out", str(out), "--selfcheck", "--device", "cpu"]) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def exported(xp, tmp_path_factory):
    """The export CLI's artifact of model.pt, and what the CLI printed."""
    out = tmp_path_factory.mktemp("exported") / "serving.srvptex"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert ex.main(["--xp_dir", str(xp[0]), "--model_name", "model.pt",
                        "--out", str(out), "--selfcheck", "--device",
                        "cpu"]) == 0
    return out, printed.getvalue()


@pytest.mark.parametrize("model_name", ["model.pt", "model.npz"])
def test_export_cli_selfcheck(xp, exported, tmp_path, capsys, model_name):
    if model_name == "model.pt":
        out, printed = exported
    else:
        out = tmp_path / "serving.srvptex"
        printed = export_cli(xp, model_name, out, capsys)
    assert "Selfcheck ok" in printed and "(6, 2, 64, 64, 1)" in printed
    fn, header = ex.load_serving(out, "cpu")
    assert (header["nt_cond"], header["nt_gen"], header["oversampling"],
            header["compute_dtype"]) == (3, 6, 1, "float32")
    # the artifact serves the checkpoint it was exported from
    _, cfg, model = ex.load_xp_model(str(xp[0]), model_name, "cpu")
    core = ex.make_serving_fn(cfg, model, 6, oversampling=1,
                              compute_dtype=torch.float32)
    x = np.random.RandomState(1).randint(0, 256, (3, 2, 64, 64, 1))
    x = torch.from_numpy(x.astype(np.uint8))
    with torch.no_grad():
        assert torch.equal(fn(x, 5), core(x, torch.tensor(5)))


def test_generate_writes_samples_and_gifs(xp, tmp_path):
    out, gifs = tmp_path / "samples.npz", tmp_path / "gifs"
    assert generate.main(common(xp, "--n_samples", "2", "--n_videos", "3",
                                "--seed", "4", "--out", str(out),
                                "--gif_dir", str(gifs))) == 0
    arc = np.load(out)
    assert set(arc.files) == {"cond", "gt", "samples"}
    assert arc["cond"].shape == (3, 3, 64, 64, 1)
    assert arc["gt"].shape == (3, 6, 64, 64, 1)
    samples = arc["samples"]
    assert samples.shape == (2, 3, 6, 64, 64, 1)
    assert samples.dtype == np.uint8 and samples.std() > 10
    assert not np.array_equal(samples[0, :, 3:], samples[1, :, 3:])
    names = sorted(p.name for p in gifs.iterdir())
    assert names == sorted(f"video{v}_sample{s}.gif" for v in range(3)
                           for s in range(2))
    for v in range(3):
        for s in range(2):
            im = Image.open(gifs / f"video{v}_sample{s}.gif")
            frames = [np.asarray(f.convert("L"))
                      for f in ImageSequence.Iterator(im)]
            np.testing.assert_array_equal(np.stack(frames),
                                          samples[s, v, ..., 0])


def test_swap_diagonal_is_generate(xp, tmp_path):
    gen_out, swap_out = tmp_path / "samples.npz", tmp_path / "swap.npz"
    gif = tmp_path / "grid.gif"
    assert generate.main(common(xp, "--n_samples", "1", "--n_videos", "3",
                                "--seed", "7", "--out", str(gen_out))) == 0
    assert swap.main(common(xp, "--n_videos", "3", "--seed",
                            str(fold_in(7, 0)), "--out", str(swap_out),
                            "--gif", str(gif))) == 0
    arc = np.load(swap_out)
    assert set(arc.files) == {"cond", "gt", "grid"}
    assert arc["cond"].shape == (3, 3, 64, 64, 1)
    grid = arc["grid"]
    assert grid.shape == (3, 3, 6, 64, 64, 1) and grid.dtype == np.uint8
    sample = np.load(gen_out)["samples"][0]
    for i in range(3):
        np.testing.assert_array_equal(grid[i, i], sample[i])
    assert np.any(grid[0, 1] != grid[0, 0])     # same content, other motion
    assert np.any(grid[1, 0] != grid[0, 0])     # other content, same motion
    im = Image.open(gif)
    assert im.n_frames == 6 and im.size == (4 * 66 - 2, 4 * 66 - 2)


def test_bench_serving_cpu(capsys):
    record = bench_serving.main(["--device", "cpu", "--tiny", "--configs",
                                 "smmnist-dcgan", "--batches", "1", "2",
                                 "--iters", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(record))
    assert line["metric"] == "serving" and line["backend"] == "cpu"
    info = line["configs"]["smmnist-dcgan"]
    assert {"artifact_bytes", "export_s", "load_s", "nt_cond", "nt_gen",
            "batches"} <= set(info)
    for b in ("1", "2"):
        assert set(info["batches"][b]) == {
            "latency_p50_ms", "latency_p95_ms", "device_latency_p50_ms",
            "device_latency_p95_ms", "frames_per_sec",
            "device_frames_per_sec", "first_call_s"}
        assert all(np.isfinite(v) and v > 0
                   for v in info["batches"][b].values())


class _Parser(Exception):
    pass


def parser_of(main, path=None):
    """{dest: (default, nargs, type)} of the parser that main builds."""
    def capture(self, *args, **kwargs):
        raise _Parser(self)
    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        main()
    except _Parser as e:
        parser = e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    return {a.dest: (a.default, a.nargs, a.type)
            for a in parser._actions if a.dest != "help"}


def jax_script_main(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("script,main", [
    ("export_serving", ex.main), ("generate", generate.main),
    ("swap", swap.main), ("bench_serving", bench_serving.main)])
def test_flags_match_the_jax_scripts(script, main):
    theirs = parser_of(jax_script_main(script))
    ours = parser_of(main)
    for dest, (default, nargs, typ) in theirs.items():
        assert dest in ours, dest
        if dest != "platforms":
            assert ours[dest] == (default, nargs, typ), dest
    assert ours["platforms" if "platforms" in theirs else "device"]


@pytest.mark.parametrize("main", [ex.main, generate.main, swap.main,
                                  bench_serving.main])
def test_tools_need_explicit_cpu(xp, main):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    argv = (["--xp_dir", str(xp[0]), "--model_name", "model.pt"]
            if main is ex.main else [] if main is bench_serving.main
            else common(xp)[:-2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_load_serving_imports_no_model_code(exported):
    out = exported[0]
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        from srvp_tpu_torch.export import load_serving
        fn, header = load_serving({str(out)!r}, "cpu")
        y = fn(np.zeros((3, 2, 64, 64, 1), np.uint8), 0)
        assert tuple(y.shape) == (6, 2, 64, 64, 1), y.shape
        loaded = sorted(m for m in sys.modules
                        if m.startswith("srvp_tpu_torch.models")
                        or m.split(".")[0] in ("jax", "srvp_tpu"))
        assert not loaded, loaded
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_gif_writer_round_trip():
    from srvp_tpu_torch.utils.gif import gif_bytes
    rng = np.random.RandomState(0)
    grey = rng.randint(0, 256, (3, 40, 24, 1)).astype(np.uint8)
    im = Image.open(io.BytesIO(gif_bytes(grey, fps=5.0)))
    assert im.info["duration"] == 200 and im.info["loop"] == 0
    frames = np.stack([np.asarray(f.convert("L"))
                       for f in ImageSequence.Iterator(im)])
    np.testing.assert_array_equal(frames, grey[..., 0])
    rgb = rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    im = Image.open(io.BytesIO(gif_bytes(rgb)))
    frames = np.stack([np.asarray(f.convert("RGB"))
                       for f in ImageSequence.Iterator(im)]).astype(int)
    # 3-3-2 bit palette: at most half a step of 255/7 (red, green) and
    # 255/3 (blue) from each value
    assert np.all(np.abs(frames - rgb)[..., :2] <= 19)
    assert np.all(np.abs(frames - rgb)[..., 2] <= 43)
