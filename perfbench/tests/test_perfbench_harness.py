"""The harness on the CPU: a --tiny rehearsal of each driver, the result
line's keys, a cell added as files and one entry, the import rules, and
the refusals (no card, no program, a forbidden module loaded). The `cuda`
test runs a cell on the card where there is one."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = ["dcgan-train", "kth-train", "kth-eval", "dcgan-serve"]


def run_cell(cell, cwd=ROOT, extra=(), seed=987654321987, timeout=600):
    cmd = [sys.executable, "-m", "perfbench.run", "--workload", cell,
           "--seed", str(seed), "--seconds", "0.5", "--trace", "1",
           "--device", "cpu", "--tiny", *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def last_line(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_rehearsal(cell):
    line = last_line(run_cell(cell))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"
    # a CPU run writes no number under a device metric's name
    assert line["metrics"] == {}
    assert line["attempted"] >= 1 and line["failed"] == 0
    # nothing is built on the CPU; on a card the build is timed apart
    assert line["build_s"] == 0.0
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name


def test_benchmark_json_names_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert w["config"] in names
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        stem = m["name"].split(".")[0]
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file() or \
            (BENCH / "metrics" / f"{stem}.py").is_file()


def test_cell_added_as_files(tmp_path):
    """A new traffic mix and cell: data files and one BENCHMARK.json
    entry, no file of the harness edited."""
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "srvp_tpu_torch", tmp_path / "srvp_tpu_torch")
    os.symlink(ROOT / "native", tmp_path / "native")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((BENCH / "traffic" /
                          "train-resident-bf16.json").read_text())
    traffic.update(pool_batches=2, warmup_steps=3)
    (tmp_path / "perfbench" / "traffic" / "train-resident-b2.json") \
        .write_text(json.dumps(traffic))
    shutil.copy(BENCH / "limits" / "kth-train.json",
                tmp_path / "perfbench" / "limits" / "dcgan-train-b2.json")
    bench["workloads"].append({
        "name": "dcgan-train-b2", "config": "smmnist-dcgan",
        "traffic": "train-resident-b2", "chips": 1,
        "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dcgan-train" in m.get("workloads", []):
            m["workloads"].append("dcgan-train-b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line = last_line(run_cell("dcgan-train-b2", cwd=tmp_path))
    assert "elementwise_pct.train" not in line["metrics"]
    assert set(line["rehearsal"]) <= {m["name"] for m in bench["per_layer"]}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_imports():
    for path in BENCH.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "srvp_tpu"}, path
        if "reference" in path.parts:
            assert "srvp_tpu_torch" not in tops, path


def test_forbidden_module_loaded_refused():
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax'); "
            "from perfbench import run; run.main(['--workload', "
            "'dcgan-train', '--seed', '5', '--seconds', '0.2', '--device', "
            "'cpu', '--tiny'])")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "jax" in proc.stderr
    assert '"correct"' not in proc.stdout


def test_no_card_refused():
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "dcgan-train",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_without_the_program_refused(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = run_cell("dcgan-train", cwd=tmp_path)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


@pytest.mark.cuda
def test_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "dcgan-train",
         "--seed", "31337", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    line = last_line(proc)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
