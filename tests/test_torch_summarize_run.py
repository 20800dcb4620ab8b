"""scripts/summarize_run.py, which imports neither package, runs as it is
on the metrics.jsonl that the port's trainer writes (its training rows and
its validation rows), on the CPU at tiny widths."""

import argparse
import json

import pytest
import torch

from scripts import summarize_run
from srvp_tpu_torch import train_main
from tests.test_torch_train_cli import parse


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_summarizes_the_port_trainers_metrics(tmp_path, capsys):
    assert train_main.main(parse(tmp_path, "--device", "cpu", "--n_iter",
                                 "4", "--val_interval", "2")) == 0
    with open(tmp_path / "xp" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    capsys.readouterr()
    summarize_run.main(argparse.Namespace(xp_dir=str(tmp_path / "xp"),
                                          every=1))
    out = capsys.readouterr().out.splitlines()
    steps = [r for r in rows if "loss" in r]
    vals = [r for r in rows if "val_metric" in r]
    assert len(steps) == 4 and len(vals) == 2
    assert out[0] == f"# Training run: {tmp_path / 'xp'}"
    assert out[1].startswith("steps: 4 ")
    table = [ln for ln in out if ln.startswith("| ") and ln[2].isdigit()]
    assert [int(ln.split("|")[1]) for ln in table] == \
        [r["step"] for r in steps + vals]
    assert table[0].split("|")[2].strip() == f"{steps[0]['loss']:.1f}"
    assert table[-1].split("|")[2].strip() == f"{-vals[-1]['val_metric']:.3f}"
