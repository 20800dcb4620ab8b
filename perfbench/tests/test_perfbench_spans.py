"""The metrics read from the port's own spans and counters
(srvp_tpu_torch/utils/trace.py) in the --tiny rehearsals on the CPU: each
cell reports its host readings under `rehearsal`; the device shares of
the evaluation need the card's CUDA events and are absent here."""

import pytest

from test_perfbench_harness import last_line, run_cell

HOST = {"dcgan-train": ["loader_wait_pct.train_loader",
                        "loader_ready_batches.train_loader",
                        "loader_busy_pct.train_loader",
                        "forward_host_pct.train_loader",
                        "backward_host_pct.train_loader",
                        "optimizer_host_pct.train_loader"],
        "dcgan-serve": ["serve_input_ms.serve", "serve_enqueue_ms.serve"],
        "kth-eval": []}
DEVICE = {"kth-eval": ["decode_device_pct.eval", "score_device_pct.eval"]}


@pytest.mark.parametrize("cell", sorted(HOST))
def test_rehearsal_reports_the_programs_spans(cell):
    line = last_line(run_cell(cell))
    assert line["metrics"] == {}
    got = line["rehearsal"]
    for name in HOST[cell]:
        assert got[name]["value"] >= 0, name
    for name in DEVICE.get(cell, []):
        assert name not in got, name
    if cell == "dcgan-train":
        shares = sum(got[n]["value"] for n in HOST[cell]
                     if n.endswith("_host_pct.train_loader"))
        assert shares + got["loader_wait_pct.train_loader"]["value"] <= 100
        assert 0 <= got["loader_ready_batches.train_loader"]["value"] <= 2
