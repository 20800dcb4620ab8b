"""The port's CLIs at two gloo ranks on the CPU, at tiny widths, against one
process (the counterpart of tests/test_multihost.py:228-281, within the
tier-1 budget):

  * the trainer at two ranks, as two processes of an explicit group and as
    the local ranks that `--n_devices 2` starts (with `--steps_per_dispatch
    2`), logs the one-process run's losses and validation metrics and ends
    on its weights at rtol 1e-4 / atol 1e-6; rank 1 writes nothing and ends
    on rank 0's parameters bit for bit;
  * SIGTERM to rank 1 alone stops both ranks at the same step, both with
    143, and `--resume` then ends on the weights of the two-rank run that
    was never stopped;
  * `test_main --n_devices 2` (with LPIPS) writes the one-process
    results.npz and artifacts, under the tolerance for rank counts: the
    noise is the same and the videos' work independent, but the CPU's
    torch.nn.Linear (BLAS sgemm) rounds a row otherwise at another row
    count (8 rows against 4: infer_w, infer_y and the decoder's first
    layer take one process's and one rank's batch), so the frames are
    held at one uint8 level and the metrics at rtol 1e-5.

Every process has its own timeout and is killed on expiry; the runs share
module-scoped fixtures and run side by side, two intra-op threads each.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

import torch

from srvp_tpu_torch.data import mmnist_test

from test_torch_lpips import write_lpips_dir
from test_torch_train_cli import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 240
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6      # tests/test_multihost.py:270-281
STOP_AT = 3
FLAGS = TINY + ["--device", "cpu", "--n_iter", "6", "--log_interval", "2",
                "--val_interval", "2", "--n_workers", "1"]
# the trainer with the rank's final parameters saved to argv[1], and
# SIGTERM sent to itself after step argv[2] (0: never)
TRAIN_CHILD = """
import os, signal, sys
import torch
torch.set_num_threads(2)
from srvp_tpu_torch import train_lib, train_main
out, stop_at, argv = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
states = []
init = train_lib.init_train_state
train_lib.init_train_state = lambda *a, **k: states.append(init(*a, **k)) \\
    or states[-1]
step = train_lib.train_step

def stepped(ts, *a, **k):
    metrics = step(ts, *a, **k)
    if ts.step == stop_at:
        os.kill(os.getpid(), signal.SIGTERM)
    return metrics

train_lib.train_step = stepped
status = train_main.main(train_main.create_args().parse_args(argv))
torch.save(states[0].model.state_dict(), out)
sys.exit(status)
"""


class Proc:
    """A child process with its own deadline; `wait()` kills it once the
    deadline passes and returns (exit status, output)."""

    def __init__(self, argv, log):
        self.deadline = time.monotonic() + PROC_TIMEOUT_S
        self.log = open(log, "w+")
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
        self.proc = subprocess.Popen(argv, cwd=ROOT, env=env,
                                     stdout=self.log,
                                     stderr=subprocess.STDOUT)

    def wait(self):
        try:
            rc = self.proc.wait(timeout=max(self.deadline - time.monotonic(),
                                            1))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self.log.seek(0)
        out = self.log.read()
        self.log.close()
        return rc, out


def trainer(tmp, name, ranks, *extra, stop_rank=None, resume=False):
    """The trainer as `ranks` processes of one group (rank 0's save path
    tmp/name/xp; with `stop_rank`, rank 1 has its own, and that rank gets
    SIGTERM after STOP_AT), or one process without a group."""
    run = tmp / name
    run.mkdir(exist_ok=True)
    procs = []
    for r in range(ranks):
        save = run / ("xp" if r == 0 or stop_rank is not None
                      or resume else "xp_rank1")
        argv = FLAGS + ["--data_dir", str(tmp / "data"), "--save_path",
                        str(save), *extra]
        if ranks > 1:
            argv += ["--coordinator_address", f"file://{run}/rendezvous",
                     "--num_processes", str(ranks), "--process_id", str(r)]
        if resume:
            argv.append("--resume")
        stop = STOP_AT if r == stop_rank else 0
        procs.append(Proc([sys.executable, "-c", TRAIN_CHILD,
                           str(run / f"rank{r}{'_resumed' * resume}.pt"),
                           str(stop), *argv],
                          run / f"rank{r}{'_resumed' * resume}.log"))
    return procs


def evaluation(tmp, name, *extra):
    """test_main over a copy of the one-process run's model (5 videos of
    6 frames, batches of 4: the second padded)."""
    xp = tmp / name
    shutil.copytree(tmp / "one" / "xp", xp)
    argv = [sys.executable, "-m", "srvp_tpu_torch.test_main", "--xp_dir",
            str(xp), "--data_dir", str(tmp / "test_data"), "--device", "cpu",
            "--batch_size", "4", "--n_samples", "4", "--samples_chunk", "2",
            "--nt_gen", "6", "--model_name", "model.pt", "--lpips_dir",
            str(tmp / "lpips"), *extra]
    return [Proc(argv, tmp / f"{name}.log")]


def finish(procs):
    return [p.wait() for p in procs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the module, side by side in two waves: {name: [(exit
    status, output) a process]} and the runs' directory."""
    tmp = tmp_path_factory.mktemp("multiproc")
    (tmp / "test_data").mkdir()
    np.savez_compressed(
        mmnist_test.archive_path(str(tmp / "test_data"), 64, 2, False),
        sequences=np.random.RandomState(0).randint(
            0, 256, (6, 5, 64, 64)).astype(np.uint8))
    write_lpips_dir(tmp / "lpips", "flat")
    first = {"one": trainer(tmp, "one", 1),
             "two": trainer(tmp, "two", 2),
             "stopped": trainer(tmp, "stopped", 2, stop_rank=1)}
    spawn_xp = tmp / "spawn" / "xp"
    first["spawn"] = [Proc([sys.executable, "-m", "srvp_tpu_torch.train_main",
                            *FLAGS, "--data_dir", str(tmp / "data"),
                            "--save_path", str(spawn_xp), "--n_devices", "2",
                            "--steps_per_dispatch", "2"],
                           tmp / "spawn.log")]
    out = {name: finish(procs) for name, procs in first.items()}
    meta = tmp / "stopped" / "xp" / "train_state.json"
    out["stopped_meta"] = json.loads(meta.read_text()) if meta.exists() \
        else None
    out["stopped_rows"] = rows(tmp / "stopped" / "xp")
    second = {"resumed": trainer(tmp, "stopped", 2, resume=True),
              "eval_one": evaluation(tmp, "eval_one"),
              "eval_two": evaluation(tmp, "eval_two", "--n_devices", "2")}
    out.update({name: finish(procs) for name, procs in second.items()})
    return out, tmp


def rows(xp):
    path = xp / "metrics.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()]


def assert_exit(results, want):
    for r, (rc, log) in enumerate(results):
        assert rc == want, f"process {r} exited with {rc}:\n{log[-3000:]}"


def assert_same_run(ref_xp, got_xp):
    """The same logged steps, losses and validation metrics, and model.pt,
    at rtol 1e-4 / atol 1e-6."""
    ref, got = rows(ref_xp), rows(got_xp)
    assert [(r["step"], sorted(r)) for r in got] == [
        (r["step"], sorted(r)) for r in ref]
    for a, b in zip(ref, got):
        for k in ("loss", "nll", "kl_y_0", "kl_z", "l2_res", "val_metric"):
            if k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=TRAIN_RTOL,
                                           atol=TRAIN_ATOL,
                                           err_msg=f"{k} at {a['step']}")
    sd_ref, sd = (torch.load(p / "model.pt") for p in (ref_xp, got_xp))
    assert sd.keys() == sd_ref.keys()
    for k in sd_ref:
        torch.testing.assert_close(sd[k], sd_ref[k], rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, msg=k)


@pytest.mark.parametrize("run", ["two", "spawn"])
def test_two_ranks_train_as_one_process(runs, run):
    """Two ranks of an explicit group (K = 1), and the two local ranks of
    --n_devices 2 at --steps_per_dispatch 2: the one-process run's steps,
    losses, validations and weights."""
    out, tmp = runs
    assert_exit(out["one"], 0)
    assert_exit(out[run], 0)
    assert_same_run(tmp / "one" / "xp", tmp / run / "xp")
    if run == "spawn":
        assert "2 ranks, gloo" in out["spawn"][0][1]


def test_rank_1_writes_nothing_and_ends_on_rank_0s_parameters(runs):
    out, tmp = runs
    assert_exit(out["two"], 0)
    run = tmp / "two"
    assert not (run / "xp_rank1").exists()
    assert sorted(p.name for p in (run / "xp").iterdir()) == [
        "config.json", "metrics.jsonl", "model.pt", "model_best.pt",
        "train_state.json", "train_state.pt"]
    ranks = [torch.load(run / f"rank{r}.pt") for r in range(2)]
    saved = torch.load(run / "xp" / "model.pt")
    for k in saved:
        assert torch.equal(ranks[1][k], ranks[0][k]), k
        assert torch.equal(ranks[0][k], saved[k]), k
    assert "[6/6]" in out["two"][0][1] and "[6/6]" not in out["two"][1][1]


def test_sigterm_to_one_rank_stops_both_then_resume_ends_on_the_run(runs):
    """SIGTERM to rank 1 after step 3: both ranks agree to stop at step 3
    and exit 143 (rank 0 saved the train state there); `--resume` runs
    steps 4-6 and ends on the losses and weights of the run never stopped,
    bit for bit. (Its validations read other batches: the validation
    loader starts again at its first epoch, as in the JAX package.)"""
    out, tmp = runs
    assert_exit(out["stopped"], 143)
    assert out["stopped_meta"]["step"] == STOP_AT
    assert [r["step"] for r in out["stopped_rows"]] == [2, 2]
    stopped = [torch.load(tmp / "stopped" / f"rank{r}.pt") for r in (0, 1)]
    for k in stopped[0]:
        assert torch.equal(stopped[0][k], stopped[1][k]), k
    assert_exit(out["resumed"], 0)
    assert f"Resumed from step {STOP_AT}" in out["resumed"][0][1]
    ref, got = (tmp / d / "xp" for d in ("two", "stopped"))
    assert [(r["step"], r.get("loss")) for r in rows(got)] == [
        (r["step"], r.get("loss")) for r in rows(ref)]
    sd_ref, sd = (torch.load(p / "model.pt") for p in (ref, got))
    for k in sd_ref:
        assert torch.equal(sd[k], sd_ref[k]), k


def test_two_rank_evaluation_writes_the_one_process_results(runs):
    """Every video's results and artifacts (5 videos: the padding
    dropped), frames within one uint8 level and metrics at rtol 1e-5 (the
    module docstring's tolerance for rank counts)."""
    out, tmp = runs
    assert_exit(out["eval_one"], 0)
    assert_exit(out["eval_two"], 0)
    names = ["results", "cond_rec"] + [
        f"{m}_{w}" for m in ("psnr", "ssim", "lpips")
        for w in ("best", "worst")] + [f"random_{i}" for i in range(1, 5)]
    for name in names:
        ref, got = (np.load(tmp / d / f"{name}.npz")
                    for d in ("eval_one", "eval_two"))
        assert sorted(got.files) == sorted(ref.files), name
        for k in ref.files:
            assert got[k].shape == ref[k].shape and ref[k].shape[0] == 5
            if ref[k].dtype == np.uint8:
                diff = np.abs(got[k].astype(int) - ref[k].astype(int))
                assert diff.max() <= 1, (name, k, diff.max())
            else:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                           err_msg=f"{name}:{k}")
    assert "Results:" in out["eval_two"][0][1]
