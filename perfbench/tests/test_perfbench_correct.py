"""`correct` comes out false when the timed path is broken underneath: a
--tiny run on the CPU (the harness's look for a chip skipped) with one
fault planted in the program for each fault the cell can have; and the
control, the reference one precision below the cell's, fails the cell's
limits (fp8 on the CPU at the cell's widths and frames on fewer videos;
every control at the cell's own size on the card)."""

import json

import numpy as np
import pytest
import torch

from perfbench import core, faults, run

SEED = 424242424242


def tiny_run(cell):
    return run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                     "0.5", "--trace", "0", "--device", "cpu", "--tiny"])


@pytest.mark.parametrize("cell,fault", [
    ("dcgan-train", "unchanged"), ("dcgan-train", "half_batch"),
    ("kth-train", "unchanged"), ("kth-train", "half_batch"),
    ("kth-eval", "altered_eval"), ("dcgan-serve", "altered_serve")])
def test_planted_fault_fails(cell, fault):
    with faults.planted(fault):
        assert tiny_run(cell)["correct"] is False


@pytest.mark.parametrize("cell", ["dcgan-train", "kth-train", "kth-eval",
                                  "dcgan-serve"])
def test_sound_tiny_run(cell):
    line = tiny_run(cell)
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert all(np.isfinite(c["value"]) for c in line["checks"].values())


# the control test's batches: the cells' widths and frames, fewer videos
SMALL_BATCH = {"dcgan-train": 8, "kth-train": 4, "dcgan-serve": 8}


def _control(cell, device, small, seed):
    """The cell's numbers for the control (the reference one precision
    below the cell's) against the reference, and the cell's limits. With
    `small`, on inputs made here at the cell's widths and frames but
    SMALL_BATCH videos, without the program (the control is the
    reference's alone); else after a set-up of the cell itself."""
    from perfbench.calibrate import CONTROL
    c = core.Cell(cell)
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      "0"])
    ctx = run.Context(c, args, device)
    quant = CONTROL[ctx.traffic["precision"]]
    if small:
        st = _small_inputs(ctx, SMALL_BATCH[cell], seed)
    else:
        st = c.driver.setup(ctx)
        c.driver.window(st, core.Records(c.driver.KIND), 0.0)
        c.driver.release(st)
    ref = c.driver.reference_outputs(ctx, st)
    ctl = c.driver.reference_outputs(ctx, st, quant)
    return c.driver.compare(ctl, ref), c.limits


def _small_inputs(ctx, bsz, seed):
    from types import SimpleNamespace

    from perfbench import weights
    w_seed, noise_seed, data_seed = core.sub_seeds(seed, 3)
    g = torch.Generator().manual_seed(data_seed)
    state = weights.make_state(ctx.model, ctx.config["init"], w_seed,
                               ctx.device)
    nx, nc = ctx.model["nx"], ctx.model["nc"]
    if ctx.cell.driver.KIND == "train":
        nt = ctx.proto["seq_len"]
        frames = core.synthetic_frames(3 * bsz, nt, nx, nc, g, ctx.device)
        kept = [frames[:, i * bsz:(i + 1) * bsz] for i in range(3)]
        return SimpleNamespace(state0=state, kept=kept, noise_seed=noise_seed,
                               nx=nx)
    pool = [core.synthetic_frames(bsz, ctx.proto["nt_cond"], nx, nc, g,
                                  ctx.device).numpy()]
    return SimpleNamespace(state=state, pool=pool,
                           kept={0: (0, noise_seed, None),
                                 1: (0, noise_seed + 1, None)})


@pytest.mark.parametrize("cell", ["dcgan-train", "kth-train", "dcgan-serve"])
def test_fp8_control_fails(cell):
    numbers, limits = _control(cell, torch.device("cpu"), True, SEED)
    assert any(numbers[k] > lim for k, lim in limits.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dcgan-train", "kth-train", "kth-eval",
                                  "dcgan-serve"])
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    numbers, limits = _control(cell, torch.device("cuda"), False, SEED)
    assert any(numbers[k] > lim for k, lim in limits.items()), numbers


def _train_outputs(grads, change, split=None):
    return {"recon": torch.zeros(2, 2), "nlls": [0.0], "pixels": 1,
            "grads": grads, "split": split, "change": change,
            "finite": True}


def test_gradient_gaps_see_the_rows():
    """The median leaf's 1 - cosine of the first gradients, and their
    distance in units of the reference's even-odd split: 0 for the
    reference's own gradients (the cosine whatever their scale); about 1
    split for a mean over half of the rows, whose norm the worst-leaf gap
    alone would let pass; a cosine gap of 1 where the program's gradient
    is all zeros."""
    from perfbench.drivers.train import compare
    g = torch.Generator().manual_seed(7)
    rows = [torch.randn(64, 16, generator=g) + 0.2 for _ in range(5)]
    full = [r.mean(0) for r in rows]
    split = [(r[0::2].sum(0) - r[1::2].sum(0)) / 64 for r in rows]
    half = [r[:32].mean(0) for r in rows]
    ref = _train_outputs(full, [1.0] * 5, split)
    same = compare(_train_outputs(full, [1.0] * 5), ref)
    assert same["grad_cos_gap"] < 1e-12 and same["grad_rows_gap"] == 0
    scaled = compare(_train_outputs([2 * f for f in full], [1.0] * 5), ref)
    assert scaled["grad_cos_gap"] < 1e-12
    cut = compare(_train_outputs(half, [1.0] * 5), ref)
    assert cut["grad_cos_gap"] > 0.05
    assert 0.5 < cut["grad_rows_gap"] < 2
    zero = compare(_train_outputs([0 * f for f in full], [1.0] * 5), ref)
    assert zero["grad_cos_gap"] == 1.0 and zero["grad_gap"] == 1.0


def test_calibrate_rehearsal(capsys):
    """calibrate on the CPU at tiny sizes: the program, the control and the
    bf16 witness each give every number the training comparison has."""
    from perfbench import calibrate
    calibrate.main(["--workload", "kth-train", "--tiny", "--seeds", "5",
                    "--control_seeds", "5", "--witness_seeds", "5"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["kind"] for r in rows] == ["program", "control", "witness"]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in ("grad_cos_gap",
                                                "grad_rows_gap"))
        assert len(r["detail"]["kl_zs"]) == 3
