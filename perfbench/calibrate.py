"""Readings that the comparison's limits are set from, on the chip, at a
cell's own size: the program against the reference over many seeds, and
the control (the reference in the next precision below the cell's: fp8
for a bfloat16 cell, TF32 for a float32 one) against the reference on
some of them. One process, so set-up is paid once per seed, not per
import.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1 2 ... \
        [--control_seeds 1 2 3] [--witness_seeds 4 5] [--fault NAME]
        [--seconds 0] [--out FILE]

Prints one JSON line per seed and kind ("program", "control", a fault's
name, "witness") with the numbers compared; for training cells also each
step's loss, reconstruction and KL_z terms and the worst leaves. The
witness (training) is the reference with its towers rounded to bfloat16,
the program's own precision, against the float32 reference. The
benchmark's own runs never run the control.
"""

import argparse
import contextlib
import json
import statistics
import sys

import torch

from perfbench import core, faults, run, weights

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def train_detail(ctx, prog, ref):
    from perfbench.drivers.train import leaf_gaps
    names = weights.param_names(ctx.model)
    rows = leaf_gaps(prog, ref)

    def worst(col):
        kept = [r for r in rows if r[col] is not None]
        return [(r[col], names[r[0]]) for r in
                sorted(kept, key=lambda r: -r[col])[:3]]
    return {key: prog[key] for key in ("losses", "nlls", "kl_zs")} | {
        "ref_" + key: ref[key] for key in ("losses", "nlls", "kl_zs")} | {
        "worst_grad": worst(1), "worst_cos": worst(2),
        "worst_update": worst(3), "worst_rows": worst(4),
        "rows_quartiles": statistics.quantiles(
            [r[4] for r in rows if r[4] is not None], n=4),
        "cos_quartiles": statistics.quantiles(
            [r[2] for r in rows if r[2] is not None], n=4),
        "left_out": [names[r[0]] for r in rows if r[2] is None]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness_seeds", type=int, nargs="*", default=[],
                   help="training: also the reference with its towers in "
                        "bfloat16, the program's precision (rows of kind "
                        "witness)")
    p.add_argument("--fault", default=None,
                   help="a fault of perfbench/faults.py planted in the "
                        "program for every seed (rows of kind fault)")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--check_stride", type=int, default=None,
                   help="serving: compare one call in this many (as many "
                        "calls in a short window as a run compares)")
    p.add_argument("--out", default=None)
    p.add_argument("--tiny", action="store_true",
                   help="on the CPU at tiny sizes (a rehearsal)")
    a = p.parse_args(argv)
    cell = core.Cell(a.workload)
    device = torch.device("cpu" if a.tiny else "cuda")
    drv = cell.driver
    out = open(a.out, "a") if a.out else None
    for seed in sorted(set(a.seeds) | set(a.control_seeds)
                       | set(a.witness_seeds)):
        args = run.parse(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds)]
                         + ["--device", "cpu", "--tiny"] * a.tiny)
        ctx = run.Context(cell, args, device)
        if a.check_stride:
            ctx.traffic["check_stride"] = a.check_stride
        rec = core.Records(drv.KIND)
        with faults.planted(a.fault) if a.fault else contextlib.nullcontext():
            t0 = core.clock()
            st = drv.setup(ctx)
            t1 = core.clock()
            drv.window(st, rec, a.seconds)
            prog = drv.program_outputs(st)
        drv.release(st)
        torch.cuda.empty_cache()
        t2 = core.clock()
        ref = drv.reference_outputs(ctx, st)
        t3 = core.clock()
        rows = []
        if seed in a.seeds:
            row = {"seed": seed, "kind": a.fault or "program",
                   **drv.compare(prog, ref), "setup_s": t1 - t0,
                   "reference_s": t3 - t2, "units": rec.units}
            if drv.KIND == "train":
                row["detail"] = train_detail(ctx, prog, ref)
            rows.append(row)
        if seed in a.control_seeds:
            quant = CONTROL[ctx.traffic["precision"]]
            ctl = drv.reference_outputs(ctx, st, quant)
            row = {"seed": seed, "kind": "control", "quant": quant,
                   **drv.compare(ctl, ref)}
            if drv.KIND == "train":
                row["detail"] = train_detail(ctx, ctl, ref)
            rows.append(row)
        if seed in a.witness_seeds and drv.KIND == "train":
            wit = drv.reference_outputs(ctx, st, "bf16")
            rows.append({"seed": seed, "kind": "witness", "quant": "bf16",
                         **drv.compare(wit, ref),
                         "detail": train_detail(ctx, wit, ref)})
        for row in rows:
            line = json.dumps(row, default=lambda v: None)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del st, ref, prog
        torch.cuda.empty_cache()
    run._join_threads()
    found = core.forbidden_modules()
    if found:
        sys.exit(f"forbidden modules loaded: {found}")


if __name__ == "__main__":
    main()
