"""Readings that the limits of ``benchmark/limits/<workload>.json`` are set
from, for one cell, on the chip, in one process (the benchmark's own runs
do not run this):

    python3 benchmark/calibrate.py --workload <name> --seeds S [S ...]
        [--control-seeds S ...] [--fault-seeds S ...] [--seconds 3]

For each of ``--seeds`` it runs the cell (a short window at the cell's own
load) and prints the program's readings of every number compared (the
lower readings).  For each of ``--control-seeds`` it also prints the
control's: the reference in the program's place, computed with the
operands of its matrix products and every activation it keeps in float8
e4m3 and their gradients in e5m2 (``reference/lily.py:Numerics``), against
the float32 reference, on the same requests or steps (the upper
readings).  For each of ``--fault-seeds`` it runs the
cell again with each fault the cell can have planted in the program and
prints those readings.  One JSON line per reading, to standard output and,
with ``--out FILE``, appended to that file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import harness  # noqa: E402
from benchmark.reference import lily as ref_lily  # noqa: E402

FAULTS = {"rerank": ("altered_answer", "half_batch", "permuted_beams"),
          "train": ("frozen_state", "half_batch")}


def control(run, device) -> dict:
    """The numbers compared, of the float8 reference against the float32
    one, on the run's compared requests or steps."""
    fp8 = ref_lily.Numerics("fp8")
    if run.cell.traffic["driver"] == "rerank":
        from benchmark.drivers import rerank
        from benchmark.reference import train as ref_train
        from benchmark import program
        with program.NoTF32():
            weights = ref_lily.make_weights(run.model, run.seed, device)
            served = [(host, ref_train.scores(weights, run.model, host, fp8).cpu().numpy())
                      for host, _ in run.samples]
            del weights
        gaps = rerank.compare(run, served, device)
        return {"score_gap": max(gaps)}
    from benchmark.drivers import train
    ipb = run.cell.traffic["instr_per_block"]
    ref = train.follow(run, run.samples, device, ipb, keep_first=True)
    ctl = train.follow(run, run.samples, device, ipb, fp8, against=ref.pop("first"))
    return train.gaps(ctl, ref)


def worst(run) -> dict:
    """The leaves that set the worst-leaf readings of a training run."""
    if run.readings is None:
        return {}
    import statistics
    ref, prog = run.reference, run.readings
    med = statistics.median(ref["grads"].values())

    def top(vals):
        k = max(vals, key=vals.get)
        return [k, vals[k]]
    return {"worst_grad_gap": top({k: abs(prog["grads"][k] - g) / max(g, med)
                                   for k, g in ref["grads"].items()}),
            "worst_grad_diff": top({k: d / max(ref["grads"][k], med)
                                    for k, d in prog["diff"].items()})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="", help="also append the lines here")
    ns = ap.parse_args(argv)
    import torch
    device = torch.device("cuda")
    build_dir = harness.use_cache_dirs()

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if ns.out:
            with open(ns.out, "a") as f:
                f.write(line + "\n")

    def one(seed, faults=()):
        cell = harness.load_cell(ns.workload)
        cell.limits = {}
        run = harness.Run(cell=cell, model=harness.model_dict(cell.config),
                          seed=seed, trace=False)
        driver = harness.load_module("drivers", cell.traffic["driver"])
        driver.run(run, seconds=ns.seconds, device=device, started=time.time(),
                   build_dir=build_dir, faults=faults)
        return run

    for seed in sorted(set(ns.seeds) | set(ns.control_seeds)):
        t0 = time.time()
        run = one(seed)
        emit(kind="program", seed=seed, s=time.time() - t0, units=run.units,
             **{k: v for k, v, _ in run.checks}, **worst(run))
        if seed in ns.control_seeds:
            emit(kind="control", seed=seed, **control(run, device))
        del run
        torch.cuda.empty_cache()
    driver = harness.load_cell(ns.workload).traffic["driver"]
    for seed in ns.fault_seeds:
        for fault in FAULTS[driver]:
            run = one(seed, (fault,))
            emit(kind=f"fault:{fault}", seed=seed,
                 **{k: v for k, v, _ in run.checks})
            del run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
