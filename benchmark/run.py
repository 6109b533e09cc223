"""Runs one cell of the benchmark of ``youtube_vln_tpu_torch`` once, on the
CUDA devices of this machine:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m benchmark.run`` from the checkout's root works as well.)
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profiled segment
right after the window (the end-to-end metrics are the window's).  The last line of standard output is the result
as one JSON object; the numbers ``correct`` compares, each beside its
limit, are the last lines of standard error and the result's last key.
Without CUDA, or with fewer devices than the cell asks for, it exits with
code 3 and prints no result.  See ``benchmark/README.md``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    # run as a script: import from the checkout's root, not from benchmark/
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    started = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = ap.parse_args(argv)
    cell = harness.load_cell(ns.workload)
    build_dir = harness.use_cache_dirs()

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {ns.workload} needs {cell.chips} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 3

    run = harness.Run(cell=cell, model=harness.model_dict(cell.config),
                      seed=ns.seed, trace=bool(ns.trace))
    driver = harness.load_module("drivers", cell.traffic["driver"])
    driver.run(run, seconds=ns.seconds, device=torch.device("cuda"),
               started=started, build_dir=build_dir)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"benchmark: the process loaded {loaded}", file=sys.stderr)
        return 4
    result = harness.report(run, torch.cuda.get_device_name(0))
    print(f"setup_s {run.setup_s!r}, window_s {run.window_s!r}, units "
          f"{run.units}, check_s {run.check_s!r}", file=sys.stderr)
    if run.traced_units:
        print(f"ms per unit: window {1e3 * run.window_s / run.units!r}, "
              f"traced {1e3 * run.traced_s / run.traced_units!r}",
              file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
