"""Runs one cell as ``benchmark/run.py`` does, with the program's host
spans (``youtube_vln_tpu_torch/utils/spans.py``) on in the window and in
the traced segment, and prints what they read (``program_spans.py``):

    python3 benchmark/spans_probe.py --workload <name> --seed <n> --seconds <s> --trace <0|1> --spans <0|1>

The last line of standard output is one JSON object: ``result``, the line
``run.py`` would print for the run (with ``--trace 1`` its idle gaps
labelled by the program's spans as well as the benchmark's), the window's
host ms per unit, and with ``--spans 1`` the spans' readings: the feed's
wait split into the Loader and the transfer, an item's assembly, the
steps' dispatch in the window and in the segment, the device's idle time
under the feed, its busy time put down to the step's phases, the
program's launch counters beside the trace's, and a span's own cost.
``--spans 0`` runs the cell with the spans off, for their cost in pairs.
Without CUDA it exits with code 3.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import harness, program_spans, readers, trace  # noqa: E402
from youtube_vln_tpu_torch.utils import spans  # noqa: E402


@dataclasses.dataclass
class ProbedRun(harness.Run):
    """A run whose window records the program's spans: on when the cell's
    driver module (``benchmark/drivers``) marks the window's start
    (``setup_s``), kept when it marks its end (``window_s``)."""
    probe: bool = False
    program_window: list = None
    program_segment: list = None
    segment_events: list = None
    segment_host_t0: float = 0.0
    segment_launches: dict = None

    def __setattr__(self, key, value):
        super().__setattr__(key, value)
        if key == "setup_s" and value and self.probe:
            spans.start()
        elif key == "window_s" and value and spans.recording():
            super().__setattr__("program_window", spans.stop())


def launch_counts() -> dict:
    from youtube_vln_tpu_torch.ops import attention, epilogue
    return {**attention.LAUNCHES, **epilogue.LAUNCHES}


def _events(seg) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        seg.prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


@contextlib.contextmanager
def instrumented(run: ProbedRun):
    """``trace.traced`` and ``trace.read`` that also record the segment's
    program spans and launch counts into ``run``, keep its events, and
    label its idle gaps with the program's spans too."""
    traced, read = trace.traced, trace.read

    @contextlib.contextmanager
    def probed(result, device):
        before = launch_counts()
        if run.probe:
            spans.start()
        try:
            with traced(result, device):
                yield
        finally:
            record = spans.stop()
        after = launch_counts()
        seg = result[-1]
        seg.program = [s for s in record
                       if s[2] > seg.host_t0 and s[1] < seg.host_t1]
        seg.launches = {k: after[k] - before[k] for k in after}

    def probed_read(seg):
        events = _events(seg)
        run.program_segment, run.segment_events = seg.program, events
        run.segment_host_t0, run.segment_launches = seg.host_t0, seg.launches
        return program_spans.labelled(events, seg.spans, seg.program, seg.host_t0)

    trace.traced, trace.read = probed, probed_read
    try:
        yield run
    finally:
        trace.traced, trace.read = traced, read


def span_cost_us(n: int = 200_000) -> dict:
    """A span's host cost (us), off and on, entered and left ``n`` times."""
    out = {}
    for state in ("off", "on"):
        if state == "on":
            spans.start()
        t0 = spans.clock()
        for _ in range(n):
            with spans.span("probe"):
                pass
        out[state] = (spans.clock() - t0) / n * 1e6
        spans.stop()
    return out


def readings(run: ProbedRun) -> dict:
    p = program_spans
    out = {"loader_ms": p.loader_ms(run), "transfer_ms": p.transfer_ms(run),
           "item_ms": p.item_ms(run), "dispatch_ms": p.dispatch_ms(run),
           "idle_feed_ms": p.idle_feed_ms(run), "optimizer_ms": p.optimizer_ms(run),
           "segment_dispatch_ms": p.segment_dispatch_ms(run),
           "split_ms": p.split_ms(run), "spans_per_unit": p.counts(run),
           "segment_split_ms": p.split_ms(run, segment=True),
           "phases_ms": p.phases_ms(run), "launches_per_unit": p.launches(run)}
    return {k: v for k, v in out.items() if v is not None}


def main(argv=None) -> int:
    started = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ns = ap.parse_args(argv)
    cell = harness.load_cell(ns.workload)
    build_dir = harness.use_cache_dirs()

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"spans_probe: {ns.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 3
    from youtube_vln_tpu_torch.utils.measure import nvidia_smi

    run = ProbedRun(cell=cell, model=harness.model_dict(cell.config),
                    seed=ns.seed, trace=bool(ns.trace), probe=bool(ns.spans))
    driver = harness.load_module("drivers", cell.traffic["driver"])
    with instrumented(run):
        driver.run(run, seconds=ns.seconds, device=torch.device("cuda"),
                   started=started, build_dir=build_dir)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"spans_probe: the process loaded {loaded}", file=sys.stderr)
        return 4
    out = {"workload": ns.workload, "seed": ns.seed, "spans": bool(ns.spans),
           "card": nvidia_smi(), "setup_s": run.setup_s,
           "end_to_end": run.end_to_end, "units": run.units,
           "window_ms_per_unit": 1e3 * run.window_s / run.units,
           "host_wait_ms": readers.host_wait_ms(run),
           "result": harness.report(run, torch.cuda.get_device_name(0))}
    if run.traced_units:
        out["traced_ms_per_unit"] = 1e3 * run.traced_s / run.traced_units
        out["segment_events"] = dict(collections.Counter(
            e.get("cat") for e in run.segment_events or ()))
    out.update(readings(run))
    out["span_cost_us"] = span_cost_us()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
