"""Host-side timing of the port's eval path on one CUDA card, for comparing
two checkouts of this repository.

    python3 eval_timing.py [--tree DIR]

DIR is a checkout (default: the one holding this script), for example an
earlier commit unpacked with ``git archive`` into an ignored directory.
The script scores 20 one-instruction requests of 30 beams with
``eval_epoch`` at the width and depth of ``lily_base_config`` (bf16, random
weights and requests from seed 0, requests from DIR's
``chip_smoke.dedup_request``) and prints one JSON line:

  * ``request_ms``: median, min and max of the requests scored one call
    each;
  * ``pipelined_ms_per_request``: one call over all the requests, so the
    host-to-device copies overlap the scoring;
  * ``traced``: three requests under torch.profiler, each with its wall
    time (to a device synchronize) and the device's busy time;
  * ``host_events``: the profiler's CPU events in one traced request.

Timings between calls of the card vary by several percent: compare two
trees within one call, in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REQUESTS = 20


def traced(run):
    """(wall ms, device busy ms, CPU events) of one profiled ``run``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    host = sum(e.count for e in events if e.device_type == DeviceType.CPU)
    return wall_ms, busy, host


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("eval_timing: no CUDA device")
    sys.path.insert(0, str(args.tree.resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.evaluation.beam_eval import eval_epoch
    from youtube_vln_tpu_torch.models import Lily

    cfg = lily_base_config(ranking=True, compute_dtype="bfloat16")
    model = Lily(cfg, device="cuda").init_weights(0).eval()
    rng = np.random.default_rng(0)
    reqs = [chip_smoke.dedup_request(rng, i) for i in range(REQUESTS)]
    eval_epoch(model, cfg, reqs[:3], device="cuda")     # build, load, warm up

    lat = []
    for r in reqs:
        t0 = time.perf_counter()
        eval_epoch(model, cfg, [r], device="cuda")
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    eval_epoch(model, cfg, reqs, device="cuda")
    pipelined = (time.perf_counter() - t0) * 1e3 / len(reqs)
    runs = [traced(lambda: eval_epoch(model, cfg, reqs[1:2], device="cuda"))
            for _ in range(3)]
    print(json.dumps({
        "tree": str(args.tree), "requests": len(reqs),
        "request_ms": {"median": statistics.median(lat), "min": min(lat),
                       "max": max(lat)},
        "pipelined_ms_per_request": pipelined,
        "traced": [{"wall_ms": w, "device_busy_ms": b} for w, b, _ in runs],
        "host_events": runs[0][2]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
