"""The device trace of a traced segment, reduced to what the per-layer
metrics read.

``torch.profiler`` records the segment's CUDA activity alone (kernels,
copies and sets on the device, and the runtime calls that launch them),
not the host's operators: recording every operator slowed the host-bound
steps by more than half and made the idle share read the profiler.  The
segment starts and ends drained, each end marked on the device by a
marker kernel (``torch.cuda._sleep``'s ``spin_kernel``) launched right
after a host-clock reading; the segment is the device time between the
two markers.  Device time is the union of the intervals of every kernel,
copy and set inside it, so work that overlaps on two streams counts once
and the idle share cannot go below 0.  Kernels are grouped by name: the
port's attention kernels (B1/B2 forward, B3/B4 backward with its
pre-pass), its epilogue kernels (B5, B6 and its column sums), cuBLAS
matrix products, and everything else ("eager": the elementwise and
reduction kernels of eager PyTorch).  The benchmark's own host spans
(``span``), read on the host clock and carried onto the device's through
the first marker, label each idle gap with the innermost span open at its
middle.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

GROUPS = (
    ("attention_fwd", ("attention_fwd_kernel",)),
    ("attention_bwd", ("attention_bwd_kernel", "delta_kernel")),
    ("epilogue", ("epilogue_fwd_kernel", "epilogue_bwd_kernel",
                  "column_sum_kernel")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "cublas")),
)
LAUNCH_NAMES = ("attention_fwd_kernel", "attention_bwd_kernel", "delta_kernel",
                "epilogue_fwd_kernel", "epilogue_bwd_kernel", "column_sum_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
MARKER_CYCLES = 1000
_SPANS: Optional[list] = None     # (name, host t0, host t1) while tracing


@contextlib.contextmanager
def span(name: str):
    """A host-clock span ``bench.<name>`` of the traced segment (nothing
    outside it)."""
    if _SPANS is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _SPANS.append((f"bench.{name}", t0, time.perf_counter()))


def _short(name: str) -> str:
    """A kernel's name without its namespaces and argument list."""
    name = re.sub(r"\(anonymous namespace\)::|at::native::|c10::|std::|"
                  r"at::|void ", "", name)
    return name.split("(")[0][:120]


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "eager"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


class Trace:
    """Device time inside the segment, in seconds.  ``spans`` are host
    spans (name, t0, t1) on the clock on which the first marker was
    launched at ``host_t0``."""

    def __init__(self, events: List[dict], spans: Sequence[tuple] = (),
                 host_t0: float = 0.0):
        marks = sorted(e["ts"] for e in events if e.get("cat") == "kernel"
                       and MARKER in e.get("name", ""))
        if len(marks) != 2:
            raise RuntimeError(f"trace: {len(marks)} '{MARKER}' markers, "
                               f"expected 2")
        t0, t1 = marks
        self.window_s = (t1 - t0) / 1e6
        device, by_group, by_name = [], {}, {}
        self.launches = dict.fromkeys(LAUNCH_NAMES, 0)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            if MARKER in e.get("name", ""):
                continue
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b <= a:
                continue
            device.append((a, b))
            if e["cat"] != "kernel":
                by_group.setdefault("copies", []).append((a, b))
                continue
            name = e["name"]
            by_group.setdefault(group_of(name), []).append((a, b))
            key = _short(name)
            by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
            for n in LAUNCH_NAMES:
                if n in name:
                    self.launches[n] += 1
        busy = _union(device)
        self.busy_s = _length(busy) / 1e6
        self.group_s = {g: _length(_union(iv)) / 1e6 for g, iv in by_group.items()}
        self.top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        on_device = [(t0 + (a - host_t0) * 1e6, t0 + (b - host_t0) * 1e6, n)
                     for n, a, b in spans]
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        gaps = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                      key=lambda g: g[0] - g[1])[:10]
        self.idle_gaps = []
        for a, b in gaps:
            mid = (a + b) / 2
            inside = [s for s in on_device if s[0] <= mid <= s[1]]
            label = min(inside, key=lambda s: s[1] - s[0])[2] if inside else "other"
            self.idle_gaps.append((label, (b - a) / 1e6))

    def breakdown(self) -> Dict[str, list]:
        return {"device_ops": [[n, s] for n, s in self.top_ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps]}


class Segment:
    """A stopped profiler, the host spans of its segment and the host
    clock's readings at its two markers."""

    def __init__(self, prof, spans, host_t0: float, host_t1: float):
        self.prof, self.spans = prof, spans
        self.host_t0, self.host_t1 = host_t0, host_t1

    @property
    def host_s(self) -> float:
        return self.host_t1 - self.host_t0


def _mark(device) -> float:
    """Drains the device, reads the host clock, launches a marker."""
    import torch
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    torch.cuda._sleep(MARKER_CYCLES)
    return t


def warm_up(device) -> None:
    """One throwaway profiled marker, so that the profiler's first session
    in the process, which sets up the device tracing, is not the measured
    one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def traced(result: list, device):
    """Profiles the body's CUDA activity between two markers and appends
    the ``Segment`` to ``result``; ``read`` reduces it."""
    global _SPANS
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    _SPANS = []
    try:
        h0 = _mark(device)
        yield
        h1 = _mark(device)
        import torch
        torch.cuda.synchronize(device)
    finally:
        spans, _SPANS = _SPANS, None
        prof.stop()
    result.append(Segment(prof, spans, h0, h1))


def read(seg: Segment) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        seg.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events, seg.spans, seg.host_t0)
