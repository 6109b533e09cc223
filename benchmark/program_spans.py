"""Readings of the program's own host spans (``youtube_vln_tpu_torch/
utils/spans.py``) over a run's window and its traced segment.

The spans split the feed's wait and time the steps' dispatch on the host
clock; in the traced segment they are carried onto the device's clock as
the benchmark's own spans are (``trace.py``, through the first marker),
so that they can label idle gaps, take a share of the device's idle
time, and have kernels put down to the span whose host code launched
them (the launching runtime call, linked to the kernel by the trace's
``args.correlation``).

A run carries what these read as attributes (``spans_probe.py`` sets
them): ``program_window`` and ``program_segment`` (the spans, tuples
``(name, t0, t1, lane)``), ``segment_events`` (the segment's Chrome trace
events), ``segment_host_t0`` (the host clock at its first marker) and
``segment_launches`` (the program's ``LAUNCHES`` counters' deltas over the
segment).  Each reading is None where the run has none of what it reads,
never 0 for a missing reading.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from benchmark import trace

MAIN = "main"
FEED = ("loader.next", "feed.transfer")
PHASES = ("step", "score")          # spans whose launches are put down to them
LAUNCH_CALLS = ("cuda_runtime", "cuda_driver")
# the program's counters, summed as the trace's kernel names group them
COUNTERS = {"attention_fwd_kernel": ("attention_fwd", "bi_attention_fwd"),
            "attention_bwd_kernel": ("attention_bwd", "bi_attention_bwd"),
            "epilogue_fwd_kernel": ("epilogue_fwd",),
            "epilogue_bwd_kernel": ("epilogue_bwd",)}


def _window(run) -> Sequence[tuple]:
    return getattr(run, "program_window", None) or ()


def _main_s(spans: Iterable[tuple], names) -> float:
    """Seconds in the main-lane spans ``names``."""
    return sum(t1 - t0 for n, t0, t1, lane in spans if n in names and lane == MAIN)


def per_unit_ms(run, names: Sequence[str]) -> Optional[float]:
    """Host ms per request or step in the window's main-lane spans
    ``names``."""
    spans = [s for s in _window(run) if s[0] in names]
    if not spans or not run.units:
        return None
    return 1e3 * _main_s(spans, names) / run.units


def loader_ms(run) -> Optional[float]:
    """Consumer ms per unit in the Loader, resume to yield."""
    return per_unit_ms(run, ("loader.next",))


def transfer_ms(run) -> Optional[float]:
    """Ms per unit in ``to_device`` of the device feed."""
    return per_unit_ms(run, ("feed.transfer",))


def dispatch_ms(run) -> Optional[float]:
    """Host ms per unit in the step or the scorer: issuing the work."""
    return per_unit_ms(run, PHASES)


def item_ms(run) -> Optional[float]:
    """Mean ms an item takes to assemble, on the Loader's thread or in a
    worker, in the window."""
    items = [t1 - t0 for n, t0, t1, _ in _window(run) if n == "loader.item"]
    return 1e3 * sum(items) / len(items) if items else None


def split_ms(run, segment: bool = False) -> Optional[Dict[str, float]]:
    """Host ms per unit of each span name in the window (or the traced
    segment), ``name@lane`` off the main lane (a parent's time holds its
    children's)."""
    spans, units = ((getattr(run, "program_segment", None), run.traced_units)
                    if segment else (_window(run), run.units))
    if not spans or not units:
        return None
    out: Dict[str, float] = {}
    for n, t0, t1, lane in spans:
        key = n if lane == MAIN else f"{n}@{lane}"
        out[key] = out.get(key, 0.0) + 1e3 * (t1 - t0) / units
    return out


def counts(run) -> Optional[Dict[str, float]]:
    """Spans per unit, by name, in the window."""
    spans = _window(run)
    if not spans or not run.units:
        return None
    out: Dict[str, float] = {}
    for n, *_ in spans:
        out[n] = out.get(n, 0.0) + 1.0 / run.units
    return out


# ---------------------------------------------------------------- segment

def _segment(run):
    events = getattr(run, "segment_events", None)
    spans = getattr(run, "program_segment", None)
    if not events or not spans or not run.traced_units:
        return None
    return events, spans, run.segment_host_t0


def _markers(events) -> List[dict]:
    marks = sorted((e for e in events if e.get("cat") == "kernel"
                    and trace.MARKER in e.get("name", "")), key=lambda e: e["ts"])
    if len(marks) != 2:
        raise RuntimeError(f"trace: {len(marks)} markers, expected 2")
    return marks


def _device(events, t0: float, t1: float) -> List[Tuple[float, float, dict]]:
    """Device intervals inside the segment (trace us), markers left out."""
    out = []
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS or "dur" not in e:
            continue
        if trace.MARKER in e.get("name", ""):
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b > a:
            out.append((a, b, e))
    return out


def _intersect(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def on_device(spans, host_t0: float, t0: float, names=None) -> List[tuple]:
    """Main-lane spans (name, t0, t1) on the device clock, the host clock
    read at ``host_t0`` where the first marker starts at ``t0`` (us)."""
    return [(n, t0 + (a - host_t0) * 1e6, t0 + (b - host_t0) * 1e6)
            for n, a, b, lane in spans
            if lane == MAIN and (names is None or n in names)]


def labelled(events, bench_spans, program_spans, host_t0: float) -> trace.Trace:
    """The segment's ``trace.Trace`` with its idle gaps labelled by the
    innermost main-lane span of either kind at the gap's middle."""
    spans = list(bench_spans) + [(n, a, b) for n, a, b, lane in program_spans
                                 if lane == MAIN]
    return trace.Trace(events, spans, host_t0)


def idle_feed_ms(run) -> Optional[float]:
    """Device-idle ms per unit of the segment that overlaps the feed's
    main-lane spans (``loader.next`` and ``feed.transfer``)."""
    seg = _segment(run)
    if seg is None:
        return None
    events, spans, host_t0 = seg
    m0, m1 = (e["ts"] for e in _markers(events))
    busy = trace._union([(a, b) for a, b, _ in _device(events, m0, m1)])
    edges = [m0] + [x for iv in busy for x in iv] + [m1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    clipped = [(max(a, m0), min(b, m1))
               for _, a, b in on_device(spans, host_t0, m0, FEED)]
    feed = trace._union([(a, b) for a, b in clipped if b > a])
    if not feed:
        return None
    return _intersect(idle, feed) / 1e3 / run.traced_units


def phases_ms(run) -> Optional[Dict[str, float]]:
    """Device ms per unit (union of intervals) of the segment's kernels,
    copies and sets, each put down to the innermost main-lane ``step*`` or
    ``score*`` span open when its launching call ran (``outside`` if none
    was, ``unlinked`` where the trace has no launching call for it), with
    ``busy``, the union of them all."""
    seg = _segment(run)
    if seg is None:
        return None
    events, spans, host_t0 = seg
    marks = _markers(events)
    m0, m1 = marks[0]["ts"], marks[1]["ts"]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in LAUNCH_CALLS and "correlation" in e.get("args", {})}
    # the host clock onto the launching calls' clock, through the first
    # marker's own launch where the trace has it
    anchor = calls.get(marks[0].get("args", {}).get("correlation"))
    c0 = anchor["ts"] if anchor is not None else m0
    phases = sorted(((n, c0 + (a - host_t0) * 1e6, c0 + (b - host_t0) * 1e6)
                     for n, a, b, lane in spans
                     if lane == MAIN and n.split(".")[0] in PHASES),
                    key=lambda s: s[2] - s[1])
    by_phase: Dict[str, list] = {}
    every = []
    for a, b, e in _device(events, m0, m1):
        call = calls.get(e.get("args", {}).get("correlation"))
        if call is None:
            phase = "unlinked"
        else:
            t = call["ts"]
            phase = next((n for n, lo, hi in phases if lo <= t <= hi), "outside")
        by_phase.setdefault(phase, []).append((a, b))
        every.append((a, b))
    out = {p: trace._length(trace._union(iv)) / 1e3 / run.traced_units
           for p, iv in by_phase.items()}
    out["busy"] = trace._length(trace._union(every)) / 1e3 / run.traced_units
    return out


def optimizer_ms(run) -> Optional[float]:
    """Device ms per step of the work launched inside ``step.optimizer``."""
    out = phases_ms(run)
    return out.get("step.optimizer") if out else None


def segment_dispatch_ms(run) -> Optional[float]:
    """``dispatch_ms`` in the traced segment: host ms per unit in the step
    or the scorer while the profiler traces."""
    spans = getattr(run, "program_segment", None)
    if not spans or not run.traced_units:
        return None
    return 1e3 * _main_s(spans, PHASES) / run.traced_units


def launches(run) -> Optional[Dict[str, dict]]:
    """Per kernel name of the trace: the program's counted launches per
    unit over the segment, by counter, beside the trace's launches per
    unit."""
    deltas = getattr(run, "segment_launches", None)
    if deltas is None or run.traced is None or not run.traced_units:
        return None
    n = run.traced_units
    return {k: {"program": {c: deltas.get(c, 0) / n for c in names},
                "trace": run.traced.launches.get(k, 0) / n}
            for k, names in COUNTERS.items()}
