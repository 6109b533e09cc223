"""The arithmetic of the per-layer metrics (``benchmark/metrics/*.py``),
from a run's host-clock spans, operation counts and device trace.  Each
returns None where the run has nothing to read, never 0 for a share."""
from __future__ import annotations

import statistics
from typing import Optional, Sequence

from benchmark import counts


def host_wait_ms(run) -> Optional[float]:
    """Mean host-clock ms per step or request spent taking the next batch
    from the feed (``prefetch_to_device`` over the ``Loader``)."""
    return statistics.fmean(run.host_wait_ms) if run.host_wait_ms else None


def mfu(run) -> Optional[float]:
    """Model operations of the window's work over the window's time, as a
    share (%) of the bf16 tensor-core peak."""
    if not run.flops or not run.window_s:
        return None
    return 100.0 * run.flops / run.window_s / counts.PEAK_BF16_FLOPS


def roofline(run, groups: Sequence[str], bound: str) -> Optional[float]:
    """The kernels' least time (their bound at the cell's shapes, per step
    or request, times the traced ones) over their device time in the
    trace, %."""
    if run.traced is None or bound not in run.bounds_s:
        return None
    device_s = sum(run.traced.group_s.get(g, 0.0) for g in groups)
    if device_s <= 0.0:
        return None
    return 100.0 * run.bounds_s[bound] * run.traced_units / device_s


def eager_ms(run) -> Optional[float]:
    """Device ms per step or request in kernels that are neither the port's
    own (B1-B6) nor cuBLAS matrix products."""
    if run.traced is None or not run.traced_units:
        return None
    return 1e3 * run.traced.group_s.get("eager", 0.0) / run.traced_units


def device_idle(run) -> Optional[float]:
    """The share (%) of the window in which nothing ran on the device: one
    less the device's busy time per step or request in the traced segment
    over the window's time per step or request.  The trace's own host cost
    (some microseconds a launch) lengthens the traced segment's steps, not
    the device's work, so its busy time is set against the untraced
    window's."""
    if (run.traced is None or not run.traced_units or not run.units
            or run.window_s <= 0.0):
        return None
    busy = run.traced.busy_s / run.traced_units
    return 100.0 * (1.0 - busy / (run.window_s / run.units))
