"""Host spans: named intervals of the host's clock around the port's work.

The Loader, the device feed and the steps open spans at their work::

    loader.next        the consumer, from the Loader's resume to its yield
      loader.wait        waiting on the producer thread's queue or a worker
      loader.collate     stacking items into a batch (producer thread in
                         the threaded path); none where the workers
                         write the batch in place
    loader.item        one item assembled (producer thread, or a worker)
    feed.wait          a take of ``device.prefetch_to_device``: the consumer
                       waiting for the feed thread's next batch
    feed.transfer      one batch through ``device.to_device`` (feed thread)
      feed.pin           a tensor's ``pin_memory()`` (to CUDA only)
      feed.copy          its non-blocking copy issued (to CUDA only)
    step               one training step
      step.forward       the loss
      step.backward      its backward
      step.optimizer     the optimizer's step and zero_grad
    score              one call of the beam scorer
      score.expand       step-dedup expansion and flattening
      score.forward      the model
      score.pad          padded candidates to -inf

A span times the host.  For a step that is the time to issue its device
work, plus any wait where CUDA's launch queue is full, not the device's
time for that work.

Recording is off by default.  ``start()`` turns it on, ``stop()`` turns it
off and returns what was recorded: ``(name, t0, t1, lane)`` tuples in the
order the spans ended.  Off, ``span()`` returns one shared no-op context
after a single check of a module flag: no clock read and no allocation.

Times are ``time.perf_counter()`` seconds.  On Linux that is
CLOCK_MONOTONIC, one clock for a process and the workers it forks, so the
times a worker reports (``record``) land on the parent's clock.  The lane
is ``"main"`` for the thread that called ``start()``, the thread's name for
any other (the Loader's producer thread is ``"loader"``, the device feed's
``"feed"``: a Loader fed through ``prefetch_to_device`` records its
``loader.*`` spans there), and what
``record`` is given for times reported from elsewhere (``"worker"``: the
Loader's worker processes).

``annotate(True)`` makes each span also open
``torch.profiler.record_function(name)`` (in a process that has torch
loaded), so that a profiler's trace carries the same names; it needs no
``start()``.  The module imports no torch: the Loader's workers import it.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import List, Optional, Tuple

clock = time.perf_counter

Span = Tuple[str, float, float, str]

_spans: Optional[List[Span]] = None   # the record while on
_main: Optional[int] = None           # the thread that called start()
_annotate = False
_active = False                       # recording or annotating


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "t0", "fn")

    def __init__(self, name: str):
        self.name = name
        self.fn = None

    def __enter__(self):
        if _annotate and "torch" in sys.modules:
            from torch.profiler import record_function
            self.fn = record_function(self.name)
            self.fn.__enter__()
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        t1 = clock()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        record(self.name, self.t0, t1)
        return False


def span(name: str):
    """A context that records ``name`` from entry to exit while on."""
    if not _active:
        return _OFF
    return _On(name)


def record(name: str, t0: float, t1: float, lane: Optional[str] = None) -> None:
    """Records a span that cannot be a ``with``: times taken elsewhere on
    this clock.  Nothing while off."""
    out = _spans
    if out is None:
        return
    if lane is None:
        lane = ("main" if threading.get_ident() == _main
                else threading.current_thread().name)
    out.append((name, t0, t1, lane))


def recording() -> bool:
    return _spans is not None


def start() -> None:
    """Starts a new record; the calling thread is lane ``main``."""
    global _spans, _main, _active
    _main = threading.get_ident()
    _spans = []
    _active = True


def stop() -> List[Span]:
    """Ends the record and returns it ([] if none was started)."""
    global _spans, _active
    out, _spans = _spans, None
    _active = _annotate
    return out or []


def annotate(on: bool) -> None:
    """Spans also open ``torch.profiler.record_function`` while on."""
    global _annotate, _active
    _annotate = bool(on)
    _active = _annotate or _spans is not None
