"""Where the port's entry points run, and how batches get there."""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

from .utils import spans


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU, and an error when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def make_generator(seed, device) -> torch.Generator:
    """``seed`` (an int) as a generator on ``device``; a generator passes
    through."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def check_device(model: torch.nn.Module, device) -> torch.device:
    """``resolve_device(device)``, which must be where ``model`` lives."""
    dev = resolve_device(device)
    p = next(model.parameters(), None)
    if p is not None and p.device.type != dev.type:
        raise ValueError(f"the model is on {p.device}, the call on {dev}")
    return dev


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into pinned host memory of its own by the calling
    thread alone (numpy's copy, which lets go of the GIL): torch's copy
    would start an intra-op team of threads beside the caller, which on
    the feed thread takes the cores from the thread that launches the
    step."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    try:
        src = t.numpy()
    except TypeError:           # a dtype numpy lacks
        return out.copy_(t)
    np.copyto(out.numpy(), src)
    return out


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; to a GPU through pinned host
    memory (a buffer of its own, never the numpy batch's memory) and
    non-blocking copies on the current stream (spans ``feed.pin`` and
    ``feed.copy``, each a tensor's).  Tensors already there are passed
    through."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        if t.device.type != device.type:
            if device.type == "cuda":
                with spans.span("feed.pin"):
                    t = _pinned(t)
                with spans.span("feed.copy"):
                    t = t.to(device, non_blocking=True)
            else:
                t = t.to(device)
        out[k] = t
    return out


# the takes of ``prefetch_to_device`` (its ``next()`` calls, the one that
# finds the end included), and of them those that found a batch already
# waiting
FEED_COUNTS = {"takes": 0, "ready": 0}
_COUNTS_LOCK = threading.Lock()

_POLL_S = 0.05      # how often a blocked wait looks at the other side
_JOIN_S = 60.0      # the longest ``close()`` waits for a batch in flight


def _feed(batches, device: torch.device, stream, slots: threading.Semaphore,
          ready: queue.SimpleQueue, stop: threading.Event) -> None:
    """The feed thread: takes a slot, then the next batch of ``batches``
    and its ``to_device`` (on ``stream`` where there is one, with an event
    recorded there after the copies), and puts (batch, event) in
    ``ready``; at the end None, or the exception that ended it.  It
    holds no reference to the consumer, and once ``stop`` is set it calls
    ``batches`` no more."""
    try:
        it = iter(batches)
        on_device = (torch.cuda.device(device) if stream is not None
                     else contextlib.nullcontext())
        with on_device:
            while True:
                while not slots.acquire(timeout=_POLL_S):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                try:
                    host = next(it)
                except StopIteration:
                    ready.put(None)
                    return
                if stop.is_set():
                    return
                with spans.span("feed.transfer"):
                    if stream is None:
                        out, event = to_device(host, device), None
                    else:
                        with torch.cuda.stream(stream):
                            out = to_device(host, device)
                            event = stream.record_event()
                # the host batch may view a Loader's slab: let it go now,
                # not at the next ``next()``, so the slab can be refilled
                del host
                ready.put((out, event))
    except BaseException as e:  # handed to the consumer, who raises it
        ready.put(e)


def _take(ready: queue.SimpleQueue, thread: threading.Thread):
    """The next item of ``ready``, under a ``feed.wait`` span, counted in
    ``FEED_COUNTS``; waits while the feed thread lives."""
    with spans.span("feed.wait"):
        try:
            item, hit = ready.get_nowait(), True
        except queue.Empty:
            hit = False
            while True:
                try:
                    item = ready.get(timeout=_POLL_S)
                    break
                except queue.Empty:
                    if not thread.is_alive() and ready.empty():
                        raise RuntimeError("the feed thread ended without "
                                           "handing over a batch") from None
    with _COUNTS_LOCK:
        FEED_COUNTS["takes"] += 1
        FEED_COUNTS["ready"] += hit and isinstance(item, tuple)
    return item


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]],
                       device: torch.device, depth: int = 2
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """``batches`` through ``to_device``, in order, from a feed thread.

    The first ``next()`` starts a daemon thread named ``feed``, which alone
    iterates ``batches`` (for a ``Loader``: its wait, and its collate where
    the workers do not write the batch in place) and runs each batch's
    ``to_device`` under a ``feed.transfer`` span (lane ``feed``), keeping
    no host batch past it.  While the consumer uses batch k, at most
    ``depth`` later batches are ready or in flight.  Each take is a
    ``feed.wait`` span on the consumer's thread and counts in
    ``FEED_COUNTS``.  To CUDA the copies run on a stream of their own; at
    the take the current stream waits on them and each tensor is recorded
    on it, so the allocator keeps its memory until that stream is done
    with it.  An exception raised in the thread is raised at the take
    where its batch would have come, and ends the batches.  ``close()``,
    or collection, stops the thread and joins it before returning."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    slots = threading.Semaphore(max(1, depth) + 1)
    ready: queue.SimpleQueue = queue.SimpleQueue()
    stop = threading.Event()
    thread = threading.Thread(target=_feed, name="feed", daemon=True,
                              args=(batches, device, stream, slots, ready, stop))
    thread.start()
    try:
        while True:
            item = _take(ready, thread)
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            out, event = item
            del item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in out.values():
                    if t.device.type == "cuda":
                        t.record_stream(current)
            yield out
            del out
            slots.release()     # the consumer is done with its batch
    finally:
        stop.set()
        slots.release()         # wakes a thread that waits for a slot
        thread.join(_JOIN_S)
        if thread.is_alive():
            raise RuntimeError(f"the feed thread did not stop within {_JOIN_S} s")
