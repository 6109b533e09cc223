"""Where the port's entry points run, and how batches get there."""
from __future__ import annotations

import collections
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


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; to a GPU through pinned host
    memory and non-blocking copies on the current stream (spans
    ``feed.pin`` and ``feed.copy``, each a tensor's).  Tensors already
    there are passed through."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        if t.device.type != device.type:
            if device.type == "cuda":
                with spans.span("feed.pin"):
                    t = t.pin_memory()
                with spans.span("feed.copy"):
                    t = t.to(device, non_blocking=True)
            else:
                t = t.to(device)
        out[k] = t
    return out


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]],
                       device: torch.device, depth: int = 2
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Starts the copies of up to ``depth`` batches ahead of their use, so
    the host-to-device transfer overlaps the work on earlier batches.  Each
    batch's ``to_device`` is a ``feed.transfer`` span."""
    buf = collections.deque()
    it = iter(batches)
    for b in it:
        with spans.span("feed.transfer"):
            buf.append(to_device(b, device))
        if len(buf) >= depth:
            break
    while buf:
        out = buf.popleft()
        for b in it:
            with spans.span("feed.transfer"):
                buf.append(to_device(b, device))
            break
        yield out
