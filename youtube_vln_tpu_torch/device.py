"""Where the port's entry points run, and how batches get there."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU, and an error when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; to a GPU through pinned host
    memory and non-blocking copies on the current stream.  Tensors already
    there are passed through."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        if t.device.type != device.type:
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
        out[k] = t
    return out
