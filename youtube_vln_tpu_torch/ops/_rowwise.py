"""What the wrappers of the row kernels share: ``ops/epilogue.py`` (B5/B6,
``csrc/epilogue.cu``) and ``ops/layer_norm.py`` (``csrc/layer_norm.cu``).

Their operands as the kernels read them (``rows``, ``param``), their C
entry points, built and loaded on first use (``entry``), one launch of an
entry that takes (the call's struct, 1 for bf16 or 0 for f32, the stream)
on the current stream (``launch``), and a backward's grid of one wave of
resident blocks (``one_wave``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# (const Call*, int is_bf16, void* stream), the row kernels' launch entries
ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)

_entries = {}


def rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """x as the kernels read it: contiguous [N, d] on a 16-byte boundary."""
    x = x.reshape(-1, d)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def param(p: torch.Tensor) -> torch.Tensor:
    """A [D] parameter as the kernels read it."""
    return rows(p, p.shape[0])[0]


def entry(source: str, name: str, argtypes=ARGTYPES):
    """The C entry ``vln_<name>`` of ``csrc/<source>.cu``, built on first
    use."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load(source), f"vln_{name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def launch(source: str, name: str, call: ctypes.Structure, x: torch.Tensor) -> None:
    """``vln_<name>(&call, x is bf16, the current stream)`` on x's device;
    raises on a CUDA error."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(source, name)(ctypes.byref(call), int(x.dtype == torch.bfloat16),
                                  stream)
    if err != 0:
        raise RuntimeError(f"vln_{name} failed with CUDA error {err}")


def one_wave(n_rows: int, rows_per_block: int, wave: int, what: str) -> int:
    """A backward's grid: one wave of the ``wave`` blocks that fit on the
    card at once, or fewer when the rows need fewer; every block then walks
    its rows in a loop."""
    if wave < 1:
        raise RuntimeError(f"the {what} fits no block on the card")
    return max(1, min(math.ceil(n_rows / rows_per_block), wave))
