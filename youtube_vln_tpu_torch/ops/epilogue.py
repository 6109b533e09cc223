"""Fused dropout + residual + LayerNorm epilogue of the port: the CUDA
kernels B5/B6 and their plain version.

``fused_dropout_add_ln`` (B5 forward, B6 backward) replaces
``youtube_vln_tpu/ops/epilogue.py`` ``_epi_fwd_kernel`` /
``_epi_bwd_kernel`` (``pallas_dropout_add_ln``): LayerNorm(dropout(h) +
res) per row of the last dim, with the dropout scale and the residual add
rounded in h's dtype, LayerNorm statistics in f32 and eps 1e-12 inside the
rsqrt.  The wrapper runs the plain PyTorch version (``epilogue_reference``,
and ``epilogue_bwd_reference`` for the backward) when the tensors lie on
the CPU and launches the kernels of ``csrc/epilogue.cu`` when they lie on
a CUDA device; it never falls back from one to the other.  When autograd
records the call, the forward runs inside ``FusedEpilogueFn`` whose
backward is B6.  ``LAUNCHES`` counts kernel launches, one per wrapper call
that launched.

Dropout keeps an element when its Philox draw is at least rate * 2^32 (the
exact rate of the attention kernels, ``ops/philox.py:epilogue_keep``) and
scales kept values by 1 / (1 - rate); the mask is a pure function of (row,
column) under the call's 64-bit seed, so B6 replays B5's mask; ``row0`` is
the call's first global row (rank * N when each process of a
data-parallel run holds N rows of the global batch, 0 in one process).

``use_epilogue_kernel_for`` is the site rule of the JAX package's
``select_epilogue_fn`` (``epilogue.py:265-274``): train mode, a rate above
0, at least ``MIN_FUSED_ELEMENTS`` elements and a last dim that is a
multiple of 128.  At the pretraining geometry that is the vision stream
(56 x 808 x 1024 elements), 24 sites per micro-step.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _rowwise
from ._rowwise import param as _param
from ._rowwise import rows as _rows
from .attention import SeedSlot, _Dropout, _dropout, _on_cpu, _records_grad
from .layer_norm import layer_norm_grads, layer_norm_reference, normalise
from .philox import EPILOGUE_DIRECTION, epilogue_keep

# only where the mask traffic matters (the JAX package's threshold); tests
# may lower it to reach the kernel sites at small shapes
MIN_FUSED_ELEMENTS = 1 << 22
MAX_D = 1024                 # csrc/epilogue.cu MAX_D
# vln_epilogue_bwd_layout's out[6], in order
BWD_LAYOUT_FIELDS = ("rows_per_block", "threads", "blocks_per_sm", "smem_bytes",
                     "registers", "local_bytes")

# kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"epilogue_fwd": 0, "epilogue_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_epilogue_kernel_for(numel: int, d: int, rate: float,
                            train: bool) -> bool:
    """Whether a dropout + add + LayerNorm site runs the fused epilogue
    (``select_epilogue_fn.fn``)."""
    return (train and rate > 0.0 and numel >= MIN_FUSED_ELEMENTS
            and d % 128 == 0)


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def _keep_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate)


def _check_pair(h, res):
    if h.shape != res.shape or h.dtype != res.dtype:
        raise ValueError(f"h {tuple(h.shape)} {h.dtype} and res "
                         f"{tuple(res.shape)} {res.dtype} must match")


def _keep(h, rate: float, seed: int, row0: int):
    d = h.shape[-1]
    return epilogue_keep(seed, rate, h.numel() // d, d, h.device,
                         row0).view(h.shape)


def _dropped(h, rate: float, seed: int, row0: int):
    """dropout(h) rounded to h's dtype: kept values times 1 / (1 - rate)."""
    if rate == 0.0:
        return h
    return torch.where(_keep(h, rate, seed, row0), h * _keep_scale(rate),
                       0.0).to(h.dtype)


def epilogue_reference(h, res, weight, bias, dropout_rate: float = 0.0,
                       seed: int = 0, row0: int = 0):
    """LayerNorm(dropout(h) + res) with ``weight``/``bias`` (f32, [D]),
    in h's dtype; at rate 0 it is ``ops/layer_norm.py:layer_norm_reference``
    of h + res, op for op."""
    _check_pair(h, res)
    return layer_norm_reference(_dropped(h, dropout_rate, seed, row0) + res,
                                weight, bias)


def epilogue_bwd_reference(h, res, weight, do, dropout_rate: float = 0.0,
                           seed: int = 0, row0: int = 0):
    """(dh, dres, dw, db) of ``epilogue_reference`` for the output gradient
    ``do``, as the TPU kernel computes them (``_epi_bwd_kernel``): recompute
    yhat and rstd, dy = rstd (dyhat - mean(dyhat) - yhat mean(dyhat yhat))
    with dyhat = do w, dres = dy, dh = dy with the mask replayed, dw = sum
    do yhat and db = sum do over the rows, in f32 (``layer_norm_grads``)."""
    _check_pair(h, res)
    yhat, rstd = normalise(_dropped(h, dropout_rate, seed, row0) + res)
    dy, dw, db = layer_norm_grads(yhat, rstd, weight, do)
    dh = dy
    if dropout_rate > 0.0:
        dh = torch.where(_keep(h, dropout_rate, seed, row0),
                         dy * _keep_scale(dropout_rate), 0.0)
    return dh.to(h.dtype), dy.to(res.dtype), dw, db


# --------------------------------------------------------------------------- #
# kernel interface (csrc/epilogue.cu)
# --------------------------------------------------------------------------- #
class _Epilogue(ctypes.Structure):
    """Mirror of ``struct Epilogue`` in csrc/epilogue.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("h", "res", "w", "b", "dout", "out", "dh", "dres",
                  "dw_part", "db_part", "dw", "db")]
                + [(n, ctypes.c_int) for n in ("n_rows", "d", "n_blocks")]
                + [("dropout", _Dropout)])


def _kernel(name: str, argtypes=_rowwise.ARGTYPES):
    """The C entry ``vln_<name>`` of ``csrc/epilogue.cu``, built on first
    use."""
    return _rowwise.entry("epilogue", name, argtypes)


def _check_kernel_operands(h, res, weight, *params):
    _check_pair(h, res)
    d = h.shape[-1]
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"epilogue kernel takes bf16 or f32, got {h.dtype}")
    if d % 128 or d > MAX_D or h.numel() == 0:
        raise ValueError(f"epilogue kernel takes a last dim that is a "
                         f"multiple of 128 up to {MAX_D} and N >= 1, got "
                         f"{tuple(h.shape)}")
    for p in (weight,) + params:
        if p.shape != (d,) or p.dtype != torch.float32:
            raise ValueError(f"LayerNorm parameters must be [{d}] float32, "
                             f"got {tuple(p.shape)} {p.dtype}")


def _epilogue_fwd(h, res, weight, bias, rate, seed, row0=0, seed_slot=None):
    """B5 on CUDA operands: (out [N, D], the operands as read)."""
    _check_kernel_operands(h, res, weight, bias)
    d = h.shape[-1]
    h, res, weight, bias = _rows(h, d), _rows(res, d), _param(weight), _param(bias)
    out = torch.empty_like(h)
    problem = _Epilogue(h=h.data_ptr(), res=res.data_ptr(), w=weight.data_ptr(),
                        b=bias.data_ptr(), out=out.data_ptr(), n_rows=h.shape[0],
                        d=d, dropout=_dropout(rate, seed, EPILOGUE_DIRECTION, row0,
                                              seed_slot=seed_slot))
    _rowwise.launch("epilogue", "epilogue_fwd", problem, h)
    LAUNCHES["epilogue_fwd"] += 1
    return out, (h, res, weight)


@functools.lru_cache(maxsize=None)
def _bwd_layout(is_bf16: bool, device_index: int) -> dict:
    """B6's layout on a card (``vln_epilogue_bwd_layout``), by
    ``BWD_LAYOUT_FIELDS``: rows and threads per block, the resident blocks
    per SM of the occupancy query, shared memory per block, registers and
    local bytes per thread."""
    out = (ctypes.c_int * len(BWD_LAYOUT_FIELDS))()
    with torch.cuda.device(device_index):
        err = _kernel("epilogue_bwd_layout", (ctypes.c_int, ctypes.c_void_p))(
            int(is_bf16), out)
    if err != 0:
        raise RuntimeError(f"vln_epilogue_bwd_layout failed with CUDA error {err}")
    return dict(zip(BWD_LAYOUT_FIELDS, out))


def _bwd_blocks(n_rows: int, rows_per_block: int, blocks_per_sm: int,
                sms: int) -> int:
    """B6's grid: one wave of the blocks that fit on the card at once
    (``blocks_per_sm`` from the occupancy query, on every SM), or fewer when
    the rows need fewer; every block then walks its rows in a loop."""
    return _rowwise.one_wave(n_rows, rows_per_block, blocks_per_sm * sms,
                             "epilogue backward kernel")


def _epilogue_bwd(h, res, weight, do, rate, seed, row0=0, seed_slot=None):
    """B6 on CUDA operands (as ``_epilogue_fwd`` read them): (dh, dres, dw,
    db); dh/dres [N, D] in h's dtype, dw/db [D] f32."""
    n, d = h.shape
    do = _rows(do.to(h.dtype), d)
    layout = _bwd_layout(h.dtype == torch.bfloat16, h.device.index)
    n_blocks = _bwd_blocks(n, layout["rows_per_block"], layout["blocks_per_sm"],
                           torch.cuda.get_device_properties(h.device).multi_processor_count)
    dh, dres = torch.empty_like(h), torch.empty_like(h)
    parts = torch.empty(2, n_blocks, d, dtype=torch.float32, device=h.device)
    dw_db = torch.empty(2, d, dtype=torch.float32, device=h.device)
    problem = _Epilogue(h=h.data_ptr(), res=res.data_ptr(), w=weight.data_ptr(),
                        dout=do.data_ptr(), dh=dh.data_ptr(), dres=dres.data_ptr(),
                        dw_part=parts[0].data_ptr(), db_part=parts[1].data_ptr(),
                        dw=dw_db[0].data_ptr(), db=dw_db[1].data_ptr(),
                        n_rows=n, d=d, n_blocks=n_blocks,
                        dropout=_dropout(rate, seed, EPILOGUE_DIRECTION, row0,
                                         seed_slot=seed_slot))
    _rowwise.launch("epilogue", "epilogue_bwd", problem, h)
    LAUNCHES["epilogue_bwd"] += 1
    return dh, dres, dw_db[0], dw_db[1]


class FusedEpilogueFn(torch.autograd.Function):
    """B5 forward, B6 backward (plain versions for CPU tensors);
    ``seed_slot`` where the kernels read the seed (``_dropout``)."""

    @staticmethod
    def forward(ctx, h, res, weight, bias, dropout_rate, seed, row0,
                seed_slot=None):
        ctx.rate, ctx.seed, ctx.row0, ctx.shape = dropout_rate, seed, row0, h.shape
        ctx.seed_slot = seed_slot
        ctx.on_cpu = _on_cpu(h, res, weight, bias)
        if ctx.on_cpu:
            ctx.save_for_backward(h, res, weight)
            return epilogue_reference(h, res, weight, bias, dropout_rate, seed,
                                      row0)
        out, operands = _epilogue_fwd(h, res, weight, bias, dropout_rate, seed,
                                      row0, seed_slot=seed_slot)
        ctx.save_for_backward(*operands)
        return out.view(h.shape)

    @staticmethod
    def backward(ctx, do):
        h, res, weight = ctx.saved_tensors
        if ctx.on_cpu:
            dh, dres, dw, db = epilogue_bwd_reference(h, res, weight, do,
                                                      ctx.rate, ctx.seed,
                                                      ctx.row0)
        else:
            dh, dres, dw, db = _epilogue_bwd(h, res, weight, do, ctx.rate,
                                             ctx.seed, ctx.row0,
                                             seed_slot=ctx.seed_slot)
        return (dh.view(ctx.shape), dres.view(ctx.shape), dw, db, None, None,
                None, None)


def fused_dropout_add_ln(h, res, weight, bias, *, dropout_rate: float = 0.0,
                         seed: int = 0, row0: int = 0,
                         seed_slot: Optional[SeedSlot] = None):
    """B5: LayerNorm(dropout(h) + res) over the last dim; its gradient is
    B6.

    h, res: [..., D] of one dtype (bf16 or f32 on the card, D a multiple of
    128 up to 1024); weight, bias: [D] f32; ``seed`` is the call's 64-bit
    dropout seed and ``row0`` its first global row (0 in one process);
    ``seed_slot`` (table, index), where given, is where the kernels read
    the seed on the device instead (``ops/attention.py:_dropout``).
    Returns h's shape and dtype."""
    if _records_grad(h, res, weight, bias):
        return FusedEpilogueFn.apply(h, res, weight, bias, float(dropout_rate),
                                     int(seed), int(row0), seed_slot)
    if _on_cpu(h, res, weight, bias):
        return epilogue_reference(h, res, weight, bias, dropout_rate, seed,
                                  row0)
    return _epilogue_fwd(h, res, weight, bias, dropout_rate, seed,
                         row0, seed_slot=seed_slot)[0].view(h.shape)
