"""LayerNorm of the port: the CUDA kernels of ``csrc/layer_norm.cu`` and
their plain version, at every LayerNorm site that the B5/B6 epilogue does
not take.

``layer_norm(x, weight, bias)`` is the JAX package's ``layer_norm``
(``youtube_vln_tpu/models/layers.py:63-70``): TF-style, statistics over the
last dim in f32, eps 1e-12 inside the rsqrt, the f32 ``weight`` and
``bias`` applied in f32 and the result rounded once to x's dtype.  Its
gradients are dx in x's dtype and dweight, dbias in f32.  It runs the plain
version (``layer_norm_reference``, and the closed form
``layer_norm_bwd_reference`` for the backward) when the tensors lie on the
CPU and launches the kernels when they lie on a CUDA device (bf16 or f32, a
last dim that is a multiple of 8 up to ``MAX_D``); it never falls back from
one to the other.  When autograd records the call, the forward runs inside
``LayerNormFn``, which saves x alone.  ``LAUNCHES`` counts kernel launches,
one per wrapper call that launched.

``normalise`` and ``layer_norm_grads`` are the plain statistics and
gradients, shared with the epilogue's plain version (``ops/epilogue.py``);
the kernels' operands, C entries and launch are ``ops/_rowwise.py``'s,
shared with the epilogue's kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _rowwise
from ._rowwise import param as _param
from ._rowwise import rows as _rows
from .attention import _on_cpu, _records_grad

LN_EPS = 1e-12
MAX_D = 1024                 # csrc/layer_norm.cu MAX_D
ROWS_PER_BLOCK = 8           # csrc/layer_norm.cu WARPS: one row per warp

# kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def normalise(x):
    """(xhat, rstd) of x over its last dim in f32: the statistics of the
    JAX ``layer_norm``, op for op."""
    x32 = x.float()
    u = x32.mean(-1, keepdim=True)
    s = (x32 - u).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(s + LN_EPS)
    return (x32 - u) * rstd, rstd


def layer_norm_reference(x, weight, bias):
    """weight * xhat + bias in f32, in x's dtype."""
    xhat, _ = normalise(x)
    return (weight * xhat + bias).to(x.dtype)


def layer_norm_grads(xhat, rstd, weight, dy):
    """(dx, dweight, dbias) in f32 of ``weight * xhat + bias`` for the
    output gradient ``dy``, as the kernel computes them: dx = rstd (g -
    mean(g) - xhat mean(g xhat)) with g = dy weight, dweight = sum dy xhat
    and dbias = sum dy over the rows."""
    d = xhat.shape[-1]
    dy32 = dy.float()
    g = dy32 * weight
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xhat).mean(-1, keepdim=True)
    dx = rstd * (g - m1 - xhat * m2)
    return dx, (dy32 * xhat).reshape(-1, d).sum(0), dy32.reshape(-1, d).sum(0)


def layer_norm_bwd_reference(x, weight, dy):
    """(dx in x's dtype, dweight, dbias in f32) of ``layer_norm_reference``."""
    xhat, rstd = normalise(x)
    dx, dw, db = layer_norm_grads(xhat, rstd, weight, dy)
    return dx.to(x.dtype), dw, db


# --------------------------------------------------------------------------- #
# kernel interface (csrc/layer_norm.cu)
# --------------------------------------------------------------------------- #
class _LayerNormCall(ctypes.Structure):
    """Mirror of ``struct LayerNormCall`` in csrc/layer_norm.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("x", "w", "b", "dy", "y", "dx", "dw_part", "db_part", "dw", "db")]
                + [(n, ctypes.c_int) for n in ("n_rows", "d", "n_blocks")])


def _check_kernel_operands(x, weight, bias):
    d = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"LayerNorm kernel takes bf16 or f32, got {x.dtype}")
    if d % 8 or d > MAX_D or x.numel() == 0:
        raise ValueError(f"LayerNorm kernel takes a last dim that is a multiple "
                         f"of 8 up to {MAX_D} and N >= 1, got {tuple(x.shape)}")
    for p in (weight, bias):
        if p.shape != (d,) or p.dtype != torch.float32:
            raise ValueError(f"LayerNorm parameters must be [{d}] float32, "
                             f"got {tuple(p.shape)} {p.dtype}")


def _fwd(x, weight, bias):
    """The forward kernel on CUDA operands: (y [N, D], x as read)."""
    _check_kernel_operands(x, weight, bias)
    d = x.shape[-1]
    x, weight, bias = _rows(x, d), _param(weight), _param(bias)
    y = torch.empty_like(x)
    _rowwise.launch("layer_norm", "layer_norm_fwd", _LayerNormCall(
        x=x.data_ptr(), w=weight.data_ptr(), b=bias.data_ptr(), y=y.data_ptr(),
        n_rows=x.shape[0], d=d), x)
    LAUNCHES["layer_norm_fwd"] += 1
    return y, x


@functools.lru_cache(maxsize=None)
def _bwd_wave(is_bf16: bool, device_index: int) -> int:
    """The backward's resident blocks on the whole card
    (``vln_layer_norm_bwd_wave``: the occupancy query times the SMs)."""
    out = ctypes.c_int()
    with torch.cuda.device(device_index):
        err = _rowwise.entry("layer_norm", "layer_norm_bwd_wave",
                             (ctypes.c_int, ctypes.c_void_p))(
            int(is_bf16), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"vln_layer_norm_bwd_wave failed with CUDA error {err}")
    return out.value


def _bwd_blocks(n_rows: int, wave: int) -> int:
    """The backward's grid (``_rowwise.one_wave``) of 8-row blocks."""
    return _rowwise.one_wave(n_rows, ROWS_PER_BLOCK, wave, "LayerNorm backward kernel")


def _bwd(x, weight, dy):
    """The backward kernels on CUDA operands (x as ``_fwd`` read it): (dx
    [N, D] in x's dtype, dweight, dbias [D] f32)."""
    n, d = x.shape
    dy = _rows(dy.to(x.dtype), d)
    n_blocks = _bwd_blocks(n, _bwd_wave(x.dtype == torch.bfloat16, x.device.index))
    dx = torch.empty_like(x)
    parts = torch.empty(2, n_blocks, d, dtype=torch.float32, device=x.device)
    dw_db = torch.empty(2, d, dtype=torch.float32, device=x.device)
    _rowwise.launch("layer_norm", "layer_norm_bwd", _LayerNormCall(
        x=x.data_ptr(), w=weight.data_ptr(), dy=dy.data_ptr(), dx=dx.data_ptr(),
        dw_part=parts[0].data_ptr(), db_part=parts[1].data_ptr(),
        dw=dw_db[0].data_ptr(), db=dw_db[1].data_ptr(),
        n_rows=n, d=d, n_blocks=n_blocks), x)
    LAUNCHES["layer_norm_bwd"] += 1
    return dx, dw_db[0], dw_db[1]


class LayerNormFn(torch.autograd.Function):
    """The forward kernel, the backward kernels as its gradient (plain
    versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.shape = x.shape
        ctx.on_cpu = _on_cpu(x, weight, bias)
        if ctx.on_cpu:
            ctx.save_for_backward(x, weight)
            return layer_norm_reference(x, weight, bias)
        y, rows = _fwd(x, weight, bias)
        ctx.save_for_backward(rows, _param(weight))
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        if ctx.on_cpu:
            dx, dw, db = layer_norm_bwd_reference(x, weight, dy)
        else:
            dx, dw, db = _bwd(x, weight, dy)
        return dx.view(ctx.shape), dw, db


def layer_norm(x, weight, bias):
    """LayerNorm over the last dim of x ([..., D], bf16 or f32 on the card)
    with ``weight`` / ``bias`` ([D] f32); returns x's shape and dtype."""
    if _records_grad(x, weight, bias):
        return LayerNormFn.apply(x, weight, bias)
    if _on_cpu(x, weight, bias):
        return layer_norm_reference(x, weight, bias)
    return _fwd(x, weight, bias)[0].view(x.shape)
