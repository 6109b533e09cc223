"""``jax.image.resize`` in PyTorch, as the JAX pipeline calls it.

Every preprocessor of the JAX pipeline resizes with ``jax.image.resize``,
which ``F.interpolate`` does not reproduce:

  * ``"bilinear"`` and ``"bicubic"`` default to ``antialias=True``: when
    downsampling, the kernel's support widens by 1/scale (a low-pass
    filter);
  * its cubic is Keys' with a = -0.5 (``F.interpolate`` uses -0.75);
  * at the borders it renormalises the kernel's weights over the samples
    inside the image (``F.interpolate`` clamps the coordinates instead),
    and an output sample whose centre falls outside the input is zero.

So the resize is separable: per resized axis a ``[in, out]`` weight matrix
built on the host as ``jax/_src/image/scale.py:compute_weight_mat`` builds
it under ``jit`` (in float32: the triangle or Keys kernel on the distances,
columns normalised by their sums, columns of out-of-range samples zeroed),
applied on the tensor's device with one product per axis.  An axis whose
size does not change is left alone, as JAX leaves it.  ``"nearest"``
gathers the rows ``floor((i + 0.5) * in / out)``, JAX's rule (torchvision's
``F.interpolate(mode="nearest")`` takes ``floor(i * in / out)``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (x >= 0)."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0), out).astype(np.float32)


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "triangle": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str,
                  antialias: bool = True) -> np.ndarray:
    """The ``[in_size, out_size]`` float32 weights of one resized axis
    (``compute_weight_mat`` with scale = out / in and no translation)."""
    kernel = _KERNELS[method]
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    # (i + 0.5) * inv_scale - 0.5 rounded once, as the fused multiply-add
    # of XLA's compiled resize rounds it (the product of two float32 is
    # exact in float64): rounding the product first moves a sample by up to
    # an ulp of its coordinate, 1.2e-4 at 1,280
    sample_f = ((np.arange(out_size, dtype=np.float64) + 0.5) * np.float64(inv_scale)
                - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = kernel(x.astype(f32)).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * _F32_EPS,
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _weights_on(in_size, out_size, method, antialias, device) -> torch.Tensor:
    w = weight_matrix(in_size, out_size, method, antialias)
    return torch.from_numpy(w).to(device)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """The input row of each output row under JAX's ``"nearest"``."""
    offsets = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size) / np.float32(out_size)
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def resize(x: torch.Tensor, size: Tuple[int, int], method: str,
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize`` over the last two dims of ``x`` (``[..., H,
    W]``, float32), to ``size`` = (h, w)."""
    h_in, w_in = x.shape[-2:]
    h, w = size
    if method == "nearest":
        if h != h_in:
            x = x.index_select(-2, torch.from_numpy(
                nearest_indices(h_in, h)).to(x.device))
        if w != w_in:
            x = x.index_select(-1, torch.from_numpy(
                nearest_indices(w_in, w)).to(x.device))
        return x
    if w != w_in:
        x = torch.matmul(x, _weights_on(w_in, w, method, antialias, x.device))
    if h != h_in:
        wh = _weights_on(h_in, h, method, antialias, x.device)
        x = torch.matmul(wh.t(), x)
    return x
