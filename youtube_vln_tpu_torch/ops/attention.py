"""Attention of the port: the CUDA kernels B1 and B2 and their plain versions.

  * ``fused_attention`` (B1) replaces ``youtube_vln_tpu/ops/attention.py``
    ``_fwd_kernel`` / ``pallas_attention_core``: one (q, k, v) problem.
  * ``fused_bi_attention`` (B2) replaces ``_bi_fwd_kernel`` /
    ``pallas_bi_attention``: both directions of co-attention in one launch.

Both wrappers run their plain PyTorch version (``attention_reference``,
``bi_attention_reference``) when the tensors lie on the CPU, and launch the
kernel of ``csrc/attention_fwd.cu`` when they lie on a CUDA device; they
never fall back from one to the other.  ``LAUNCHES`` counts kernel
launches, one per wrapper call that launched.

Layouts follow the JAX package: q, k, v are ``[B, H, S, D]`` (any strides
with a contiguous last dim; others are copied with ``.contiguous()``), the
key bias is ``[B, S_kv]`` f32 (the additive ``(1 - m) * -10000`` mask).
The kernel writes its output as a ``[B, H, S, D]`` view of a
``[B, S, H, D]`` buffer, so ``merge_heads`` after it is a free view.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

# kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"attention_fwd": 0, "bi_attention_fwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernel_for(s_q: int, s_kv: int, d: int) -> bool:
    """The kernels pay off when the score matrix is big enough to matter
    (vision self-attention and both co-attention directions); the small
    text self-attention stays on the plain path (mirrors
    ``use_pallas_for``)."""
    return s_q * s_kv >= 4096 and d in (64, 128)


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def attention_reference(q, k, v, key_bias: Optional[torch.Tensor]):
    """softmax(q k^T / sqrt(D) + key_bias) v with f32 scores and softmax;
    the probabilities are cast to v's dtype before P v (as
    ``models/layers.py:attention_core`` of the JAX package)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(q.shape[-1])
    if key_bias is not None:
        scores = scores + key_bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def bi_attention_reference(q1, k1, v1, q2, k2, v2, v_bias, t_bias):
    """(ctx1, ctx2): text queries q2 over vision k1/v1, vision queries q1
    over text k2/v2."""
    return (attention_reference(q2, k1, v1, v_bias),
            attention_reference(q1, k2, v2, t_bias))


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
class _Problem(ctypes.Structure):
    """Mirror of ``struct Problem`` in csrc/attention_fwd.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "bias", "o")]
                + [(f"{t}_s{a}", ctypes.c_longlong)
                   for t in "qkvo" for a in "bhs"]
                + [("s_q", ctypes.c_int), ("s_kv", ctypes.c_int)])


_kernel_fn = None


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load("attention_fwd").vln_attention_fwd
        fn.argtypes = [ctypes.POINTER(_Problem), ctypes.POINTER(_Problem),
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _on_cpu(*tensors) -> bool:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"attention operands on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"attention kernels run on CUDA or CPU, not {dev}")
    return False


def _operand(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """q/k/v as the kernel reads them: the dtype of ``like``, contiguous last
    dim, other strides and the base on 16-byte boundaries."""
    if x.dtype != like.dtype or x.dim() != 4 or x.shape[-1] != like.shape[-1]:
        raise ValueError(f"operand {tuple(x.shape)} {x.dtype} does not match "
                         f"{tuple(like.shape)} {like.dtype}")
    vec = 16 // x.element_size()
    if (x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3])
            or x.data_ptr() % 16):
        x = x.contiguous()
    return x


def _key_bias(bias: Optional[torch.Tensor], b: int, s_kv: int, device):
    if bias is None:
        return torch.zeros(b, s_kv, dtype=torch.float32, device=device)
    if bias.shape != (b, s_kv) or bias.dtype != torch.float32:
        raise ValueError(f"key bias must be [{b}, {s_kv}] float32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    return bias.contiguous()


def _output(q: torch.Tensor) -> torch.Tensor:
    b, h, s, d = q.shape
    return torch.empty(b, s, h, d, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _problem(q, k, v, bias, out) -> _Problem:
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[2] < 1:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    return _Problem(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], *out.stride()[:3], q.shape[2], k.shape[2])


def _launch(p0: _Problem, p1: _Problem, q: torch.Tensor) -> None:
    b, h, _, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or d not in (64, 128):
        raise ValueError(f"attention kernel takes bf16/f32 with head dim 64 "
                         f"or 128, got {q.dtype} and {d}")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid's y limit")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(ctypes.byref(p0), ctypes.byref(p1), b, h, d,
                        int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"vln_attention_fwd failed with CUDA error {err}")


def _no_dropout(rate: float) -> None:
    if rate > 0.0:
        raise NotImplementedError(
            "attention dropout arrives with the backward kernels (training)")


def fused_attention(q, k, v, key_bias=None, *, dropout_rate: float = 0.0):
    """B1: softmax(q k^T / sqrt(D) + key_bias) v per (batch, head).

    q: [B, H, S_q, D]; k, v: [B, H, S_kv, D]; key_bias: [B, S_kv] f32 or
    None.  Returns [B, H, S_q, D] in q's dtype."""
    _no_dropout(dropout_rate)
    if _on_cpu(q, k, v, key_bias):
        return attention_reference(q, k, v, key_bias)
    q = _operand(q, q)
    k, v = _operand(k, q), _operand(v, q)
    bias = _key_bias(key_bias, q.shape[0], k.shape[2], q.device)
    out = _output(q)
    _launch(_problem(q, k, v, bias, out), _Problem(), q)
    LAUNCHES["attention_fwd"] += 1
    return out


def fused_bi_attention(q1, k1, v1, q2, k2, v2, v_bias=None, t_bias=None, *,
                       dropout_rate: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: both directions of co-attention in one launch.

    q1/k1/v1: vision projections [B, H, S_v, D]; q2/k2/v2: text [B, H, S_t,
    D]; v_bias [B, S_v], t_bias [B, S_t] f32.  Returns (ctx1 [B, H, S_t, D],
    ctx2 [B, H, S_v, D]): text queries over vision keys, and vision queries
    over text keys."""
    _no_dropout(dropout_rate)
    if _on_cpu(q1, k1, v1, q2, k2, v2, v_bias, t_bias):
        return bi_attention_reference(q1, k1, v1, q2, k2, v2, v_bias, t_bias)
    q1 = _operand(q1, q1)
    k1, v1, q2, k2, v2 = (_operand(x, q1) for x in (k1, v1, q2, k2, v2))
    b = q1.shape[0]
    vb = _key_bias(v_bias, b, k1.shape[2], q1.device)
    tb = _key_bias(t_bias, b, k2.shape[2], q1.device)
    ctx1, ctx2 = _output(q2), _output(q1)
    _launch(_problem(q2, k1, v1, vb, ctx1), _problem(q1, k2, v2, tb, ctx2), q1)
    LAUNCHES["bi_attention_fwd"] += 1
    return ctx1, ctx2
