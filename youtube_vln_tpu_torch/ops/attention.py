"""Attention of the port: the CUDA kernels B1-B4 and their plain versions.

  * ``fused_attention`` (B1 forward, B3 backward) replaces
    ``youtube_vln_tpu/ops/attention.py`` ``_fwd_kernel`` / ``_bwd_kernel``
    (``pallas_attention_core``): one (q, k, v) problem.
  * ``fused_bi_attention`` (B2 forward, B4 backward) replaces
    ``_bi_fwd_kernel`` / ``_bi_bwd_kernel`` (``pallas_bi_attention``): both
    directions of co-attention in one launch each way.

Both wrappers run their plain PyTorch versions (``attention_reference``,
``bi_attention_reference`` and the backward ``attention_bwd_reference``,
``bi_attention_bwd_reference``) when the tensors lie on the CPU, and launch
the kernels of ``csrc/attention_fwd.cu`` / ``csrc/attention_bwd.cu`` when
they lie on a CUDA device; they never fall back from one to the other.
When autograd records the call, the forward runs inside a
``torch.autograd.Function`` (``FusedAttentionFn``, ``FusedBiAttentionFn``)
whose backward is B3 / B4.  ``LAUNCHES`` counts kernel launches, one per
wrapper call that launched.

Layouts follow the JAX package: q, k, v are ``[B, H, S, D]`` (any strides
with a contiguous last dim; others are copied with ``.contiguous()``), the
key bias is ``[B, S_kv]`` f32 (the additive ``(1 - m) * -10000`` mask) and
gets no gradient.  The kernels write outputs and gradients as
``[B, H, S, D]`` views of ``[B, S, H, D]`` buffers, so ``merge_heads``
after them and the gradient of ``split_heads`` before them are free views.

Dropout applies to the probabilities with the exact rate and scales kept
values by 1 / (1 - rate) (``attention.py:40-45``); the mask comes from
``ops/philox.py`` (kernel and plain version draw the same bits) under one
64-bit seed per call, with stream id b * H + h of the whole problem: a
call on B rows and H_local heads passes ``stream0``, its first global
stream (data rank * B * H when each process of a data-parallel run holds
B rows of the global batch, 0 in one process), and ``head0`` /
``heads_total``, its first head of the problem's H when it holds a shard
of the heads under tensor parallelism (model rank * H_local; 0 and 0, the
call's own heads, without); row b, head h of the call then draws global
stream stream0 + b * H + head0 + h (``ops/philox.py:global_streams``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .philox import dropout_keep, keep_threshold, seed_key

# kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"attention_fwd": 0, "bi_attention_fwd": 0,
            "attention_bwd": 0, "bi_attention_bwd": 0}


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
def attention_scores(q, k, key_bias):
    """q k^T / sqrt(D) + key_bias in f32, [B, H, S_q, S_kv]."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(q.shape[-1])
    if key_bias is not None:
        scores = scores + key_bias.float()[:, None, None, :]
    return scores


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must be in [0, 1), got {rate}")


def _drop(probs, rate: float, seed: int, direction: int, stream0: int = 0,
          head0: int = 0, heads_total: int = 0):
    _check_rate(rate)
    if rate == 0.0:
        return probs
    b, h, s_q, s_kv = probs.shape
    keep = dropout_keep(seed, rate, b, h, s_q, s_kv, direction, probs.device,
                        stream0=stream0, head0=head0, heads_total=heads_total)
    return torch.where(keep, probs / (1.0 - rate), 0.0)


def attention_reference(q, k, v, key_bias: Optional[torch.Tensor],
                        dropout_rate: float = 0.0, seed: int = 0,
                        direction: int = 0, stream0: int = 0, head0: int = 0,
                        heads_total: int = 0):
    """softmax(q k^T / sqrt(D) + key_bias) v with f32 scores and softmax,
    dropout on the probabilities; the probabilities are cast to v's dtype
    before P v (as ``models/layers.py:attention_core`` of the JAX
    package)."""
    probs = torch.softmax(attention_scores(q, k, key_bias), dim=-1)
    probs = _drop(probs, dropout_rate, seed, direction, stream0, head0,
                  heads_total)
    return torch.matmul(probs.to(v.dtype), v)


def attention_lse_reference(q, k, key_bias) -> torch.Tensor:
    """log-sum-exp of the scores per query row, [B, H, S_q] f32: what the
    forward kernel hands to the backward."""
    return torch.logsumexp(attention_scores(q, k, key_bias), dim=-1)


def bi_attention_reference(q1, k1, v1, q2, k2, v2, v_bias, t_bias,
                           rate1: float = 0.0, rate2: float = 0.0,
                           seed: int = 0, stream0: int = 0, head0: int = 0,
                           heads_total: int = 0):
    """(ctx1, ctx2): text queries q2 over vision k1/v1 (direction 0, rate1),
    vision queries q1 over text k2/v2 (direction 1, rate2)."""
    streams = (stream0, head0, heads_total)
    return (attention_reference(q2, k1, v1, v_bias, rate1, seed, 0, *streams),
            attention_reference(q1, k2, v2, t_bias, rate2, seed, 1, *streams))


def attention_bwd_reference(q, k, v, key_bias, do, dropout_rate: float = 0.0,
                            seed: int = 0, direction: int = 0,
                            stream0: int = 0, head0: int = 0,
                            heads_total: int = 0):
    """(dq, dk, dv) of ``attention_reference`` for the output gradient
    ``do``, computed as the TPU kernel does (``_bwd_kernel``): recompute P,
    replay the dropout mask, dV = P~^T dO, dP = mask * (dO V^T) / (1 - r),
    dS = P o (dP - rowsum(P o dP)) / sqrt(D), dQ = dS K, dK = dS^T Q; all
    in f32, cast to the input dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(attention_scores(q, k, key_bias), dim=-1)
    streams = (stream0, head0, heads_total)
    p_drop = _drop(p, dropout_rate, seed, direction, *streams)
    dv = torch.matmul(p_drop.transpose(-1, -2), do32)
    dp = _drop(torch.matmul(do32, v32.transpose(-1, -2)), dropout_rate,
               seed, direction, *streams)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    return (torch.matmul(ds, k32).to(q.dtype),
            torch.matmul(ds.transpose(-1, -2), q32).to(k.dtype),
            dv.to(v.dtype))


def bi_attention_bwd_reference(q1, k1, v1, q2, k2, v2, v_bias, t_bias, do1,
                               do2, rate1: float = 0.0, rate2: float = 0.0,
                               seed: int = 0, stream0: int = 0, head0: int = 0,
                               heads_total: int = 0):
    """(dq1, dk1, dv1, dq2, dk2, dv2) of ``bi_attention_reference``
    (``_bi_bwd_kernel``)."""
    streams = (stream0, head0, heads_total)
    dq2, dk1, dv1 = attention_bwd_reference(q2, k1, v1, v_bias, do1, rate1,
                                            seed, 0, *streams)
    dq1, dk2, dv2 = attention_bwd_reference(q1, k2, v2, t_bias, do2, rate2,
                                            seed, 1, *streams)
    return dq1, dk1, dv1, dq2, dk2, dv2


# --------------------------------------------------------------------------- #
# kernel interface (csrc/philox.cuh, attention_fwd.cu, attention_bwd.cu)
# --------------------------------------------------------------------------- #
class _Dropout(ctypes.Structure):
    """Mirror of ``struct vln_philox::Dropout`` in csrc/philox.cuh."""
    _fields_ = ([(n, ctypes.c_uint32) for n in
                 ("seed_lo", "seed_hi", "threshold", "direction")]
                + [("keep_scale", ctypes.c_float), ("enabled", ctypes.c_int)]
                + [(n, ctypes.c_uint32) for n in ("offset", "heads_total",
                                                  "head0")])


class _Problem(ctypes.Structure):
    """Mirror of ``struct Problem`` in csrc/attention_fwd.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "bias", "o",
                                                 "lse")]
                + [(f"{t}_s{a}", ctypes.c_longlong)
                   for t in "qkvo" for a in "bhs"]
                + [("s_q", ctypes.c_int), ("s_kv", ctypes.c_int),
                   ("dropout", _Dropout)])


class _BwdProblem(ctypes.Structure):
    """Mirror of ``struct BwdProblem`` in csrc/attention_bwd.cu."""
    TENSORS = ("q", "k", "v", "o", "do", "dq", "dk", "dv")
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "bias", "o", "do", "lse", "delta", "dq",
                  "dk", "dv")]
                + [(f"{t}_s{a}", ctypes.c_longlong)
                   for t in TENSORS for a in "bhs"]
                + [("s_q", ctypes.c_int), ("s_kv", ctypes.c_int),
                   ("dropout", _Dropout)])


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_kernels = {}


def _kernel(name: str):
    """The C entry ``vln_<name>`` of ``csrc/<name>.cu``, built on first
    use."""
    fn = _kernels.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"vln_{name}")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _kernels[name] = fn
    return fn


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
    """A tensor as the kernels read it: the dtype of ``like``, contiguous
    last dim, other strides and the base on 16-byte boundaries."""
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


def _dropout(rate: float, seed: int, direction: int, offset: int = 0,
             heads_total: int = 0, head0: int = 0) -> _Dropout:
    """The Dropout settings of a launch; ``offset`` is its first global
    stream (B1-B4) or row (B5/B6), ``heads_total`` and ``head0`` the
    problem's heads and the launch's first (B1-B4)."""
    _check_rate(rate)
    for name, x in (("offset", offset), ("heads_total", heads_total),
                    ("head0", head0)):
        if not 0 <= x < 2 ** 32:
            raise ValueError(f"dropout {name} {x} outside [0, 2^32)")
    lo, hi = seed_key(seed)
    return _Dropout(lo, hi, keep_threshold(rate), direction,
                    1.0 / (1.0 - rate), int(rate > 0.0), offset, heads_total,
                    head0)


def _heads(q: torch.Tensor, head0: int, heads_total: int) -> Tuple[int, int]:
    """(heads_total, head0) of a launch on q's heads, checked."""
    heads = q.shape[1]
    total = heads_total or heads
    if head0 < 0 or head0 + heads > total:
        raise ValueError(f"heads [{head0}, {head0 + heads}) outside the "
                         f"problem's {total}")
    return total, head0


def _check_kv(q, k, v):
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[2] < 1:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")


def _problem(q, k, v, bias, out, lse, rate, seed, direction, stream0=0,
             head0=0, heads_total=0) -> _Problem:
    _check_kv(q, k, v)
    return _Problem(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *out.stride()[:3], q.shape[2], k.shape[2],
                    _dropout(rate, seed, direction, stream0,
                             *_heads(q, head0, heads_total)))


def _bwd_problem(q, k, v, bias, o, do, lse, delta, dq, dk, dv, rate, seed,
                 direction, stream0=0, head0=0, heads_total=0) -> _BwdProblem:
    _check_kv(q, k, v)
    tensors = (q, k, v, o, do, dq, dk, dv)
    return _BwdProblem(*(t.data_ptr() for t in (q, k, v, bias, o, do, lse,
                                                 delta, dq, dk, dv)),
                       *(s for t in tensors for s in t.stride()[:3]),
                       q.shape[2], k.shape[2],
                       _dropout(rate, seed, direction, stream0,
                                *_heads(q, head0, heads_total)))


def _launch(name: str, p0, p1, q: torch.Tensor) -> None:
    b, h, _, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or d not in (64, 128):
        raise ValueError(f"attention kernel takes bf16/f32 with head dim 64 "
                         f"or 128, got {q.dtype} and {d}")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid's y limit")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(name)(ctypes.byref(p0), ctypes.byref(p1), b, h, d,
                            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"vln_{name} failed with CUDA error {err}")


def _lse(q: torch.Tensor) -> torch.Tensor:
    b, h, s, _ = q.shape
    return torch.empty(b, h, s, dtype=torch.float32, device=q.device)


# --------------------------------------------------------------------------- #
# B1 / B3
# --------------------------------------------------------------------------- #
def _attention_fwd(q, k, v, bias, rate, seed, want_lse, stream0=0, head0=0,
                   heads_total=0):
    """B1 on CUDA operands: (out, lse or None, the operands as read)."""
    q = _operand(q, q)
    k, v = _operand(k, q), _operand(v, q)
    bias = _key_bias(bias, q.shape[0], k.shape[2], q.device)
    out = _output(q)
    lse = _lse(q) if want_lse else None
    _launch("attention_fwd",
            _problem(q, k, v, bias, out, lse, rate, seed, 0, stream0, head0,
                     heads_total), _Problem(), q)
    LAUNCHES["attention_fwd"] += 1
    return out, lse, (q, k, v, bias)


def _attention_bwd(q, k, v, bias, o, do, lse, rate, seed, stream0=0, head0=0,
                   heads_total=0):
    """B3 on CUDA operands: (dq, dk, dv)."""
    do = _operand(do, q)
    dq, dk, dv = _output(q), _output(k), _output(v)
    delta = torch.empty_like(lse)
    _launch("attention_bwd",
            _bwd_problem(q, k, v, bias, o, do, lse, delta, dq, dk, dv, rate,
                         seed, 0, stream0, head0, heads_total),
            _BwdProblem(), q)
    LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


class FusedAttentionFn(torch.autograd.Function):
    """B1 forward, B3 backward (plain versions for CPU tensors);
    ``streams`` is (stream0, head0, heads_total)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, dropout_rate, seed, streams):
        ctx.rate, ctx.seed, ctx.streams = dropout_rate, seed, streams
        if _on_cpu(q, k, v, key_bias):
            ctx.on_cpu = True
            ctx.save_for_backward(q, k, v, key_bias)
            return attention_reference(q, k, v, key_bias, dropout_rate, seed,
                                       0, *streams)
        ctx.on_cpu = False
        out, lse, (q, k, v, bias) = _attention_fwd(q, k, v, key_bias,
                                                   dropout_rate, seed, True,
                                                   *streams)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        if ctx.on_cpu:
            q, k, v, bias = ctx.saved_tensors
            grads = attention_bwd_reference(q, k, v, bias, do, ctx.rate,
                                            ctx.seed, 0, *ctx.streams)
        else:
            # read once: activation checkpointing (--remat) unpacks each
            # saved tensor a single time
            q, k, v, bias, out, lse = ctx.saved_tensors
            grads = _attention_bwd(q, k, v, bias, out, do, lse, ctx.rate,
                                   ctx.seed, *ctx.streams)
        return (*grads, None, None, None, None)


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_attention(q, k, v, key_bias=None, *, dropout_rate: float = 0.0,
                    seed: int = 0, stream0: int = 0, head0: int = 0,
                    heads_total: int = 0):
    """B1: dropout(softmax(q k^T / sqrt(D) + key_bias)) v per (batch, head);
    its gradient is B3.

    q: [B, H, S_q, D]; k, v: [B, H, S_kv, D]; key_bias: [B, S_kv] f32 or
    None; ``seed`` is the call's 64-bit dropout seed, ``stream0`` its first
    global stream (0 in one process) and ``head0`` / ``heads_total`` its
    first head of the problem's (0 / 0: the call holds every head).
    Returns [B, H, S_q, D] in q's dtype."""
    streams = (int(stream0), int(head0), int(heads_total))
    if _records_grad(q, k, v):
        return FusedAttentionFn.apply(q, k, v, key_bias, float(dropout_rate),
                                      int(seed), streams)
    if _on_cpu(q, k, v, key_bias):
        return attention_reference(q, k, v, key_bias, dropout_rate, seed, 0,
                                   *streams)
    return _attention_fwd(q, k, v, key_bias, dropout_rate, seed, False,
                          *streams)[0]


# --------------------------------------------------------------------------- #
# B2 / B4
# --------------------------------------------------------------------------- #
def _bi_attention_fwd(q1, k1, v1, q2, k2, v2, v_bias, t_bias, rate1, rate2,
                      seed, want_lse, stream0=0, head0=0, heads_total=0):
    """B2 on CUDA operands: (ctx1, ctx2, lse1, lse2, operands as read)."""
    q1 = _operand(q1, q1)
    k1, v1, q2, k2, v2 = (_operand(x, q1) for x in (k1, v1, q2, k2, v2))
    b = q1.shape[0]
    vb = _key_bias(v_bias, b, k1.shape[2], q1.device)
    tb = _key_bias(t_bias, b, k2.shape[2], q1.device)
    ctx1, ctx2 = _output(q2), _output(q1)
    lse1, lse2 = (_lse(q2), _lse(q1)) if want_lse else (None, None)
    streams = (stream0, head0, heads_total)
    _launch("attention_fwd",
            _problem(q2, k1, v1, vb, ctx1, lse1, rate1, seed, 0, *streams),
            _problem(q1, k2, v2, tb, ctx2, lse2, rate2, seed, 1, *streams), q1)
    LAUNCHES["bi_attention_fwd"] += 1
    return ctx1, ctx2, lse1, lse2, (q1, k1, v1, q2, k2, v2, vb, tb)


def _bi_attention_bwd(q1, k1, v1, q2, k2, v2, vb, tb, ctx1, ctx2, lse1, lse2,
                      do1, do2, rate1, rate2, seed, stream0=0, head0=0,
                      heads_total=0):
    """B4 on CUDA operands: (dq1, dk1, dv1, dq2, dk2, dv2)."""
    do1, do2 = _operand(do1, q1), _operand(do2, q1)
    dq1, dk1, dv1 = _output(q1), _output(k1), _output(v1)
    dq2, dk2, dv2 = _output(q2), _output(k2), _output(v2)
    delta1, delta2 = torch.empty_like(lse1), torch.empty_like(lse2)
    streams = (stream0, head0, heads_total)
    _launch("attention_bwd",
            _bwd_problem(q2, k1, v1, vb, ctx1, do1, lse1, delta1, dq2, dk1,
                         dv1, rate1, seed, 0, *streams),
            _bwd_problem(q1, k2, v2, tb, ctx2, do2, lse2, delta2, dq1, dk2,
                         dv2, rate2, seed, 1, *streams), q1)
    LAUNCHES["bi_attention_bwd"] += 1
    return dq1, dk1, dv1, dq2, dk2, dv2


class FusedBiAttentionFn(torch.autograd.Function):
    """B2 forward, B4 backward (plain versions for CPU tensors);
    ``streams`` is (stream0, head0, heads_total)."""

    @staticmethod
    def forward(ctx, q1, k1, v1, q2, k2, v2, v_bias, t_bias, rate1, rate2,
                seed, streams):
        ctx.rates, ctx.seed, ctx.streams = (rate1, rate2), seed, streams
        if _on_cpu(q1, k1, v1, q2, k2, v2, v_bias, t_bias):
            ctx.on_cpu = True
            ctx.save_for_backward(q1, k1, v1, q2, k2, v2, v_bias, t_bias)
            return bi_attention_reference(q1, k1, v1, q2, k2, v2, v_bias,
                                          t_bias, rate1, rate2, seed, *streams)
        ctx.on_cpu = False
        ctx1, ctx2, lse1, lse2, ops = _bi_attention_fwd(
            q1, k1, v1, q2, k2, v2, v_bias, t_bias, rate1, rate2, seed, True,
            *streams)
        ctx.save_for_backward(*ops, ctx1, ctx2, lse1, lse2)
        return ctx1, ctx2

    @staticmethod
    def backward(ctx, do1, do2):
        if ctx.on_cpu:
            grads = bi_attention_bwd_reference(*ctx.saved_tensors, do1, do2,
                                               *ctx.rates, ctx.seed,
                                               *ctx.streams)
        else:
            grads = _bi_attention_bwd(*ctx.saved_tensors, do1, do2,
                                      *ctx.rates, ctx.seed, *ctx.streams)
        return (*grads, None, None, None, None, None, None)


def fused_bi_attention(q1, k1, v1, q2, k2, v2, v_bias=None, t_bias=None, *,
                       rate1: float = 0.0, rate2: float = 0.0, seed: int = 0,
                       stream0: int = 0, head0: int = 0, heads_total: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: both directions of co-attention in one launch; its gradient is
    B4 (one launch for both directions).

    q1/k1/v1: vision projections [B, H, S_v, D]; q2/k2/v2: text [B, H, S_t,
    D]; v_bias [B, S_v], t_bias [B, S_t] f32.  Returns (ctx1 [B, H, S_t, D],
    ctx2 [B, H, S_v, D]): text queries over vision keys (dropout rate1,
    ``v_attention_probs_dropout_prob``), and vision queries over text keys
    (rate2, ``attention_probs_dropout_prob``), both masks from ``seed`` from
    the first global stream ``stream0`` on heads [head0, head0 + H) of
    ``heads_total`` (0: the call holds every head)."""
    streams = (int(stream0), int(head0), int(heads_total))
    if _records_grad(q1, k1, v1, q2, k2, v2):
        return FusedBiAttentionFn.apply(q1, k1, v1, q2, k2, v2, v_bias, t_bias,
                                        float(rate1), float(rate2), int(seed),
                                        streams)
    if _on_cpu(q1, k1, v1, q2, k2, v2, v_bias, t_bias):
        return bi_attention_reference(q1, k1, v1, q2, k2, v2, v_bias, t_bias,
                                      rate1, rate2, seed, *streams)
    return _bi_attention_fwd(q1, k1, v1, q2, k2, v2, v_bias, t_bias, rate1,
                             rate2, seed, False, *streams)[:2]
