"""Primitive layers of the port (counterpart of ``youtube_vln_tpu/models/layers.py``).

Weights are kept in float32 in the reference (torch) layout — ``Linear``
stores ``[out, in]`` — and cast to the activations' dtype at use, as the JAX
package casts its f32 parameters to ``compute_dtype``.  Semantics match the
JAX package:

  * TF-style LayerNorm: f32 statistics, eps 1e-12 inside the rsqrt, output
    cast back to the input dtype;
  * erf-based gelu;
  * attention with an additive key-side mask, f32 scores and softmax, the
    probabilities cast to v's dtype before P v.

The module names follow the reference state-dict keys
(``attention.self.query``, ``attention.output.LayerNorm``,
``intermediate.dense``, ``output.dense`` ...), so a reference-layout
checkpoint loads with ``load_state_dict`` as it is.  The port runs eval
mode only: dropout arrives with the training slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_reference as attention_core
from ..ops.attention import fused_attention, use_kernel_for

LN_EPS = 1e-12


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


ACT2FN = {"gelu": gelu, "relu": F.relu, "swish": lambda x: x * torch.sigmoid(x)}


class Linear(nn.Module):
    """y = x W^T + b in x's dtype (the JAX ``linear``'s
    ``preferred_element_type=x.dtype``); W and b stay float32."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = (nn.Parameter(torch.zeros(d_out, device=device))
                     if bias else None)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.Module):
    """TF-style LayerNorm in float32 whatever the input dtype."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        x32 = x.float()
        u = x32.mean(-1, keepdim=True)
        s = (x32 - u).square().mean(-1, keepdim=True)
        y = (x32 - u) * torch.rsqrt(s + LN_EPS)
        return (self.weight * y + self.bias).to(x.dtype)


def split_heads(x, num_heads: int):
    """[B, S, H] -> [B, heads, S, H/heads] (a view)."""
    b, s, h = x.shape
    return x.view(b, s, num_heads, h // num_heads).transpose(1, 2)


def merge_heads(x):
    """[B, heads, S, D] -> [B, S, heads*D]."""
    b, n, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, n * d)


class SelfAttentionHeads(nn.Module):
    """Query/key/value projections and the attention itself (the
    reference's ``BertSelfAttention``).  The kernel B1 runs where
    ``use_kernel_for`` selects it, as ``select_attention_fn`` does."""

    def __init__(self, hidden: int, num_heads: int, cfg, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.cfg = cfg
        self.query = Linear(hidden, hidden, device=device)
        self.key = Linear(hidden, hidden, device=device)
        self.value = Linear(hidden, hidden, device=device)

    def forward(self, x, key_bias):
        q = split_heads(self.query(x), self.num_heads)
        k = split_heads(self.key(x), self.num_heads)
        v = split_heads(self.value(x), self.num_heads)
        if (self.cfg.use_attention_kernels
                and use_kernel_for(q.shape[2], k.shape[2], q.shape[3])):
            ctx = fused_attention(q, k, v, key_bias)
        else:
            ctx = attention_core(q, k, v, key_bias)
        return merge_heads(ctx)


class AddNorm(nn.Module):
    """LayerNorm(dense(h) + residual): the reference's ``BertSelfOutput``
    and ``BertOutput`` (their dropout is the identity in eval)."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.dense = Linear(d_in, d_out, device=device)
        self.LayerNorm = LayerNorm(d_out, device=device)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class Intermediate(nn.Module):
    """act(dense(x)): the reference's ``BertIntermediate``."""

    def __init__(self, d_in: int, d_out: int, act: str, device=None):
        super().__init__()
        self.dense = Linear(d_in, d_out, device=device)
        self.act = ACT2FN[act]

    def forward(self, x):
        return self.act(self.dense(x))


class SelfAttention(nn.Module):
    """BertAttention: self-attention -> projection -> add & norm."""

    def __init__(self, hidden: int, num_heads: int, cfg, device=None):
        super().__init__()
        self.self = SelfAttentionHeads(hidden, num_heads, cfg, device=device)
        self.output = AddNorm(hidden, hidden, device=device)

    def forward(self, x, key_bias):
        return self.output(self.self(x, key_bias), x)


def ffn(x, intermediate: Intermediate, output: AddNorm):
    """The feed-forward sub-block (JAX ``ffn_block``)."""
    return output(intermediate(x), x)


class TransformerLayer(nn.Module):
    """One BERT layer: self-attention sub-block, then feed-forward."""

    def __init__(self, hidden: int, inter: int, num_heads: int, act: str, cfg,
                 device=None):
        super().__init__()
        self.attention = SelfAttention(hidden, num_heads, cfg, device=device)
        self.intermediate = Intermediate(hidden, inter, act, device=device)
        self.output = AddNorm(inter, hidden, device=device)

    def forward(self, x, key_bias):
        return ffn(self.attention(x, key_bias), self.intermediate, self.output)
