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
checkpoint loads with ``load_state_dict`` as it is.

Dropout, in train mode only (a ``DropoutRng`` is handed down; ``None``
means eval), keeps the JAX package's two semantics:

  * at the kernel sites (vision self-attention and co-attention, where
    ``use_kernel_for`` holds) the exact rate with a Philox mask and one
    64-bit seed per call, drawn in call order (``ops/philox.py``); the
    kernel and its plain version draw the same mask;
  * everywhere else (embeddings, hidden states, the small text
    self-attention, the fused pool) the JAX ``dropout`` of
    ``models/layers.py:78-94``: uint8 draws, keep probability quantised
    to thresh / 256 with thresh = round(keep * 256), kept values scaled by
    256 / thresh, zeros at thresh 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (attention_reference, attention_scores,
                             fused_attention, use_kernel_for)
from ..ops.philox import MASK64, site_seed

LN_EPS = 1e-12


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


ACT2FN = {"gelu": gelu, "relu": F.relu, "swish": lambda x: x * torch.sigmoid(x)}


class DropoutRng:
    """The randomness of one train-mode forward, derived on the host from a
    64-bit seed (no device value is read): the n-th kernel site in call
    order takes ``site_seed(seed, n)``, n = 1, 2, ...; the other sites draw
    from one generator on ``device`` seeded with ``site_seed(seed, 0)``."""

    def __init__(self, seed: int, device):
        self.seed = seed & MASK64
        self.sites = 0
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(site_seed(self.seed, 0))

    def kernel_seed(self) -> int:
        self.sites += 1
        return site_seed(self.seed, self.sites)


def dropout(x, rate: float, rng):
    """The JAX package's XLA-path dropout (``layers.py:78-94``); identity
    when ``rng`` is None (eval) or the rate is 0."""
    if rng is None or rate == 0.0:
        return x
    thresh = min(round((1.0 - rate) * 256), 255)
    if thresh == 0:
        return torch.zeros_like(x)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                         generator=rng.generator)
    return torch.where(bits < thresh, x * (256.0 / thresh), 0.0).to(x.dtype)


def attention_core(q, k, v, key_bias, rate: float = 0.0, rng=None):
    """The JAX ``attention_core``: f32 scores and softmax, XLA-path dropout
    on the probabilities, which are cast to v's dtype before P v.  Without
    dropout it is ``attention_reference``, op for op."""
    probs = dropout(torch.softmax(attention_scores(q, k, key_bias), dim=-1),
                    rate, rng)
    return torch.matmul(probs.to(v.dtype), v)


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
    reference's ``BertSelfAttention``).  Where ``use_kernel_for`` selects
    a kernel site, kernel B1 runs (``cfg.use_attention_kernels``) or its
    plain version, as ``select_attention_fn`` does."""

    def __init__(self, hidden: int, num_heads: int, cfg, dropout_rate: float,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.cfg = cfg
        self.dropout_rate = dropout_rate
        self.query = Linear(hidden, hidden, device=device)
        self.key = Linear(hidden, hidden, device=device)
        self.value = Linear(hidden, hidden, device=device)

    def forward(self, x, key_bias, rng=None):
        q = split_heads(self.query(x), self.num_heads)
        k = split_heads(self.key(x), self.num_heads)
        v = split_heads(self.value(x), self.num_heads)
        rate = 0.0 if rng is None else self.dropout_rate
        if use_kernel_for(q.shape[2], k.shape[2], q.shape[3]):
            seed = 0 if rng is None else rng.kernel_seed()
            attend = (fused_attention if self.cfg.use_attention_kernels
                      else attention_reference)
            ctx = attend(q, k, v, key_bias, dropout_rate=rate, seed=seed)
        else:
            ctx = attention_core(q, k, v, key_bias, rate, rng)
        return merge_heads(ctx)


class AddNorm(nn.Module):
    """LayerNorm(dropout(dense(h)) + residual): the reference's
    ``BertSelfOutput`` and ``BertOutput`` (JAX ``dropout_add_ln``)."""

    def __init__(self, d_in: int, d_out: int, dropout_rate: float,
                 device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dense = Linear(d_in, d_out, device=device)
        self.LayerNorm = LayerNorm(d_out, device=device)

    def forward(self, h, residual, rng=None):
        return self.LayerNorm(dropout(self.dense(h), self.dropout_rate, rng)
                              + residual)


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

    def __init__(self, hidden: int, num_heads: int, cfg, attn_dropout: float,
                 hidden_dropout: float, device=None):
        super().__init__()
        self.self = SelfAttentionHeads(hidden, num_heads, cfg, attn_dropout,
                                       device=device)
        self.output = AddNorm(hidden, hidden, hidden_dropout, device=device)

    def forward(self, x, key_bias, rng=None):
        return self.output(self.self(x, key_bias, rng), x, rng)


def ffn(x, intermediate: Intermediate, output: AddNorm, rng=None):
    """The feed-forward sub-block (JAX ``ffn_block``)."""
    return output(intermediate(x), x, rng)


class TransformerLayer(nn.Module):
    """One BERT layer: self-attention sub-block, then feed-forward; the
    dropout rates are the stream's (attention, hidden)."""

    def __init__(self, hidden: int, inter: int, num_heads: int, act: str, cfg,
                 attn_dropout: float, hidden_dropout: float, device=None):
        super().__init__()
        self.attention = SelfAttention(hidden, num_heads, cfg, attn_dropout,
                                       hidden_dropout, device=device)
        self.intermediate = Intermediate(hidden, inter, act, device=device)
        self.output = AddNorm(inter, hidden, hidden_dropout, device=device)

    def forward(self, x, key_bias, rng=None):
        return ffn(self.attention(x, key_bias, rng), self.intermediate,
                   self.output, rng)
