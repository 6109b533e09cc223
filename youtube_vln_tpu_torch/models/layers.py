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
  * at the epilogue kernel sites (``dropout_add_ln`` with
    ``cfg.use_epilogue_kernels`` and ``cfg.use_attention_kernels``, where
    ``use_epilogue_kernel_for`` holds) the same exact-rate Philox rule,
    one seed per call from the same counter (``ops/epilogue.py``);
  * everywhere else (embeddings, hidden states, the small text
    self-attention, the fused pool) the JAX ``dropout`` of
    ``models/layers.py:78-94``: uint8 draws, keep probability quantised
    to thresh / 256 with thresh = round(keep * 256), kept values scaled by
    256 / thresh, zeros at thresh 0.

Tensor parallelism (``parallel/tensor.py``, a ``ModelShard`` handed to each
layer): the attention projections and the FFN input are column-parallel
(local features, their input through ``copy_to_model``), the attention
output and the FFN output row-parallel (``reduce_from_model`` before the
bias, which is replicated), as the JAX package's ``_param_spec`` shards
them, whether or not the heads split with the features: a rank attends on
the whole heads that cover its features and keeps its own features of the
context (``HeadCover``).  A sharded weight carries ``tp_dim``, the dim of
the full tensor it is a shard of.  Every model rank of a data coordinate
draws the same bits at the replicated dropout sites (``DropoutRng`` keys
on the data rank), and the one head-sharded site of the XLA path, the text
self-attention's probabilities, draws the bits of every head and keeps
its own, so the mask is the one process's, two ranks that cover one head
draw the same mask for it, and the generator advances alike on every
model rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import epilogue
from ..ops.attention import (attention_reference, attention_scores,
                             fused_attention, use_kernel_for)
from ..ops.philox import MASK64, site_seed
from ..parallel.tensor import (HeadCover, ModelShard, copy_to_model,
                               reduce_from_model)

LN_EPS = 1e-12


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


ACT2FN = {"gelu": gelu, "relu": F.relu, "swish": lambda x: x * torch.sigmoid(x)}


class DropoutRng:
    """The randomness of one train-mode forward, derived on the host from a
    64-bit seed (no device value is read): the n-th kernel site in call
    order takes ``site_seed(seed, n)``, n = 1, 2, ...; the other sites draw
    from one generator on ``device`` seeded with ``site_seed(seed, 0)``.

    Under data parallelism every rank takes the same step seed and
    ``rank`` is its data coordinate: its place on the ``data`` axis, which
    the model ranks that hold the same rows share.  A kernel site then
    draws its rows of the global batch's mask: the rank's call starts at
    global stream or row ``offset(rows)`` = rank * rows (equal shards, as
    the JAX package's batch-sharded row ids).  The generator of the other
    sites is seeded from ``site_seed(site_seed(seed, 0), rank)`` on a
    rank above 0, so data ranks draw independent bits there and model
    ranks the same."""

    def __init__(self, seed: int, device, rank: int = 0):
        self.seed = seed & MASK64
        self.rank = rank
        self.sites = 0
        self.generator = torch.Generator(device=device)
        generator_seed = site_seed(self.seed, 0)
        if rank:
            generator_seed = site_seed(generator_seed, rank)
        self.generator.manual_seed(generator_seed)

    def kernel_seed(self) -> int:
        self.sites += 1
        return site_seed(self.seed, self.sites)

    def offset(self, rows: int) -> int:
        """The first global stream (attention) or row (epilogue) of a
        kernel call that holds ``rows`` of them on each rank."""
        return self.rank * rows


def dropout(x, rate: float, rng, heads=None):
    """The JAX package's XLA-path dropout (``layers.py:78-94``); identity
    when ``rng`` is None (eval) or the rate is 0.  ``heads`` = (head0,
    heads_total) marks x [B, H_local, ...] as heads [head0, head0 +
    H_local) of heads_total: the bits of every head are drawn, and these
    heads' kept."""
    if rng is None or rate == 0.0:
        return x
    thresh = min(round((1.0 - rate) * 256), 255)
    if thresh == 0:
        return torch.zeros_like(x)
    shape = x.shape
    if heads is not None:
        shape = (x.shape[0], heads[1]) + tuple(x.shape[2:])
    bits = torch.randint(0, 256, shape, dtype=torch.uint8, device=x.device,
                         generator=rng.generator)
    if heads is not None:
        bits = bits[:, heads[0]:heads[0] + x.shape[1]]
    return torch.where(bits < thresh, x * (256.0 / thresh), 0.0).to(x.dtype)


def dropout_add_ln(h, res, ln: "LayerNorm", rate: float, rng, cfg):
    """LayerNorm(dropout(h) + res), the sub-block epilogue (JAX
    ``layers.py:97-105``).  Kernels B5/B6 run where ``select_epilogue_fn``
    would pick the Pallas kernel (``epilogue.py:265-274``): both kernel
    knobs on, train mode, a rate above 0, at least ``MIN_FUSED_ELEMENTS``
    elements and a last dim that is a multiple of 128; such a site takes
    the next kernel seed.  Every other site is ``dropout`` then
    ``LayerNorm``."""
    if (rng is not None and cfg.use_attention_kernels
            and cfg.use_epilogue_kernels
            and epilogue.use_epilogue_kernel_for(h.numel(), h.shape[-1], rate,
                                                 True)):
        return epilogue.fused_dropout_add_ln(
            h, res, ln.weight, ln.bias, dropout_rate=rate,
            seed=rng.kernel_seed(), row0=rng.offset(h.numel() // h.shape[-1]))
    return ln(dropout(h, rate, rng) + res)


def attention_core(q, k, v, key_bias, rate: float = 0.0, rng=None, heads=None):
    """The JAX ``attention_core``: f32 scores and softmax, XLA-path dropout
    on the probabilities (``heads``: see ``dropout``), which are cast to v's
    dtype before P v.  Without dropout it is ``attention_reference``, op for
    op."""
    probs = dropout(torch.softmax(attention_scores(q, k, key_bias), dim=-1),
                    rate, rng, heads)
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


def column_linear(d_in: int, d_out: int, shard: ModelShard, device=None
                  ) -> Linear:
    """A column-parallel ``Linear``: this rank's ``shard.local(d_out)``
    output features (weight and bias); its input goes through
    ``copy_to_model`` at the caller, once for all the layers that read it."""
    lin = Linear(d_in, shard.local(d_out), device=device)
    if shard.divides(d_out):
        lin.weight.tp_dim = lin.bias.tp_dim = 0
    return lin


class RowLinear(Linear):
    """A row-parallel ``Linear``: this rank's ``shard.local(d_in)`` input
    features; the partial products are summed over the model group
    (``reduce_from_model``) before the replicated bias."""

    def __init__(self, d_in: int, d_out: int, shard: ModelShard, device=None):
        super().__init__(shard.local(d_in), d_out, device=device)
        self.shard = shard if shard.divides(d_in) else ModelShard()
        if self.shard.world > 1:
            self.weight.tp_dim = 1

    def forward(self, x):
        if self.shard.world == 1:
            return super().forward(x)
        y = reduce_from_model(F.linear(x, self.weight.to(x.dtype)), self.shard)
        return y + self.bias.to(x.dtype)


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
    plain version, as ``select_attention_fn`` does.  Under a model axis
    the projections are column-parallel: this rank attends on the heads
    [head0, head0 + n) of ``num_heads`` that cover its features
    (``HeadCover``) and returns its features of the context."""

    def __init__(self, hidden: int, num_heads: int, cfg, dropout_rate: float,
                 device=None, shard: ModelShard = ModelShard()):
        super().__init__()
        self.num_heads = num_heads
        self.cover = HeadCover(shard, num_heads, hidden)
        self.cfg = cfg
        self.dropout_rate = dropout_rate
        self.query = column_linear(hidden, hidden, shard, device=device)
        self.key = column_linear(hidden, hidden, shard, device=device)
        self.value = column_linear(hidden, hidden, shard, device=device)

    def forward(self, x, key_bias, rng=None):
        cover = self.cover
        x = copy_to_model(x, cover.shard)
        q, k, v = (split_heads(cover.take(proj(x)), cover.heads)
                   for proj in (self.query, self.key, self.value))
        rate = 0.0 if rng is None else self.dropout_rate
        if use_kernel_for(q.shape[2], k.shape[2], q.shape[3]):
            seed, stream0 = ((0, 0) if rng is None else
                             (rng.kernel_seed(), rng.offset(q.shape[0] * self.num_heads)))
            attend = (fused_attention if self.cfg.use_attention_kernels
                      else attention_reference)
            ctx = attend(q, k, v, key_bias, dropout_rate=rate, seed=seed,
                         stream0=stream0, head0=cover.head0,
                         heads_total=self.num_heads)
        else:
            ctx = attention_core(q, k, v, key_bias, rate, rng,
                                 (cover.head0, self.num_heads))
        return cover.keep(merge_heads(ctx))


class AddNorm(nn.Module):
    """LayerNorm(dropout(dense(h)) + residual): the reference's
    ``BertSelfOutput`` and ``BertOutput`` (JAX ``dropout_add_ln``), its
    dense row-parallel under a model axis."""

    def __init__(self, d_in: int, d_out: int, dropout_rate: float, cfg,
                 device=None, shard: ModelShard = ModelShard()):
        super().__init__()
        self.cfg = cfg
        self.dropout_rate = dropout_rate
        self.dense = RowLinear(d_in, d_out, shard, device=device)
        self.LayerNorm = LayerNorm(d_out, device=device)

    def forward(self, h, residual, rng=None):
        return dropout_add_ln(self.dense(h), residual, self.LayerNorm,
                              self.dropout_rate, rng, self.cfg)


class Intermediate(nn.Module):
    """act(dense(x)): the reference's ``BertIntermediate``, column-parallel
    under a model axis (this rank's features)."""

    def __init__(self, d_in: int, d_out: int, act: str, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.shard = shard if shard.divides(d_out) else ModelShard()
        self.dense = column_linear(d_in, d_out, shard, device=device)
        self.act = ACT2FN[act]

    def forward(self, x):
        return self.act(self.dense(copy_to_model(x, self.shard)))


class SelfAttention(nn.Module):
    """BertAttention: self-attention -> projection -> add & norm."""

    def __init__(self, hidden: int, num_heads: int, cfg, attn_dropout: float,
                 hidden_dropout: float, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.self = SelfAttentionHeads(hidden, num_heads, cfg, attn_dropout,
                                       device=device, shard=shard)
        self.output = AddNorm(hidden, hidden, hidden_dropout, cfg,
                              device=device, shard=shard)

    def forward(self, x, key_bias, rng=None):
        return self.output(self.self(x, key_bias, rng), x, rng)


def ffn(x, intermediate: Intermediate, output: AddNorm, rng=None):
    """The feed-forward sub-block (JAX ``ffn_block``)."""
    return output(intermediate(x), x, rng)


class TransformerLayer(nn.Module):
    """One BERT layer: self-attention sub-block, then feed-forward; the
    dropout rates are the stream's (attention, hidden)."""

    def __init__(self, hidden: int, inter: int, num_heads: int, act: str, cfg,
                 attn_dropout: float, hidden_dropout: float, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.attention = SelfAttention(hidden, num_heads, cfg, attn_dropout,
                                       hidden_dropout, device=device,
                                       shard=shard)
        self.intermediate = Intermediate(hidden, inter, act, device=device,
                                         shard=shard)
        self.output = AddNorm(inter, hidden, hidden_dropout, cfg,
                              device=device, shard=shard)

    def forward(self, x, key_bias, rng=None):
        return ffn(self.attention(x, key_bias, rng), self.intermediate,
                   self.output, rng)
