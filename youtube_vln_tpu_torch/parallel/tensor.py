"""Tensor parallelism over the ``model`` axis: the collectives that GSPMD
inserts around the JAX package's Megatron rules (``parallel/mesh.py``
``param_spec``), written out as autograd Functions over the model group.

  * ``copy_to_model``: the input of column-parallel layers; identity
    forward, the gradient all-reduced backward (each rank holds the
    gradient of its shard's share).
  * ``reduce_from_model``: the output of a row-parallel layer; the partial
    products all-reduced forward, identity backward.
  * ``gather_from_model``: feature-sharded activations made whole on the
    last dim (the co-attention contexts before their replicated outputs,
    the MLM logits); the gradient sliced backward.
  * ``gather_heads_from_model``: the same gather, for q/k/v of an attention
    layer whose heads the model axis splits (``HeadCover``); each rank reads
    only the heads that cover its features, so the gradient is summed over
    the model group before this rank's slice is taken.
  * ``shard_tensor`` / ``unshard_tensor``: a full tensor's shard of this
    rank, and a shard gathered back to the full tensor (no gradient).
  * ``average_over_model``: the mean of replicated gradients over the
    model group, for the embedding tables marked ``tp_sync``: the CUDA
    backward of an embedding lookup sums the rows of repeated ids in an
    order that may differ from run to run, so the model ranks' copies of a
    replicated table would drift apart by rounding.

NCCL is the backend across cards.  Gloo, which runs two ranks on one card
or ranks on the CPU, documents only ``all_reduce`` and ``broadcast`` for
CUDA tensors, but its ``all_gather`` and its bf16 ``all_reduce`` take CUDA
tensors in torch 2.11.0+cu128 on the H100 machine (probed there), so every
backend gathers with ``all_gather``.  No collective failure is caught.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class ModelShard:
    """The ``model`` axis as a module sees it: this process's coordinate
    ``rank`` of ``world`` and the group over which its collectives run.
    ``ModelShard()`` is one process: every layer whole, no collective."""

    def __init__(self, rank: int = 0, world: int = 1, group=None):
        if not 0 <= rank < world:
            raise ValueError(f"model rank {rank} of {world}")
        self.rank, self.world, self.group = rank, world, group

    def divides(self, n: int) -> bool:
        """Whether a dim of ``n`` is sharded (``param_spec``'s fallback
        keeps a dim the axis does not divide whole)."""
        return self.world > 1 and n % self.world == 0

    def local(self, n: int) -> int:
        """This rank's part of a sharded dim of ``n``."""
        return n // self.world if self.divides(n) else n

    def heads(self, num_heads: int, hidden: int):
        """(n, head0, off) of an attention layer of ``num_heads`` over
        ``hidden`` features: heads [head0, head0 + n) are the whole heads
        that cover this rank's features [r * f, (r + 1) * f), f = hidden /
        M, which start ``off`` features into them.  Where f is a whole
        number of heads these are the rank's own heads and off is 0; where
        the features stay whole, every head."""
        if not self.divides(hidden):
            return num_heads, 0, 0
        f, d = hidden // self.world, hidden // num_heads
        lo = self.rank * f
        head0 = lo // d
        return -(-(lo + f) // d) - head0, head0, lo - head0 * d


def _all_gather(x: torch.Tensor, dim: int, shard: ModelShard) -> torch.Tensor:
    """The shards of the model group concatenated on ``dim``, in rank
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.world)]
    dist.all_gather(parts, x, group=shard.group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=shard.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _all_gather(x, -1, shard)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        return grad.chunk(shard.world, dim=-1)[shard.rank].contiguous(), None


class _GatherHeadsFromModel(_GatherFromModel):
    @staticmethod
    def backward(ctx, grad):
        # each rank's gradient holds what its own heads read of every
        # shard, which two ranks that share a head both read
        shard = ctx.shard
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=shard.group)
        return grad.chunk(shard.world, dim=-1)[shard.rank].contiguous(), None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return x if shard.world == 1 else _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return x if shard.world == 1 else _ReduceFromModel.apply(x, shard)


def gather_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return x if shard.world == 1 else _GatherFromModel.apply(x, shard)


def gather_heads_from_model(x: torch.Tensor, shard: ModelShard
                            ) -> torch.Tensor:
    return x if shard.world == 1 else _GatherHeadsFromModel.apply(x, shard)


class HeadCover:
    """An attention layer of ``num_heads`` over ``hidden`` features on this
    rank of the model axis, whose q/k/v projections are column-parallel.
    Where the rank's f = hidden / M features are a whole number of heads it
    attends on its own heads.  Where they start or end inside a head
    (``split``: 12 heads of 64 over 8 ranks, 96 features each) the ranks
    gather q, k and v (``take``), attend on the heads [head0, head0 + heads)
    that cover their features, and each keeps its own features of the
    context (``keep``): a head that two ranks share is computed on both."""

    def __init__(self, shard: ModelShard, num_heads: int, hidden: int):
        self.shard = shard if shard.divides(hidden) else ModelShard()
        self.heads, self.head0, self.off = shard.heads(num_heads, hidden)
        self.width = self.shard.local(hidden)
        d = hidden // num_heads
        self.split = self.width % d != 0
        self.span = slice(self.head0 * d, (self.head0 + self.heads) * d)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, f] of this rank's features -> [B, S, heads * d] of its
        covering heads."""
        if not self.split:
            return x
        return gather_heads_from_model(x, self.shard)[..., self.span]

    def keep(self, ctx: torch.Tensor) -> torch.Tensor:
        """[B, S, heads * d] of the covering heads -> [B, S, f] of this
        rank's features."""
        return ctx[..., self.off:self.off + self.width] if self.split else ctx


def shard_tensor(t: torch.Tensor, dim: Optional[int], rank: int, world: int
                 ) -> torch.Tensor:
    """Shard ``rank`` of ``world`` of the full tensor ``t`` on ``dim`` (``t``
    itself when ``dim`` is None)."""
    if dim is None or world == 1:
        return t
    return t.chunk(world, dim=dim)[rank].contiguous()


@torch.no_grad()
def average_over_model(tensors, shard: ModelShard) -> None:
    """Replaces each of ``tensors`` (the same list on every model rank) by
    its mean over the model group, in one collective.  Equal tensors stay
    as they are for a power-of-two group (x * M / M is exact)."""
    tensors = list(tensors)
    if shard.world == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=shard.group)
    flat /= shard.world
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


@torch.no_grad()
def unshard_tensor(t: torch.Tensor, dim: Optional[int], shard: ModelShard
                   ) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's shard on ``dim``,
    gathered over the model group (``t`` itself when ``dim`` is None)."""
    if dim is None or shard.world == 1:
        return t
    return _all_gather(t.detach(), dim, shard)
