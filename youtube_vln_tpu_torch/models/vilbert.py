"""Two-stream ViLBERT encoder and the Lily task model (counterpart of
``youtube_vln_tpu/models/vilbert.py``), in eval and train mode.

Candidates are flattened into the batch dimension and masks are additive
key biases ``[B, S]`` f32 computed once, as in the JAX package.  Attribute
names follow the reference state-dict keys listed in
``youtube_vln_tpu/models/torch_io.py:_key_map`` (``bert.encoder.v_layer.0.
attention.self.query`` ...), so ``load_state_dict(strict=True)`` takes a
reference-layout checkpoint once ``models/weights.py:normalize_state_dict``
has unwrapped it.  The vision self-attention runs kernel B1 and every
co-attention layer kernel B2 (``ops/attention.py``) when
``cfg.use_attention_kernels`` is set; their gradients are B3 and B4.  With
``cfg.use_epilogue_kernels`` as well, the large dropout + residual +
LayerNorm sites of train mode run B5, with B6 as their gradient
(``models/layers.py:dropout_add_ln``).  In
train mode ``Lily.forward`` takes a 64-bit ``seed`` and applies the JAX
package's dropout at the same sites and rates (``models/layers.py``);
``cfg.remat`` recomputes each encoder block in the backward
(``Encoder._block``).

Under tensor parallelism (``Lily(..., shard=ModelShard(m, M, group))``)
each process holds its shard of the weights by the JAX package's
``_param_spec`` rules (``parallel/mesh.py:param_spec``): the attention,
FFN and co-attention projections column-parallel and the attention and
FFN outputs row-parallel (``models/layers.py``), each attention on the
whole heads that cover the rank's features (``parallel/tensor.py:
HeadCover``); the co-attention contexts gathered before the replicated
``biOutput.dense1`` / ``dense2``; the word embedding, and the MLM decoder
tied to it, sharded on the vocabulary (masked lookups summed over the
model group, logits gathered before the replicated bias).  Everything
else is replicated, and so is any tensor whose dim the model axis does
not divide (the vocabulary of 30,522 at 4).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import LilyConfig
from ..ops.attention import (bi_attention_reference, fused_bi_attention,
                             use_kernel_for)
from ..parallel.tensor import (HeadCover, ModelShard, copy_to_model,
                               gather_from_model, reduce_from_model,
                               shard_tensor)
from .layers import (ACT2FN, AddNorm, DropoutRng, Intermediate, LayerNorm,
                     Linear, TransformerLayer, attention_core, column_linear,
                     dropout, dropout_add_ln, ffn, merge_heads, split_heads)


def compute_dtype(cfg: LilyConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def key_bias(mask) -> torch.Tensor:
    """Additive key bias (1 - m) * -10000 as [B, S] f32."""
    return (1.0 - mask.float()) * -10000.0


# --------------------------------------------------------------------------- #
# embeddings
# --------------------------------------------------------------------------- #
def _sync_over_model(*tables: nn.Embedding) -> None:
    """Marks the replicated weights among ``tables`` ``tp_sync``: their
    gradients are averaged over the model group after the backward
    (``parallel/tensor.py:average_over_model``)."""
    for t in tables:
        if not hasattr(t.weight, "tp_dim"):
            t.weight.tp_sync = True


class VocabEmbedding(nn.Embedding):
    """The word embedding, sharded on the vocabulary under a model axis that
    divides it: this rank holds rows [rank * V/M, (rank + 1) * V/M), looks
    up the ids that fall there, zeroes the others and sums the ranks'
    lookups (``reduce_from_model``; x + 0 is exact)."""

    def __init__(self, vocab: int, d: int, shard: ModelShard, device=None):
        shard = shard if shard.divides(vocab) else ModelShard()
        super().__init__(shard.local(vocab), d, device=device)
        self.shard = shard
        self.row0 = self.shard.rank * self.num_embeddings
        if self.shard.world > 1:
            self.weight.tp_dim = 0

    def forward(self, ids):
        if self.shard.world == 1:
            return super().forward(ids)
        local = ids - self.row0
        inside = (local >= 0) & (local < self.num_embeddings)
        emb = F.embedding(torch.where(inside, local, 0), self.weight)
        return reduce_from_model(emb * inside[..., None].to(emb.dtype),
                                 self.shard)


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: LilyConfig, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = VocabEmbedding(cfg.vocab_size, h, shard,
                                              device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h,
                                                device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                                  device=device)
        _sync_over_model(self.word_embeddings, self.position_embeddings,
                         self.token_type_embeddings)
        self.LayerNorm = LayerNorm(h, device=device)
        self.dropout_rate = cfg.hidden_dropout_prob

    def forward(self, input_ids, token_type_ids, dtype, rng=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
               + self.token_type_embeddings(token_type_ids))
        return dropout(self.LayerNorm(emb.to(dtype)), self.dropout_rate, rng)


class VisionEmbeddings(nn.Module):
    """The 12-d location vector splits [:5] box, [5:9] orientation, [9:11]
    next orientation, [11] step index (reference vilbert.py:1356-1365)."""

    def __init__(self, cfg: LilyConfig, device=None):
        super().__init__()
        h = cfg.v_hidden_size
        self.image_embeddings = Linear(cfg.v_feature_size, h, device=device)
        self.image_location_embeddings = Linear(5, h, device=device)
        self.image_orientation_embeddings = Linear(4, h, device=device)
        self.image_next_orientation_embeddings = Linear(2, h, device=device)
        self.image_sequence_embeddings = nn.Embedding(32, h, device=device)
        _sync_over_model(self.image_sequence_embeddings)
        self.LayerNorm = LayerNorm(h, device=device)
        # the JAX package uses the text rate here (vilbert.py:150)
        self.dropout_rate = cfg.hidden_dropout_prob

    def forward(self, feats, locs, dtype, rng=None):
        feats, locs = feats.to(dtype), locs.to(dtype)
        emb = (self.image_embeddings(feats)
               + self.image_location_embeddings(locs[..., :5])
               + self.image_orientation_embeddings(locs[..., 5:9])
               + self.image_next_orientation_embeddings(locs[..., 9:11])
               + self.image_sequence_embeddings(locs[..., 11].long()).to(dtype))
        return dropout(self.LayerNorm(emb), self.dropout_rate, rng)


# --------------------------------------------------------------------------- #
# co-attention connection layer
# --------------------------------------------------------------------------- #
class BiAttention(nn.Module):
    """Bi-directional cross attention (reference vilbert.py:552-618).
    Stream 1 is vision, stream 2 text.  Under a model axis the projections
    are column-parallel: this rank attends on the heads that cover its
    features (``HeadCover``), keeps its features of the contexts and
    gathers them whole for the replicated ``BiOutput``."""

    def __init__(self, cfg: LilyConfig, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.cfg = cfg
        bi = cfg.bi_hidden_size
        self.cover = HeadCover(shard, cfg.bi_num_attention_heads, bi)
        for name, d_in in (("query1", cfg.v_hidden_size),
                           ("key1", cfg.v_hidden_size),
                           ("value1", cfg.v_hidden_size),
                           ("query2", cfg.hidden_size),
                           ("key2", cfg.hidden_size),
                           ("value2", cfg.hidden_size)):
            setattr(self, name, column_linear(d_in, bi, shard, device=device))

    def forward(self, v_x, v_bias, t_x, t_bias, rng=None):
        """Returns (text-side context [B, S_t, bi], vision-side context
        [B, S_v, bi]).  Dropout rates (train mode): text -> vision
        ``v_attention_probs_dropout_prob``, vision -> text
        ``attention_probs_dropout_prob`` (JAX vilbert.py:180-181, 186-192)."""
        cfg, cover = self.cfg, self.cover
        total = cfg.bi_num_attention_heads
        v_x, t_x = copy_to_model(v_x, cover.shard), copy_to_model(t_x, cover.shard)
        q1, k1, v1 = (split_heads(cover.take(proj(v_x)), cover.heads)
                      for proj in (self.query1, self.key1, self.value1))
        q2, k2, v2 = (split_heads(cover.take(proj(t_x)), cover.heads)
                      for proj in (self.query2, self.key2, self.value2))
        rate1, rate2 = ((0.0, 0.0) if rng is None else
                        (cfg.v_attention_probs_dropout_prob,
                         cfg.attention_probs_dropout_prob))
        if use_kernel_for(q2.shape[2], k1.shape[2], q1.shape[3]):
            # both directions in ONE kernel launch (or its plain version)
            seed, stream0, slot = (
                (0, 0, None) if rng is None else
                (rng.kernel_seed(), rng.offset(q1.shape[0] * total),
                 rng.seed_slot()))
            kw = dict(rate1=rate1, rate2=rate2, seed=seed, stream0=stream0,
                      head0=cover.head0, heads_total=total)
            if cfg.use_attention_kernels:
                ctx1, ctx2 = fused_bi_attention(q1, k1, v1, q2, k2, v2, v_bias,
                                                t_bias, seed_slot=slot, **kw)
            else:
                ctx1, ctx2 = bi_attention_reference(q1, k1, v1, q2, k2, v2,
                                                    v_bias, t_bias, **kw)
        else:
            ours = (cover.head0, total)
            ctx1 = attention_core(q2, k1, v1, v_bias, rate1, rng, ours)  # text -> vision
            ctx2 = attention_core(q1, k2, v2, t_bias, rate2, rng, ours)  # vision -> text
        return (gather_from_model(cover.keep(merge_heads(ctx1)), cover.shard),
                gather_from_model(cover.keep(merge_heads(ctx2)), cover.shard))


class BiOutput(nn.Module):
    """BertBiOutput (vilbert.py:620-650); the reference's q_dense1/q_dense2
    are never read by its forward and are not carried."""

    def __init__(self, cfg: LilyConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.dense1 = Linear(cfg.bi_hidden_size, cfg.v_hidden_size, device=device)
        self.LayerNorm1 = LayerNorm(cfg.v_hidden_size, device=device)
        self.dense2 = Linear(cfg.bi_hidden_size, cfg.hidden_size, device=device)
        self.LayerNorm2 = LayerNorm(cfg.hidden_size, device=device)
        self.rates = (cfg.v_hidden_dropout_prob, cfg.hidden_dropout_prob)

    def forward(self, ctx_v, v_x, ctx_t, t_x, rng=None):
        return (dropout_add_ln(self.dense1(ctx_v), v_x, self.LayerNorm1,
                               self.rates[0], rng, self.cfg),
                dropout_add_ln(self.dense2(ctx_t), t_x, self.LayerNorm2,
                               self.rates[1], rng, self.cfg))


class ConnectionLayer(nn.Module):
    """BertConnectionLayer (reference vilbert.py:652-679)."""

    def __init__(self, cfg: LilyConfig, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.biattention = BiAttention(cfg, device=device, shard=shard)
        self.biOutput = BiOutput(cfg, device=device)
        self.v_intermediate = Intermediate(cfg.v_hidden_size,
                                           cfg.v_intermediate_size,
                                           cfg.v_hidden_act, device=device,
                                           shard=shard)
        self.v_output = AddNorm(cfg.v_intermediate_size, cfg.v_hidden_size,
                                cfg.v_hidden_dropout_prob, cfg, device=device,
                                shard=shard)
        self.t_intermediate = Intermediate(cfg.hidden_size,
                                           cfg.intermediate_size,
                                           cfg.hidden_act, device=device,
                                           shard=shard)
        self.t_output = AddNorm(cfg.intermediate_size, cfg.hidden_size,
                                cfg.hidden_dropout_prob, cfg, device=device,
                                shard=shard)

    def forward(self, v_x, v_bias, t_x, t_bias, rng=None):
        ctx_t, ctx_v = self.biattention(v_x, v_bias, t_x, t_bias, rng)
        v_att, t_att = self.biOutput(ctx_v, v_x, ctx_t, t_x, rng)
        return (ffn(v_att, self.v_intermediate, self.v_output, rng),
                ffn(t_att, self.t_intermediate, self.t_output, rng))


# --------------------------------------------------------------------------- #
# interleaved two-stream encoder
# --------------------------------------------------------------------------- #
class Encoder(nn.Module):
    """Vision/text layers interleaved with connection layers at the
    (v_biattention_id, t_biattention_id) schedule (reference
    vilbert.py:712-818)."""

    def __init__(self, cfg: LilyConfig, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList(
            TransformerLayer(cfg.hidden_size, cfg.intermediate_size,
                             cfg.num_attention_heads, cfg.hidden_act, cfg,
                             cfg.attention_probs_dropout_prob,
                             cfg.hidden_dropout_prob, device=device,
                             shard=shard)
            for _ in range(cfg.num_hidden_layers))
        self.v_layer = nn.ModuleList(
            TransformerLayer(cfg.v_hidden_size, cfg.v_intermediate_size,
                             cfg.v_num_attention_heads, cfg.v_hidden_act, cfg,
                             cfg.v_attention_probs_dropout_prob,
                             cfg.v_hidden_dropout_prob, device=device,
                             shard=shard)
            for _ in range(cfg.v_num_hidden_layers))
        self.c_layer = nn.ModuleList(
            ConnectionLayer(cfg, device=device, shard=shard)
            for _ in range(len(cfg.v_biattention_id)))

    def _block(self, layer, rng, *xs):
        """``layer(*xs, rng)``; with ``cfg.remat``, in train mode under
        autograd, recomputed in the backward (``torch.utils.checkpoint``,
        the JAX package's ``jax.checkpoint``) instead of keeping its
        activations.  The recompute restarts the block's randomness where
        the forward found it, the kernel-seed counter of ``rng`` and the
        state of its generator, so both passes draw the same dropout masks
        (``preserve_rng_state`` saves only the default generators, which no
        site draws from).  Under a model axis the recompute runs the
        block's collectives again, the all-gathers of split heads among
        them; every rank replays its blocks in the same order, so they
        meet."""
        if not (self.cfg.remat and rng is not None and torch.is_grad_enabled()):
            return layer(*xs, rng)
        sites, state = rng.sites, rng.generator.get_state()

        def replay(*inputs):
            rng.sites = sites
            rng.generator.set_state(state)
            return layer(*inputs, rng)

        return checkpoint(replay, *xs, use_reentrant=False,
                          preserve_rng_state=False)

    def forward(self, t_x, v_x, t_bias, v_bias, rng=None):
        cfg = self.cfg
        v_start, t_start = 0, 0
        for count, (v_end, t_end) in enumerate(
                zip(cfg.v_biattention_id, cfg.t_biattention_id)):
            # frozen prefixes (the JAX package's stop_gradient)
            for idx in range(v_start, min(cfg.fixed_v_layer, v_end)):
                v_x = self._block(self.v_layer[idx], rng, v_x, v_bias).detach()
                v_start = cfg.fixed_v_layer
            for idx in range(v_start, v_end):
                v_x = self._block(self.v_layer[idx], rng, v_x, v_bias)
            for idx in range(t_start, min(cfg.fixed_t_layer, t_end)):
                t_x = self._block(self.layer[idx], rng, t_x, t_bias).detach()
                t_start = cfg.fixed_t_layer
            for idx in range(t_start, t_end):
                t_x = self._block(self.layer[idx], rng, t_x, t_bias)

            if count == 0 and cfg.in_batch_pairs:
                # batch^2 expansion: every text paired with every image
                b = t_x.shape[0]
                v_x, v_bias = v_x.repeat(b, 1, 1), v_bias.repeat(b, 1)
                t_x = t_x.repeat_interleave(b, 0)
                t_bias = t_bias.repeat_interleave(b, 0)
            if count == 0 and cfg.fast_mode:
                # broadcast one instruction over all image rows
                n = v_x.shape[0]
                t_x = t_x.expand(n, *t_x.shape[1:])
                t_bias = t_bias.expand(n, -1)

            if cfg.with_coattention:
                v_x, t_x = self._block(self.c_layer[count], rng, v_x, v_bias,
                                       t_x, t_bias)
            v_start, t_start = v_end, t_end

        for idx in range(v_start, cfg.v_num_hidden_layers):
            v_x = self._block(self.v_layer[idx], rng, v_x, v_bias)
        for idx in range(t_start, cfg.num_hidden_layers):
            t_x = self._block(self.layer[idx], rng, t_x, t_bias)
        return t_x, v_x


# --------------------------------------------------------------------------- #
# poolers & heads
# --------------------------------------------------------------------------- #
class Pooler(nn.Module):
    """First-token pool -> linear -> ReLU (reference vilbert.py:821-848)."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.dense = Linear(d_in, d_out, device=device)

    def forward(self, x):
        return F.relu(self.dense(x[:, 0]))


class HeadTransform(nn.Module):
    """dense -> act -> LayerNorm (reference BertPredictionHeadTransform)."""

    def __init__(self, d: int, act: str, device=None):
        super().__init__()
        self.dense = Linear(d, d, device=device)
        self.LayerNorm = LayerNorm(d, device=device)
        self.act = ACT2FN[act]

    def forward(self, x):
        return self.LayerNorm(self.act(self.dense(x)))


class LMPredictionHead(nn.Module):
    """Transform + decoder tied to the word embedding + bias.  With the
    embedding sharded on the vocabulary the decoder keeps the shard: each
    rank's logits are gathered on the vocabulary before the replicated
    bias."""

    def __init__(self, cfg: LilyConfig, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.shard = shard if shard.divides(cfg.vocab_size) else ModelShard()
        self.transform = HeadTransform(cfg.hidden_size, cfg.hidden_act,
                                       device=device)
        self.decoder = Linear(cfg.hidden_size, self.shard.local(cfg.vocab_size),
                              bias=False, device=device)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))

    def forward(self, x):
        h = self.transform(x)
        logits = self.decoder(copy_to_model(h, self.shard))
        return gather_from_model(logits, self.shard) + self.bias.to(h.dtype)


class ImagePredictionHead(nn.Module):
    def __init__(self, cfg: LilyConfig, device=None):
        super().__init__()
        self.transform = HeadTransform(cfg.v_hidden_size, cfg.hidden_act,
                                       device=device)
        self.decoder = Linear(cfg.v_hidden_size, cfg.v_target_size,
                              device=device)

    def forward(self, x):
        return self.decoder(self.transform(x))


class PreTrainingHeads(nn.Module):
    def __init__(self, cfg: LilyConfig, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.predictions = LMPredictionHead(cfg, device=device, shard=shard)
        # carried for checkpoint compatibility; Lily never reads it
        self.bi_seq_relationship = Linear(cfg.bi_hidden_size, 2, device=device)
        self.imagePredictions = ImagePredictionHead(cfg, device=device)


def fuse_pooled(cfg: LilyConfig, pooled_t, pooled_v):
    if cfg.fusion_method == "sum":
        return pooled_t + pooled_v
    if cfg.fusion_method == "mul":
        return pooled_t * pooled_v
    raise ValueError(cfg.fusion_method)


# --------------------------------------------------------------------------- #
# full model
# --------------------------------------------------------------------------- #
class BertModel(nn.Module):
    """Reference BertModel.forward (vilbert.py:1242-1337)."""

    def __init__(self, cfg: LilyConfig, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = TextEmbeddings(cfg, device=device, shard=shard)
        self.v_embeddings = VisionEmbeddings(cfg, device=device)
        self.encoder = Encoder(cfg, device=device, shard=shard)
        self.t_pooler = Pooler(cfg.hidden_size, cfg.bi_hidden_size, device=device)
        self.v_pooler = Pooler(cfg.v_hidden_size, cfg.bi_hidden_size,
                               device=device)

    def forward(self, instr_tokens, image_features, image_locations,
                token_type_ids=None, attention_mask=None,
                image_attention_mask=None, rng=None):
        dtype = compute_dtype(self.cfg)
        if attention_mask is None:
            attention_mask = torch.ones_like(instr_tokens)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(instr_tokens)
        if image_attention_mask is None:
            image_attention_mask = torch.ones(image_features.shape[:2],
                                              device=image_features.device)
        t_x = self.embeddings(instr_tokens.long(), token_type_ids.long(), dtype,
                              rng)
        v_x = self.v_embeddings(image_features, image_locations, dtype, rng)
        seq_t, seq_v = self.encoder(t_x, v_x, key_bias(attention_mask),
                                    key_bias(image_attention_mask), rng)
        return seq_t, seq_v, self.t_pooler(seq_t), self.v_pooler(seq_v)


class Lily(nn.Module):
    """Reference Lily (lily.py:23-129): ``forward`` returns float32 outputs
    keyed by the enabled tasks, like ``lily_forward``:
      ranking [N, 1]   vision [N, S_v, v_target]
      traj    [N, 1]   language [N, S_t, vocab]
    ``language_target_idx`` / ``vision_target_idx`` ([N, M]) restrict the
    masked-prediction heads to those rows.  In train mode (``.train()``)
    dropout is on and ``seed``, the forward's 64-bit dropout seed, is
    required, and ``rank`` is the process's data coordinate, its place on
    the data axis (``DropoutRng``); eval mode ignores both.  ``seed`` may
    also be a ``DropoutRng`` the caller built (the graphed train step's,
    with its own generator and seed table), which the forward then draws
    from, ``rank`` unread.  ``shard`` is
    the model axis (``parallel/tensor.py``): this process holds its shard
    of the weights, whose full names and shapes ``state_dict`` keys
    (``models/weights.py:shard_state_dict``).  The weights are
    uninitialised until ``init_weights`` or ``load_state_dict``."""

    def __init__(self, cfg: LilyConfig, device=None,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.cfg = cfg
        self.shard = shard
        self.bert = BertModel(cfg, device=device, shard=shard)
        self.cls = PreTrainingHeads(cfg, device=device, shard=shard)
        self.vil_logit = Linear(cfg.bi_hidden_size, 1, device=device)
        self.judge = Linear(cfg.bi_hidden_size, 1, device=device)
        self.cls.predictions.decoder.weight = (
            self.bert.embeddings.word_embeddings.weight)

    @torch.no_grad()
    def init_weights(self, seed: int) -> "Lily":
        """Reference init_bert_weights: N(0, initializer_range) weights and
        embeddings, zero biases, unit LayerNorm; word row 0 (padding) zero.
        Drawn from a generator seeded with ``seed`` on the weights' device;
        a sharded weight draws the whole tensor and keeps its shard, so a
        model axis starts from the one process's weights."""
        std = self.cfg.initializer_range
        gen = torch.Generator(device=self.vil_logit.weight.device)
        gen.manual_seed(seed)
        rank, world = self.shard.rank, self.shard.world
        for m in self.modules():
            if isinstance(m, (Linear, nn.Embedding)):
                w = m.weight
                dim = getattr(w, "tp_dim", None)
                if dim is None:
                    w.normal_(0.0, std, generator=gen)
                else:
                    shape = list(w.shape)
                    shape[dim] *= world
                    full = torch.empty(shape, device=w.device)
                    w.copy_(shard_tensor(full.normal_(0.0, std, generator=gen),
                                         dim, rank, world))
            if isinstance(m, Linear) and m.bias is not None:
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.cls.predictions.bias.zero_()
        words = self.bert.embeddings.word_embeddings
        if words.row0 == 0:
            words.weight[0] = 0.0
        return self

    def forward(self, instr_tokens, image_features, image_locations,
                token_type_ids=None, attention_mask=None,
                image_attention_mask=None, language_target_idx=None,
                vision_target_idx=None, seed: Optional[int] = None,
                rank: int = 0) -> Dict[str, torch.Tensor]:
        rng = None
        if self.training:
            if seed is None:
                raise ValueError("train mode needs a dropout seed: pass "
                                 "seed=, or call .eval()")
            rng = (seed if isinstance(seed, DropoutRng)
                   else DropoutRng(seed, instr_tokens.device, rank))
        cfg = self.cfg
        seq_t, seq_v, pooled_t, pooled_v = self.bert(
            instr_tokens, image_features, image_locations, token_type_ids,
            attention_mask, image_attention_mask, rng)

        outputs: Dict[str, torch.Tensor] = {}
        if cfg.masked_language:
            h = _take_rows(seq_t, language_target_idx)
            outputs["language"] = self.cls.predictions(h).float()
        if cfg.masked_vision:
            hv = _take_rows(seq_v, vision_target_idx)
            outputs["vision"] = self.cls.imagePredictions(hv).float()
        if cfg.ranking or cfg.traj_judge:
            # Lily's own dropout on the fused pool (lily.py:51,100)
            pooled = dropout(fuse_pooled(cfg, pooled_t, pooled_v),
                             cfg.fusion_dropout_prob, rng)
            if cfg.ranking:
                outputs["ranking"] = self.vil_logit(pooled).float()
            if cfg.traj_judge:
                outputs["traj"] = self.judge(pooled).float()
        return outputs


def _take_rows(x, idx: Optional[torch.Tensor]):
    if idx is None:
        return x
    return torch.take_along_dim(x, idx.long()[..., None], dim=1)
