"""The legacy ViLBERT task heads (counterpart of
``youtube_vln_tpu/models/legacy.py``): carried by the reference
(``vilbert/vilbert.py:1373-1535``) but unused by its entry points.

  * ``WeightNormLinear``: ``weight_norm(nn.Linear, dim=None)``, weight =
    g v / |v| with a scalar g over the whole matrix, under the reference's
    keys ``weight_g`` (0-dim), ``weight_v`` ([out, in]) and ``bias``;
  * ``SimpleClassifier``: WN-linear -> ReLU -> Dropout(0.5) -> WN-linear
    as ``main.0`` .. ``main.3``;
  * ``BertForMultiModalPreTraining``: MLM, the masked-vision head and
    ``cls.bi_seq_relationship`` over the fused pool after the heads'
    hard-coded Dropout(0.1);
  * ``VILBertForVLTasks``: the fused pool through Dropout(0.1) and a
    ``SimpleClassifier`` (``vil_prediction``).

Both run the port's ``BertModel``, so the vision self-attention and the
co-attention go through kernels B1/B2 (and B3/B4 in the backward).  In
train mode the forward takes a 64-bit dropout ``seed`` as ``Lily`` does;
the head dropouts are XLA-path sites of its ``DropoutRng``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import LilyConfig
from ..device import make_generator, resolve_device
from .layers import DropoutRng, LayerNorm, Linear, dropout
from .vilbert import BertModel, PreTrainingHeads, fuse_pooled

# hard-coded in the reference constructors (BertPreTrainingHeads
# nn.Dropout(0.1), VILBertForVLTasks dropout_prob=0.1; SimpleClassifier's
# own Dropout is 0.5)
HEAD_DROPOUT = 0.1
CLASSIFIER_DROPOUT = 0.5


class WeightNormLinear(nn.Module):
    """``weight_norm(nn.Linear(in, out), dim=None)`` as a plain module (the
    keys of ``torch.nn.utils.parametrizations.weight_norm`` are not the
    reference's).  The weight is built in float32 and the input promoted to
    it, as the JAX package's ``x @ w`` promotes."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones((), device=device))
        self.weight_v = nn.Parameter(torch.empty(out_dim, in_dim, device=device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))

    def forward(self, x):
        w = self.weight_g * self.weight_v / torch.linalg.vector_norm(self.weight_v)
        return F.linear(x.float(), w, self.bias)


class SimpleClassifier(nn.Module):
    """Reference SimpleClassifier (vilbert.py:1522-1535)."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, device=None):
        super().__init__()
        self.main = nn.Sequential(WeightNormLinear(in_dim, hid_dim, device=device),
                                  nn.ReLU(), nn.Dropout(CLASSIFIER_DROPOUT),
                                  WeightNormLinear(hid_dim, out_dim, device=device))

    def forward(self, x, rng: Optional[DropoutRng] = None):
        h = F.relu(self.main[0](x))
        return self.main[3](dropout(h, CLASSIFIER_DROPOUT, rng))


@torch.no_grad()
def _init_bert_weights(model: nn.Module, cfg: LilyConfig, gen: torch.Generator):
    """The reference init_bert_weights (as ``Lily.init_weights``): N(0,
    initializer_range) weights and embeddings, zero biases, unit LayerNorm,
    word row 0 zero; a WN-linear draws v and starts at g = |v|."""
    std = cfg.initializer_range
    for m in model.modules():
        if isinstance(m, (Linear, nn.Embedding)):
            m.weight.normal_(0.0, std, generator=gen)
            if isinstance(m, Linear) and m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, WeightNormLinear):
            m.weight_v.normal_(0.0, std, generator=gen)
            m.weight_g.copy_(torch.linalg.vector_norm(m.weight_v))
            m.bias.zero_()
    model.bert.embeddings.word_embeddings.weight[0] = 0.0


class _LegacyModel(nn.Module):
    def _rng(self, seed, device, rank):
        if not self.training:
            return None
        if seed is None:
            raise ValueError("train mode needs a dropout seed: pass seed=, or "
                             "call .eval()")
        if isinstance(seed, DropoutRng):
            return seed
        return DropoutRng(seed, device, rank)

    @torch.no_grad()
    def init_weights(self, seed: Union[int, torch.Generator]):
        gen = make_generator(seed, self.bert.t_pooler.dense.weight.device)
        _init_bert_weights(self, self.cfg, gen)
        if hasattr(self, "cls"):
            self.cls.predictions.bias.zero_()
        return self


class BertForMultiModalPreTraining(_LegacyModel):
    """Reference BertForMultiModalPreTraining (vilbert.py:1373-1455):
    ``forward`` returns float32 (MLM logits [N, S_t, vocab], vision
    [N, S_v, v_target], seq-relationship [N, 2])."""

    def __init__(self, cfg: LilyConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, device=device)
        self.cls = PreTrainingHeads(cfg, device=device)
        self.cls.predictions.decoder.weight = self.bert.embeddings.word_embeddings.weight

    def forward(self, instr_tokens, image_features, image_locations,
                token_type_ids=None, attention_mask=None,
                image_attention_mask=None, seed: Optional[int] = None,
                rank: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        rng = self._rng(seed, instr_tokens.device, rank)
        seq_t, seq_v, pooled_t, pooled_v = self.bert(
            instr_tokens, image_features, image_locations, token_type_ids,
            attention_mask, image_attention_mask, rng)
        pooled = dropout(fuse_pooled(self.cfg, pooled_t, pooled_v), HEAD_DROPOUT, rng)
        return (self.cls.predictions(seq_t).float(),
                self.cls.imagePredictions(seq_v).float(),
                self.cls.bi_seq_relationship(pooled).float())


class VILBertForVLTasks(_LegacyModel):
    """Reference VILBertForVLTasks (vilbert.py:1457-1520), its
    ``vil_prediction`` output: the fused pool through Dropout(0.1) and
    ``SimpleClassifier(bi_hidden, hid_dim, num_labels)`` -> float32
    [N, num_labels] (e.g. VQA, 3,129 labels)."""

    def __init__(self, cfg: LilyConfig, num_labels: int, hid_dim: Optional[int] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, device=device)
        self.vil_prediction = SimpleClassifier(cfg.bi_hidden_size,
                                               hid_dim or 2 * cfg.bi_hidden_size,
                                               num_labels, device=device)

    def forward(self, instr_tokens, image_features, image_locations,
                token_type_ids=None, attention_mask=None,
                image_attention_mask=None, seed: Optional[int] = None,
                rank: int = 0) -> torch.Tensor:
        rng = self._rng(seed, instr_tokens.device, rank)
        _, _, pooled_t, pooled_v = self.bert(
            instr_tokens, image_features, image_locations, token_type_ids,
            attention_mask, image_attention_mask, rng)
        pooled = dropout(fuse_pooled(self.cfg, pooled_t, pooled_v), HEAD_DROPOUT, rng)
        return self.vil_prediction(pooled, rng).float()
