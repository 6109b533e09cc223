"""Plain PyTorch reference of Lily, the two-stream ViLBERT re-ranker of
YouTube-VLN (text 12 x 768, vision 6 x 1024, 6 co-attention layers), in
float32 with TF32 off, written from the model's equations and not from the
program: no kernel, no cache, no batching trick.

The weights are a dict from the reference state-dict key names to f32
tensors (``make_weights`` draws them from the seed on the device; the
benchmark hands the same values to the program).  ``forward`` runs a
block of rows ``rows = (b0, b1)`` of a batch of ``n_full`` rows, so that
the reference fits on the card while the dropout masks stay those of the
whole batch: every mask is drawn at the full batch's shape in call order
and cached (``Dropout``), and a block takes its rows of it.

Semantics, as the configuration states them:
  * TF-style LayerNorm (f32 statistics, eps 1e-12), erf gelu;
  * additive key masks (1 - m) * -10000, softmax in f32;
  * train-mode dropout: at the attention sites with a score matrix of at
    least 4096 entries and head size 64 or 128 (vision self-attention and
    co-attention), and at the dropout + residual + LayerNorm sites with at
    least 2^22 elements and a width that is a multiple of 128 when the
    configuration turns its epilogue rule on, a Philox mask at the exact
    rate with one site seed per call in call order (``philox.py``);
    elsewhere uint8 draws from one generator seeded with site seed 0,
    kept below round(keep * 256) and scaled by 256 / thresh;
  * heads: ranking and trajectory logits from the fused pool (``mul``),
    masked language over the first 32 target-carrying text positions,
    masked vision over the given region rows.

``Numerics("fp8")`` rounds every matrix product's operands and every
activation the model keeps to float8 e4m3, and the gradients flowing back
to e5m2, with one scale per tensor, and accumulates in f32: the precision
below the configuration's bfloat16, used as the control of the comparison.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import philox

LN_EPS = 1e-12
MIN_FUSED_ELEMENTS = 1 << 22
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Operands rounded to float8 e4m3 going forward and their gradients to
    e5m2 coming back, one scale per tensor, as float8 training does."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


class Numerics:
    """How the model rounds: "f32" (not at all) or "fp8": matrix products'
    operands and every activation the model keeps (the outputs of linear
    layers, activations, attention, embeddings and LayerNorm sub-blocks,
    where a bfloat16 model keeps bfloat16) in float8 e4m3, their gradients
    in e5m2, one scale per tensor."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.kind == "f32" else _Fp8.apply(x)


F32 = Numerics("f32")


# --------------------------------------------------------------------------- #
# weights
# --------------------------------------------------------------------------- #
def _linear(name: str, d_in: int, d_out: int, bias: bool = True):
    out = [(f"{name}.weight", (d_out, d_in), "normal")]
    if bias:
        out.append((f"{name}.bias", (d_out,), "zero"))
    return out


def _ln(name: str, d: int):
    return [(f"{name}.weight", (d,), "one"), (f"{name}.bias", (d,), "zero")]


def _bert_layer(name: str, h: int, inter: int):
    return (_linear(f"{name}.attention.self.query", h, h)
            + _linear(f"{name}.attention.self.key", h, h)
            + _linear(f"{name}.attention.self.value", h, h)
            + _linear(f"{name}.attention.output.dense", h, h)
            + _ln(f"{name}.attention.output.LayerNorm", h)
            + _linear(f"{name}.intermediate.dense", h, inter)
            + _linear(f"{name}.output.dense", inter, h)
            + _ln(f"{name}.output.LayerNorm", h))


def param_specs(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, init) of every weight, in the reference's key order."""
    h, hv, bi = cfg["hidden_size"], cfg["v_hidden_size"], cfg["bi_hidden_size"]
    specs = [("bert.embeddings.word_embeddings.weight",
              (cfg["vocab_size"], h), "normal"),
             ("bert.embeddings.position_embeddings.weight",
              (cfg["max_position_embeddings"], h), "normal"),
             ("bert.embeddings.token_type_embeddings.weight",
              (cfg["type_vocab_size"], h), "normal")]
    specs += _ln("bert.embeddings.LayerNorm", h)
    specs += _linear("bert.v_embeddings.image_embeddings", cfg["v_feature_size"], hv)
    specs += _linear("bert.v_embeddings.image_location_embeddings", 5, hv)
    specs += _linear("bert.v_embeddings.image_orientation_embeddings", 4, hv)
    specs += _linear("bert.v_embeddings.image_next_orientation_embeddings", 2, hv)
    specs += [("bert.v_embeddings.image_sequence_embeddings.weight", (32, hv),
               "normal")]
    specs += _ln("bert.v_embeddings.LayerNorm", hv)
    for i in range(cfg["num_hidden_layers"]):
        specs += _bert_layer(f"bert.encoder.layer.{i}", h, cfg["intermediate_size"])
    for i in range(cfg["v_num_hidden_layers"]):
        specs += _bert_layer(f"bert.encoder.v_layer.{i}", hv,
                             cfg["v_intermediate_size"])
    for i in range(len(cfg["v_biattention_id"])):
        c = f"bert.encoder.c_layer.{i}"
        for name, d_in in (("query1", hv), ("key1", hv), ("value1", hv),
                           ("query2", h), ("key2", h), ("value2", h)):
            specs += _linear(f"{c}.biattention.{name}", d_in, bi)
        specs += _linear(f"{c}.biOutput.dense1", bi, hv)
        specs += _ln(f"{c}.biOutput.LayerNorm1", hv)
        specs += _linear(f"{c}.biOutput.dense2", bi, h)
        specs += _ln(f"{c}.biOutput.LayerNorm2", h)
        specs += _linear(f"{c}.v_intermediate.dense", hv, cfg["v_intermediate_size"])
        specs += _linear(f"{c}.v_output.dense", cfg["v_intermediate_size"], hv)
        specs += _ln(f"{c}.v_output.LayerNorm", hv)
        specs += _linear(f"{c}.t_intermediate.dense", h, cfg["intermediate_size"])
        specs += _linear(f"{c}.t_output.dense", cfg["intermediate_size"], h)
        specs += _ln(f"{c}.t_output.LayerNorm", h)
    specs += _linear("bert.t_pooler.dense", h, bi)
    specs += _linear("bert.v_pooler.dense", hv, bi)
    specs += [("cls.predictions.bias", (cfg["vocab_size"],), "zero")]
    specs += _linear("cls.predictions.transform.dense", h, h)
    specs += _ln("cls.predictions.transform.LayerNorm", h)
    specs += _linear("cls.bi_seq_relationship", bi, 2)
    specs += _linear("cls.imagePredictions.transform.dense", hv, hv)
    specs += _ln("cls.imagePredictions.transform.LayerNorm", hv)
    specs += _linear("cls.imagePredictions.decoder", hv, cfg["v_target_size"])
    specs += _linear("vil_logit", bi, 1)
    specs += _linear("judge", bi, 1)
    return specs


# the MLM decoder shares the word embedding
TIED = ("cls.predictions.decoder.weight", "bert.embeddings.word_embeddings.weight")


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight from ``seed`` in one draw on ``device``: N(0,
    initializer_range) matrices and embeddings (word row 0, the padding id,
    zero), zero biases, unit LayerNorm scales; f32, the type the model
    keeps its weights in.  The tied decoder key names the word embedding."""
    specs = param_specs(cfg)
    sizes = [math.prod(s) for _, s, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(cfg["initializer_range"])
    out, at = {}, 0
    for (name, shape, init), n in zip(specs, sizes):
        w = flat[at:at + n].view(shape)
        at += n
        if init == "zero":
            w.zero_()
        elif init == "one":
            w.fill_(1.0)
        out[name] = w
    out[TIED[1]][0].zero_()
    out[TIED[0]] = out[TIED[1]]
    return out


# --------------------------------------------------------------------------- #
# dropout of one train-mode forward
# --------------------------------------------------------------------------- #
class Dropout:
    """The masks of one train-mode forward of a whole batch, drawn in call
    order on the first block and replayed for the others."""

    def __init__(self, seed: int, device):
        self.seed = seed & philox.MASK64
        self.device = device
        self.sites = 0
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(philox.site_seed(self.seed, 0))
        self.masks: List[Tuple[torch.Tensor, float]] = []
        self.cursor = 0

    def replay(self) -> None:
        self.cursor = 0

    def _mask(self, draw):
        if self.cursor == len(self.masks):
            self.masks.append(draw())
        out = self.masks[self.cursor]
        self.cursor += 1
        return out

    def _kernel_seed(self) -> int:
        self.sites += 1
        return philox.site_seed(self.seed, self.sites)

    def uint8(self, shape, rate: float):
        """(keep, scale) of a generator site, at the full batch's shape."""
        def draw():
            thresh = min(round((1.0 - rate) * 256), 255)
            bits = torch.randint(0, 256, shape, dtype=torch.uint8,
                                 device=self.device, generator=self.gen)
            return bits < thresh, 256.0 / thresh
        return self._mask(draw)

    def attention(self, rates, problems):
        """[(keep, scale)] of one attention site: one seed for all of its
        ``problems`` (batch, heads, s_q, s_kv, direction)."""
        def draw():
            seed = self._kernel_seed()
            return [(philox.attention_keep(seed, r, *p, self.device),
                     1.0 / (1.0 - r)) for r, p in zip(rates, problems)]
        return self._mask(draw)

    def epilogue(self, rate: float, n_rows: int, d: int):
        def draw():
            seed = self._kernel_seed()
            return (philox.epilogue_keep(seed, rate, n_rows, d, self.device),
                    1.0 / (1.0 - rate))
        return self._mask(draw)


class Block:
    """Rows [b0, b1) of a batch of ``n`` rows, and its dropout (None in
    eval)."""

    def __init__(self, b0: int, b1: int, n: int, drop: Optional[Dropout]):
        self.b0, self.b1, self.n, self.drop = b0, b1, n, drop

    def rows(self, keep: torch.Tensor) -> torch.Tensor:
        return keep[self.b0:self.b1]


def _apply(x, keep, scale):
    return torch.where(keep, x * scale, 0.0)


def xla_dropout(x, rate: float, blk: Block):
    if blk.drop is None or rate == 0.0:
        return x
    keep, scale = blk.drop.uint8((blk.n,) + tuple(x.shape[1:]), rate)
    return _apply(x, blk.rows(keep), scale)


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
def linear(P, name, x, num: Numerics):
    b = P.get(f"{name}.bias")
    return num(F.linear(num(x), num(P[f"{name}.weight"]), b))


def layer_norm(P, name, x):
    u = x.mean(-1, keepdim=True)
    s = (x - u).square().mean(-1, keepdim=True)
    return P[f"{name}.weight"] * ((x - u) * torch.rsqrt(s + LN_EPS)) + P[f"{name}.bias"]


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


ACT = {"gelu": gelu, "relu": F.relu, "swish": lambda x: x * torch.sigmoid(x)}


def split(x, heads):
    b, s, h = x.shape
    return x.view(b, s, heads, h // heads).transpose(1, 2)


def merge(x):
    b, n, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, n * d)


def kernel_site(s_q: int, s_kv: int, d: int) -> bool:
    return s_q * s_kv >= 4096 and d in (64, 128)


def attend(q, k, v, bias, num, keep=None):
    """softmax(q k^T / sqrt(D) + bias) v; ``keep`` = (mask, scale) or None."""
    scores = torch.matmul(num(q), num(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores + bias[:, None, None, :], dim=-1)
    if keep is not None:
        probs = _apply(probs, *keep)
    return num(torch.matmul(num(probs), num(v)))


def add_norm(P, name, h, res, rate, cfg, blk: Block, num: Numerics):
    """LayerNorm(dropout(h) + res) at a sub-block's end."""
    d = h.shape[-1]
    s = h.shape[1]
    if (blk.drop is not None and rate > 0.0 and cfg["use_epilogue_kernels"]
            and cfg["use_attention_kernels"]
            and blk.n * s * d >= MIN_FUSED_ELEMENTS and d % 128 == 0):
        keep, scale = blk.drop.epilogue(rate, blk.n * s, d)
        keep = keep.view(blk.n, s, d)[blk.b0:blk.b1]
        return num(layer_norm(P, name, _apply(h, keep, scale) + res))
    return num(layer_norm(P, name, xla_dropout(h, rate, blk) + res))


def self_attention_layer(P, name, x, bias, heads, act, attn_rate, hid_rate,
                         cfg, num, blk: Block):
    q, k, v = (split(linear(P, f"{name}.attention.self.{p}", x, num), heads)
               for p in ("query", "key", "value"))
    train = blk.drop is not None
    s, d = q.shape[2], q.shape[3]
    if kernel_site(s, s, d):
        keep = None
        if train:
            (mask, scale), = blk.drop.attention(
                [attn_rate], [(blk.n, heads, s, s, 0)])
            keep = (blk.rows(mask), scale)
        ctx = attend(q, k, v, bias, num, keep)
    else:
        scores = torch.matmul(num(q), num(k).transpose(-1, -2)) / math.sqrt(d)
        probs = torch.softmax(scores + bias[:, None, None, :], dim=-1)
        probs = xla_dropout(probs, attn_rate if train else 0.0, blk)
        ctx = num(torch.matmul(num(probs), num(v)))
    att = add_norm(P, f"{name}.attention.output.LayerNorm",
                   linear(P, f"{name}.attention.output.dense", merge(ctx), num),
                   x, hid_rate, cfg, blk, num)
    inter = ACT[act](linear(P, f"{name}.intermediate.dense", att, num))
    return add_norm(P, f"{name}.output.LayerNorm",
                    linear(P, f"{name}.output.dense", inter, num),
                    att, hid_rate, cfg, blk, num)


def connection_layer(P, name, v_x, v_bias, t_x, t_bias, cfg, num, blk: Block):
    heads = cfg["bi_num_attention_heads"]
    b = f"{name}.biattention"
    q1, k1, v1 = (split(linear(P, f"{b}.{p}", v_x, num), heads)
                  for p in ("query1", "key1", "value1"))
    q2, k2, v2 = (split(linear(P, f"{b}.{p}", t_x, num), heads)
                  for p in ("query2", "key2", "value2"))
    train = blk.drop is not None
    rate1 = cfg["v_attention_probs_dropout_prob"] if train else 0.0
    rate2 = cfg["attention_probs_dropout_prob"] if train else 0.0
    s_t, s_v, d = q2.shape[2], q1.shape[2], q1.shape[3]
    if kernel_site(s_t, s_v, d):
        keep1 = keep2 = None
        if train:
            (m1, sc1), (m2, sc2) = blk.drop.attention(
                [rate1, rate2], [(blk.n, heads, s_t, s_v, 0),
                                 (blk.n, heads, s_v, s_t, 1)])
            keep1, keep2 = (blk.rows(m1), sc1), (blk.rows(m2), sc2)
        ctx1 = attend(q2, k1, v1, v_bias, num, keep1)     # text -> vision
        ctx2 = attend(q1, k2, v2, t_bias, num, keep2)     # vision -> text
    else:
        def core(q, k, v, bias, rate):
            probs = torch.softmax(torch.matmul(num(q), num(k).transpose(-1, -2))
                                  / math.sqrt(d) + bias[:, None, None, :], -1)
            return num(torch.matmul(num(xla_dropout(probs, rate, blk)), num(v)))
        ctx1 = core(q2, k1, v1, v_bias, rate1)
        ctx2 = core(q1, k2, v2, t_bias, rate2)
    o = f"{name}.biOutput"
    v_att = add_norm(P, f"{o}.LayerNorm1",
                     linear(P, f"{o}.dense1", merge(ctx2), num), v_x,
                     cfg["v_hidden_dropout_prob"], cfg, blk, num)
    t_att = add_norm(P, f"{o}.LayerNorm2",
                     linear(P, f"{o}.dense2", merge(ctx1), num), t_x,
                     cfg["hidden_dropout_prob"], cfg, blk, num)
    v_int = ACT[cfg["v_hidden_act"]](linear(P, f"{name}.v_intermediate.dense", v_att, num))
    v_out = add_norm(P, f"{name}.v_output.LayerNorm",
                     linear(P, f"{name}.v_output.dense", v_int, num), v_att,
                     cfg["v_hidden_dropout_prob"], cfg, blk, num)
    t_int = ACT[cfg["hidden_act"]](linear(P, f"{name}.t_intermediate.dense", t_att, num))
    t_out = add_norm(P, f"{name}.t_output.LayerNorm",
                     linear(P, f"{name}.t_output.dense", t_int, num), t_att,
                     cfg["hidden_dropout_prob"], cfg, blk, num)
    return v_out, t_out


def _text_layer(P, i, x, bias, cfg, num, blk):
    return self_attention_layer(
        P, f"bert.encoder.layer.{i}", x, bias, cfg["num_attention_heads"],
        cfg["hidden_act"], cfg["attention_probs_dropout_prob"],
        cfg["hidden_dropout_prob"], cfg, num, blk)


def _vision_layer(P, i, x, bias, cfg, num, blk):
    return self_attention_layer(
        P, f"bert.encoder.v_layer.{i}", x, bias, cfg["v_num_attention_heads"],
        cfg["v_hidden_act"], cfg["v_attention_probs_dropout_prob"],
        cfg["v_hidden_dropout_prob"], cfg, num, blk)


def encoder(P, t_x, v_x, t_bias, v_bias, cfg, num, blk):
    """Vision and text layers interleaved with the connection layers at the
    (v_biattention_id, t_biattention_id) schedule."""
    v_start = t_start = 0
    for count, (v_end, t_end) in enumerate(zip(cfg["v_biattention_id"],
                                               cfg["t_biattention_id"])):
        for i in range(v_start, v_end):
            v_x = _vision_layer(P, i, v_x, v_bias, cfg, num, blk)
        for i in range(t_start, t_end):
            t_x = _text_layer(P, i, t_x, t_bias, cfg, num, blk)
        v_x, t_x = connection_layer(P, f"bert.encoder.c_layer.{count}", v_x,
                                    v_bias, t_x, t_bias, cfg, num, blk)
        v_start, t_start = v_end, t_end
    for i in range(v_start, cfg["v_num_hidden_layers"]):
        v_x = _vision_layer(P, i, v_x, v_bias, cfg, num, blk)
    for i in range(t_start, cfg["num_hidden_layers"]):
        t_x = _text_layer(P, i, t_x, t_bias, cfg, num, blk)
    return t_x, v_x


def _rows(x, idx):
    return x if idx is None else torch.take_along_dim(x, idx.long()[..., None], dim=1)


def forward(P, cfg, x, blk: Block, num: Numerics = F32,
            language_rows=None, vision_rows=None) -> Dict[str, torch.Tensor]:
    """Outputs of the enabled heads for the rows of ``blk``.  ``x`` holds
    the block's model inputs ([rows, ...]: instr_tokens, segment_ids,
    instr_mask, image_features, image_locations, image_mask);
    ``language_rows`` / ``vision_rows`` ([rows, M]) pick the positions of
    the masked heads."""
    h_act = ACT[cfg["hidden_act"]]
    ids = x["instr_tokens"].long()
    pos = torch.arange(ids.shape[1], device=ids.device)
    emb = (P["bert.embeddings.word_embeddings.weight"][ids]
           + P["bert.embeddings.position_embeddings.weight"][pos]
           + P["bert.embeddings.token_type_embeddings.weight"][x["segment_ids"].long()])
    t_x = xla_dropout(num(layer_norm(P, "bert.embeddings.LayerNorm", num(emb))),
                      cfg["hidden_dropout_prob"], blk)
    feats, locs = x["image_features"].float(), x["image_locations"].float()
    ve = "bert.v_embeddings"
    v_emb = (linear(P, f"{ve}.image_embeddings", feats, num)
             + linear(P, f"{ve}.image_location_embeddings", locs[..., :5], num)
             + linear(P, f"{ve}.image_orientation_embeddings", locs[..., 5:9], num)
             + linear(P, f"{ve}.image_next_orientation_embeddings", locs[..., 9:11], num)
             + P[f"{ve}.image_sequence_embeddings.weight"][locs[..., 11].long()])
    v_x = xla_dropout(num(layer_norm(P, f"{ve}.LayerNorm", v_emb)),
                      cfg["hidden_dropout_prob"], blk)
    t_bias = (1.0 - x["instr_mask"].float()) * -10000.0
    v_bias = (1.0 - x["image_mask"].float()) * -10000.0
    seq_t, seq_v = encoder(P, t_x, v_x, t_bias, v_bias, cfg, num, blk)
    pooled_t = F.relu(linear(P, "bert.t_pooler.dense", seq_t[:, 0], num))
    pooled_v = F.relu(linear(P, "bert.v_pooler.dense", seq_v[:, 0], num))

    out = {}
    if cfg["masked_language"]:
        h = _rows(seq_t, language_rows)
        h = layer_norm(P, "cls.predictions.transform.LayerNorm",
                       h_act(linear(P, "cls.predictions.transform.dense", h, num)))
        out["language"] = (F.linear(num(h), num(P[TIED[1]]))
                           + P["cls.predictions.bias"])
    if cfg["masked_vision"]:
        hv = _rows(seq_v, vision_rows)
        hv = layer_norm(P, "cls.imagePredictions.transform.LayerNorm",
                        h_act(linear(P, "cls.imagePredictions.transform.dense", hv, num)))
        out["vision"] = linear(P, "cls.imagePredictions.decoder", hv, num)
    if cfg["ranking"] or cfg["traj_judge"]:
        if cfg["fusion_method"] == "mul":
            pooled = pooled_t * pooled_v
        else:
            pooled = pooled_t + pooled_v
        pooled = xla_dropout(pooled, cfg["fusion_dropout_prob"], blk)
        if cfg["ranking"]:
            out["ranking"] = linear(P, "vil_logit", pooled, num)
        if cfg["traj_judge"]:
            out["traj"] = linear(P, "judge", pooled, num)
    return out
