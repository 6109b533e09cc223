"""Carrying weights into the port.

  * ``state_dict_from_jax_params`` turns the JAX package's parameter tree
    (nested dicts and lists of numpy arrays, linear kernels ``[in, out]``)
    into the port's state dict; the key map is a copy of
    ``youtube_vln_tpu/models/torch_io.py:_key_map``.
  * ``normalize_state_dict`` applies the reference-checkpoint rules of
    ``torch_io.py:normalize_state_dict`` (the ``model_state_dict`` wrapper,
    gamma/beta renames, the missing ``bert.`` prefix) and drops the dead
    ``biOutput.q_dense1`` / ``q_dense2`` keys, so that
    ``Lily.load_state_dict(..., strict=True)`` takes a reference ``.bin``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..config import LilyConfig


def _key_map(cfg: LilyConfig) -> List[Tuple[str, Tuple, str]]:
    """(state-dict prefix, JAX tree path, kind); kind is "linear"
    (weight transposed + bias), "ln" (weight + bias) or "emb" (weight)."""
    m: List[Tuple[str, Tuple, str]] = []
    add = m.append

    add(("bert.embeddings.word_embeddings", ("text_embed", "word"), "emb"))
    add(("bert.embeddings.position_embeddings", ("text_embed", "pos"), "emb"))
    add(("bert.embeddings.token_type_embeddings", ("text_embed", "type"), "emb"))
    add(("bert.embeddings.LayerNorm", ("text_embed", "ln"), "ln"))

    add(("bert.v_embeddings.image_embeddings", ("vis_embed", "img"), "linear"))
    add(("bert.v_embeddings.image_location_embeddings", ("vis_embed", "loc"), "linear"))
    add(("bert.v_embeddings.image_orientation_embeddings", ("vis_embed", "orient"), "linear"))
    add(("bert.v_embeddings.image_next_orientation_embeddings", ("vis_embed", "next_orient"), "linear"))
    add(("bert.v_embeddings.image_sequence_embeddings", ("vis_embed", "seq"), "emb"))
    add(("bert.v_embeddings.LayerNorm", ("vis_embed", "ln"), "ln"))

    def layer(prefix, tree_prefix):
        add((f"{prefix}.attention.self.query", tree_prefix + ("attn", "query"), "linear"))
        add((f"{prefix}.attention.self.key", tree_prefix + ("attn", "key"), "linear"))
        add((f"{prefix}.attention.self.value", tree_prefix + ("attn", "value"), "linear"))
        add((f"{prefix}.attention.output.dense", tree_prefix + ("attn", "out"), "linear"))
        add((f"{prefix}.attention.output.LayerNorm", tree_prefix + ("attn", "ln"), "ln"))
        add((f"{prefix}.intermediate.dense", tree_prefix + ("ffn", "inter"), "linear"))
        add((f"{prefix}.output.dense", tree_prefix + ("ffn", "out"), "linear"))
        add((f"{prefix}.output.LayerNorm", tree_prefix + ("ffn", "ln"), "ln"))

    for i in range(cfg.num_hidden_layers):
        layer(f"bert.encoder.layer.{i}", ("text_layers", i))
    for i in range(cfg.v_num_hidden_layers):
        layer(f"bert.encoder.v_layer.{i}", ("vis_layers", i))

    for i in range(len(cfg.v_biattention_id)):
        p = f"bert.encoder.c_layer.{i}"
        t = ("cross_layers", i)
        for name in ("query1", "key1", "value1", "query2", "key2", "value2"):
            add((f"{p}.biattention.{name}", t + ("bi", name), "linear"))
        add((f"{p}.biOutput.dense1", t + ("out", "dense1"), "linear"))
        add((f"{p}.biOutput.LayerNorm1", t + ("out", "ln1"), "ln"))
        add((f"{p}.biOutput.dense2", t + ("out", "dense2"), "linear"))
        add((f"{p}.biOutput.LayerNorm2", t + ("out", "ln2"), "ln"))
        add((f"{p}.v_intermediate.dense", t + ("v_ffn", "inter"), "linear"))
        add((f"{p}.v_output.dense", t + ("v_ffn", "out"), "linear"))
        add((f"{p}.v_output.LayerNorm", t + ("v_ffn", "ln"), "ln"))
        add((f"{p}.t_intermediate.dense", t + ("t_ffn", "inter"), "linear"))
        add((f"{p}.t_output.dense", t + ("t_ffn", "out"), "linear"))
        add((f"{p}.t_output.LayerNorm", t + ("t_ffn", "ln"), "ln"))

    add(("bert.t_pooler.dense", ("t_pooler",), "linear"))
    add(("bert.v_pooler.dense", ("v_pooler",), "linear"))

    add(("cls.predictions.transform.dense", ("cls", "transform", "dense"), "linear"))
    add(("cls.predictions.transform.LayerNorm", ("cls", "transform", "ln"), "ln"))
    add(("cls.bi_seq_relationship", ("cls", "seq_rel"), "linear"))
    add(("cls.imagePredictions.transform.dense", ("cls", "img_head", "transform", "dense"), "linear"))
    add(("cls.imagePredictions.transform.LayerNorm", ("cls", "img_head", "transform", "ln"), "ln"))
    add(("cls.imagePredictions.decoder", ("cls", "img_head", "decoder"), "linear"))
    add(("vil_logit", ("vil_logit",), "linear"))
    add(("judge", ("judge",), "linear"))
    return m


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_jax_params(params: Dict[str, Any],
                               cfg: LilyConfig) -> Dict[str, torch.Tensor]:
    """The JAX parameter tree (numpy leaves) as the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for key, path, kind in _key_map(cfg):
        node = params
        for p in path:
            node = node[p]
        if kind == "emb":
            sd[f"{key}.weight"] = _tensor(node)
        elif kind == "ln":
            sd[f"{key}.weight"] = _tensor(node["w"])
            sd[f"{key}.bias"] = _tensor(node["b"])
        else:
            sd[f"{key}.weight"] = _tensor(np.asarray(node["w"]).T)
            sd[f"{key}.bias"] = _tensor(node["b"])
    # the MLM decoder is tied to the word embedding
    sd["cls.predictions.decoder.weight"] = sd[
        "bert.embeddings.word_embeddings.weight"]
    sd["cls.predictions.bias"] = _tensor(params["cls"]["decoder_bias"])
    return sd


def normalize_state_dict(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference-layout state dict (torch tensors or numpy arrays) in the
    port's key layout."""
    if "model_state_dict" in state_dict:
        state_dict = state_dict["model_state_dict"]
    has_bert_prefix = any(k.startswith("bert.") for k in state_dict)
    out = {}
    for k, v in state_dict.items():
        k = k.replace("gamma", "weight").replace("beta", "bias")
        if not has_bert_prefix and not k.startswith(("cls.", "vil_logit", "judge")):
            # pure BertModel dump (embeddings.* / encoder.* ...) -> bert.*
            k = "bert." + k
        if ".biOutput.q_dense" in k:
            continue   # reference params its forward never reads
        out[k] = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
    return out
