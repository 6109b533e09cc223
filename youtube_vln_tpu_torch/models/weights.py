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
  * ``shard_state_dict`` cuts a full state dict (either of the above) into
    one model rank's shard by ``parallel/mesh.py:param_spec``, the layout
    of a ``Lily`` built with that rank's ``ModelShard``;
    ``merge_state_dicts`` puts every rank's shards back together.
  * one carrier per JAX parameter tree of the legacy heads and the offline
    pipeline's models (``legacy_state_dict_from_jax_params``,
    ``places_`` / ``alexnet_`` / ``maskrcnn_`` / ``clip_`` /
    ``inverse_state_dict_from_jax_params``): convs HWIO -> OIHW, linears
    transposed, the HWC-flattened rows of AlexNet's and the inverse head's
    first linear put in torch's CHW order, Mask R-CNN's folded
    FrozenBatchNorm written as weight = scale, bias = shift, mean 0 and
    var 1 - eps (var + eps rounds to 1 in float32, so nothing is lost).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..config import LilyConfig
from ..parallel.mesh import param_spec
from ..parallel.tensor import shard_tensor


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


def full_shapes(cfg: LilyConfig) -> Dict[str, Tuple[int, ...]]:
    """The shape of every state-dict tensor of an unsharded ``Lily`` of
    ``cfg`` (built on the meta device: nothing is allocated)."""
    from .vilbert import Lily
    return {k: tuple(v.shape)
            for k, v in Lily(cfg, device="meta").state_dict().items()}


def shard_state_dict(full: Dict[str, torch.Tensor], extents: Dict[str, int],
                     model_rank: int) -> Dict[str, torch.Tensor]:
    """Model rank ``model_rank``'s shard of the full state dict ``full``
    (keys of ``Lily``, full shapes) under the mesh ``extents``: every
    tensor that ``param_spec`` shards is cut on its dim, the rest kept."""
    world = extents.get("model", 1)
    return {k: shard_tensor(v, param_spec(k, tuple(v.shape), extents),
                            model_rank, world) for k, v in full.items()}


def merge_state_dicts(shards: List[Dict[str, torch.Tensor]],
                      shapes: Dict[str, Tuple[int, ...]]
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``: the full state dict of every
    model rank's shard, in rank order; ``shapes`` are the full shapes
    (``full_shapes``)."""
    extents = {"model": len(shards)}
    out = {}
    for k, v in shards[0].items():
        dim = param_spec(k, shapes[k], extents)
        out[k] = v if dim is None else torch.cat([s[k] for s in shards], dim)
    return out


# --------------------------------------------------------------------------- #
# carriers of the legacy heads and the pipeline's models: one per JAX
# parameter tree (numpy leaves) -> a state dict that the port's module
# loads with strict=True
# --------------------------------------------------------------------------- #
def _conv(w) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _tensor(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _linear_t(p) -> Dict[str, torch.Tensor]:
    """{w [in, out], b} -> {weight [out, in], bias}."""
    return {"weight": _tensor(np.asarray(p["w"]).T), "bias": _tensor(p["b"])}


def _put(sd: Dict[str, torch.Tensor], prefix: str, tensors: Dict[str, torch.Tensor]):
    for k, v in tensors.items():
        sd[f"{prefix}.{k}"] = v


def _hwc_rows_to_chw(w, h: int, wd: int, c: int) -> np.ndarray:
    """The rows of a [h*wd*c, out] kernel that reads an HWC flatten, in the
    order of a CHW flatten."""
    w = np.asarray(w)
    return w.reshape(h, wd, c, -1).transpose(2, 0, 1, 3).reshape(h * wd * c, -1)


def simple_classifier_state_dict(cls_params: Dict, prefix: str = "vil_prediction"
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX SimpleClassifier ``{dense1, dense2: {v [in, out], g, b}}``
    -> ``{prefix}.main.0|3.weight_g|weight_v|bias``."""
    sd = {}
    for i, name in ((0, "dense1"), (3, "dense2")):
        p = cls_params[name]
        _put(sd, f"{prefix}.main.{i}", {
            "weight_g": _tensor(np.float32(p["g"])),
            "weight_v": _tensor(np.asarray(p["v"]).T),
            "bias": _tensor(p["b"])})
    return sd


def legacy_state_dict_from_jax_params(params: Dict[str, Any], cfg: LilyConfig,
                                      classifier_params: Dict = None
                                      ) -> Dict[str, torch.Tensor]:
    """The JAX parameter tree of the legacy heads: without
    ``classifier_params`` the keys of ``BertForMultiModalPreTraining``
    (``bert.*`` and ``cls.*``), with them those of ``VILBertForVLTasks``
    (``bert.*`` and ``vil_prediction.*``)."""
    full = state_dict_from_jax_params(params, cfg)
    keep = ("bert.",) if classifier_params is not None else ("bert.", "cls.")
    sd = {k: v for k, v in full.items() if k.startswith(keep)}
    if classifier_params is not None:
        sd.update(simple_classifier_state_dict(classifier_params))
    return sd


def _bn(p) -> Dict[str, torch.Tensor]:
    """{scale, bias, mean, var} -> torch BatchNorm2d."""
    return {"weight": _tensor(p["scale"]), "bias": _tensor(p["bias"]),
            "running_mean": _tensor(p["mean"]), "running_var": _tensor(p["var"])}


def _frozen_bn(p, eps: float) -> Dict[str, torch.Tensor]:
    """BN folded to {scale, shift} -> FrozenBatchNorm2d: weight = scale,
    bias = shift, mean 0, var 1 - eps, so that var + eps rounds to 1."""
    c = np.asarray(p["scale"]).shape[0]
    return {"weight": _tensor(p["scale"]), "bias": _tensor(p["shift"]),
            "running_mean": torch.zeros(c), "running_var": torch.full((c,), 1.0 - eps)}


def places_state_dict_from_jax_params(params: Dict) -> Dict[str, torch.Tensor]:
    """``places365.init_places_params`` / ``params_from_torch_state_dict``
    -> ``WideResNet18``."""
    sd = {"conv1.weight": _conv(params["conv1"])}
    _put(sd, "bn1", _bn(params["bn1"]))
    for li in range(1, 5):
        for bi, blk in enumerate(params[f"layer{li}"]):
            p = f"layer{li}.{bi}"
            sd[f"{p}.conv1.weight"] = _conv(blk["conv1"])
            _put(sd, f"{p}.bn1", _bn(blk["bn1"]))
            sd[f"{p}.conv2.weight"] = _conv(blk["conv2"])
            _put(sd, f"{p}.bn2", _bn(blk["bn2"]))
            if "downsample" in blk:
                sd[f"{p}.downsample.0.weight"] = _conv(blk["downsample"]["conv"])
                _put(sd, f"{p}.downsample.1", _bn(blk["downsample"]["bn"]))
    _put(sd, "fc", _linear_t(params["fc"]))
    return sd


def alexnet_state_dict_from_jax_params(params: Dict) -> Dict[str, torch.Tensor]:
    """``places365.init_alexnet_params`` -> ``AlexNet``; the first linear's
    rows back from the JAX forward's HWC flatten to torch's CHW."""
    sd = {}
    for p, i in zip(params["features"], (0, 3, 6, 8, 10)):
        sd[f"features.{i}.weight"] = _conv(p["w"])
        sd[f"features.{i}.bias"] = _tensor(p["b"])
    for j, (p, i) in enumerate(zip(params["classifier"], (1, 4, 6))):
        w = _hwc_rows_to_chw(p["w"], 6, 6, 256) if j == 0 else p["w"]
        _put(sd, f"classifier.{i}", _linear_t({"w": w, "b": p["b"]}))
    return sd


def maskrcnn_state_dict_from_jax_params(params: Dict, eps: float = 1e-5
                                        ) -> Dict[str, torch.Tensor]:
    """``maskrcnn.init_maskrcnn_params`` / ``params_from_torch_state_dict``
    (FrozenBN folded to scale and shift) -> ``MaskRCNN``."""
    B = "backbone.body"
    sd = {f"{B}.conv1.weight": _conv(params["stem"]["conv"])}
    _put(sd, f"{B}.bn1", _frozen_bn(params["stem"]["bn"], eps))
    for li in range(4):
        for bi, blk in enumerate(params[f"layer{li + 1}"]):
            p = f"{B}.layer{li + 1}.{bi}"
            for n in (1, 2, 3):
                sd[f"{p}.conv{n}.weight"] = _conv(blk[f"conv{n}"])
                _put(sd, f"{p}.bn{n}", _frozen_bn(blk[f"bn{n}"], eps))
            if "down" in blk:
                sd[f"{p}.downsample.0.weight"] = _conv(blk["down"]["conv"])
                _put(sd, f"{p}.downsample.1", _frozen_bn(blk["down"]["bn"], eps))
    for kind in ("inner", "layer"):
        for i, p in enumerate(params["fpn"][kind]):
            sd[f"backbone.fpn.{kind}_blocks.{i}.weight"] = _conv(p["w"])
            sd[f"backbone.fpn.{kind}_blocks.{i}.bias"] = _tensor(p["b"])
    for name, key in (("conv", "conv"), ("cls", "cls_logits"), ("bbox", "bbox_pred")):
        sd[f"rpn.head.{key}.weight"] = _conv(params["rpn"][name]["w"])
        sd[f"rpn.head.{key}.bias"] = _tensor(params["rpn"][name]["b"])
    for name in ("fc6", "fc7"):
        _put(sd, f"roi_heads.box_head.{name}", _linear_t(params["box_head"][name]))
    _put(sd, "roi_heads.box_predictor.cls_score", _linear_t(params["box_pred"]["cls"]))
    _put(sd, "roi_heads.box_predictor.bbox_pred", _linear_t(params["box_pred"]["bbox"]))
    return sd


def clip_state_dict_from_jax_params(params: Dict) -> Dict[str, torch.Tensor]:
    """``clip_model.init_clip_params`` / ``params_from_hf_state_dict`` ->
    ``ClipModel`` (HF ``CLIPModel`` keys)."""
    sd = {}

    def ln(prefix, p):
        _put(sd, prefix, {"weight": _tensor(p["w"]), "bias": _tensor(p["b"])})

    def blocks(prefix, layers):
        for i, p in enumerate(layers):
            b = f"{prefix}.encoder.layers.{i}"
            ln(f"{b}.layer_norm1", p["ln1"])
            for name, key in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                              ("out", "out_proj")):
                _put(sd, f"{b}.self_attn.{key}", _linear_t(p[name]))
            ln(f"{b}.layer_norm2", p["ln2"])
            _put(sd, f"{b}.mlp.fc1", _linear_t(p["fc1"]))
            _put(sd, f"{b}.mlp.fc2", _linear_t(p["fc2"]))

    v, t = params["visual"], params["text"]
    sd["vision_model.embeddings.class_embedding"] = _tensor(v["cls"])
    sd["vision_model.embeddings.patch_embedding.weight"] = _conv(v["patch"])
    sd["vision_model.embeddings.position_embedding.weight"] = _tensor(v["pos"])
    ln("vision_model.pre_layrnorm", v["ln_pre"])
    blocks("vision_model", v["blocks"])
    ln("vision_model.post_layernorm", v["ln_post"])
    sd["visual_projection.weight"] = _tensor(np.asarray(v["proj"]).T)
    sd["text_model.embeddings.token_embedding.weight"] = _tensor(t["tok"])
    sd["text_model.embeddings.position_embedding.weight"] = _tensor(t["pos"])
    blocks("text_model", t["blocks"])
    ln("text_model.final_layer_norm", t["ln_final"])
    sd["text_projection.weight"] = _tensor(np.asarray(t["proj"]).T)
    sd["logit_scale"] = _tensor(params["logit_scale"])
    return sd


def inverse_state_dict_from_jax_params(params: Dict) -> Dict[str, torch.Tensor]:
    """``inverse_action.init_inverse_params`` -> ``InverseActionHead``;
    fc1's rows back from the JAX forward's HWC flatten to CHW."""
    sd = {}
    for name in ("conv1", "conv2", "conv3"):
        sd[f"{name}.weight"] = _conv(params[name]["w"])
        sd[f"{name}.bias"] = _tensor(params[name]["b"])
    _put(sd, "fc1", _linear_t({"w": _hwc_rows_to_chw(params["fc1"]["w"], 3, 3, 64),
                               "b": params["fc1"]["b"]}))
    _put(sd, "fc2", _linear_t(params["fc2"]))
    return sd
