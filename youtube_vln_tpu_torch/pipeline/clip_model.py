"""Step 6's CLIP image and text encoders (ViT-B/32) in PyTorch (counterpart
of ``youtube_vln_tpu/pipeline/clip_model.py``).

The reference calls OpenAI ``clip.load("ViT-B/32")`` for frame features
(``precomute_CLIP_features.py:70-100``) and prompt embeddings
(``generate_CLIP_captions.py:34-40``).  ``ClipModel`` holds the weights
under HuggingFace ``CLIPModel``'s key names, so a ``CLIPModel`` state dict
(``pytorch_model.bin`` or ``.safetensors``) loads with ``strict=True``;
the forward is the JAX package's: pre-LN blocks with quickGELU, attention
scores and softmax in float32, a causal -inf mask on the text side, the text
pooled at the eot token (the argmax of the ids), the two projections.

``load_clip_params`` imports ``safetensors`` and ``tokenize_prompts``
imports ``transformers`` only when called: neither is on the card machine,
where the caller passes weights and token ids.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Union

import numpy as np
import torch
from torch import nn

from ..device import check_device, make_generator, resolve_device
from .resize import resize

LN_EPS = 1e-5


@dataclass(frozen=True)
class ClipConfig:
    # ViT-B/32 defaults (openai/clip-vit-base-patch32)
    image_size: int = 224
    patch_size: int = 32
    v_hidden: int = 768
    v_layers: int = 12
    v_heads: int = 12
    t_hidden: int = 512
    t_layers: int = 12
    t_heads: int = 8
    vocab_size: int = 49408
    context_length: int = 77
    proj_dim: int = 512

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


# --------------------------------------------------------------------------- #
# modules (HF CLIPModel key names)
# --------------------------------------------------------------------------- #
def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, device):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(hidden, hidden, device=device))

    def forward(self, x, causal: bool):
        n, s, h = x.shape
        d = h // self.heads

        def split(t):
            return t.view(n, s, self.heads, d).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
        if causal:
            scores = scores + torch.full((s, s), float("-inf"),
                                         device=x.device).triu(1)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(n, s, h)
        return self.out_proj(ctx)


class MLP(nn.Module):
    def __init__(self, hidden: int, device):
        super().__init__()
        self.fc1 = nn.Linear(hidden, 4 * hidden, device=device)
        self.fc2 = nn.Linear(4 * hidden, hidden, device=device)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, device):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.self_attn = Attention(hidden, heads, device)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.mlp = MLP(hidden, device)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class Encoder(nn.Module):
    def __init__(self, hidden: int, heads: int, n_layers: int, device):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(hidden, heads, device)
                                    for _ in range(n_layers))

    def forward(self, x, causal: bool):
        for layer in self.layers:
            x = layer(x, causal)
        return x


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: ClipConfig, device):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.v_hidden, device=device))
        self.patch_embedding = nn.Conv2d(3, cfg.v_hidden, cfg.patch_size,
                                         cfg.patch_size, bias=False, device=device)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, cfg.v_hidden,
                                               device=device)

    def forward(self, pixels):
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight


class VisionModel(nn.Module):
    def __init__(self, cfg: ClipConfig, device):
        super().__init__()
        self.embeddings = VisionEmbeddings(cfg, device)
        self.pre_layrnorm = nn.LayerNorm(cfg.v_hidden, eps=LN_EPS, device=device)
        self.encoder = Encoder(cfg.v_hidden, cfg.v_heads, cfg.v_layers, device)
        self.post_layernorm = nn.LayerNorm(cfg.v_hidden, eps=LN_EPS, device=device)


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: ClipConfig, device):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.t_hidden, device=device)
        self.position_embedding = nn.Embedding(cfg.context_length, cfg.t_hidden,
                                               device=device)


class TextModel(nn.Module):
    def __init__(self, cfg: ClipConfig, device):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg, device)
        self.encoder = Encoder(cfg.t_hidden, cfg.t_heads, cfg.t_layers, device)
        self.final_layer_norm = nn.LayerNorm(cfg.t_hidden, eps=LN_EPS, device=device)


class ClipModel(nn.Module):
    """CLIP's two encoders and projections, in eval mode."""

    def __init__(self, cfg: ClipConfig = ClipConfig(), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vision_model = VisionModel(cfg, device)
        self.text_model = TextModel(cfg, device)
        self.visual_projection = nn.Linear(cfg.v_hidden, cfg.proj_dim, bias=False,
                                           device=device)
        self.text_projection = nn.Linear(cfg.t_hidden, cfg.proj_dim, bias=False,
                                         device=device)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07), device=device))
        self._register_load_state_dict_pre_hook(_drop_position_ids)
        self.eval()

    @torch.no_grad()
    def init_weights(self, seed: Union[int, torch.Generator]) -> "ClipModel":
        """The JAX package's init: weights, embeddings and projections N(0,
        0.02), zero biases, unit LayerNorms."""
        gen = make_generator(seed, self.logit_scale.device)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding, nn.Conv2d)):
                m.weight.normal_(0.0, 0.02, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        self.vision_model.embeddings.class_embedding.normal_(0.0, 0.02, generator=gen)
        self.logit_scale.fill_(math.log(1 / 0.07))
        return self


def _drop_position_ids(state_dict, prefix, *args):
    """HF checkpoints of some versions carry the ``position_ids`` buffer."""
    for k in [k for k in state_dict if k.startswith(prefix)
              and k.endswith("embeddings.position_ids")]:
        del state_dict[k]


def clip_image_features(model: ClipModel, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [N, 3, H, W] float32 (CLIP-normalised) -> [N, proj_dim]: HF
    ``get_image_features`` / OpenAI ``encode_image`` (unnormalised)."""
    vm = model.vision_model
    x = vm.pre_layrnorm(vm.embeddings(pixels))
    x = vm.encoder(x, causal=False)
    return model.visual_projection(vm.post_layernorm(x[:, 0]))


def clip_text_features(model: ClipModel, token_ids: torch.Tensor) -> torch.Tensor:
    """token_ids [N, S] (BPE ids, eot the highest id) -> [N, proj_dim]:
    causal attention, pooled at the eot position (the first argmax)."""
    tm = model.text_model
    token_ids = token_ids.long()
    n, s = token_ids.shape
    x = (tm.embeddings.token_embedding(token_ids)
         + tm.embeddings.position_embedding.weight[:s])
    x = tm.final_layer_norm(tm.encoder(x, causal=True))
    pooled = x[torch.arange(n, device=x.device), token_ids.argmax(dim=-1)]
    return model.text_projection(pooled)


# --------------------------------------------------------------------------- #
# weights and tokens from local files
# --------------------------------------------------------------------------- #
def load_clip_params(path, cfg: ClipConfig = ClipConfig(), device="cuda") -> ClipModel:
    """A ``ClipModel`` on ``device`` from a local HF CLIP checkpoint
    (``.safetensors`` through ``safetensors``, else ``torch.load``)."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file
        sd = load_file(str(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    model = ClipModel(cfg, device=device)
    model.load_state_dict(sd, strict=True)
    return model


def tokenize_prompts(prompts: Sequence[str], tokenizer_dir: str,
                     context_length: int = 77) -> np.ndarray:
    """BPE-tokenize with a local HF CLIPTokenizer directory (vocab.json +
    merges.txt); raises when the assets or ``transformers`` are absent."""
    try:
        from transformers import CLIPTokenizer
        tok = CLIPTokenizer.from_pretrained(tokenizer_dir)
    except Exception as e:   # no egress: only local dirs work
        raise RuntimeError(
            f"CLIP tokenizer assets not available at {tokenizer_dir}; "
            "download vocab.json/merges.txt offline first") from e
    enc = tok(list(prompts), padding="max_length", truncation=True,
              max_length=context_length, return_tensors="np")
    return enc["input_ids"].astype(np.int32)


# --------------------------------------------------------------------------- #
# preprocessing and the step-6a driver
# --------------------------------------------------------------------------- #
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_images(images_uint8: np.ndarray, size: int = 224,
                      device="cuda") -> torch.Tensor:
    """[N, H, W, 3] uint8 -> CLIP-normalised float32 [N, 3, size, size] on
    ``device``: ``clip.load()``'s Resize(size, BICUBIC) of the shorter side
    and CenterCrop(size), the resize as ``jax.image.resize(method=
    "bicubic")`` (Keys a = -0.5, antialiased)."""
    from .places365 import frames_to_device, normalize, crop_size

    x = frames_to_device(images_uint8, resolve_device(device))
    nh, nw = crop_size(x.shape[2], x.shape[3], size, size)
    x = resize(x, (nh, nw), "bicubic", antialias=True)
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, :, top:top + size, left:left + size]
    return normalize(x, CLIP_MEAN, CLIP_STD)


def encode_video_frames(model: ClipModel, images_uint8: np.ndarray,
                        batch_size: int = 64, device="cuda") -> np.ndarray:
    """Preprocess + encode_image per ``batch_size`` frames -> float32
    [N, proj_dim] (precomute_CLIP_features.py:70-100)."""
    dev = check_device(model, device)
    chunks = []
    for s in range(0, len(images_uint8), batch_size):
        px = preprocess_images(images_uint8[s:s + batch_size],
                               model.cfg.image_size, device=dev)
        with torch.inference_mode():
            chunks.append(clip_image_features(model, px).float().cpu().numpy())
    return np.concatenate(chunks, axis=0)


CLIP_TSV_FIELDNAMES = ["video_id", "frame_id", "features"]


def read_clip_tsv(path, feature_size: int = 512):
    """Reference ``read_tsv`` (precomute_CLIP_features.py:48-59):
    returns (video_ids_with_features, {"{vid}_{frame}": [1, D] f32})."""
    import base64
    import csv

    exist, feats = [], {}
    with open(path, newline="") as f:
        for item in csv.DictReader(f, delimiter="\t",
                                   fieldnames=CLIP_TSV_FIELDNAMES):
            long_id = item["video_id"] + "_" + item["frame_id"]
            feats[long_id] = np.frombuffer(
                base64.decodebytes(item["features"].encode("ascii")),
                dtype=np.float32).reshape((1, feature_size))
            exist.append(item["video_id"])
    return exist, feats


def build_clip_tsv(model: ClipModel, frames_dir, out_path, image_loader=None,
                   batch_size: int = 64, device="cuda") -> int:
    """Reference ``build_tsv`` (precomute_CLIP_features.py:61-104): walk
    raw_frames/{vid}/*.jpg, encode every frame not already in the TSV
    (resume-by-append), write base64 f32 rows.  ``image_loader`` reads a
    frame (PIL by default).  Returns rows written."""
    import base64
    import csv
    from pathlib import Path

    from .filters import pil_loader

    dev = check_device(model, device)
    image_loader = image_loader or pil_loader

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    done = set()
    if out_path.exists():
        try:
            _, feats = read_clip_tsv(out_path, model.cfg.proj_dim)
            done = set(feats)
        except Exception:
            done = set()

    n = 0
    with open(out_path, "a", newline="") as f:
        writer = csv.DictWriter(f, delimiter="\t",
                                fieldnames=CLIP_TSV_FIELDNAMES)
        for vid_dir in sorted(Path(frames_dir).iterdir()):
            if not vid_dir.is_dir():
                continue
            frames = [p for p in sorted(vid_dir.glob("*.jpg"))
                      if f"{vid_dir.name}_{p.name}" not in done]
            if not frames:
                continue
            images = np.stack([image_loader(p) for p in frames])
            emb = encode_video_frames(model, images, batch_size, device=dev)
            for p, e in zip(frames, emb):
                writer.writerow({
                    "video_id": vid_dir.name,
                    "frame_id": p.name,
                    "features": base64.b64encode(
                        e[None].astype(np.float32)).decode(),
                })
                n += 1
    return n


def text_features(model: ClipModel, token_ids: np.ndarray,
                  device="cuda") -> np.ndarray:
    """Token ids [N, S] -> float32 [N, proj_dim] on the host (the
    ``text_encoder`` of ``clip_captions.run`` once tokenised)."""
    dev = check_device(model, device)
    with torch.inference_mode():
        out = clip_text_features(model, torch.as_tensor(np.asarray(token_ids)).to(dev))
    return out.float().cpu().numpy()
