"""Steps 7-8: the inverse action model and the per-video action profiles in
PyTorch (counterpart of ``youtube_vln_tpu/pipeline/inverse_action.py``).

The reference trains a small classifier over frozen ResNet-18 feature maps
of consecutive frame pairs to predict the camera action between them,
{forward, left, right} (``scripts/inverse_action/inverse_model.py:34-88``:
concat [B, 1024, 7, 7] -> 1x1 conv 256 -> 3x3 conv 256 -> 3x3 conv 64 ->
fc 128 -> Dropout(0.5) -> fc 3).  ``InverseActionHead`` is that head in
NCHW: its fc1 reads the conv map flattened CHW, as the reference's does
(the JAX package flattens HWC; ``models/weights.py`` permutes its rows).
It trains with ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8 outside
the square root, as ``optax.adam``).  Profiles are written as JSON.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import check_device, make_generator, resolve_device
from .places365 import WideResNet18, preprocess_images_crop, resnet18_backbone_forward

ACTIONS = ("forward", "left", "right")
ACTION_MAP = {0: "forward", 1: "left", 2: "right"}
DROPOUT = 0.5


class InverseActionHead(nn.Module):
    """[B, C, 7, 7] feature maps of frames k and k+1 -> [B, 3] logits."""

    def __init__(self, feat_channels: int = 512, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = nn.Conv2d(2 * feat_channels, 256, 1, device=device)
        self.conv2 = nn.Conv2d(256, 256, 3, device=device)
        self.conv3 = nn.Conv2d(256, 64, 3, device=device)
        self.fc1 = nn.Linear(64 * 3 * 3, 128, device=device)
        self.fc2 = nn.Linear(128, 3, device=device)

    @torch.no_grad()
    def init_weights(self, seed: Union[int, torch.Generator]) -> "InverseActionHead":
        """The JAX package's init: weights N(0, 0.05), zero biases."""
        gen = make_generator(seed, self.fc2.weight.device)
        for m in (self.conv1, self.conv2, self.conv3, self.fc1, self.fc2):
            m.weight.normal_(0.0, 0.05, generator=gen)
            m.bias.zero_()
        return self

    def forward(self, feat_k, feat_k1, generator: torch.Generator = None):
        """Dropout(0.5) after fc1's ReLU when ``generator`` is given (train
        mode), drawn from it."""
        x = torch.cat([feat_k, feat_k1], dim=1)
        x = F.relu(self.conv1(x))                   # [B, 256, 7, 7]
        x = F.relu(self.conv2(x))                   # [B, 256, 5, 5]
        x = F.relu(self.conv3(x))                   # [B, 64, 3, 3]
        x = F.relu(self.fc1(x.flatten(1)))
        if generator is not None:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < DROPOUT
            x = torch.where(keep, x / DROPOUT, torch.zeros((), device=x.device))
        return self.fc2(x)


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s update: b1 0.9, b2 0.999, eps 1e-8 added to
    sqrt of the bias-corrected second moment."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_inverse_model(pairs: Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                        *, steps: int = 100, lr: float = 1e-3,
                        feat_channels: int = 512, seed: int = 0,
                        device="cuda") -> Tuple[InverseActionHead, List[float]]:
    """Train the head on (feat_k, feat_k1, action) batches of NCHW maps.
    Weights from ``seed``, dropout from ``seed + 1``.  Returns (the head in
    eval mode, per-step losses)."""
    dev = resolve_device(device)
    model = InverseActionHead(feat_channels, device=dev).init_weights(seed)
    opt = make_optimizer(model, lr)
    gen = make_generator(seed + 1, dev)
    losses = []
    for _, (fk, fk1, y) in zip(range(steps), pairs):
        fk, fk1, y = (torch.as_tensor(np.asarray(a)).to(dev) for a in (fk, fk1, y))
        logits = model(fk, fk1, generator=gen)
        loss = F.cross_entropy(logits, y.long())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())     # read once at the end
    return model.eval(), [float(x) for x in losses]


def encode_frames(backbone: WideResNet18, images_uint8: np.ndarray,
                  batch_size: int = 64, device="cuda") -> np.ndarray:
    """Frozen ResNet-18 pair-encoder features from raw frames (reference
    inverse_model.py:36-44 + imageNetTransformPIL: Resize(224) on the
    shorter side + CenterCrop(224)): [N, H, W, 3] uint8 -> [N, 512, 7, 7]
    float32."""
    dev = check_device(backbone, device)
    chunks = []
    for s in range(0, len(images_uint8), batch_size):
        px = preprocess_images_crop(images_uint8[s:s + batch_size], resize=224,
                                    crop=224, device=dev)
        with torch.inference_mode():
            chunks.append(resnet18_backbone_forward(backbone, px).cpu().numpy())
    return np.concatenate(chunks, axis=0)


def image_pair_batches(images_uint8: np.ndarray, actions: np.ndarray,
                       backbone: WideResNet18, *, batch_size: int = 32,
                       seed: int = 0, device="cuda"
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(frame_k, frame_k+1, action) batches from raw frames through the
    frozen backbone; ``actions`` labels the transition images[i] ->
    images[i+1]."""
    feats = encode_frames(backbone, images_uint8, device=device)
    fk, fk1 = feats[:-1], feats[1:]
    y = np.asarray(actions, np.int64)
    assert len(y) == len(fk)
    rng = np.random.default_rng(seed)
    while True:
        sel = rng.integers(0, len(fk), size=batch_size)
        yield fk[sel], fk1[sel], y[sel]


def train_inverse_model_from_images(images_uint8: np.ndarray, actions: np.ndarray,
                                    backbone: WideResNet18, device="cuda", **train_kw):
    """Step 7 end-to-end from frames: frozen ResNet-18 features + the head."""
    batches = image_pair_batches(images_uint8, actions, backbone,
                                 seed=train_kw.get("seed", 0), device=device)
    return train_inverse_model(batches, device=device, **train_kw)


def predict_actions(model: InverseActionHead, feats: Sequence[np.ndarray],
                    device="cuda") -> List[str]:
    """Actions between consecutive frames: len(feats) - 1 predictions."""
    dev = check_device(model, device)
    if len(feats) < 2:
        return []
    x = torch.as_tensor(np.stack(feats)).to(dev)
    with torch.inference_mode():
        logits = model(x[:-1], x[1:])
    return [ACTION_MAP[int(i)] for i in logits.argmax(-1).cpu().numpy()]


def write_action_profiles(out_dir, video_id: str,
                          trajectories: Dict[str, List[int]],
                          actions_by_frame: Dict[int, str],
                          captions: Dict[str, List[str]]) -> Path:
    """Per-video profile artifacts (reference genearate_Profiles.py:40-62):
    ``inverses_actions.json`` — one {frame_id: [action]} dict per
    trajectory, actions for all but the last frame — and
    ``captions_pro.json`` — one {frame_id: caption} dict per trajectory,
    including the last frame.  Returns the inverses_actions.json path."""
    profiles, cap_profiles = [], []
    for _, frames in trajectories.items():
        per, cap_per = {}, {}
        for fid in frames[:-1]:
            per[str(fid)] = [actions_by_frame[fid]]
        for fid in frames:
            cap_per[str(fid)] = captions["%04d.jpg" % fid][0]
        profiles.append(per)
        cap_profiles.append(cap_per)
    d = Path(out_dir) / video_id
    d.mkdir(parents=True, exist_ok=True)
    path = d / "inverses_actions.json"
    with open(path, "w") as f:
        json.dump(profiles, f)
    with open(d / "captions_pro.json", "w") as f:
        json.dump(cap_profiles, f)
    return path
