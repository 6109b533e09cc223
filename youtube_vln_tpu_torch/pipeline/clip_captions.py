"""Step 6: zero-shot "room with object" captions from frame embeddings (a copy
of ``youtube_vln_tpu/pipeline/clip_captions.py``; it imports no torch).

Reference ``scripts/video_process/generate_CLIP_captions.py``: CLIP ViT-B/32
frame embeddings scored against 12 Matterport room types and 39 object
categories; each frame gets the caption "{room} with {object}" from the
top-scoring pair, written to ``CLIP_captioned_images/{vid}/captions_SE.json``
mapping "%04d.jpg" -> [caption].

Embedding models are pluggable (any image/text encoder pair); the scoring
math (cosine similarity over normalized embeddings, softmax-free argmax) is
implemented here in numpy.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np

# Matterport3D category lists (reference generate_CLIP_captions.py:23-29)
AREAS = ["office", "lounge", "family room", "entry way", "dining room",
         "living room", "stairs", "kitchen", "porch", "bathroom", "bedroom",
         "hallway"]
OBJECTS = ["wall", "floor", "chair", "door", "table", "picture", "cabinet",
           "cushion", "window", "sofa", "bed", "curtain", "chest of drawers",
           "plant", "sink", "stairs", "ceiling", "toilet", "stool", "towel",
           "mirror", "tv monitor", "shower", "column", "bathtub", "counter",
           "fireplace", "lighting", "beam", "railing", "shelving", "blinds",
           "gym equipment", "seating", "board panel", "furniture",
           "appliances", "clothes", "person"]

PROMPT = "a photo of a {}"


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-8)


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _shannon_entropy(p: np.ndarray) -> np.ndarray:
    """Reference ShannonEntropy (generate_CLIP_captions.py:64-70): the 1e-7
    shift is applied to BOTH factors of p*log2(p)."""
    q = p + 1e-7
    return -(q * np.log2(q)).sum(axis=-1)


def zero_shot_captions(frame_embeddings: np.ndarray,
                       area_text_embeddings: np.ndarray,
                       object_text_embeddings: np.ndarray,
                       areas: Sequence[str] = AREAS,
                       objects: Sequence[str] = OBJECTS) -> List[str]:
    """frame_embeddings [N, D] -> ["{room} with {object}"] per frame."""
    f = _normalize(frame_embeddings.astype(np.float32))
    a = _normalize(area_text_embeddings.astype(np.float32))
    o = _normalize(object_text_embeddings.astype(np.float32))
    area_idx = np.argmax(f @ a.T, axis=1)
    obj_idx = np.argmax(f @ o.T, axis=1)
    return [f"{areas[i]} with {objects[j]}"
            for i, j in zip(area_idx, obj_idx)]


def caption_video_frames(frame_ids: Sequence[int],
                         frame_embeddings: np.ndarray,
                         area_text_embeddings: np.ndarray,
                         object_text_embeddings: np.ndarray
                         ) -> Dict[str, List]:
    """captions_SE.json payload, reference layout
    (generate_CLIP_captions.py:98-101): "%04d.jpg" ->
    [caption, {"ShannonEntropy": H(softmax(100*area_sim))},
    {"similarity": top-1 area softmax prob}].  Every downstream consumer
    reads only element [0] (merge_photos.py:90, build_dataset.py:120,174,
    genearate_Profiles.py:46), but the file format carries all three."""
    f = _normalize(frame_embeddings.astype(np.float32))
    a = _normalize(area_text_embeddings.astype(np.float32))
    area_probs = _softmax(100.0 * (f @ a.T))
    ents = _shannon_entropy(area_probs)
    caps = zero_shot_captions(frame_embeddings, area_text_embeddings,
                              object_text_embeddings)
    return {"%04d.jpg" % fid:
            [c, {"ShannonEntropy": float(h)}, {"similarity": float(s)}]
            for fid, c, h, s in zip(frame_ids, caps, ents,
                                    area_probs.max(axis=-1))}


def write_captions(out_dir, video_id: str, payload: Dict) -> Path:
    d = Path(out_dir) / video_id
    d.mkdir(parents=True, exist_ok=True)
    path = d / "captions_SE.json"
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def run(frames_embeddings_by_video: Dict[str, Dict[int, np.ndarray]],
        text_encoder: Callable[[List[str]], np.ndarray], out_dir) -> int:
    """Caption every video given its per-frame embeddings and a text encoder
    (called once per category list with the reference's prompt)."""
    area_emb = text_encoder([PROMPT.format(c) for c in AREAS])
    obj_emb = text_encoder([PROMPT.format(c) for c in OBJECTS])
    n = 0
    for vid, frames in frames_embeddings_by_video.items():
        frame_ids = sorted(frames)
        emb = np.stack([frames[i] for i in frame_ids])
        write_captions(out_dir, vid,
                       caption_video_frames(frame_ids, emb, area_emb,
                                            obj_emb))
        n += len(frame_ids)
    return n
