"""Synthetic pretraining fixtures (the YTb and BnB builders of
``youtube_vln_tpu/data/fixtures.py``, copied; they write the same bytes).

Generates a miniature, fully self-consistent copy of the artifacts the
reference pretraining pipeline consumes (stores, caption JSONs, templates,
frozen testsets, vocab), with the same schemas, so the pretraining path
runs end-to-end without the real YouTube/Airbnb data.  The R2R builders
come with the beam-eval slice.
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .store import StoreRecord, StoreWriter
from .tokenizer import WordPieceTokenizer, write_vocab
from . import sampling as S

ROOMS = ["bedroom", "kitchen", "bathroom", "hallway", "office", "porch"]
OBJECTS = ["bed", "table", "sink", "mirror", "desk", "chair"]
ACTIONS = ["forward", "left", "right"]

TEMPLATE_WORDS = ["walk", "into", "the", "and", "turn", "go", "past", "stop",
                  "then", "at", "wait", "there", "straight", "around",
                  "toward", "room", "with"]


def fixture_vocab() -> List[str]:
    """Small vocab with BERT special-token ids at the canonical positions
    ([PAD]=0, [CLS]=101, [SEP]=102, [MASK]=103 — matching the ids the
    masking/token framing code assumes)."""
    vocab = ["[PAD]"]
    filler = [f"[unused{i}]" for i in range(100)]
    vocab += filler  # ids 1..100
    vocab += ["[CLS]", "[SEP]", "[MASK]", "[UNK]"]
    words = sorted(set(ROOMS + OBJECTS + ACTIONS + TEMPLATE_WORDS
                       + [".", ","]))
    vocab += words
    return vocab


def write_fixture_vocab(path) -> WordPieceTokenizer:
    vocab = fixture_vocab()
    write_vocab(vocab, path)
    return WordPieceTokenizer.from_vocab_file(path)


def _random_record(rng: np.random.Generator, k: int, pano: bool
                   ) -> StoreRecord:
    w, h = 640, 480
    x1 = rng.uniform(0, w / 2, k)
    y1 = rng.uniform(0, h / 2, k)
    boxes = np.stack([x1, y1, x1 + rng.uniform(10, w / 2, k),
                      y1 + rng.uniform(10, h / 2, k)], axis=1)
    probs = rng.random((k, 1601)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    rec = StoreRecord(
        num_boxes=k, image_w=w, image_h=h,
        features=rng.normal(size=(k, 2048)).astype(np.float32),
        boxes=boxes.astype(np.float32),
        cls_prob=probs)
    if pano:
        rec.view_heading = rng.uniform(-np.pi, np.pi, 36).astype(np.float32)
        rec.view_elevation = rng.uniform(-0.5, 0.5, 36).astype(np.float32)
        rec.feat_heading = rng.uniform(-np.pi, np.pi, k).astype(np.float32)
        rec.feat_elevation = rng.uniform(-0.5, 0.5, k).astype(np.float32)
        rec.feat_view_index = rng.integers(0, 36, k).astype(np.float32)
    return rec


def write_store(path, keys: Sequence[str], *, k_boxes: int = 4,
                pano: bool = False, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    with StoreWriter(path) as w:
        for key in keys:
            w.add(key, _random_record(rng, k_boxes, pano))


# --------------------------------------------------------------------------- #
# YouTube pretraining fixture
# --------------------------------------------------------------------------- #
def build_ytb_fixture(root, *, n_videos: int = 6, frames_per_video: int = 12,
                      seed: int = 0, k_boxes: int = 4,
                      args_overrides: Optional[Dict] = None) -> Dict[str, str]:
    """Creates captions JSON + templates + feature store + frozen testset.
    Returns the path map (caption_path, skeleton_path, store paths,
    testset paths, vocab).  ``k_boxes``/``args_overrides`` let perf
    harnesses build the FLAGSHIP geometry (101 boxes, path 8) instead of
    the tiny test default (scripts/bench_loader.py)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = random.Random(seed)

    vocab_path = root / "vocab.txt"
    tok = write_fixture_vocab(vocab_path)

    # captions: every other frame captioned "room with object"
    captions = []
    keys = []
    for v in range(n_videos):
        vid = f"video{v:03d}"
        for f in range(frames_per_video):
            captioned = f % 2 == 0
            captions.append({
                "video_id": vid,
                "frame_id": f,
                "caption": (f"{rng.choice(ROOMS)} with {rng.choice(OBJECTS)}"
                            if captioned else ""),
                "action": rng.choice(ACTIONS),
                "merging": [f],
            })
            keys.append(S.ytb_key(vid, f))
    caption_path = root / "merge+ytb_train.json"
    with open(caption_path, "w") as fh:
        json.dump(captions, fh)
    test_caption_path = root / "merge+ytb_test.json"
    with open(test_caption_path, "w") as fh:
        json.dump(captions, fh)

    # templates with n [MASK] x (n-1) [OMASK] for n = 1..7 (two per
    # signature so template choice exercises randomness)
    templates = []
    for n in range(1, 8):
        parts = []
        for i in range(n):
            parts.append("walk into the [MASK]")
            if i < n - 1:
                parts.append("and turn [OMASK]")
        templates.append({"instructions": [" ".join(parts) + " ."]})
        parts = []
        for i in range(n):
            parts.append("go past the [MASK]")
            if i < n - 1:
                parts.append("then turn [OMASK]")
        templates.append({"instructions": [" ".join(parts) + " and stop ."]})
    skeleton_path = root / "R2R_train_templates.json"
    with open(skeleton_path, "w") as fh:
        json.dump(templates, fh)

    store_path = root / "ytb_features.vlnstore"
    write_store(store_path, keys, k_boxes=k_boxes, seed=seed)

    # frozen testset, built with the live samplers (the reference freezes
    # eval negatives the same way, scripts/build_dataset/build_testset.py)
    from .datasets import YTbDataset  # local import to avoid cycle
    args = _default_args(skeleton_path=str(skeleton_path),
                         **(args_overrides or {}))
    from .features_reader import YTbFeaturesReader
    reader = YTbFeaturesReader(store_path)
    ds = YTbDataset(args=args, caption_path=caption_path, tokenizer=tok,
                    features_reader=reader, masked_vision=False,
                    masked_language=False, training=True, seed=seed)
    testset = {}
    for vid in ds.listing_ids:
        pos, nc_, ni_, nr_, ol = ds.pick_photo_ids(vid)
        testset[vid] = [pos, nc_, ni_, nr_, ol]
    testset_path = root / "merge+testset.json"
    with open(testset_path, "w") as fh:
        json.dump(testset, fh)
    traj_testset_path = root / "merge+traj_testset.json"
    with open(traj_testset_path, "w") as fh:
        json.dump(testset, fh)
    reader.close()

    return dict(caption_path=str(caption_path),
                test_caption_path=str(test_caption_path),
                skeleton_path=str(skeleton_path),
                store_path=str(store_path),
                testset_path=str(testset_path),
                traj_testset_path=str(traj_testset_path),
                vocab_path=str(vocab_path))


def _default_args(**kw):
    from ..config import RunConfig
    base = dict(
        pretrain=True, pre_dataset="ytb", ranking=True,
        max_instruction_length=32, max_path_length=4, max_num_boxes=5,
        min_path_length=3, min_captioned=2, max_captioned=4,
        num_negatives=2, shuffler="different", negative_style="normal")
    base.update(kw)
    return RunConfig(**base)


# --------------------------------------------------------------------------- #
# BnB (Airbnb) pretraining fixture
# --------------------------------------------------------------------------- #
def build_bnb_fixture(root, *, n_listings: int = 6, photos_per_listing: int = 8,
                      seed: int = 0) -> Dict[str, str]:
    """Caption JSON (listing/photo records with per-photo captions) +
    feature store with the BnB key convention '{listing}-{photo}'."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = random.Random(seed)

    vocab_path = root / "vocab.txt"
    write_fixture_vocab(vocab_path)

    captions = []
    keys = []
    photo_id = 0
    for l in range(n_listings):
        listing = 1000 + l
        for p in range(photos_per_listing):
            captioned = p % 2 == 0
            captions.append({
                "listing_id": listing,
                "photo_id": photo_id,
                "instructions": [
                    f"{rng.choice(ROOMS)} with {rng.choice(OBJECTS)}"
                    if captioned else ""],
            })
            keys.append(f"{listing}-{photo_id}")
            photo_id += 1
    caption_path = root / "bnb_train.json"
    with open(caption_path, "w") as fh:
        json.dump(captions, fh)

    store_path = root / "bnb_features.vlnstore"
    write_store(store_path, keys, seed=seed)

    test_caption_path = root / "bnb_test.json"
    with open(test_caption_path, "w") as fh:
        json.dump(captions, fh)

    # frozen ranking testset through the live samplers
    from .datasets import BnBDataset
    from .features_reader import BnBFeaturesReader
    from .tokenizer import WordPieceTokenizer
    tok = WordPieceTokenizer.from_vocab_file(vocab_path)
    args = _default_args(pre_dataset="bnb", skeleton_path="")
    reader = BnBFeaturesReader(store_path)
    ds = BnBDataset(args=args, caption_path=caption_path, tokenizer=tok,
                    features_reader=reader, masked_vision=False,
                    masked_language=False, training=True, seed=seed)
    testset = {}
    for lid in ds.listing_ids:
        pos, nc_, ni_, nr_, ol = ds.pick_photo_ids(lid)
        testset[lid] = [pos, nc_, ni_, nr_, ol]
    testset_path = root / "testset.json"
    with open(testset_path, "w") as fh:
        json.dump(testset, fh)
    reader.close()
    return dict(caption_path=str(caption_path), store_path=str(store_path),
                test_caption_path=str(test_caption_path),
                testset_path=str(testset_path), vocab_path=str(vocab_path))
