"""Synthetic dataset fixtures (a copy of ``youtube_vln_tpu/data/
fixtures.py``; every builder writes the same bytes as the JAX one).

Generates a miniature, fully self-consistent copy of every artifact the
reference pipeline consumes (stores, caption JSONs, templates, frozen
testsets, R2R task + beam JSONs, connectivity graphs, distance tables,
vocab), with the same schemas, so the entry points run end-to-end without
the real YouTube/Airbnb/Matterport data.
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


def build_full_fixture(data_dir, *, seed: int = 0) -> Dict[str, str]:
    """Assemble the canonical data-directory layout the entry points expect
    (dataset_init.py path conventions), plus a tiny model-config JSON."""
    data_dir = Path(data_dir)
    ytb_dir = data_dir / "YouTube-VLN" / "ytb"
    ytb = build_ytb_fixture(ytb_dir, seed=seed)
    bnb = build_bnb_fixture(data_dir / "YouTube-VLN" / "bnb", seed=seed)
    r2r = build_r2r_fixture(data_dir, seed=seed)

    # relocate the YTb template skeleton to the canonical task path
    task_skeleton = data_dir / "task" / "R2R_train_templates.json"
    task_skeleton.write_bytes(Path(ytb["skeleton_path"]).read_bytes())

    cfg_dir = data_dir / "config"
    cfg_dir.mkdir(exist_ok=True)
    tiny_cfg = dict(
        vocab_size=256, hidden_size=32, num_hidden_layers=4,
        num_attention_heads=4, intermediate_size=64,
        v_feature_size=2048, v_target_size=1601, v_hidden_size=48,
        v_num_hidden_layers=2, v_num_attention_heads=4,
        v_intermediate_size=48, bi_hidden_size=48, bi_num_attention_heads=4,
        v_biattention_id=[0, 1], t_biattention_id=[2, 3],
        max_position_embeddings=64)
    with open(cfg_dir / "tiny.json", "w") as fh:
        json.dump(tiny_cfg, fh)

    return dict(
        data_dir=str(data_dir),
        vocab_path=str(data_dir / "vocab.txt"),
        config_file=str(cfg_dir / "tiny.json"),
        ytb_store=ytb["store_path"],
        bnb_store=bnb["store_path"],
        pano_store=r2r["store_path"],
        skeleton_path=str(task_skeleton),
    )


# --------------------------------------------------------------------------- #
# R2R fixture
# --------------------------------------------------------------------------- #
def build_r2r_fixture(root, *, n_scans: int = 2, n_viewpoints: int = 9,
                      n_paths: int = 5, n_beams: int = 4, path_len: int = 4,
                      k_boxes: int = 4, seed: int = 0) -> Dict[str, str]:
    """Connectivity graphs (grid scans), distances, R2R task JSONs, beam
    JSONs, pano feature store, vocab.  ``k_boxes``/``n_beams``/``path_len``
    let perf harnesses build the FLAGSHIP eval geometry (100 boxes + the
    global row, 30 beams, 8 steps — scripts/bench_loader.py --eval)."""
    root = Path(root)
    (root / "connectivity").mkdir(parents=True, exist_ok=True)
    (root / "distances").mkdir(exist_ok=True)
    (root / "task").mkdir(exist_ok=True)
    (root / "beamsearch").mkdir(exist_ok=True)
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)

    vocab_path = root / "vocab.txt"
    write_fixture_vocab(vocab_path)

    side = int(np.ceil(np.sqrt(n_viewpoints)))
    scans = [f"scan{i}" for i in range(n_scans)]
    pano_keys = []
    for scan in scans:
        items = []
        vps = [f"{scan}_vp{j}" for j in range(n_viewpoints)]
        coords = {vp: (j % side * 2.0, j // side * 2.0, 1.5)
                  for j, vp in enumerate(vps)}
        for j, vp in enumerate(vps):
            x, y, z = coords[vp]
            pose = [0.0] * 16
            pose[3], pose[7], pose[11] = x, y, z
            unobstructed = []
            for k2, vp2 in enumerate(vps):
                x2, y2, _ = coords[vp2]
                unobstructed.append(
                    k2 != j and abs(x2 - x) + abs(y2 - y) <= 2.0)
            items.append({"image_id": vp, "pose": pose, "included": True,
                          "unobstructed": unobstructed, "height": 1.5})
        with open(root / "connectivity" / f"{scan}_connectivity.json",
                  "w") as fh:
            json.dump(items, fh)
        pano_keys += [f"{scan}-{vp}" for vp in vps]

    # distances on the graphs we just wrote (networkx's order and sums)
    from .nav_graph import load_nav_graphs, compute_distances
    graphs = load_nav_graphs(scans, root)
    for scan in scans:
        with open(root / "distances" / f"{scan}_distances.json", "w") as fh:
            json.dump(compute_distances(graphs[scan]), fh)

    store_path = root / "matterport.vlnstore"
    write_store(store_path, pano_keys, k_boxes=k_boxes, pano=True, seed=seed)

    # R2R items + beams per split
    def random_path(scan, length, start=None):
        g = graphs[scan]
        node = start if start is not None else rng.choice(sorted(g.nodes()))
        path = [node]
        while len(path) < length:
            nxt = rng.choice(sorted(g.neighbors(path[-1])))
            path.append(nxt)
        return path

    for split in ("train", "val_seen", "val_unseen"):
        items, beams = [], []
        for p in range(n_paths):
            scan = scans[p % n_scans]
            gt = random_path(scan, path_len)
            pid = 1000 * (1 + ["train", "val_seen",
                               "val_unseen"].index(split)) + p
            items.append({
                "path_id": pid, "scan": scan, "heading": rng.uniform(0, 6.28),
                "path": gt,
                "instructions": [
                    f"walk into the {rng.choice(ROOMS)} and stop ."
                    for _ in range(3)],
                "distance": float(len(gt)),
            })
            for instr_idx in range(3):
                ranked = []
                for b in range(n_beams):
                    # real beam-search candidates share the start viewpoint
                    bp = gt if b == 0 else random_path(scan, path_len,
                                                       start=gt[0])
                    ranked.append([[vp, 0.0, 0.0] for vp in bp])
                beams.append({"instr_id": f"{pid}_{instr_idx}",
                              "ranked_paths": ranked})
        with open(root / "task" / f"R2R_{split}.json", "w") as fh:
            json.dump(items, fh)
        with open(root / "beamsearch" / f"beams_{split}.json", "w") as fh:
            json.dump(beams, fh)

    return dict(data_dir=str(root), store_path=str(store_path),
                vocab_path=str(vocab_path))
