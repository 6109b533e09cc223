"""Step 3-4: region features -> feature store (a copy of
``youtube_vln_tpu/pipeline/detector.py``; it imports no torch).

The reference extracts Faster-RCNN (bottom-up-attention) region features
with an external Caffe/CUDA stack into TSV shards
(``scripts/video_process/precompute_youtube_img_features_with_butd.py``),
then converts TSV -> LMDB (``convert_to_lmdb.py``).  Here:

  * :class:`RegionFeatureExtractor` is the pluggable detector interface —
    any callable producing (boxes, features, cls_prob) per image.  The Caffe
    model was external to the reference repo as well; plug a saved
    detector in production.
  * :func:`convert_tsv_to_store` ingests the reference's exact TSV schema
    (video_id/frame_id/image_w/image_h/features/boxes/cls_prob base64
    columns, precompute_...py:43-56) into a VLN store, with the same
    key convention ``{video_id}/{frame_id:04d}``.
  * :func:`extract_to_store` runs an extractor over a raw_frames tree.
"""
from __future__ import annotations

import base64
import csv
import sys
from pathlib import Path
from typing import Callable, Iterable, Optional, Protocol, Tuple

import numpy as np

from ..data.store import StoreRecord, StoreWriter

TSV_FIELDNAMES = [
    "video_id", "frame_id", "image_w", "image_h", "vfov", "features",
    "boxes", "cls_prob", "attr_prob", "featureViewIndex", "featureHeading",
    "featureElevation",
]


class RegionFeatureExtractor(Protocol):
    def __call__(self, image: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """image [H,W,3] uint8 -> (boxes [K,4] px, features [K,2048],
        cls_prob [K,1601])."""


class RandomProposalExtractor:
    """Deterministic stand-in detector for pipeline smoke tests: random but
    seeded box proposals with pooled-pixel features hashed into 2048-d."""

    def __init__(self, num_boxes: int = 36, seed: int = 0):
        self.num_boxes = num_boxes
        self.seed = seed

    def __call__(self, image: np.ndarray):
        h, w = image.shape[:2]
        rng = np.random.default_rng(
            self.seed + int(image.astype(np.uint64).sum()) % (2 ** 31))
        x1 = rng.uniform(0, w * 0.6, self.num_boxes)
        y1 = rng.uniform(0, h * 0.6, self.num_boxes)
        boxes = np.stack([x1, y1,
                          x1 + rng.uniform(8, w * 0.4, self.num_boxes),
                          y1 + rng.uniform(8, h * 0.4, self.num_boxes)],
                         axis=1).astype(np.float32)
        feats = rng.normal(size=(self.num_boxes, 2048)).astype(np.float32)
        probs = rng.random((self.num_boxes, 1601)).astype(np.float32)
        probs /= probs.sum(-1, keepdims=True)
        return boxes, feats, probs


def frame_key(video_id: str, frame_id: int) -> str:
    return f"{video_id}/%04d" % frame_id


def extract_to_store(frames_dir, store_path,
                     extractor: RegionFeatureExtractor,
                     image_loader: Optional[Callable] = None) -> int:
    """Run the detector over raw_frames/{vid}/####.jpg into a store."""
    if image_loader is None:
        def image_loader(path):
            try:
                from PIL import Image
                return np.asarray(Image.open(path).convert("RGB"))
            except ImportError as e:
                raise RuntimeError("install pillow or pass image_loader") \
                    from e
    n = 0
    with StoreWriter(store_path) as writer:
        for vid_dir in sorted(Path(frames_dir).iterdir()):
            if not vid_dir.is_dir():
                continue
            for frame in sorted(vid_dir.glob("*.jpg")):
                image = image_loader(frame)
                boxes, feats, probs = extractor(image)
                writer.add(frame_key(vid_dir.name, int(frame.stem)),
                           StoreRecord(len(boxes), image.shape[1],
                                       image.shape[0], feats, boxes, probs))
                n += 1
    return n


def _b64(field: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(field), dtype=np.float32)


def convert_tsv_to_store(tsv_paths: Iterable, store_path,
                         pano: bool = False) -> int:
    """Reference TSV shards -> one VLN store (replaces convert_to_lmdb.py).

    Deduplicates repeated keys keeping the first occurrence (the reference's
    redundant-features cache served the same purpose)."""
    csv.field_size_limit(sys.maxsize)
    seen = set()
    n = 0
    with StoreWriter(store_path) as writer:
        for tsv in tsv_paths:
            with open(tsv, newline="") as fid:
                reader = csv.DictReader(fid, delimiter="\t",
                                        fieldnames=TSV_FIELDNAMES)
                for item in reader:
                    key = frame_key(item["video_id"], int(item["frame_id"]))
                    if key in seen:
                        continue
                    seen.add(key)
                    feats = _b64(item["features"]).reshape(-1, 2048)
                    boxes = _b64(item["boxes"]).reshape(-1, 4)
                    probs = _b64(item["cls_prob"]).reshape(-1, 1601)
                    rec = StoreRecord(len(boxes), int(item["image_w"]),
                                      int(item["image_h"]), feats, boxes,
                                      probs)
                    if pano:
                        rec.view_heading = np.zeros(36, np.float32)
                        rec.view_elevation = np.zeros(36, np.float32)
                        rec.feat_heading = _b64(item["featureHeading"])
                        rec.feat_elevation = _b64(item["featureElevation"])
                        rec.feat_view_index = _b64(item["featureViewIndex"])
                    writer.add(key, rec)
                    n += 1
    return n
