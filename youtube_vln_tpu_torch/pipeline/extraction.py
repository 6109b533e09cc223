"""Step 3 driver: multi-process sharded region-feature extraction (a copy of
``youtube_vln_tpu/pipeline/extraction.py``).  It imports no torch: its
``multiprocessing.Pool`` forks, and a fork after CUDA is up is unsafe.

Re-implements the orchestration of
``scripts/video_process/precompute_youtube_img_features_with_butd.py``
(the 567-LoC Caffe driver) over the model-agnostic
:class:`detector.RegionFeatureExtractor` protocol:

  * 11-shard TSV production (``ResNet-101-faster-rcnn-genome-{i}.tsv``,
    shard i takes ``photos[i::num_splits]`` — reference ``:459-463``)
  * resume-from-partial via the all/finished/pending photo-path caches in
    ``Extra/`` (reference ``:205-259``)
  * a worker pool, one extractor instance per process (reference
    ``:544-567``; the Caffe net per GPU becomes a factory per process)
  * box orientation (heading/elevation from box centers through the
    pinhole model, reference ``:369-384``) and the cosine+orientation
    redundancy filter (reference ``filter``, ``:411-452``)

The TSV schema is bit-compatible with the reference
(detector.convert_tsv_to_store ingests it).
"""
from __future__ import annotations

import base64
import csv
import math
import sys
from multiprocessing import Pool
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .detector import RegionFeatureExtractor, TSV_FIELDNAMES

# reference constants (precompute_youtube_img_features_with_butd.py:57-88)
MIN_LOCAL_BOXES = 5
MAX_LOCAL_BOXES = 20
MAX_TOTAL_BOXES = 100
CONF_THRESH = 0.1
WIDTH = 600
HEIGHT = 600
VFOV = 80
FOC = (HEIGHT / 2) / math.tan(math.radians(VFOV / 2))

SHARD_TEMPLATE = "ResNet-101-faster-rcnn-genome-{}.tsv"


# --------------------------------------------------------------------------- #
# photo-path caches (resume-from-partial)
# --------------------------------------------------------------------------- #
def load_all_photo_paths(frames_dir, cache_dir) -> List[str]:
    """All */####.jpg under the frames tree, cached to
    Extra/all_photo_path.txt (reference :205-222)."""
    cache = Path(cache_dir) / "all_photo_path.txt"
    if not cache.is_file():
        cache.parent.mkdir(parents=True, exist_ok=True)
        with open(cache, "w") as fid:
            for image in sorted(Path(frames_dir).rglob("*.jpg")):
                fid.write(f"{image}\n")
    with open(cache, errors="replace") as fid:
        return [p.strip() for p in fid if p.strip()]


def load_finished_photo_paths(tsv_files: Sequence, frames_dir,
                              cache_dir) -> List[str]:
    """Photos already present in existing TSV shards (reference :224-239)."""
    cache = Path(cache_dir) / "finished_photo_path.txt"
    if not cache.is_file():
        cache.parent.mkdir(parents=True, exist_ok=True)
        csv.field_size_limit(sys.maxsize)
        with open(cache, "w") as fid:
            for f in tsv_files:
                with open(f, newline="") as cid:
                    reader = csv.DictReader(cid, fieldnames=TSV_FIELDNAMES,
                                            delimiter="\t")
                    for i in reader:
                        fid.write(f'{frames_dir}/{i["video_id"]}/'
                                  f'{i["frame_id"]}.jpg\n')
    with open(cache, errors="replace") as fid:
        return [p.strip() for p in fid if p.strip()]


def load_pending_photo_paths(tsv_files: Sequence, frames_dir,
                             cache_dir) -> List[str]:
    """all - finished, cached (reference :241-259).  Sorted for a
    deterministic shard split (the reference's set order was arbitrary)."""
    cache = Path(cache_dir) / "doing_photo_path.txt"
    if not cache.is_file():
        all_photos = set(load_all_photo_paths(frames_dir, cache_dir))
        finished = set(load_finished_photo_paths(tsv_files, frames_dir,
                                                 cache_dir))
        with open(cache, "w") as fid:
            for image in sorted(all_photos - finished):
                fid.write(f"{image}\n")
    with open(cache, errors="replace") as fid:
        return [p.strip() for p in fid if p.strip()]


# --------------------------------------------------------------------------- #
# record assembly
# --------------------------------------------------------------------------- #
def compute_box_orientation(boxes: np.ndarray, image_w: int, image_h: int,
                            foc: float = FOC):
    """Heading/elevation of each box center through the pinhole model
    (reference :369-384), with the reference's wrap-to-(-pi, pi]."""
    center_x = 0.5 * (boxes[:, 0] + boxes[:, 2])
    center_y = 0.5 * (boxes[:, 1] + boxes[:, 3])
    heading = np.arctan2(center_x - image_w / 2, foc)
    heading = np.mod(heading, math.pi * 2)
    heading = np.expand_dims(np.mod(heading + math.pi * 2, math.pi * 2), 1)
    heading = np.where(heading > math.pi, heading - math.pi * 2, heading)
    elevation = np.expand_dims(
        np.arctan2(-center_y + image_h / 2, foc), 1)
    return heading.astype(np.float32), elevation.astype(np.float32)


def redundancy_filter(record: Dict, max_boxes: int = MAX_TOTAL_BOXES) -> None:
    """Drop the most redundant features — nearest pairs in cosine distance
    + heading + elevation lose their lower-scoring member until max_boxes
    remain.  Faithful port of reference ``filter`` (:411-452)."""
    feats = record["features"]
    if feats.shape[0] == 0 or feats.shape[0] <= max_boxes:
        return

    f = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True),
                           1e-12)
    feat_dist = (1.0 - f @ f.T).astype(np.float32)
    heading_diff = np.abs(record["featureHeading"]
                          - record["featureHeading"].T)
    heading_diff = np.minimum(heading_diff, 2 * math.pi - heading_diff)
    elevation_diff = np.abs(record["featureElevation"]
                            - record["featureElevation"].T)
    feat_dist = feat_dist + heading_diff + elevation_diff
    feat_dist += 10 * np.identity(feat_dist.shape[0], dtype=np.float32)
    feat_dist[np.triu_indices(feat_dist.shape[0])] = 10.0

    ind = np.unravel_index(np.argsort(feat_dist, axis=None), feat_dist.shape)
    keep = set(range(feat_dist.shape[0]))
    ix = 0
    while len(keep) > max_boxes:
        i, j = ind[0][ix], ind[1][ix]
        if i in keep and j in keep:
            if record["cls_prob"][i, 1:].max() > record["cls_prob"][j, 1:].max():
                keep.remove(j)
            else:
                keep.remove(i)
        ix += 1
    sel = sorted(keep)
    for k in ("boxes", "cls_prob", "attr_prob", "features",
              "featureViewIndex", "featureHeading", "featureElevation"):
        if k in record and isinstance(record[k], np.ndarray):
            record[k] = record[k][sel]


def make_record(video_id: str, frame_id: str, image: np.ndarray,
                boxes: np.ndarray, features: np.ndarray,
                cls_prob: np.ndarray,
                max_boxes: int = MAX_TOTAL_BOXES) -> Dict:
    """Assemble one TSV row dict from a detector's raw output."""
    h, w = image.shape[:2]
    # The module-level FOC is only valid for HEIGHT=600 images (the
    # reference resizes every frame to 600x600 via transform_img before
    # detection, so its WIDTH/HEIGHT/FOC are mutually consistent).  Our
    # detector is pluggable and may run on the raw frame, so derive the
    # focal length from THIS image's height — (h/2)/tan(VFOV/2) — or a
    # 720p frame gets every featureHeading/featureElevation systematically
    # compressed by 600/720 (r5 review finding; skews both the redundancy
    # filter distances and the orientation features the model consumes).
    foc = (h / 2) / math.tan(math.radians(VFOV / 2))
    heading, elevation = compute_box_orientation(boxes, w, h, foc=foc)
    record = {
        "video_id": video_id,
        "frame_id": frame_id,
        "image_w": w,
        "image_h": h,
        "vfov": VFOV,
        "boxes": boxes.astype(np.float32),
        "features": features.astype(np.float32),
        "cls_prob": cls_prob.astype(np.float32),
        "attr_prob": np.zeros((len(boxes), 0), np.float32),
        "featureViewIndex": np.zeros((len(boxes), 1), np.float32),
        "featureHeading": heading,
        "featureElevation": elevation,
    }
    redundancy_filter(record, max_boxes)
    return record


def _default_image_loader(path):
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError as e:
        raise RuntimeError("install pillow or pass image_loader") from e


# --------------------------------------------------------------------------- #
# sharded TSV production
# --------------------------------------------------------------------------- #
def build_shard(photos: Sequence[str], shard_id: int, num_splits: int,
                out_dir, extractor: RegionFeatureExtractor,
                image_loader: Optional[Callable] = None) -> int:
    """Append shard ``shard_id``'s interleaved slice of ``photos`` to its
    TSV (reference build_tsv, :459-515).  Returns rows written."""
    image_loader = image_loader or _default_image_loader
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shard_photos = list(photos)[shard_id::num_splits]
    n = 0
    with open(out_dir / SHARD_TEMPLATE.format(shard_id), "a",
              newline="") as tsvfile:
        writer = csv.DictWriter(tsvfile, delimiter="\t",
                                fieldnames=TSV_FIELDNAMES)
        for photo in shard_photos:
            p = Path(photo)
            try:
                image = image_loader(p)
            except Exception:
                continue  # unreadable frames are skipped, like the
                # reference's Problem/ bucket (:288-307)
            boxes, feats, probs = extractor(image)
            record = make_record(p.parent.name, p.stem, image, boxes, feats,
                                 probs)
            row = dict(record)
            for k, v in row.items():
                if isinstance(v, np.ndarray):
                    row[k] = str(base64.b64encode(
                        np.ascontiguousarray(v)), "utf-8")
            writer.writerow(row)
            n += 1
    return n


def _pool_worker(shard_id: int, photos: Sequence[str], num_splits: int,
                 out_dir: str, factory: Callable,
                 image_loader: Optional[Callable] = None) -> int:
    # one extractor per process, like one Caffe net per GPU (:130-143)
    extractor = factory(shard_id)
    return build_shard(photos, shard_id, num_splits, out_dir, extractor,
                       image_loader)


def run_extraction(frames_dir, out_dir,
                   extractor_factory: Callable[[int],
                                               RegionFeatureExtractor],
                   *, num_splits: int = 11, num_workers: int = 0,
                   start: int = 0,
                   image_loader: Optional[Callable] = None) -> int:
    """Main driver (reference __main__, :530-567): validate existing
    shards, compute the pending photo list, then extract.

    Invocation semantics follow the reference's multi-GPU orchestration:
    a pool run covers ONE shard group, shards start..start+num_workers-1
    (the reference launches one such invocation per GPU group with a
    different --start; 11 shards / 3 workers = invocations at start
    0, 3, 6, then a final one with --start 9 --num_workers 2).  The
    sequential path (num_workers <= 1) is a deliberate superset of the
    reference — it builds shards start..num_splits-1 in one go instead of
    only shard `start`, so a single-process run covers everything.

    Returns total rows written.  Re-running after an interruption resumes:
    finished photos are skipped via the TSV-derived cache.  ``image_loader``
    reads a frame (PIL by default; a module-level function for a pool run),
    a parameter the JAX package's driver does not have.
    """
    if num_workers > 1 and start + num_workers > num_splits:
        # the reference silently slices photos[k::num_splits] with
        # k >= num_splits here, producing rows that duplicate other
        # shards' slices — fail loudly instead
        raise ValueError(
            f"shard group start={start}..{start + num_workers - 1} exceeds "
            f"num_splits={num_splits}; lower --num_workers or --start")
    out_dir = Path(out_dir)
    if out_dir.exists():
        tsv_files = sorted(out_dir.glob(SHARD_TEMPLATE.format("*")))
        if tsv_files and len(tsv_files) not in (num_splits, start):
            raise ValueError(
                f"the number of tsv files {len(tsv_files)} is not equal to "
                f"the number of splits {num_splits}!")
    else:
        out_dir.mkdir(parents=True)
        tsv_files = []

    cache_dir = out_dir / "Extra"
    photos = load_pending_photo_paths(tsv_files, frames_dir, cache_dir)
    if not photos:
        return 0

    if num_workers <= 1:
        total = 0
        for shard_id in range(start, num_splits):
            total += build_shard(photos, shard_id, num_splits, out_dir,
                                 extractor_factory(shard_id), image_loader)
        return total

    with Pool(num_workers) as pool:
        counts = pool.starmap(
            _pool_worker,
            [(shard_id, photos, num_splits, str(out_dir), extractor_factory,
              image_loader)
             for shard_id in range(start, start + num_workers)])
    return sum(counts)
