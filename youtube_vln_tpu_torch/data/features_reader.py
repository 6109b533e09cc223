"""Region-feature readers over the VLN store.

Semantics are matched to the reference readers
(``utils/dataset/features_reader.py``):

  * box normalization to 5-d (x1,y1,x2,y2 in [0,1] + relative area)
    (reference :86-104)
  * 11-d location vectors; non-pano readers fill cols 5..10 with ones
    (reference :107-121 — ``np.ones`` initialization leaves them at 1)
  * a synthesized "global" region 0: mean-pooled feature, location
    [0,0,1,1,1,...], uniform 1/1601 class prob (reference :170-178,316-340)
  * pano reader: query is (key, heading, next_heading); orientation cols are
    sin/cos of feature heading relative to (next_)heading and elevation
    (reference :257-341)
  * key conventions: BnB ``{listing}-{photo}``, YTb ``{video}/{frame:04d}``,
    Pano ``{scan}-{viewpoint}`` (reference :182-189,289)

Multiple store shards are merged into one key space, mirroring the
reference's multi-LMDB handling (reference :17-42).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Sequence, Set, Tuple, Union

import numpy as np

from .store import Store, StoreRecord, PROB_DIM

PathLike = Union[str, Path]

logger = logging.getLogger(__name__)


def _normalize_boxes(rec: StoreRecord) -> np.ndarray:
    """[K,4] pixel boxes -> [K,5] normalized + area."""
    b = rec.boxes
    w = float(rec.image_w)
    h = float(rec.image_h)
    out = np.zeros((len(b), 5), dtype=np.float32)
    out[:, 0] = b[:, 0] / w
    out[:, 1] = b[:, 1] / h
    out[:, 2] = b[:, 2] / w
    out[:, 3] = b[:, 3] / h
    out[:, 4] = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) / (w * h)
    return out


class FeaturesReader:
    """Base: opens shards, merges key index (reference :16-66)."""

    def __init__(self, path: Union[PathLike, Sequence[PathLike]]):
        if isinstance(path, (str, Path)):
            path = [path]
        self._stores = []
        try:
            # open one by one — a corrupt later shard must not leak the
            # mmaps/fds/native handles of the shards already opened
            for p in path:
                self._stores.append(Store(p))
        except Exception:
            for s in self._stores:
                s.close()
            raise
        self._by_key: Dict[str, int] = {}
        for i, s in enumerate(self._stores):
            for k in s.keys:
                self._by_key[k] = i
        self._warned_multi_shard = False

    @property
    def keys(self):
        return self._by_key.keys()

    def __len__(self):
        return len(self._by_key)

    def __contains__(self, key: str):
        return key in self._by_key

    def _record(self, key: str) -> StoreRecord:
        idx = self._by_key.get(key)
        if idx is None:
            raise KeyError(f"invalid key: {key}")
        return self._stores[idx].get(key)

    def _single_shard(self, keys, *, skip_falsy=False, default=None):
        """Index of the one store shard holding every key, for the native
        packers (one packed path = one C call against one mmap).  Accepts
        flat key sequences or nested tuples-of-keys; ``skip_falsy`` treats
        empty keys as padding steps (pack_pano_steps).  Returns ``default``
        when no real keys were seen, and None — after a one-time warning —
        when the keys span shards (callers decline to the Python path).
        Raises KeyError on unknown keys, like ``_record``."""
        first = None
        for entry in keys:
            sub = entry if isinstance(entry, (tuple, list)) else (entry,)
            for k in sub:
                if skip_falsy and not k:
                    continue
                idx = self._by_key.get(k)
                if idx is None:
                    raise KeyError(f"invalid key: {k}")
                if first is None:
                    first = idx
                elif idx != first:
                    self._warn_multi_shard()
                    return None
        return default if first is None else first

    def _warn_multi_shard(self):
        """One-time loud note when a path spans store shards: the native C
        packer declines (one packed path = one C call against one mmap)
        and every such item pays the ~3x slower Python assembly.  Merge
        the shards offline with scripts/merge_stores.py."""
        if not self._warned_multi_shard:
            self._warned_multi_shard = True
            from .store import get_native
            if get_native() is None:
                # merging shards would NOT restore the fast path here — the
                # shared library itself is missing; say so instead of
                # sending the operator on a pointless merge
                logger.warning(
                    "native store library (libvlnstore.so) is not built: "
                    "item assembly uses the ~3x slower Python path — run "
                    "`make -C native` to enable the C packers")
            else:
                logger.warning(
                    "a feature path spans %d store shards: the native path "
                    "packer is disabled for such items (Python fallback, "
                    "~3x slower item assembly) — merge the shards once "
                    "with scripts/merge_stores.py to restore the fast "
                    "path", len(self._stores))

    def close(self):
        for s in self._stores:
            s.close()


class RegionFeaturesReader(FeaturesReader):
    """YTb/BnB-style reader: query a tuple of keys (one per merged photo),
    concatenate regions, prepend the global region
    (reference BaseFeaturesReader.__getitem__, :153-179)."""

    def __getitem__(self, keys: Tuple[str, ...]):
        feats, locs, probs = [], [], []
        for key in keys:
            rec = self._record(key)
            boxes5 = _normalize_boxes(rec)
            loc = np.ones((len(boxes5), 11), dtype=np.float32)
            loc[:, :5] = boxes5
            feats.append(rec.features)
            locs.append(loc)
            probs.append(rec.cls_prob)
        features = np.concatenate(feats, axis=0)
        locations = np.concatenate(locs, axis=0)
        prob = np.concatenate(probs, axis=0)
        if features.size == 0:
            raise RuntimeError("Features could not be correctly read")

        g_feature = features.mean(axis=0, keepdims=True)
        g_location = np.array([[0, 0, 1, 1, 1, 0, 1, 0, 1, 0, 1]],
                              dtype=np.float32)
        g_prob = np.full((1, PROB_DIM), 1.0 / PROB_DIM, dtype=np.float32)
        return (np.concatenate([g_feature, features], axis=0),
                np.concatenate([g_location, locations], axis=0),
                np.concatenate([g_prob, prob], axis=0))


    def pack_path(self, step_keys: Sequence[Tuple[str, ...]],
                  max_steps: int, max_boxes: int):
        """Native fast path for a whole candidate path (one C call instead
        of per-step reads + numpy pad/concat).  Only when every key lives
        in one store shard and the C library is built; None -> caller uses
        the Python path."""
        first = self._single_shard(step_keys)
        if first is None:
            return None  # spans shards (or empty): python fallback
        return self._stores[first].pack_path(step_keys, max_steps, max_boxes)

    def pack_path_f16(self, step_keys, max_steps: int, max_boxes: int):
        """Dedup-transport fast path: f16 features (the H2D dtype,
        converted in C), no probs materialization (store.py:
        pack_path_f16); None -> python fallback."""
        first = self._single_shard(step_keys)
        if first is None:
            return None
        return self._stores[first].pack_path_f16(step_keys, max_steps,
                                                 max_boxes)

    def gather_probs(self, step_keys, region_ids, max_boxes: int):
        """Target-row gather matching pack_path's row layout; None ->
        caller must use a materialized probs array."""
        first = self._single_shard(step_keys)
        if first is None:
            return None
        return self._stores[first].gather_probs(step_keys, region_ids,
                                                max_boxes)


class YTbFeaturesReader(RegionFeaturesReader):
    """Keys look like ``{video}/{frame:04d}`` (reference :187-189)."""


class BnBFeaturesReader(RegionFeaturesReader):
    """Keys look like ``{listing}-{photo}`` (reference :182-184)."""


class PanoFeaturesReader(FeaturesReader):
    """R2R panorama reader (reference :282-341)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.viewpoints: Dict[str, Set[str]] = {}
        for key in self.keys:
            scan_id, viewpoint_id = key.split("-")
            self.viewpoints.setdefault(scan_id, set()).add(viewpoint_id)

    def __getitem__(self, query: Tuple[str, float, float]):
        key, heading, next_heading = query
        rec = self._record(key)
        if not rec.is_pano:
            raise ValueError(f"record {key} has no pano orientation fields")

        boxes5 = _normalize_boxes(rec)
        loc = np.ones((len(boxes5), 11), dtype=np.float32)
        loc[:, :5] = boxes5
        fh = rec.feat_heading
        fe = rec.feat_elevation
        loc[:, 5] = np.sin(fh - heading)
        loc[:, 6] = np.cos(fh - heading)
        loc[:, 7] = np.sin(fe)
        loc[:, 8] = np.cos(fe)
        loc[:, 9] = np.sin(fh - next_heading)
        loc[:, 10] = np.cos(fh - next_heading)

        features = rec.features
        if features.size == 0:
            # same guard as the region reader above: mean() over a
            # (0, 2048) array would silently make the global region NaN
            # (the native packer DECLINES zero-box records, so this
            # Python fallback is exactly where such a record lands)
            raise RuntimeError("Features could not be correctly read")
        g_feature = features.mean(axis=0, keepdims=True)
        g_location = np.array([[
            0, 0, 1, 1, 1,
            np.sin(0 - heading), np.cos(0 - heading),
            np.sin(0.0), np.cos(0.0),
            np.sin(0 - next_heading), np.cos(0 - next_heading),
        ]], dtype=np.float32)
        g_prob = np.full((1, PROB_DIM), 1.0 / PROB_DIM, dtype=np.float32)
        return (np.concatenate([g_feature, features], axis=0),
                np.concatenate([g_location, loc], axis=0),
                np.concatenate([g_prob, rec.cls_prob], axis=0))

    def pack_pano_path(self, keys: Sequence[str], headings: Sequence[float],
                       next_headings: Sequence[float], max_steps: int,
                       max_boxes: int):
        """Native fast path for a whole R2R candidate path (one C call per
        path instead of per-step reads + numpy pad/concat); None -> caller
        uses the Python path."""
        first = self._single_shard(keys)
        if first is None:
            return None
        return self._stores[first].pack_pano_path(
            keys, headings, next_headings, max_steps, max_boxes)

    def pack_pano_steps(self, keys, headings, next_headings, steps,
                        max_boxes: int, out=None):
        """Native batched single-step packer for the beam-eval host path
        (store.py:pack_pano_steps_f16) — None/empty keys emit the
        empty-step block; all real keys must live in one shard (returns
        None otherwise, like pack_pano_path).  f16 features, no probs."""
        first = self._single_shard(keys, skip_falsy=True, default=0)
        if first is None:
            return None
        return self._stores[first].pack_pano_steps_f16(
            keys, headings, next_headings, steps, max_boxes, out=out)
