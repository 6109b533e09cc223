"""Datasets: YouTube/BnB pretraining (the pretraining part of
``youtube_vln_tpu/data/datasets.py``, copied; the R2R beam-ranking dataset
and its navigation graphs come with the beam-eval slice).

Pure-Python + numpy (no torch); each ``__getitem__`` returns a dict of
statically-shaped numpy arrays matching the train-step batch layout
(see parallel/train_step.py).  Equivalence with the reference 16-tuple
(``utils/dataset/all_dataset.py:275-292``):

    ranking_target     <- tuple[0]    image_targets_mask <- tuple[5]
    image_features     <- tuple[1]    instr_tokens       <- tuple[6]
    image_locations    <- tuple[2]    instr_mask         <- tuple[7]
    image_mask         <- tuple[3]    instr_targets      <- tuple[8]
    image_targets      <- tuple[4]    segment_ids        <- tuple[10]
    instr_id           <- tuple[12]   opt_mask           <- tuple[13]

``instr_highlights`` (tuple[9], always empty), ``co_attention_mask``
(tuple[11], always zeros and unused — BertEncoder never enables
use_co_attention_mask, vilbert.py:736), ``ordering_target`` (tuple[14]) and
``order_attended_visual_feature`` (tuple[15]) are inert in the reference
(SURVEY §6 "dead/vestigial"); we generate ``ordering_target`` for format
compatibility and omit the other constants from the device batch.
"""
from __future__ import annotations

import logging
import random as _random
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import sampling as S
from . import instructions as I
from ..ops.masking import (
    max_masked_regions,
    randomize_regions_np,
    randomize_regions_sparse_dedup_np,
    randomize_regions_sparse_np,
    randomize_tokens_np,
    unmasked_region_targets,
)

logger = logging.getLogger(__name__)

FEAT_DIM = 2048
LOC_DIM = 12
PROB_DIM = 1601


def load_trajectories(testset_path, dataset_type: str):
    """Frozen eval testsets (reference common.py:636-639)."""
    data = I.load_json(testset_path)
    return {int(k) if dataset_type == "bnb" else k: v
            for k, v in data.items()}


class _PathFeatureAssembler:
    """Shared [path -> [L*B, ...]] padding logic
    (reference all_dataset.py:294-345)."""

    def __init__(self, max_path_length: int, max_num_boxes: int):
        self.max_path_length = max_path_length
        self.max_num_boxes = max_num_boxes

    def pad_step(self, features, locations, probs, step_idx: int):
        B = self.max_num_boxes
        k = min(len(locations), B)
        f = np.zeros((B, FEAT_DIM), np.float32)
        f[:k] = features[:k]
        b = np.zeros((B, LOC_DIM), np.float32)
        b[:k, :11] = locations[:k, :11]
        b[:, 11] = step_idx
        p = np.zeros((B, PROB_DIM), np.float32)
        p[:k] = probs[:k]
        m = np.zeros((B,), np.int32)
        m[:k] = 1
        return f, b, p, m

    def empty_step(self, step_idx: int):
        B = self.max_num_boxes
        b = np.zeros((B, LOC_DIM), np.float32)
        b[:, 11] = step_idx
        return (np.zeros((B, FEAT_DIM), np.float32), b,
                np.zeros((B, PROB_DIM), np.float32),
                np.zeros((B,), np.int32))

    def stack(self, steps):
        L = self.max_path_length
        steps = list(steps)
        for i in range(len(steps), L):
            steps.append(self.empty_step(i))
        f, b, p, m = zip(*steps)
        return (np.concatenate(f, 0), np.concatenate(b, 0),
                np.concatenate(p, 0), np.concatenate(m, 0))


# --------------------------------------------------------------------------- #
# pretraining datasets
# --------------------------------------------------------------------------- #
class _LazyProbRows:
    """Row-gatherable stand-in for a packed [S, 1601] probs array.

    The dedup fast path never materializes per-region class probabilities
    (a ~5 MB copy per trajectory); this adapter fetches exactly the rows
    the MVM masking selected, via the native store gather
    (store.py:gather_probs).  Supports the two operations
    randomize_regions_sparse_dedup_np performs on a probs entry:
    ``probs_u[u][row_indices]`` and ``probs_u[0].shape[-1]``."""

    __slots__ = ("reader", "step_keys", "max_boxes")
    shape = (0, PROB_DIM)
    dtype = np.dtype(np.float32)

    def __init__(self, reader, step_keys, max_boxes):
        self.reader = reader
        self.step_keys = step_keys
        self.max_boxes = max_boxes

    def __getitem__(self, region_ids):
        out = self.reader.gather_probs(self.step_keys, region_ids,
                                       self.max_boxes)
        if out is None:  # native library vanished mid-run; stay correct
            raise RuntimeError("native gather_probs unavailable")
        return out


class PretrainDataset:
    """Common machinery for YTb/BnB pretraining
    (reference BaseDataset, all_dataset.py:60-345)."""

    dataset_type = ""

    def __init__(self, args, caption_path, tokenizer, features_reader,
                 masked_vision: bool, masked_language: bool,
                 training: bool = False,
                 separators: Sequence[str] = (),
                 testset_path: Optional[Dict[str, str]] = None,
                 seed: int = 0):
        self.args = args
        self.tok = tokenizer
        self.reader = features_reader
        self.masked_vision = masked_vision
        self.masked_language = masked_language
        self.training = training
        self.rng = _random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.shuffler = S.load_shuffler(args.shuffler)
        self.traj_judge_only = args.traj_judge and not args.ranking
        self.assembler = _PathFeatureAssembler(args.max_path_length,
                                               args.max_num_boxes)
        self.io_dtype = np.dtype(getattr(args, "io_dtype", "float32"))
        self.sparse_vision_targets = getattr(args, "sparse_vision_targets",
                                             False)
        self.dedup_candidates = bool(getattr(args, "dedup_candidates",
                                             False))
        # when the masked-vision TASK is globally off, no loss ever reads
        # vision targets — don't build/ship them (the dense uniform
        # [nc, S, 1601] block is most of a ranking-only batch).  A split
        # with masking off under an enabled task still emits them (the
        # reference's test_epoch computes the vision loss on unmasked
        # uniform targets, utils_init.py:122-128).
        self.emit_vision_targets = masked_vision or bool(
            getattr(args, "masked_vision", False))

        captions = self.load_captions(caption_path)
        self.caption_by_key = {self.caption_key(c): c for c in captions}
        self.gather(captions)
        if not args.out_listing:
            self.photos_by_listing = S.drop_small_listings(
                self.photos_by_listing, args.min_path_length)
        self.listing_ids = list(self.photos_by_listing.keys())
        self.build_instruction = self.make_instruction_generator(
            args.skeleton_path, separators)
        self.testsets = {
            key: load_trajectories(path, self.dataset_type)
            for key, path in (testset_path or {}).items()
        } if not training else {}

    def reseed(self, seed: int) -> None:
        """Deterministic per-item seeding (see data.loader)."""
        self.rng.seed(seed)
        self.np_rng = np.random.default_rng(seed)

    # hooks ------------------------------------------------------------- #
    def load_captions(self, path):
        raise NotImplementedError

    def caption_key(self, caption):
        raise NotImplementedError

    def gather(self, captions):
        raise NotImplementedError

    def make_instruction_generator(self, skeleton_path, separators):
        raise NotImplementedError

    def feature_key(self, listing_id, pid) -> str:
        raise NotImplementedError

    def pick_photo_ids(self, listing_id):
        raise NotImplementedError

    def generate_instruction(self, traj) -> List[int]:
        raise NotImplementedError

    # ------------------------------------------------------------------- #
    def __len__(self):
        if self.args.out_listing:
            return min(len(self.listing_ids),
                       15000 if self.training else 500)
        return len(self.listing_ids)

    def num_candidates(self) -> int:
        # 1 positive + THREE negative families x n in BOTH modes: the
        # reference's negative_style block runs outside the traj_judge
        # branch (common.py:509 is top-level), and the judge-mode item
        # assembly concatenates all three families
        # (all_dataset.py:189-197).  An earlier 1+2n here made collate
        # reject every judge-only pretrain item.
        # BnB out-listing items DO carry fewer real candidates (randoms
        # dropped, all_dataset.py:548-549) — they pad to this width via
        # opt_mask (pinned by tests/test_data.py:test_bnb_out_listing).
        return 1 + 3 * self.args.num_negatives

    def num_unique_candidates(self):
        """Static unique-trajectory count under --dedup_candidates (the
        collate pad target for uniq_* keys); None when dedup is off.
        Mirrors __getitem__'s sharing structure: caption-negatives (and
        under shuffle_instruction also image-negatives) reuse the
        positive's features."""
        if not self.dedup_candidates:
            return None
        n = self.args.num_negatives
        if self.traj_judge_only:
            return 1 + 3 * n          # every candidate has own visuals
        if self.args.negative_style == "shuffle_instruction":
            return 1 + n              # only the random negatives differ
        return 1 + 2 * n              # image + random negatives differ

    def _visual_features(self, trajectory):
        step_keys = []
        for listing_id, photo_id in trajectory[: self.args.max_path_length]:
            if isinstance(photo_id, int):
                photo_id = (photo_id,)
            step_keys.append(tuple(self.feature_key(listing_id, pid)
                                   for pid in photo_id))
        if (self.dedup_candidates and self.io_dtype == np.float16
                and getattr(self.reader, "pack_path_f16", None) is not None):
            # dedup fast path: f16 features straight from the C packer
            # (same round-to-nearest-even as numpy astype) and NO probs
            # materialization — target rows are gathered post-masking
            # (_LazyProbRows); cuts ~1/3 of item-assembly copy volume
            packed = self.reader.pack_path_f16(
                step_keys, self.args.max_path_length,
                self.args.max_num_boxes)
            if packed is not None:
                f, l, m = packed
                return (f, l,
                        _LazyProbRows(self.reader, step_keys,
                                      self.args.max_num_boxes), m)
        pack = getattr(self.reader, "pack_path", None)
        if pack is not None:
            packed = pack(step_keys, self.args.max_path_length,
                          self.args.max_num_boxes)
            if packed is not None:
                return packed
        steps = [self.assembler.pad_step(*self.reader[keys], i)
                 for i, keys in enumerate(step_keys)]
        return self.assembler.stack(steps)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        listing_id = self.listing_ids[index]
        (positive, neg_captions, neg_images, neg_randoms,
         order_labels) = self.pick_photo_ids(listing_id)

        self.template = None
        instructions = [self.generate_instruction(positive)]
        feats = [self._visual_features(positive)]

        if self.traj_judge_only:
            # same instruction, different (negative) trajectories
            # (all_dataset.py:189-197)
            for traj in neg_captions + neg_images + neg_randoms:
                instructions.append(instructions[0])
                feats.append(self._visual_features(traj))
        else:
            for traj in neg_captions:        # new instruction, same visuals
                instructions.append(self.generate_instruction(traj))
                feats.append(feats[0])
            if self.args.negative_style == "shuffle_instruction":
                for traj in neg_images:      # also instruction-side
                    instructions.append(self.generate_instruction(traj))
                    feats.append(feats[0])
            else:
                for traj in neg_images:      # same instruction, new visuals
                    instructions.append(instructions[0])
                    feats.append(self._visual_features(traj))
            for traj in neg_randoms:
                instructions.append(instructions[0])
                feats.append(self._visual_features(traj))

        return self._finalize(instructions, feats, positive, order_labels)

    def _finalize(self, instructions, feats, positive, order_labels):
        nc = len(instructions)
        dedup = self.dedup_candidates
        cand_map: List[int] = []
        if dedup:
            # candidates sharing a trajectory hold the SAME feature tuple
            # object (see __getitem__: feats.append(feats[0])); ship each
            # unique trajectory once + a per-candidate gather index, and
            # let the train step expand in-graph (ranking mode: 5 unique
            # of 7 candidates -> ~29% less visual transport)
            uniq, seen = [], {}
            for f in feats:
                key = id(f)
                if key not in seen:
                    seen[key] = len(uniq)
                    uniq.append(f)
                cand_map.append(seen[key])
            src = uniq
        else:
            src = feats
        # stack features straight into the transport dtype: one fused
        # cast-copy instead of an f32 stack + a second astype pass (the
        # two passes were ~25% of item assembly time at full geometry)
        image_features = np.stack([f[0] for f in src],
                                  dtype=self.io_dtype)
        image_locations = np.stack([f[1] for f in src])
        if dedup:
            # never stack probs under dedup: the [n_u, S, 1601] f32 stack
            # is a ~26 MB copy per item (measured 45% of item assembly
            # lived in np.stack) and only ~120 gathered target rows are
            # ever read from it
            image_probs_list = [f[2] for f in src]
        else:
            image_probs = np.stack([f[2] for f in src])
        image_mask = np.stack([f[3] for f in src])
        instr_tokens = np.asarray(instructions, np.int32)
        instr_mask = (instr_tokens > 0).astype(np.int32)
        segment_ids = np.zeros_like(instr_tokens)

        image_targets_idx = None
        feature_zero_mask = None
        if dedup:
            s_v = image_mask.shape[-1]
            m_cap = max_masked_regions(s_v)
            if self.masked_vision:
                (feature_zero_mask, image_targets_idx, image_targets,
                 image_targets_mask) = randomize_regions_sparse_dedup_np(
                    image_probs_list, image_mask, cand_map, self.np_rng,
                    dtype=self.io_dtype)
            elif not self.emit_vision_targets:
                image_targets = image_targets_mask = None
            else:
                image_targets_idx = np.full((nc, m_cap), s_v, np.int32)
                image_targets = np.zeros(
                    (nc, m_cap, image_probs_list[0].shape[-1]),
                    self.io_dtype)
                image_targets_mask = np.zeros((nc, s_v), image_mask.dtype)
        elif not self.masked_vision and not self.emit_vision_targets:
            image_targets = image_targets_mask = None
        elif self.masked_vision and self.sparse_vision_targets:
            (image_features, image_targets_idx, image_targets,
             image_targets_mask) = randomize_regions_sparse_np(
                image_features, image_probs, image_mask, self.np_rng,
                copy=False)
        elif self.masked_vision:
            image_features, image_targets, image_targets_mask = \
                randomize_regions_np(image_features, image_probs, image_mask,
                                     self.np_rng, copy=False)
        elif self.sparse_vision_targets:
            s_v = image_mask.shape[-1]
            m_cap = max_masked_regions(s_v)
            image_targets_idx = np.full(image_mask.shape[:-1] + (m_cap,),
                                        s_v, np.int32)
            image_targets = np.zeros(
                image_targets_idx.shape + (image_probs.shape[-1],),
                image_probs.dtype)
            image_targets_mask = np.zeros_like(image_mask)
        else:
            image_targets, image_targets_mask = unmasked_region_targets(
                image_probs, image_mask)
        if self.masked_language:
            instr_tokens, instr_targets = randomize_tokens_np(
                instr_tokens, instr_mask, len(self.tok.vocab),
                self.tok.vocab["[MASK]"], self.np_rng,
                self.args.mask_action_rate)
        else:
            instr_targets = np.full_like(instr_tokens, -1)

        # inert ordering plumbing kept for format compatibility
        # (all_dataset.py:159-179; prob_order is hardcoded to 1 so the
        # identity branch always runs)
        L = self.args.max_path_length
        ordering_target = np.asarray(
            [list(range(len(positive))) + [-1] * (L - len(positive))
             for _ in order_labels.get("negative_images_idx", [])],
            np.int32).reshape(-1, L) if order_labels else np.zeros((0, L),
                                                                   np.int32)

        if self.training:
            ranking_target = np.int32(0)
        else:
            ranking_target = np.zeros((nc,), np.float32)
            ranking_target[0] = 1

        image_features = image_features.astype(self.io_dtype, copy=False)
        if dedup:
            visual = dict(
                uniq_image_features=image_features,
                uniq_image_locations=image_locations,
                uniq_image_mask=image_mask,
                cand_index=np.asarray(cand_map, np.int32))
            if feature_zero_mask is not None:
                visual["feature_zero_mask"] = feature_zero_mask
        else:
            visual = dict(image_features=image_features,
                          image_locations=image_locations,
                          image_mask=image_mask)
        targets = {} if image_targets is None else dict(
            image_targets=image_targets.astype(self.io_dtype, copy=False),
            **({"image_targets_idx": image_targets_idx}
               if image_targets_idx is not None else {}),
            image_targets_mask=image_targets_mask.astype(np.int32,
                                                         copy=False))
        return dict(
            ranking_target=ranking_target,
            **visual,
            **targets,
            instr_tokens=instr_tokens.astype(np.int32, copy=False),
            instr_mask=instr_mask,
            instr_targets=instr_targets.astype(np.int32, copy=False),
            segment_ids=segment_ids,
            opt_mask=np.ones((nc,), bool),
            ordering_target=ordering_target,
            instr_id=np.zeros((2,), np.int64),
        )


class YTbDataset(PretrainDataset):
    """YouTube house-tour pretraining set
    (reference all_dataset.py:348-457)."""

    dataset_type = "ytb"

    def load_captions(self, path):
        return I.load_json(path)

    def caption_key(self, c):
        return S.ytb_key(c["video_id"], c["frame_id"])

    def gather(self, captions):
        by_video: Dict[str, List] = {}
        for c in sorted(captions, key=lambda c: c["video_id"]):
            by_video.setdefault(c["video_id"], []).append(c)
        self.photos_by_listing = by_video

    def make_instruction_generator(self, skeleton_path, separators):
        if not skeleton_path:
            raise NotImplementedError("YTb requires a template skeleton")
        return I.YTBRephraseInstructionGenerator(
            skeleton_path, self.args.random_action, self.tok, separators,
            self.caption_by_key, self.args.max_instruction_length,
            rng=self.rng)

    def feature_key(self, listing_id, pid):
        return S.ytb_key(listing_id, pid)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.key_trajectories = {
            vid: [f["frame_id"] for f in frames if f["caption"] != ""]
            for vid, frames in self.photos_by_listing.items()
        }
        if self.args.out_listing:
            raise NotImplementedError

    def pick_photo_ids(self, listing_id):
        if not self.training:
            key = "traj" if self.traj_judge_only else "ranking"
            return self.testsets[key][listing_id]
        positive, captioned = S.ytb_trajectory(
            listing_id, self.photos_by_listing,
            self.key_trajectories[listing_id],
            self.args.min_path_length, self.args.max_path_length,
            self.args.min_captioned, self.args.max_captioned, self.rng)
        if self.args.no_serial:
            order = list(range(len(positive)))
            self.rng.shuffle(order)
            positive = [positive[i] for i in order]
            captioned = [captioned[i] for i in order]
        negs = S.generate_negatives(
            positive, captioned, self.listing_ids, self.photos_by_listing,
            self.caption_by_key, self.args.num_negatives, self.shuffler,
            "ytb", self.traj_judge_only, self.args.negative_style, self.rng)
        return (positive,) + negs

    def generate_instruction(self, traj):
        sentence, self.template = self.build_instruction(traj, self.template)
        return sentence


class BnBDataset(PretrainDataset):
    """Airbnb listings pretraining set (reference all_dataset.py:460-561)."""

    dataset_type = "bnb"

    def load_captions(self, path):
        return I.load_tokens(path, self.tok,
                             self.args.max_instruction_length)

    def caption_key(self, c):
        return int(c["photo_id"])

    def gather(self, captions):
        by_listing: Dict[str, List] = {}
        for c in sorted(captions, key=lambda c: c["listing_id"]):
            by_listing.setdefault(str(c["listing_id"]), []).append(c)
        self.photos_by_listing = {
            lid: S.merge_images(photos)
            for lid, photos in by_listing.items()
        }

    def make_instruction_generator(self, skeleton_path, separators):
        if not skeleton_path:
            return I.ConcatenateInstructionGenerator(
                self.tok, separators, self.caption_by_key,
                self.args.max_instruction_length, rng=self.rng)
        return I.RephraseInstructionGenerator(
            skeleton_path, self.tok, separators, self.caption_by_key,
            self.args.max_instruction_length, rng=self.rng)

    def feature_key(self, listing_id, pid):
        return f"{listing_id}-{pid}"

    def pick_photo_ids(self, listing_id):
        if not self.training:
            key = "traj" if self.traj_judge_only else "ranking"
            return self.testsets[key][int(listing_id)]
        gen = S.bnb_trajectory_out_listing if self.args.out_listing \
            else S.bnb_trajectory_in_listing
        if self.args.out_listing:
            positive, captioned = gen(
                listing_id, self.listing_ids, self.photos_by_listing,
                self.caption_by_key, self.args.min_path_length,
                self.args.max_path_length, self.args.min_captioned,
                self.args.max_captioned, self.rng)
        else:
            positive, captioned = gen(
                listing_id, self.photos_by_listing, self.caption_by_key,
                self.args.min_path_length, self.args.max_path_length,
                self.args.min_captioned, self.args.max_captioned, self.rng)
        negs = S.generate_negatives(
            positive, captioned, self.listing_ids, self.photos_by_listing,
            self.caption_by_key, self.args.num_negatives, self.shuffler,
            "bnb", self.traj_judge_only, self.args.negative_style, self.rng)
        neg_captions, neg_images, neg_randoms, order_labels = negs
        if self.args.out_listing:
            neg_randoms = []
        return positive, neg_captions, neg_images, neg_randoms, order_labels

    def generate_instruction(self, traj):
        return self.build_instruction(traj)
