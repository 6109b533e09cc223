"""Datasets: YouTube/BnB pretraining and the R2R beam-ranking dataset (a
copy of ``youtube_vln_tpu/data/datasets.py`` on the port's ``NavGraph``).

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
from .nav_graph import get_headings, load_distances, load_nav_graphs
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


# --------------------------------------------------------------------------- #
# R2R beam dataset
# --------------------------------------------------------------------------- #
class BeamDataset:
    """Beam re-ranking dataset (reference all_dataset.py:563-1105)."""

    def __init__(self, args, vln_path, beam_path, tokenizer, features_reader,
                 num_beams: int, num_beams_strict: bool, training: bool,
                 masked_vision: bool, masked_language: bool,
                 shuffle_visual_features: bool, shuffler: str = "different",
                 ground_truth_trajectory: bool = False,
                 data_dir: str = "data", seed: int = 0):
        self.args = args
        self.reader = features_reader
        self.training = training
        self.masked_vision = masked_vision
        self.masked_language = masked_language
        self.shuffle_visual = shuffle_visual_features
        self.ground_truth_trajectory = ground_truth_trajectory
        self.batch_size = args.batch_size // args.gradient_accumulation_steps
        self.traj_judge_only = args.traj_judge and not (
            args.ranking or args.not_traj_judge_data)
        self.rng = _random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.tok = tokenizer
        self.assembler = _PathFeatureAssembler(args.max_path_length,
                                               args.max_num_boxes)
        self.io_dtype = np.dtype(getattr(args, "io_dtype", "float32"))
        self.sparse_vision_targets = getattr(args, "sparse_vision_targets",
                                             False)
        # see PretrainDataset: skip vision targets when the TASK is off
        # (a ranking-only eval batch is mostly the dense uniform block)
        self.emit_vision_targets = masked_vision or bool(
            getattr(args, "masked_vision", False))
        # step-level transport dedup (--dedup_beam_steps): eval beams are
        # tree-shaped paths over one graph neighborhood (reference
        # all_dataset.py:981-1041), so per-step pano blocks repeat across
        # beams; ship each unique (viewpoint, heading, step) block once +
        # a per-beam gather index, expanded in-graph (beam_eval.py).
        # Scope: eval items with the masked-vision task off (features are
        # then never corrupted and no per-beam prob targets are shipped).
        self.step_dedup = (bool(getattr(args, "dedup_beam_steps", False))
                           and not training and not masked_vision
                           and not self.emit_vision_targets)
        if shuffler not in ("different", "nonadj"):
            raise ValueError(f"Unexpected shuffling mode ({shuffler})")
        self.shuffler = S.load_shuffler(shuffler)

        self.vln_data = I.load_tokens(vln_path, tokenizer,
                                      args.max_instruction_length)
        scan_list = sorted({item["scan"] for item in self.vln_data})
        self.graphs = load_nav_graphs(scan_list, data_dir)
        self.distances = load_distances(scan_list, data_dir)

        self.num_beams = num_beams
        if training:
            num_beams_strict = False
        beam_data = I.load_json(beam_path)
        self.beam_data = []
        for idx, item in enumerate(beam_data):
            if len(item["ranked_paths"]) >= num_beams:
                if num_beams_strict:
                    item["ranked_paths"] = item["ranked_paths"][:num_beams]
                self.beam_data.append(item)
            else:
                logger.warning("skipping beam index %d from %s", idx,
                               beam_path)
        path_to_vln = {item["path_id"]: i
                       for i, item in enumerate(self.vln_data)}
        self.beam_to_vln = {}
        for idx, item in enumerate(self.beam_data):
            pid = int(item["instr_id"].split("_")[0])
            if pid not in path_to_vln:
                logger.warning("Skipping beam %s", item["instr_id"])
                continue
            self.beam_to_vln[idx] = path_to_vln[pid]

    def reseed(self, seed: int) -> None:
        self.rng.seed(seed)
        self.np_rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.beam_data)

    def num_candidates(self) -> int:
        if self.training:
            n = self.args.num_beams_train if not self.traj_judge_only else 1
            if self.shuffle_visual or self.traj_judge_only:
                n += self.args.num_negatives
            return n
        if self.batch_size == 1:
            # the reference skips the per-item tile/trim entirely at batch
            # size 1 (all_dataset.py:782) and torch's default collate takes
            # whatever candidate count the item has — ALL ranked paths are
            # scored (test.py mode sets num_beams=1, test.py:46, making
            # this also the test.py all-paths path; the same holds for a
            # val split evaluated at batch_size 1 when an item carries
            # more than num_beams ranked paths, since num_beams_strict is
            # always False, dataset_init.py:85).  Our static collate pads
            # every item to the dataset-wide max and masks the padding
            # via opt_mask.
            n = self.max_beam_count()
        else:
            n = self.num_beams
        return n + (self.args.num_negatives + 1
                    if self.shuffle_visual else 0)

    def max_beam_count(self) -> int:
        return max(len(item["ranked_paths"]) for item in self.beam_data)

    def _success(self, scan_id, gt_path, beam_paths, margin=3.0):
        d = self.distances[scan_id]
        return np.array([
            1.0 if d[gt_path[-1]][bp[-1]] < margin else 0.0
            for bp in beam_paths])

    def _path_features(self, scan_id, path, first_heading):
        headings = get_headings(self.graphs[scan_id], path, first_heading)
        next_headings = headings[1:] + [headings[-1]]
        steps = []
        for i, vp in enumerate(path[: self.args.max_path_length]):
            feats, locs, probs = self.reader[
                f"{scan_id}-{vp}", headings[i], next_headings[i]]
            steps.append(self.assembler.pad_step(feats, locs, probs, i))
        L = self.args.max_path_length
        for i in range(len(steps), L):
            steps.append(self.assembler.empty_step(i))
        return steps

    def _packed_path_features(self, scan_id, path, first_heading):
        """stack(_path_features(...)) with the native pano packer when
        available (one C call per candidate path)."""
        headings = get_headings(self.graphs[scan_id], path, first_heading)
        next_headings = headings[1:] + [headings[-1]]
        L = self.args.max_path_length
        pack = getattr(self.reader, "pack_pano_path", None)
        if pack is not None:
            packed = pack([f"{scan_id}-{vp}" for vp in path[:L]],
                          headings[:L], next_headings[:L], L,
                          self.args.max_num_boxes)
            if packed is not None:
                return packed
        steps = []
        for i, vp in enumerate(path[:L]):
            feats, locs, probs = self.reader[
                f"{scan_id}-{vp}", headings[i], next_headings[i]]
            steps.append(self.assembler.pad_step(feats, locs, probs, i))
        return self.assembler.stack(steps)

    # n_u is padded up to a bucket multiple so the scorer jit sees at most
    # ceil(nc * L / bucket) static shapes per run (each bucket compiles
    # once; a per-item exact n_u would recompile for every instruction)
    STEP_BUCKET = 40

    def _dedup_step_features(self, scan_id, paths, first_heading):
        """Unique per-step pano block SPECS + a [nc, L] gather index.

        A step block is fully determined by (viewpoint, entry heading,
        next heading, step position) — the reader call plus the assembler
        padding take exactly these — so beams sharing a path prefix (the
        common case: beams are a search tree, all_dataset.py:981-1041)
        reuse each other's blocks, and every short path shares the same
        empty-step block per position.  Specs are (store_key|None,
        heading, next_heading, position); assembly happens batched in
        _finalize_step_dedup (one native C call for the whole item)."""
        L = self.args.max_path_length
        specs, index_rows = [], []
        seen: Dict[tuple, int] = {}
        for path in paths:
            headings = get_headings(self.graphs[scan_id], path,
                                    first_heading)
            next_headings = headings[1:] + [headings[-1]]
            row = []
            for i, vp in enumerate(path[:L]):
                key = (vp, float(headings[i]), float(next_headings[i]), i)
                j = seen.get(key)
                if j is None:
                    j = len(specs)
                    seen[key] = j
                    specs.append((f"{scan_id}-{vp}", headings[i],
                                  next_headings[i], i))
                row.append(j)
            for i in range(min(len(path), L), L):
                key = (None, 0.0, 0.0, i)
                j = seen.get(key)
                if j is None:
                    j = len(specs)
                    seen[key] = j
                    specs.append((None, 0.0, 0.0, i))
                row.append(j)
            index_rows.append(row)
        return specs, np.asarray(index_rows, np.int32)

    def _assemble_step(self, key, heading, next_heading, step_idx: int):
        """One pano step block through the SAME code path as the dense
        item (the native packer when available): the global-region row is
        a mean over box features whose C accumulation order differs from
        numpy's pairwise summation by 1 f16 ulp, so mixing paths would
        break the bit-exact dedup==dense guarantee.  key None -> the
        empty-step block."""
        if key is None:
            return self.assembler.empty_step(step_idx)
        pack = getattr(self.reader, "pack_pano_path", None)
        if pack is not None:
            packed = pack([key], [heading], [next_heading],
                          1, self.assembler.max_num_boxes)
            if packed is not None:
                f, b, p, m = packed
                b[:, 11] = step_idx   # the packer wrote position 0
                return f, b, p, m
        feats, locs, probs = self.reader[key, heading, next_heading]
        return self.assembler.pad_step(feats, locs, probs, step_idx)

    def _finalize_step_dedup(self, instr_tokens, specs, step_index,
                             target, instr_id):
        nc = step_index.shape[0]
        boxes = self.assembler.max_num_boxes
        n_u = len(specs)
        # cap at the dense slot count: n_u <= nc*L always, and without the
        # cap a small geometry (few beams / short paths) would pad past the
        # dense layout and ship MORE bytes than the transport it replaces
        bucket = min(-(-n_u // self.STEP_BUCKET) * self.STEP_BUCKET,
                     nc * self.args.max_path_length)
        # zeros, not empty: blocks past n_u are the bucket padding and
        # must stay zero (the scorer's gather never reads them, but the
        # collate/H2D ships them)
        uniq_feats = np.zeros((bucket, boxes, 2048), self.io_dtype)
        uniq_locs = np.zeros((bucket, boxes, 12), np.float32)
        uniq_mask = np.zeros((bucket, boxes), np.int32)
        packed = None
        if self.io_dtype == np.float16:
            pack = getattr(self.reader, "pack_pano_steps", None)
            if pack is not None:
                keys, hs, nhs, poss = zip(*specs)
                packed = pack(keys, hs, nhs, poss, boxes,
                              out=(uniq_feats, uniq_locs, uniq_mask))
        if packed is None:   # python / f32 / multi-shard fallback
            for j, (key, hd, nh, pos) in enumerate(specs):
                f, b, _, m = self._assemble_step(key, hd, nh, pos)
                uniq_feats[j] = f
                uniq_locs[j] = b
                uniq_mask[j] = m
        instr_tokens, instr_mask, instr_targets, segment_ids = \
            self._instruction_fields(instr_tokens, nc)
        return dict(
            ranking_target=np.asarray(target, np.float32),
            uniq_step_features=uniq_feats,
            uniq_step_locations=uniq_locs,
            uniq_step_mask=uniq_mask,
            step_index=step_index,
            instr_tokens=instr_tokens,
            instr_mask=instr_mask,
            instr_targets=instr_targets,
            segment_ids=segment_ids,
            opt_mask=np.ones((nc,), bool),
            ordering_target=np.zeros((0, self.args.max_path_length),
                                     np.int32),
            instr_id=instr_id,
        )

    def _packed_paths_f16(self, scan_id, paths, first_heading):
        """All candidates' step blocks in ONE native call (f16 features,
        f32 locations, i32 mask; class probabilities never materialized —
        the ranking-only eval item reads none, and the [nc, S_v, 1601]
        probs stack was ~60% of the dense item's host bytes at flagship
        eval geometry).  None -> caller takes the generic path."""
        pack = getattr(self.reader, "pack_pano_steps", None)
        if pack is None:
            return None
        L = self.args.max_path_length
        boxes = self.assembler.max_num_boxes
        keys, hs, nhs, poss = [], [], [], []
        for path in paths:
            headings = get_headings(self.graphs[scan_id], path,
                                    first_heading)
            next_headings = headings[1:] + [headings[-1]]
            n = min(len(path), L)
            for i in range(n):
                keys.append(f"{scan_id}-{path[i]}")
                hs.append(headings[i])
                nhs.append(next_headings[i])
                poss.append(i)
            for i in range(n, L):
                keys.append(None)
                hs.append(0.0)
                nhs.append(0.0)
                poss.append(i)
        nc = len(paths)
        # every block is written by the native call — empty init is safe
        f = np.empty((nc, L * boxes, 2048), np.float16)
        l = np.empty((nc, L * boxes, 12), np.float32)
        m = np.empty((nc, L * boxes), np.int32)
        return pack(keys, hs, nhs, poss, boxes, out=(f, l, m))

    def _finalize_eval_fast(self, instr_tokens, packed, target, instr_id):
        """_finalize for the probs-free eval layout (same output dict,
        minus the vision-target fields the gate already excludes)."""
        image_features, image_locations, image_mask = packed
        nc = image_features.shape[0]
        instr_tokens, instr_mask, instr_targets, segment_ids = \
            self._instruction_fields(instr_tokens, nc)
        ranking_target = (np.int32(target) if self.training
                         else np.asarray(target, np.float32))
        return dict(
            ranking_target=ranking_target,
            image_features=image_features,
            image_locations=image_locations,
            image_mask=image_mask,
            instr_tokens=instr_tokens.astype(np.int32, copy=False),
            instr_mask=instr_mask,
            instr_targets=instr_targets.astype(np.int32, copy=False),
            segment_ids=segment_ids,
            opt_mask=np.ones((nc,), bool),
            ordering_target=np.zeros((0, self.args.max_path_length),
                                     np.int32),
            instr_id=instr_id,
        )

    def _single_feature(self, scan_id, viewpoint, step_idx):
        heading = self.rng.uniform(-np.pi / 2, np.pi / 2)
        next_heading = self.rng.uniform(-np.pi / 2, np.pi / 2)
        feats, locs, probs = self.reader[
            f"{scan_id}-{viewpoint}", heading, next_heading]
        return self.assembler.pad_step(feats, locs, probs, step_idx)

    def __getitem__(self, beam_index: int) -> Dict[str, np.ndarray]:
        vln_index = self.beam_to_vln[beam_index]
        vln_item = self.vln_data[vln_index]
        path_id, instruction_index = map(
            int, self.beam_data[beam_index]["instr_id"].split("_"))
        scan_id = vln_item["scan"]
        heading = vln_item["heading"]
        gt_path = vln_item["path"]

        instr_tokens = np.asarray(
            vln_item["instruction_tokens"][instruction_index], np.int32)

        beam_paths = [[p for p, _, _ in ranked]
                      for ranked in self.beam_data[beam_index]["ranked_paths"]]
        success = self._success(scan_id, gt_path, beam_paths)

        if self.training:
            target, selected_paths = self._select_training_paths(
                vln_item, instruction_index, beam_paths, success, vln_index)
        else:
            target = np.zeros(len(beam_paths)) if self.traj_judge_only \
                else success
            selected_paths = list(beam_paths)
            if self.shuffle_visual:
                for i in np.arange(len(success))[success.astype(bool)]:
                    if i > self.args.num_negatives:
                        break
                    selected_paths.append(
                        next(self.shuffler(selected_paths[int(i)], self.rng)))
                    target = np.append(target, 0)
            if self.batch_size != 1 and len(target) != self.num_beams:
                reps = int(self.num_beams / len(target)) + 1
                target = np.tile(target, reps)[: self.num_beams]
                selected_paths = (selected_paths * reps)[: self.num_beams]

        iid = np.asarray([path_id, instruction_index], np.int64)
        if self.training and self.traj_judge_only:
            step_lists = self._traj_judge_features(
                scan_id, heading, selected_paths, vln_index)
            feats = [self.assembler.stack(s) for s in step_lists]
        elif self.step_dedup:
            specs, step_index = self._dedup_step_features(
                scan_id, selected_paths, heading)
            return self._finalize_step_dedup(instr_tokens, specs,
                                             step_index, target, iid)
        else:
            if (not self.masked_vision and not self.emit_vision_targets
                    and not self.masked_language
                    and self.io_dtype == np.float16):
                # ranking-only item: skip the probs stack entirely and
                # pack all candidates' blocks in one native call.  The
                # masked_language exclusion is caution, not correctness
                # (no vision rng draws happen on either path) — it keeps
                # every MLM-bearing item on the single reference-shaped
                # assembly path.
                packed = self._packed_paths_f16(scan_id, selected_paths,
                                                heading)
                if packed is not None:
                    return self._finalize_eval_fast(instr_tokens, packed,
                                                    target, iid)
            feats = [self._packed_path_features(scan_id, p, heading)
                     for p in selected_paths]

        return self._finalize(instr_tokens, feats, target, iid)

    def _select_training_paths(self, vln_item, instruction_index, beam_paths,
                               success, vln_index):
        """Reference all_dataset.py:702-748.

        The speaker-augmented ``positive`` field is INERT in the reference
        beyond its GT-incompatibility assert: its branch (:702-706) sets
        target/selected_paths, but the success-count if/else that follows
        (:709-733) assigns BOTH on every path, unconditionally overwriting
        them — an aug item with positive=false and sufficient
        success/failure counts trains as an ordinary target=0 item with
        np.random-selected beams.  Replicated exactly (an earlier `elif
        selected_paths is None` kept the dead branch alive, silently
        changing 30RSA training data AND the per-item np RNG stream);
        pinned by tests/test_data.py:test_beam_dataset_aug_positive_field.
        """
        target = 0
        if "positive" in vln_item and \
                not vln_item["positive"][instruction_index]:
            target = -1
            selected_paths = beam_paths[: self.args.num_beams_train]
            assert not self.ground_truth_trajectory, "Not compatible"
        if np.sum(success == 1) == 0 or \
                np.sum(success == 0) < self.args.num_beams_train - 1:
            target = -1
            if self.ground_truth_trajectory:
                selected_paths = [vln_item["path"]] + \
                    beam_paths[: self.args.num_beams_train - 1]
            else:
                selected_paths = beam_paths[: self.args.num_beams_train]
        else:
            target = 0
            selected_paths = []
            if self.ground_truth_trajectory:
                selected_paths.append(vln_item["path"])
            else:
                idx = self.np_rng.choice(np.where(success == 1)[0])
                selected_paths.append(beam_paths[int(idx)])
            if not self.traj_judge_only:
                idxs = self.np_rng.choice(np.where(success == 0)[0],
                                          size=self.args.num_beams_train - 1,
                                          replace=False)
                for idx in idxs:
                    selected_paths.append(beam_paths[int(idx)])

        if self.shuffle_visual and not self.traj_judge_only:
            path = vln_item["path"]
            for corr, _ in zip(self.shuffler(list(range(len(path))), self.rng),
                               range(self.args.num_negatives)):
                selected_paths.append([path[i] for i in corr])
        return target, selected_paths

    def _traj_judge_features(self, scan_id, heading, selected_paths,
                             vln_index):
        """Training negatives for the pure judge task: 3 shuffle types
        (reference all_dataset.py:790-879).

        DOCUMENTED DEVIATION (MIGRATION.md): in shuffle type 3 the
        reference's ``temp = path_features[0].copy()`` is a shallow copy,
        so all candidates alias the same inner step lists and every
        replacement mutates the positive too — after the loop ALL
        candidates carry identical visual features while the judge
        targets still mark only candidate 0 positive.  We replace steps
        per candidate (the evident intent — ``steps = list(pos_steps)``
        below copies the outer list).  The live loop-parity test
        replicates the reference aliasing in a test-side shim."""
        pos = selected_paths[0][: self.args.max_path_length]
        pos_steps = self._path_features(scan_id, pos, heading)
        step_lists = [pos_steps]
        path_range = list(range(len(pos)))
        shuffle_type = self.rng.randint(1, 3)

        if shuffle_type == 1:
            # recompute features along a shuffled viewpoint order
            for corr, _ in zip(self.shuffler(path_range, self.rng),
                               range(self.args.num_negatives)):
                path = [pos[i] for i in corr]
                step_lists.append(self._path_features(scan_id, path, heading))
        elif shuffle_type == 2:
            # permute the positive path's precomputed per-step features
            for corr, _ in zip(self.shuffler(path_range, self.rng),
                               range(self.args.num_negatives)):
                steps = [pos_steps[i] for i in corr]
                steps += pos_steps[len(pos):self.args.max_path_length]
                step_lists.append(steps)
        else:
            # splice in viewpoints from a different scan
            other = self.rng.randint(0, len(self.vln_data) - 1)
            while other == vln_index:
                other = self.rng.randint(0, len(self.vln_data) - 1)
            path2 = self.vln_data[other]["path"]
            scan2 = self.vln_data[other]["scan"]
            max_out = 4
            for _ in range(self.args.num_negatives):
                min_len = min(len(pos), len(path2))
                n_out = self.rng.randint(1, min(max_out, min_len))
                steps = list(pos_steps)
                for i in self.rng.sample(range(min_len), n_out):
                    steps[i] = self._single_feature(scan2, path2[i], i)
                step_lists.append(steps)
        return step_lists

    def _instruction_fields(self, instr_tokens, nc):
        """Per-candidate instruction arrays (+ optional MLM masking).
        NOTE: callers must invoke this AFTER any vision-masking rng draws
        so the np_rng stream order matches the reference item assembly."""
        instr_tokens = np.tile(instr_tokens[None, :], (nc, 1))
        instr_mask = (instr_tokens > 0).astype(np.int32)
        segment_ids = np.zeros_like(instr_tokens)
        if self.masked_language:
            instr_tokens, instr_targets = randomize_tokens_np(
                instr_tokens, instr_mask, len(self.tok.vocab),
                self.tok.vocab["[MASK]"], self.np_rng,
                self.args.mask_action_rate)
        else:
            instr_targets = np.full_like(instr_tokens, -1)
        return (instr_tokens.astype(np.int32, copy=False), instr_mask,
                instr_targets.astype(np.int32, copy=False), segment_ids)

    def _finalize(self, instr_tokens, feats, target, instr_id):
        nc = len(feats)
        # fused cast-copy into the transport dtype (see PretrainDataset)
        image_features = np.stack([f[0] for f in feats],
                                  dtype=self.io_dtype)
        image_locations = np.stack([f[1] for f in feats])
        # probs stacked ONLY on the branches that read them: the stack is
        # ~155 MB of copy per 30-beam eval instruction at flagship
        # geometry, and the no-vision-targets branch (ranking-only items
        # off the f16 fast paths, e.g. --io_dtype float32 eval) discards it
        probs_list = [f[2] for f in feats]
        image_mask = np.stack([f[3] for f in feats])

        image_targets_idx = None
        if self.masked_vision and self.sparse_vision_targets:
            (image_features, image_targets_idx, image_targets,
             image_targets_mask) = randomize_regions_sparse_np(
                image_features, np.stack(probs_list), image_mask,
                self.np_rng, copy=False)
        elif self.masked_vision:
            image_features, image_targets, image_targets_mask = \
                randomize_regions_np(image_features, np.stack(probs_list),
                                     image_mask, self.np_rng, copy=False)
        elif not self.emit_vision_targets:
            image_targets = image_targets_mask = None
        elif self.sparse_vision_targets:
            s_v = image_mask.shape[-1]
            m_cap = max_masked_regions(s_v)
            image_targets_idx = np.full(image_mask.shape[:-1] + (m_cap,),
                                        s_v, np.int32)
            image_targets = np.zeros(
                image_targets_idx.shape + (probs_list[0].shape[-1],),
                probs_list[0].dtype)
            image_targets_mask = np.zeros_like(image_mask)
        else:
            image_targets, image_targets_mask = unmasked_region_targets(
                np.stack(probs_list), image_mask)
        # AFTER the vision draws: np_rng order is vision-then-language
        instr_tokens, instr_mask, instr_targets, segment_ids = \
            self._instruction_fields(instr_tokens, nc)

        if self.training:
            ranking_target = np.int32(target)
        else:
            ranking_target = np.asarray(target, np.float32)

        image_features = image_features.astype(self.io_dtype, copy=False)
        targets = {} if image_targets is None else dict(
            image_targets=image_targets.astype(self.io_dtype, copy=False),
            **({"image_targets_idx": image_targets_idx}
               if image_targets_idx is not None else {}),
            image_targets_mask=image_targets_mask.astype(np.int32,
                                                         copy=False))
        return dict(
            ranking_target=ranking_target,
            image_features=image_features,
            image_locations=image_locations,
            image_mask=image_mask,
            **targets,
            instr_tokens=instr_tokens.astype(np.int32, copy=False),
            instr_mask=instr_mask,
            instr_targets=instr_targets.astype(np.int32, copy=False),
            segment_ids=segment_ids,
            opt_mask=np.ones((nc,), bool),
            ordering_target=np.zeros((0, self.args.max_path_length),
                                     np.int32),
            instr_id=instr_id,
        )
