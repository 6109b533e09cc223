"""Instruction synthesis and tokenization caching.

Reference behavior mirrored:
  * CLS/SEP/PAD framing to max_instruction_length with a JSON side-cache
    named ``{stem}_tokenized_{len}.json`` (``utils/dataset/common.py:114-210``)
  * ConcatenateInstructionGenerator: caption concat with separator choice and
    per-caption length budget (:1022-1079)
  * RephraseInstructionGenerator: fill R2R skeleton noun-phrase slots
    (:979-1020)
  * YTBRephraseInstructionGenerator: fill [MASK]/[OMASK] template slots with
    captions + direction words, reusing one template across the candidates
    of a sample (:1081-1124 + scripts/video_process/
    gen_instructions4train.py:37-139)
"""
from __future__ import annotations

import json
import random as _random
import re
from itertools import groupby
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .sampling import is_captionless, ytb_key

PathLike = Union[str, Path]


def load_json(path: PathLike):
    with open(path, "r") as f:
        return json.load(f)


def save_json(data, path: PathLike):
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


# --------------------------------------------------------------------------- #
# tokenization + caching
# --------------------------------------------------------------------------- #
def frame_tokens(tokenizer, instruction: str, max_len: int) -> List[int]:
    """[CLS] tokens [SEP] padded to max_len (reference common.py:128-138)."""
    pad, cls, sep = tokenizer.convert_tokens_to_ids(["[PAD]", "[CLS]", "[SEP]"])
    ids = [cls] + tokenizer.convert_tokens_to_ids(
        tokenizer.tokenize(instruction))
    ids = ids[: max_len - 1] + [sep]
    return ids + [pad] * (max_len - len(ids))


def _subseq_index(needle: List[int], haystack: List[int]) -> int:
    """First start index of needle as a contiguous run in haystack, or -1."""
    n, m = len(haystack), len(needle)
    for i in range(n - m + 1):
        if haystack[i:i + m] == needle:
            return i
    return -1


def highlight_mask(tokenizer, words: Sequence[str], token_ids: List[int],
                   max_len: int) -> List[bool]:
    """Token-aligned highlight mask (reference common.py:140-158).

    Scans left to right: each highlight word is wordpiece-tokenized and
    located as a contiguous id run at or after the cursor; words that don't
    appear are skipped.  Positions up to and including each match flip the
    matched span to True; the mask is False-padded to max_len.  token_ids
    is the framed [CLS]..[SEP][PAD]* row — no real word tokenizes to the
    pad id, so searching the padded row equals the reference's unpadded
    search.
    """
    mask: List[bool] = []
    cursor = 0
    for word in words:
        ids = tokenizer.convert_tokens_to_ids(tokenizer.tokenize(word))
        at = _subseq_index(ids, token_ids[cursor:])
        if at == -1:
            continue
        mask += [False] * at + [True] * len(ids)
        cursor += at + len(ids)
    return mask + [False] * (max_len - len(mask))


def tokenize_dataset(data: List[Dict], tokenizer, max_len: int) -> None:
    """In-place tokenization of {"instructions": [...]} items.

    Mirrors reference tokenize() (common.py:114-192) including the optional
    variants, produced only when the source JSON carries the fields (inert
    in every published Lily recipe, see SURVEY.md §6):
      * "highlights"             -> "instruction_highlights" bool masks
      * "perturbations"          -> "perturbation_tokens" framed id rows
      * "perturbation_highlights"-> "perturbation_highlight_masks"
    """
    for item in data:
        item["instruction_tokens"] = []
        if "highlights" in item:
            item["instruction_highlights"] = []
        if "perturbations" in item:
            item["perturbation_tokens"] = [[] for _ in item["instructions"]]
        if "perturbation_highlights" in item:
            item["perturbation_highlight_masks"] = [
                [] for _ in item["instructions"]]

        for i, instr in enumerate(item["instructions"]):
            tokens = frame_tokens(tokenizer, instr, max_len)
            item["instruction_tokens"].append(tokens)
            if "highlights" in item:
                item["instruction_highlights"].append(
                    highlight_mask(tokenizer, item["highlights"][i], tokens,
                                   max_len))
            if "perturbations" in item:
                for j, perturbed in enumerate(item["perturbations"][i]):
                    ptokens = frame_tokens(tokenizer, perturbed, max_len)
                    item["perturbation_tokens"][i].append(ptokens)
                    if "perturbation_highlights" in item:
                        item["perturbation_highlight_masks"][i].append(
                            highlight_mask(
                                tokenizer,
                                item["perturbation_highlights"][i][j],
                                ptokens, max_len))


def load_tokens(path: PathLike, tokenizer, max_len: int) -> List[Dict]:
    """Tokenize with the reference's side-cache naming (common.py:193-210)."""
    p = Path(path)
    assert p.suffix == ".json", p
    cache = p.parent / f"{p.stem}_tokenized_{max_len}{p.suffix}"
    if cache.is_file():
        return load_json(cache)
    data = load_json(p)
    tokenize_dataset(data, tokenizer, max_len)
    try:
        save_json(data, cache)
    except OSError:
        pass  # read-only data dir: skip the cache
    return data


def ytb_load_tokens(path: PathLike, tokenizer) -> List[Dict]:
    """YTb variant: unpadded [CLS]+tokens, cache ``{stem}_tokenized_.json``
    (reference common.py:328-361)."""
    p = Path(path)
    assert p.suffix == ".json", p
    cache = p.parent / f"{p.stem}_tokenized_{p.suffix}"
    if cache.is_file():
        return load_json(cache)
    data = load_json(p)
    cls = tokenizer.convert_tokens_to_ids("[CLS]")
    for item in data:
        item["instruction_tokens"] = [
            [cls] + tokenizer.convert_tokens_to_ids(tokenizer.tokenize(t))
            for t in item["instructions"]
        ]
    try:
        save_json(data, cache)
    except OSError:
        pass
    return data


# --------------------------------------------------------------------------- #
# template machinery for the YTb generator
# --------------------------------------------------------------------------- #
_PUNCT_RE = re.compile(r"([.,!?:()])")


def _split_template(instr: str) -> List[str]:
    return _PUNCT_RE.sub(r" \1", instr).split(" ")


def index_templates(templates: List[Dict]) -> Tuple[List[List[int]], List[str]]:
    """Group template indices by their '{n_mask}_{n_omask}' signature
    (reference sort_skeletons, common.py:652-673)."""
    sig_names: List[str] = []
    sig_indices: List[List[int]] = [[] for _ in range(200)]
    for i, t in enumerate(templates):
        words = _split_template(t["instructions"][0])
        sig = f"{words.count('[MASK]')}_{words.count('[OMASK]')}"
        if sig not in sig_names:
            sig_names.append(sig)
        sig_indices[sig_names.index(sig)].append(i)
    return sig_indices, sig_names


def fill_template(captions: List[str], directions: List[List[str]],
                  templates: List[Dict], sig_indices, sig_names,
                  template: Optional[str] = None, rng=_random
                  ) -> Optional[Tuple[str, str]]:
    """Fill [MASK] slots with caption fragments and [OMASK] slots with
    direction words (reference run_insertion,
    gen_instructions4train.py:37-139).  Returns (sentence, template) or
    None when no template matches the (captions, directions) counts."""
    sig = f"{len(captions)}_{len(directions)}"
    if sig not in sig_names:
        return None
    if template is None:
        template = templates[rng.choice(
            sig_indices[sig_names.index(sig)])]["instructions"][0]
    words = _split_template(template)

    mask_indexes = None
    viewpoint_indexes: List[int] = []
    if "[MASK]" in words:
        cap_words = []
        for i, cap in enumerate(captions):
            room, obj = cap.split(" with ")
            cap_words.append(rng.sample([cap, room, obj], 1)[0])
            viewpoint_indexes.append(i + 1)
        mask_indexes = [i for i, w in enumerate(words) if w == "[MASK]"]
        for i, idx in enumerate(mask_indexes):
            words[idx] = cap_words[i]
        if len(captions) > len(directions):
            mask_indexes = mask_indexes[: len(directions)]

    omask_indexes = [i for i, w in enumerate(words) if w == "[OMASK]"]
    if omask_indexes:
        if mask_indexes is not None:
            i = 0
            for idx in omask_indexes:
                while i < len(mask_indexes) and mask_indexes[i] < idx:
                    i += 1
                curr_view = (viewpoint_indexes[i] if i < len(mask_indexes)
                             else viewpoint_indexes[i - 1])
                dirs = directions[curr_view - 1] if curr_view - 1 >= 0 \
                    else directions[curr_view]
                words[idx] = _pick_direction(words, idx, dirs, rng)
        else:
            if len(omask_indexes) < len(viewpoint_indexes):
                sample_idx = sorted(rng.sample(viewpoint_indexes,
                                               len(omask_indexes)))
            else:
                omask_indexes = sorted(rng.sample(omask_indexes,
                                                  len(viewpoint_indexes)))
                sample_idx = viewpoint_indexes
            for i, idx in enumerate(omask_indexes):
                curr_view = sample_idx[i]
                while curr_view > len(directions):
                    curr_view -= 1
                dirs = directions[curr_view - 1] if curr_view - 1 >= 0 \
                    else directions[curr_view]
                words[idx] = _pick_direction(words, idx, dirs, rng,
                                             rewrite_turn=False)
    return " ".join(words), template


def _pick_direction(words, idx, dirs, rng, rewrite_turn=True) -> str:
    """Direction-word choice incl. the 'turn forward' -> 'go forward' rewrite
    (gen_instructions4train.py:93-108)."""
    if "around" in dirs:
        return "around"
    if idx - 1 >= 0 and words[idx - 1] in ("turn", "Turn"):
        for w in dirs:
            if w != "forward":
                return w
        if rewrite_turn:
            words[idx - 1] = "go" if words[idx - 1] == "turn" else "Go"
        return rng.choice(dirs)
    return rng.choice(dirs)


# --------------------------------------------------------------------------- #
# generators
# --------------------------------------------------------------------------- #
class InstructionGenerator:
    """Base: tokenizer + separators + caption lookup
    (reference common.py:946-977)."""

    def __init__(self, tokenizer, separators: Sequence[str],
                 photo_id_to_caption: Dict, max_instruction_length: int,
                 rng=_random):
        self.tok = tokenizer
        self._cls, self._pad, self._sep = tokenizer.convert_tokens_to_ids(
            ["[CLS]", "[PAD]", "[SEP]"])
        if separators:
            self._separators = list(
                tokenizer.convert_tokens_to_ids(list(separators)))
        else:
            self._separators = [self._sep]
        self.max_len = max_instruction_length
        self.captions = photo_id_to_caption
        self.rng = rng

    def _strip_special(self, tokens: List[int]) -> List[int]:
        end = tokens.index(self._pad) - 1 if self._pad in tokens \
            else len(tokens)
        while tokens[end - 1] in self._separators:
            end -= 1
            if end < 0:
                raise ValueError(f"Issue with tokens {tokens}")
        return tokens[1:end]

    def _caption_tokens(self, photo_id) -> List[int]:
        """Merged-photo caption choice by Places365 weights
        (reference get_caption, common.py:892-917)."""
        if isinstance(photo_id, (tuple, list)):
            if not photo_id:
                raise ValueError("empty photo id")
            pid = None
            for pid in photo_id:
                if pid in self.captions:
                    break
            if pid is None:
                return []
            cands = list(self.captions[pid]["merging"])
            weights = list(self.captions[pid]["weights"])
            for i, c in enumerate(cands):
                if c not in self.captions or is_captionless(c, self.captions):
                    weights[i] = 0
            photo_id = int(self.rng.choices(cands, weights=weights)[0])
        return self.captions[photo_id]["instruction_tokens"][0]

    def __call__(self, trajectory):
        raise NotImplementedError


class ConcatenateInstructionGenerator(InstructionGenerator):
    """Join captions with separators under a length budget
    (reference common.py:1022-1079)."""

    def _sep_choice(self) -> List[int]:
        s = self.rng.choice(self._separators)
        return [s] if s is not None else []

    def __call__(self, trajectory) -> List[int]:
        captions = []
        for _, photo_id in trajectory:
            if is_captionless(photo_id, self.captions):
                continue
            captions.append(self._strip_special(
                self._caption_tokens(photo_id)))

        credit = self.max_len - 1 - len(captions)
        quota = credit // len(captions)
        over_ids, over_lens = [], []
        for i, cap in enumerate(captions):
            if len(cap) > quota:
                over_ids.append(i)
                over_lens.append(len(cap))
            else:
                credit -= len(cap)
        if over_ids:
            over_lens, over_ids = zip(*sorted(zip(over_lens, over_ids)))
            over_ids = list(over_ids)
            for i, idx in enumerate(over_ids):
                n = credit // len(over_ids[i:])
                captions[idx] = captions[idx][:n]
                credit -= len(captions[idx])
                assert credit >= 0

        out = [self._cls]
        for i, cap in enumerate(captions):
            out += cap
            if i < len(captions) - 1:
                out += self._sep_choice()
        out += [self._sep]
        out += [self._pad] * (self.max_len - len(out))
        return out


class RephraseInstructionGenerator(InstructionGenerator):
    """Fill R2R skeleton noun-phrase slots with BnB captions
    (reference common.py:979-1020; skeleton loader :919-941)."""

    def __init__(self, skeleton_path: PathLike, *args, **kwargs):
        super().__init__(*args, **kwargs)
        raw = load_tokens(skeleton_path, self.tok, self.max_len)
        flat = []
        for sk in raw:
            for i, _ in enumerate(sk["instructions"]):
                flat.append({
                    "np": sk["np"][i],
                    "instruction_tokens": sk["instruction_tokens"][i],
                })
        flat.sort(key=lambda s: sum(s["np"]))
        self.by_length = {
            n: list(g) for n, g in groupby(flat, key=lambda s: sum(s["np"]))
        }

    def __call__(self, trajectory) -> List[int]:
        captions = []
        for _, photo_id in trajectory:
            if is_captionless(photo_id, self.captions):
                continue
            captions.append(self._strip_special(
                self._caption_tokens(photo_id)))

        skeleton = self.rng.choice(self.by_length[len(captions)])
        sentence: List[int] = []
        counter = 0
        for np_flag, token in zip(skeleton["np"],
                                  skeleton["instruction_tokens"]):
            if np_flag:
                sentence += captions[counter]
                counter += 1
            else:
                sentence += [token]
        sentence = sentence[: self.max_len - 1]
        sentence += [self._sep]
        sentence += [self._pad] * (self.max_len - len(sentence))
        return sentence


class YTBRephraseInstructionGenerator(InstructionGenerator):
    """Template fill with YTb captions + inverse-action directions
    (reference common.py:1081-1124)."""

    def __init__(self, skeleton_path: PathLike, random_action: bool,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.random_action = random_action
        raw = ytb_load_tokens(skeleton_path, self.tok)
        self.templates = [t for t in raw
                          if len(t["instruction_tokens"][0]) <= 60]
        self.sig_indices, self.sig_names = index_templates(self.templates)

    def __call__(self, trajectory, template=None) -> Tuple[List[int], str]:
        captions: List[str] = []
        directions: List[List[str]] = []
        for vid, fid in trajectory:
            frame = self.captions[ytb_key(vid, fid[0])]
            if frame["caption"] == "":
                continue
            action = frame["action"]
            if self.random_action:
                action = self.rng.choice(["forward", "left", "right"])
            captions.append(frame["caption"])
            directions.append([action])
        directions = directions[:-1]  # last frame needs no outgoing action

        filled = fill_template(captions, directions, self.templates,
                               self.sig_indices, self.sig_names, template,
                               self.rng)
        if filled is None:
            raise ValueError(
                f"no template with {len(captions)} captions / "
                f"{len(directions)} directions")
        sentence, template = filled
        ids = [self._cls] + self.tok.convert_tokens_to_ids(
            self.tok.tokenize(sentence))
        ids = ids[: self.max_len - 1]
        ids += [self._sep]
        ids += [self._pad] * (self.max_len - len(ids))
        return ids, template
