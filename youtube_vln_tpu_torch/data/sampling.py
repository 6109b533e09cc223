"""Trajectory sampling and negative generation for pretraining.

Host-side Python mirroring the reference's sampling distributions
(``utils/dataset/common.py:363-857``):

  * positive path sampling from a video's key-frame trajectory (YTb,
    :683-762) and from Airbnb listings in/out-listing (:767-857)
  * three negative families x num_negatives each: shuffled captions,
    shuffled/replaced images (4 negative styles), random cross-video
    replacements (:401-575), plus the trajectory-judge variant that keeps
    caption order and permutes captionless frames (:431-464)
  * shufflers: any-permutation / one-swap / non-adjacent swap (:577-623)

All randomness uses a ``random.Random`` instance passed in (the reference
uses the global ``random``) so workers can be seeded independently.
"""
from __future__ import annotations

import copy
import itertools
import random as _random
from typing import Callable, Dict, Iterator, List, Sequence, Tuple, TypeVar, Union

T = TypeVar("T")

PhotoId = Union[int, Tuple[int, ...]]
Sample = Tuple[str, PhotoId]  # (listing/video id, photo/frame id)
Trajectory = List[Sample]


# --------------------------------------------------------------------------- #
# shufflers (reference common.py:577-623)
# --------------------------------------------------------------------------- #
def shuffle_different(seq: List[T], rng=_random) -> Iterator[List[T]]:
    """Distinct non-identity permutations in uniformly random order.

    The reference materializes all n! permutations and shuffles the list
    (common.py:577-584) — O(n!) time/memory per call even though callers
    take only num_negatives of them.  For n > 6 this draws Fisher-Yates
    permutations lazily instead with a seen-set; the first k yields have
    exactly the same distribution (uniform over distinct non-identity
    permutations), without the factorial blowup."""
    n = len(seq)
    if n <= 6:  # <= 720 perms: keep the exhaustive no-repeat behavior
        sequences = list(itertools.permutations(seq, len(seq)))
        rng.shuffle(sequences)
        for s in sequences:
            l = list(s)
            if l != seq:
                yield l
        return
    identity = tuple(range(n))
    seen = {identity}
    misses = 0
    while misses < 64:  # callers take ~num_negatives; collisions are rare
        p = list(range(n))
        rng.shuffle(p)
        t = tuple(p)
        if t in seen:
            misses += 1
            continue
        seen.add(t)
        yield [seq[i] for i in p]


def shuffle_two(seq: List[T], rng=_random) -> Iterator[List[T]]:
    n = len(seq)
    ij = list(itertools.permutations(range(n), 2))
    rng.shuffle(ij)
    for i, j in ij:
        out = list(seq)
        out[i], out[j] = out[j], out[i]
        yield out


def shuffle_non_adjacent(seq: List[T], rng=_random) -> Iterator[List[T]]:
    n = len(seq)
    candidates = {i: [j for j in range(n) if abs(j - i) > 1]
                  for i in range(n)}
    keys = list(candidates.keys())
    done: List[set] = []
    while keys:
        idx_keys, start = rng.choice(list(enumerate(keys)))
        idx_list, permute = rng.choice(list(enumerate(candidates[start])))
        del candidates[start][idx_list]
        if not candidates[start]:
            del keys[idx_keys]
        if {start, permute} in done:
            continue
        done.append({start, permute})
        out = list(seq)
        out[start], out[permute] = out[permute], out[start]
        yield out


SHUFFLERS: Dict[str, Callable] = {
    "different": shuffle_different,
    "nonadj": shuffle_non_adjacent,
    "two": shuffle_two,
}


def load_shuffler(name: str) -> Callable:
    try:
        return SHUFFLERS[name]
    except KeyError:
        raise ValueError(f"Unexpected shuffling mode ({name})")


# --------------------------------------------------------------------------- #
# helpers (reference common.py:363-399,859-889)
# --------------------------------------------------------------------------- #
def random_fill(captioned_idx: List[T], captionless_idx: List[T],
                seq: List[T], fillers: List[T], rng=_random) -> List[T]:
    """Insert fillers at random positions in seq; returns the order list of
    indices after insertion (reference :363-372)."""
    order = copy.deepcopy(captioned_idx)
    n = len(seq)
    rng.shuffle(fillers)
    for idx, x in enumerate(fillers):
        pos = rng.randint(0, n - 1)
        order.insert(pos, captionless_idx[idx])
        seq.insert(pos, x)
        n += 1
    return order


def random_caption_image(video_ids, frames_by_video, rng=_random):
    vid = rng.choice(video_ids)
    while True:
        frame = rng.choice(frames_by_video[vid])
        if frame["caption"] != "":
            return vid, frame["frame_id"]


def random_captionless_image(video_ids, frames_by_video, rng=_random):
    vid = rng.choice(video_ids)
    while True:
        frame = rng.choice(frames_by_video[vid])
        if frame["caption"] == "":
            return vid, frame["frame_id"]


def random_image(listing_ids, photos_by_listing, rng=_random):
    l = rng.choice(listing_ids)
    return l, rng.choice(photos_by_listing[l])


def is_captionless(photo_id: PhotoId, photo_id_to_caption: Dict) -> bool:
    """BnB heuristic: token-id sum below CLS+SEP+1 means no real caption
    (reference :395-399)."""
    if isinstance(photo_id, (list, tuple)):
        return all(is_captionless(p, photo_id_to_caption) for p in photo_id)
    return sum(photo_id_to_caption[photo_id]["instruction_tokens"][0]) < 204


def merge_images(captions) -> List[PhotoId]:
    return list({
        tuple(p["merging"]) if "merging" in p and len(p["merging"]) > 1
        else p["photo_id"]
        for p in captions
    })


def merge_frames(captions) -> List[PhotoId]:
    return list({
        tuple(p["merging"]) if "merging" in p and len(p["merging"]) > 1
        else (p["frame_id"],)
        for p in captions
    })


def ytb_key(video_id: str, frame_id: int) -> str:
    return f"{video_id}/%04d" % frame_id


def drop_small_listings(photos_by_listing: Dict, min_length: int) -> Dict:
    """reference _check_enough_images (common.py:625-634)."""
    return {k: v for k, v in photos_by_listing.items()
            if len(v) >= min_length}


# --------------------------------------------------------------------------- #
# positive trajectory generators
# --------------------------------------------------------------------------- #
def ytb_trajectory(video_id: str, frames_by_video: Dict,
                   key_trajectory: List[int], min_length=4, max_length=7,
                   min_captioned=2, max_captioned=7, rng=_random
                   ) -> Tuple[Trajectory, List[bool]]:
    """Sample a window of a video around captioned key frames
    (reference ytb_generate_trajectory_from_listing, common.py:683-762)."""
    frame_ids = merge_frames(frames_by_video[video_id])
    frame_ids = sorted(frame_ids, key=lambda x: x[0])
    all_candidates = [f[0] for f in frame_ids]
    frame_to_merge = {f[0]: f for f in frame_ids}

    if len(key_trajectory) < min_captioned:
        raise ValueError(f"Not enough captioned frames for {video_id}")
    if len(all_candidates) < min_length:
        raise ValueError(f"Not enough images for {video_id}")

    span = (all_candidates.index(key_trajectory[-1])
            - all_candidates.index(key_trajectory[0]))
    if span < min_length:
        # too few frames between key frames: top up with random others
        pool = list(all_candidates)
        chosen = all_candidates[
            all_candidates.index(key_trajectory[0]):
            all_candidates.index(key_trajectory[-1]) + 1]
        chosen = list(chosen)
        while len(chosen) < min_length:
            x = rng.choice(pool)
            if x in chosen:
                pool.remove(x)
                continue
            chosen.append(x)
        chosen.sort()
        traj = [(video_id, frame_to_merge[i]) for i in chosen]
        states = [t[1][0] in key_trajectory for t in traj]
        return traj, states

    while True:
        n_key = rng.randint(min_captioned,
                            min(max_captioned, len(key_trajectory)))
        start_key = rng.randint(0, len(key_trajectory) - n_key)
        start = key_trajectory[start_key]
        end = key_trajectory[start_key + n_key - 1]
        si = all_candidates.index(start)
        ei = all_candidates.index(end)
        if (ei - si + 1) >= min_length:
            path_len = rng.randint(max(n_key, min_length),
                                   min(ei - si + 1, max_length))
            break

    captioned, captionless = [], []
    for fid in all_candidates[si:ei + 1]:
        (captioned if fid in key_trajectory else captionless).append(fid)
    chosen = captioned + rng.sample(captionless, path_len - len(captioned))
    chosen.sort()
    traj = [(video_id, frame_to_merge[i]) for i in chosen]
    states = [t[1][0] in key_trajectory for t in traj]
    return traj, states


def bnb_trajectory_in_listing(listing_id, photos_by_listing,
                              photo_id_to_caption, min_length=4,
                              max_length=7, min_captioned=2, max_captioned=7,
                              rng=_random) -> Tuple[Trajectory, List[bool]]:
    """reference generate_trajectory_from_listing (common.py:806-857)."""
    photo_ids = copy.deepcopy(photos_by_listing[listing_id])
    candidates: Trajectory = [(listing_id, p) for p in photo_ids]
    rng.shuffle(candidates)

    path_len = rng.randint(min_length, min(max_length, len(candidates)))
    states = [not is_captionless(p, photo_id_to_caption)
              for _, p in candidates]
    captioned = [c for c, s in zip(candidates, states) if s]
    captionless = [c for c, s in zip(candidates, states) if not s]

    assert len(captioned) > 1, listing_id
    max_c = min(max_captioned, len(captioned), path_len)
    min_c = min(min_captioned, len(captioned), path_len)
    assert max_c >= min_c, (len(captioned), listing_id)
    n_cap = rng.randint(min_c, max_c)
    chosen = captioned[:n_cap]
    chosen_states = [True] * n_cap
    chosen += captionless[:path_len - n_cap]
    chosen_states += [False] * (len(chosen) - n_cap)
    extra = max(0, path_len - len(chosen))
    chosen += captioned[n_cap:n_cap + extra]
    chosen_states += [True] * extra

    paired = list(zip(chosen, chosen_states))
    rng.shuffle(paired)
    chosen, chosen_states = map(list, zip(*paired))
    return chosen, chosen_states


def bnb_trajectory_out_listing(listing_id, listing_ids, photos_by_listing,
                               photo_id_to_caption, min_length=4,
                               max_length=7, min_captioned=2, max_captioned=7,
                               rng=_random) -> Tuple[Trajectory, List[bool]]:
    """reference generate_trajectory_out_listing (common.py:767-804)."""
    path_len = rng.randint(min_length, max_length)
    n_cap = rng.randint(min(min_captioned, path_len),
                        min(max_captioned, path_len))
    assert n_cap > 1
    n_capless = path_len - n_cap

    captioned: Trajectory = []
    captionless: Trajectory = []
    while len(captioned) < n_cap or len(captionless) < n_capless:
        lid, pid = random_image(listing_ids, photos_by_listing, rng)
        if is_captionless(pid, photo_id_to_caption):
            if len(captionless) < n_capless:
                captionless.append((lid, pid))
        elif len(captioned) < n_cap:
            captioned.append((lid, pid))

    traj = captioned + captionless
    states = [True] * n_cap + [False] * n_capless
    paired = list(zip(traj, states))
    rng.shuffle(paired)
    traj, states = map(list, zip(*paired))
    return traj, states


# --------------------------------------------------------------------------- #
# negatives (reference common.py:401-575)
# --------------------------------------------------------------------------- #
def _take_shuffles(shuffler, base: List, count: int, rng) -> List[List]:
    out = [s for _, s in zip(range(count), shuffler(base, rng))]
    if out and len(out) < count:
        out = (out * (count // len(out)))[:count]
    return out


def _bounded_miss(misses: int, num_negatives: int) -> int:
    """Backstop for the judge retry loops: positive-colliding draws are
    possible but must not be CERTAIN (the captionless guard above rules
    out the provable case; this catches e.g. replacements that coincide
    with the originals).  The reference loops unboundedly."""
    misses += 1
    if misses > 200 * max(1, num_negatives):
        raise ValueError(
            "traj_judge negative sampling cannot escape the positive "
            f"trajectory after {misses} draws — the permutation/"
            "replacement space for this item is degenerate (the reference "
            "dataloader hangs forever here)")
    return misses


def generate_negatives(
    positive_path: Trajectory,
    states: Sequence[bool],
    room_ids: List,
    photos_by_room: Dict,
    photo_id_to_caption: Dict,
    num_negatives: int,
    shuffler: Callable,
    dataset_type: str,
    traj_judge: bool,
    negative_style: str,
    rng=_random,
):
    """Returns (neg_captions, neg_images, neg_randoms, order_labels)."""
    path_len = len(positive_path)
    captioned_idx = [i for i, s in enumerate(states) if s]
    captionless_idx = [i for i, s in enumerate(states) if not s]
    captionless_ids = [positive_path[i] for i in captionless_idx]
    normal_idx = list(range(path_len))
    cand = 2  # candidate multiplier (reference :428)

    if traj_judge:
        # keep captioned order, permute captionless positions (:431-443).
        # A fully-captioned positive makes BOTH judge loops below
        # unsatisfiable: with no captionless slots random_fill is a no-op,
        # traj == positive on every draw, and the reference's
        # while/continue spins FOREVER (common.py:435-461 — a
        # pass reproduced the hang on a fixture item).  Fail loudly
        # instead; documented safe-superset in MIGRATION.md.
        if not captionless_idx:
            raise ValueError(
                "traj_judge negatives permute/replace CAPTIONLESS frames, "
                "but this positive trajectory has none (all "
                f"{len(captioned_idx)} frames captioned) — no distinct "
                "negative exists and the reference dataloader hangs "
                "forever here; lower --max_captioned below "
                "--max_path_length or disable --traj_judge")
        neg_captions_idx: List[List[int]] = []
        neg_captions: List[Trajectory] = []
        misses = 0
        while len(neg_captions) < num_negatives:
            traj = [positive_path[i] for i in captioned_idx]
            order = random_fill(captioned_idx, captionless_idx, traj,
                                list(captionless_ids), rng)
            if traj == positive_path:
                misses = _bounded_miss(misses, num_negatives)
                continue
            neg_captions_idx.append(order)
            neg_captions.append(traj)

        # captionless replaced from other videos/listings (:444-464)
        replacements = []
        for _ in captionless_idx:
            if dataset_type == "ytb":
                replacements.append(random_captionless_image(
                    room_ids, photos_by_room, rng))
            else:
                lid, pid = random_image(room_ids, photos_by_room, rng)
                while not is_captionless(pid, photo_id_to_caption):
                    lid, pid = random_image(room_ids, photos_by_room, rng)
                replacements.append((lid, pid))
        neg_randoms: List[Trajectory] = []
        misses = 0
        while len(neg_randoms) < num_negatives:
            traj = [positive_path[i] for i in captioned_idx]
            random_fill(captioned_idx, captionless_idx, traj,
                        list(replacements), rng)
            if traj == positive_path:
                misses = _bounded_miss(misses, num_negatives)
                continue
            neg_randoms.append(traj)
    else:
        # shuffled caption order (:466-482)
        shuffles = _take_shuffles(shuffler, captioned_idx,
                                  num_negatives * cand, rng)
        neg_captions_idx = []
        neg_captions = []
        for _ in range(num_negatives):
            pick = rng.choice(shuffles)
            shuffles.remove(pick)
            traj = [positive_path[i] for i in pick]
            neg_captions_idx.append(random_fill(
                pick, captionless_idx, traj, list(captionless_ids), rng))
            neg_captions.append(traj)

        # random replacement of 1..path_len-1 positions with captioned
        # images from elsewhere (:484-507)
        n_flip = rng.randint(1, path_len - 1)
        flip_idx = list(range(path_len))
        rng.shuffle(flip_idx)
        flip_idx = flip_idx[:n_flip]
        neg_randoms = []
        for _ in range(num_negatives):
            traj = []
            for i in range(path_len):
                if i in flip_idx:
                    if dataset_type == "ytb":
                        traj.append(random_caption_image(
                            room_ids, photos_by_room, rng))
                    else:
                        lid, pid = random_image(room_ids, photos_by_room, rng)
                        while is_captionless(pid, photo_id_to_caption):
                            lid, pid = random_image(room_ids, photos_by_room,
                                                    rng)
                        traj.append((lid, pid))
                else:
                    traj.append(positive_path[i])
            neg_randoms.append(traj)

    # image-order negatives, per style (:509-567)
    if negative_style == "normal":
        shuffles = _take_shuffles(shuffler, normal_idx,
                                  num_negatives * cand, rng)
        neg_images_idx: List[List[int]] = []
        neg_images: List[Trajectory] = []
        for _ in range(num_negatives):
            pick = rng.choice(shuffles)
            shuffles.remove(pick)
            neg_images_idx.append(pick)
            neg_images.append([positive_path[i] for i in pick])
    elif negative_style == "shuffle_instruction":
        shuffles = _take_shuffles(shuffler, captioned_idx,
                                  num_negatives * cand, rng)
        neg_images_idx = []
        neg_images = []
        for _ in range(num_negatives):
            pick = rng.choice(shuffles)
            shuffles.remove(pick)
            traj = [positive_path[i] for i in pick]
            neg_images_idx.append(random_fill(
                pick, captionless_idx, traj, list(captionless_ids), rng))
            neg_images.append(traj)
    elif negative_style in ("another_path", "another_destination"):
        neg_images_idx = []
        neg_images = []
        while len(neg_images) < num_negatives:
            traj = [positive_path[0]]
            idx, pool = [], []
            for fr in photos_by_room[positive_path[0][0]]:
                idx.append(fr["frame_id"])
                pool.append((positive_path[0][0], tuple(fr["merging"])
                             if "merging" in fr and len(fr["merging"]) > 1
                             else (fr["frame_id"],)))
            current = idx.index(positive_path[0][1][0])
            if len(idx) - current < path_len:
                for _ in range(num_negatives):
                    neg_images_idx.append(normal_idx)
                    neg_images.append(sorted(rng.sample(pool, path_len),
                                             key=lambda x: x[1][0]))
                break
            traj += sorted(rng.sample(pool[current + 1:], path_len - 1),
                           key=lambda x: x[1][0])
            if traj != positive_path and (
                    negative_style == "another_path"
                    or positive_path[-1] != traj[-1]):
                neg_images_idx.append(normal_idx)
                neg_images.append(traj)
    else:
        raise NotImplementedError(negative_style)

    order_labels = {
        "normal_idx": normal_idx,
        "negative_captions_idx": neg_captions_idx,
        "negative_images_idx": neg_images_idx,
    }
    return neg_captions, neg_images, neg_randoms, order_labels
