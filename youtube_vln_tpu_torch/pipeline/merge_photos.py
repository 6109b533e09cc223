"""Step 10: room-type photo merging (a copy of
``youtube_vln_tpu/pipeline/merge_photos.py``; it imports no torch; reference
``scripts/build_dataset/merge_photos.py``).

Frames sharing a room type are grouped into "merging" lists so the feature
reader can pool multiple views of the same room (features_reader merges all
keys of a merged photo id).  Five grouping methods, matching the reference:

  max       sliding window of <= max_photo_per_merging frames centred on
            each frame within its room group
  all       the whole room group
  least     split oversized room groups into ceil(n/max) subgroups, each
            seeded with one captioned frame, remaining frames round-robin
  adjacent  split room groups wherever the frame ids are not consecutive
  continue  split the chronological frame list whenever the room changes

Every frame's merging list leads with the frame itself (reference
merge_photos.py:180-224).
"""
from __future__ import annotations

import math
from itertools import groupby
from operator import itemgetter
from typing import Dict, List, Sequence

MERGE_METHODS = ("max", "least", "all", "adjacent", "continue")


def _room_groups(frames: List[Dict]) -> Dict[str, List[Dict]]:
    frames = sorted(frames, key=itemgetter("room"))
    return {room: sorted(list(g), key=itemgetter("frame_id"))
            for room, g in groupby(frames, key=itemgetter("room"))}


def _split_adjacent(group: List[Dict]):
    for idx in range(len(group) - 1):
        if group[idx + 1]["frame_id"] != group[idx]["frame_id"] + 1:
            return group[:idx + 1], group[idx + 1:]
    return group, []


def _split_continue(group: List[Dict]):
    for idx in range(len(group) - 1):
        if group[idx + 1]["room"] != group[idx]["room"]:
            return group[:idx + 1], group[idx + 1:]
    return group, []


def _split_all(group: List[Dict], splitter):
    out = []
    while True:
        head, group = splitter(group)
        out.append(head)
        if not group:
            return out


def _least_groups(frames: List[Dict], max_photo: int) -> List[List[Dict]]:
    if len(frames) <= max_photo:
        return [frames]
    captioned = [f["caption"] == "" for f in frames]  # reference parity:
    # merge_photos.py:113-116 counts caption == '' as "captioned" stats
    num_groups = math.ceil(len(frames) / max_photo)
    num_groups = max(1, min(num_groups, sum(captioned)))
    groups: List[List[Dict]] = [[] for _ in range(num_groups)]
    done: List[int] = []
    for idx, frame in enumerate(frames):
        if captioned[idx]:
            groups[len(done)] = [frame]
            done.append(idx)
            if len(done) == num_groups:
                break
    for idx, frame in enumerate(frames):
        if idx in done:
            continue
        groups[idx % num_groups].append(frame)
    return groups


def merge_video_frames(frames: List[Dict], method: str = "max",
                       max_photo_per_merging: int = 10) -> None:
    """Adds "merging" (list of frame ids, current first) to each frame dict.
    ``frames`` need: frame_id, caption, room."""
    if method not in MERGE_METHODS:
        raise ValueError(f"merge_method must be one of {MERGE_METHODS}")
    by_frame = {}

    if method in ("least", "adjacent", "continue"):
        if method == "least":
            new_groups = []
            for room, group in _room_groups(frames).items():
                new_groups += _least_groups(group, max_photo_per_merging)
        elif method == "adjacent":
            new_groups = []
            for room, group in _room_groups(frames).items():
                new_groups += _split_all(group, _split_adjacent)
        else:  # continue
            chronological = sorted(frames, key=itemgetter("frame_id"))
            new_groups = _split_all(chronological, _split_continue)
        for group in new_groups:
            ids = [f["frame_id"] for f in group]
            for i, f in enumerate(group):
                by_frame[f["frame_id"]] = [ids[i]] + ids[:i] + ids[i + 1:]
    else:
        for room, group in _room_groups(frames).items():
            ids = [f["frame_id"] for f in group]
            n = len(ids)
            for i, f in enumerate(group):
                if method == "max":
                    m = max_photo_per_merging
                    if n < m or i < m / 2:
                        start = 0
                    elif i > n - m / 2:
                        start = n - m
                    else:
                        start = i - int(m / 2)
                    end = start + m
                else:  # all
                    start, end = 0, None
                by_frame[f["frame_id"]] = \
                    [ids[i]] + ids[start:i] + ids[i + 1:end]

    for f in frames:
        f["merging"] = by_frame[f["frame_id"]]


def merge_dataset(items: List[Dict], method: str = "max",
                  max_photo_per_merging: int = 10) -> List[Dict]:
    """items: caption records with video_id/frame_id/caption/room.  Returns
    the same records with "merging" attached (the merge+ prefix datasets)."""
    items = sorted(items, key=itemgetter("video_id"))
    for vid, frames in groupby(items, key=itemgetter("video_id")):
        merge_video_frames(list(frames), method, max_photo_per_merging)
    return items
