"""Step 9: assemble the pretraining JSONs and freeze the eval testset (a copy
of ``youtube_vln_tpu/pipeline/build_dataset.py``; it imports no torch).

Reference ``scripts/build_dataset/{build_dataset,preprocess_dataset,
build_testset}.py``: caption + action + filter artifacts become
``ytb_train.json`` / ``ytb_test.json`` (records with video_id / frame_id /
caption / action), split by video at ``test_rate``; eval negatives are
frozen into ``testset.json`` by running the live samplers once
(build_testset.py:60-130 reuses the common.py generators the same way).
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from . import filters as F


def assemble_records(video_ids: Sequence[str],
                     captions_by_video: Dict[str, Dict[str, List[str]]],
                     actions_by_video: Dict[str, Dict[int, str]],
                     indoor_by_video: Optional[Dict[str, List[int]]] = None,
                     maskrcnn_by_video: Optional[Dict[str, Dict]] = None,
                     trajectory_by_video: Optional[Dict[str, List[int]]]
                     = None,
                     feature_errors_by_video:
                     Optional[Dict[str, Sequence[int]]] = None,
                     trim_by_video: Optional[Dict[str, Dict[str, int]]]
                     = None,
                     ) -> List[Dict]:
    """One record per surviving frame (reference build_dataset.py:178-195).

    captions_by_video:   vid -> {"%04d.jpg": [caption, ...]}
                         (captions_SE.json; only element [0] is read)
    actions_by_video:    vid -> {frame_id: action word} (inverse model
                         output — trajectory frames EXCEPT the last)
    trajectory_by_video: vid -> ordered keyframe ids (trajectory.json).
                         Keyframe membership is decided by the TRAJECTORY,
                         not the action dict: the last trajectory frame has
                         no outgoing action yet keeps its caption with
                         action "" (the reference's `frame == trajectory
                         [-1]` branch).  Non-keyframes get caption "" AND
                         action "" — not "forward" (an r5 review finding:
                         both wrongs changed min_caption filtering,
                         instruction content, and MLM text vs a
                         reference-built ytb_train.json).  Defaults to the
                         action keys + their successors being unknowable,
                         so callers must pass it; None falls back to
                         treating action-dict keys as the keyframes WITH a
                         final captioned keyframe unavailable (legacy
                         fixture behavior, kept for inputs that never had
                         a trajectory file).
    feature_errors_by_video: vid -> frame ids listed in the extractor's
                         error TSV (reference build_dataset.py:124-130,
                         ``--feature total-error.tsv``); dropped.
    trim_by_video:       vid -> {"front": f, "back": b} manual trimming
                         (reference's filter_frame hook,
                         build_dataset.py:136-153): drop frames <= front
                         and >= back; negative values wrap by
                         n_frames+1; 0 disables that side.
    """
    records = []
    for vid in video_ids:
        caps = captions_by_video[vid]
        actions = actions_by_video.get(vid, {})
        traj = (trajectory_by_video or {}).get(vid)
        keyframes = set(traj) if traj is not None else set(actions)
        last = traj[-1] if traj else None
        feat_errors = set((feature_errors_by_video or {}).get(vid, ()))
        trim = (trim_by_video or {}).get(vid, {})
        front, back = trim.get("front", 0), trim.get("back", 0)
        if front < 0:
            front += len(caps) + 1
        if back < 0:
            back += len(caps) + 1
        for name, cap_list in sorted(caps.items()):
            fid = int(name.split(".")[0])
            caption = cap_list[0]
            if front != 0 and fid <= front:
                continue
            if back != 0 and fid >= back:
                continue
            if fid in feat_errors:
                continue
            if not F.frame_passes(
                    fid,
                    indoor_resnet=(indoor_by_video or {}).get(vid),
                    maskrcnn=(maskrcnn_by_video or {}).get(vid),
                    caption=caption):
                continue
            keyframe = fid in keyframes
            records.append({
                "video_id": vid,
                "frame_id": fid,
                "caption": caption if keyframe else "",
                "action": ("" if fid == last or not keyframe
                           else actions.get(fid, "")),
            })
    return records


def load_frames_tsv(path) -> List[Dict]:
    """video_id/frame_id/caption/action TSV -> record dicts
    (reference preprocess_dataset.py:44-57)."""
    import csv
    with open(path, newline="") as fid:
        reader = csv.DictReader(
            fid, delimiter="\t",
            fieldnames=["video_id", "frame_id", "caption", "action"])
        return [{"video_id": r["video_id"], "frame_id": int(r["frame_id"]),
                 "caption": r["caption"], "action": r["action"]}
                for r in reader]


def preprocess_records(frames: List[Dict], *, min_caption: int = 2,
                       min_length: int = 4, captionless: bool = True
                       ) -> Dict[str, List[Dict]]:
    """Reference preprocess_dataset.py:60-80: optionally drop captionless
    frames, group by video, and keep only videos with >= min_caption
    captioned frames and >= min_length frames total.  Returns
    {video_id: [records]} in frame order."""
    from itertools import groupby
    from operator import itemgetter

    if not captionless:
        frames = [f for f in frames if f["caption"] != ""]
    frames = sorted(frames, key=itemgetter("video_id"))
    by_video = {vid: list(items) for vid, items in
                groupby(frames, key=itemgetter("video_id"))}
    return {
        vid: items for vid, items in by_video.items()
        if sum(f["caption"] != "" for f in items) >= min_caption
        and len(items) >= min_length
    }


def write_preprocessed(by_video: Dict[str, List[Dict]], location, name: str):
    """{name}.json (flattened records) + {name}-videos.txt
    (reference preprocess_dataset.py:82-86)."""
    location = Path(location)
    location.mkdir(parents=True, exist_ok=True)
    flat = [r for items in by_video.values() for r in items]
    json_path = location / f"{name}.json"
    with open(json_path, "w") as f:
        json.dump(flat, f, indent=2)
    txt_path = location / f"{name}-videos.txt"
    with open(txt_path, "w") as f:
        for vid in by_video:
            print(vid, file=f)
    return json_path, txt_path


def split_train_test(records: List[Dict], test_rate: float = 0.05,
                     seed: int = 0):
    """Split by video (the reference splits at video granularity)."""
    videos = sorted({r["video_id"] for r in records})
    rng = random.Random(seed)
    rng.shuffle(videos)
    n_test = max(1, int(len(videos) * test_rate)) if len(videos) > 1 else 0
    test_videos = set(videos[:n_test])
    train = [r for r in records if r["video_id"] not in test_videos]
    test = [r for r in records if r["video_id"] in test_videos]
    return train, test


def write_dataset(records: List[Dict], path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(records, f)
    return path


def freeze_testset(dataset, out_path) -> Path:
    """Run the live samplers once per listing and freeze the result
    (reference build_testset.py).  ``dataset`` is a training-mode
    YTbDataset/BnBDataset."""
    testset = {}
    for listing_id in dataset.listing_ids:
        pos, negc, negi, negr, order = dataset.pick_photo_ids(listing_id)
        testset[listing_id] = [pos, negc, negi, negr, order]
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(testset, f)
    return out_path
