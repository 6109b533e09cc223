"""Step 5: indoor / person frame filters (counterpart of
``youtube_vln_tpu/pipeline/filters.py``).

The reference runs two filter models offline — a WideResNet-18 Places365
indoor/outdoor classifier (``filter_outdoor_resnet_place365.py``) and a
Mask-RCNN person detector (``filter_outdoor_maskrcnn_coco.py``) — and later
drops frames that fail either filter plus CLIP-caption 'person' frames
(``build_dataset.py``).  The decision logic and the artifact writers are
copies of the JAX module's numpy code; the drivers run the port's models
(``places365.py``, ``maskrcnn.py``) on ``device``, CUDA unless the caller
asks for the CPU.  The module imports no torch itself: the drivers import
the models when called, so the host-only ``build_dataset`` can use
``frame_passes``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

# Places365 indoor/outdoor: the reference keeps a frame when the classifier
# votes indoor (io <= the indoor/outdoor boundary).  Scorers here return
# P(indoor) directly.
INDOOR_THRESHOLD = 0.5


def indoor_filter(frames: Sequence[int], indoor_scores: Sequence[float],
                  threshold: float = INDOOR_THRESHOLD) -> List[int]:
    """Frames KEPT as indoor: score > threshold STRICTLY.  The score is
    1 - io_image, so this is the reference's ``io_image < 0.5`` vote
    (filter_outdoor_resnet_place365.py:203-206); io_image is a mean of 10
    binary labels, so the == 0.5 boundary is reachable (a 5/5 top-10
    vote) and the reference REJECTS it — a >= here silently kept it."""
    return [f for f, s in zip(frames, indoor_scores) if s > threshold]


def person_filter(frames: Sequence[int], person_scores: Sequence[float],
                  threshold: float = 0.5) -> List[int]:
    """Frames REJECTED for containing people."""
    return [f for f, s in zip(frames, person_scores) if s >= threshold]


def indoor_probability(class_probs: np.ndarray, is_indoor_class: np.ndarray,
                       top_k: int = 10) -> float:
    """Reference ``classify_indoors``
    (filter_outdoor_maskrcnn_coco.py:128-137): the summed probability of
    the indoor scene categories among the top-k classes.

    class_probs: [C] softmax scene probabilities; is_indoor_class: [C]
    bool/0-1 (their ``io_dict``: 2 - IO_places365 label)."""
    idx = np.argsort(-class_probs)[:top_k]
    return float(np.sum(class_probs[idx] * (np.asarray(
        is_indoor_class)[idx] > 0)))


def gaussian_smooth_round(values: Sequence[float], sigma: float = 6.0
                          ) -> np.ndarray:
    """Temporal smoothing of the per-frame indoor probabilities
    (filter_outdoor_maskrcnn_coco.py:151-152): gaussian_filter1d then
    round to a 0/1 decision per frame."""
    from scipy.ndimage import gaussian_filter1d
    sm = gaussian_filter1d(np.asarray(values, np.float64), sigma=sigma)
    return np.array([round(v) for v in sm])


def smooth_window_round(values: Sequence[float], window: int = 6
                        ) -> np.ndarray:
    """Reference ``smooth`` (filter_outdoor_maskrcnn_coco.py:120-125):
    in-place rolling-mean rounding of the person flags (faithful to the
    sequential in-place update, which feeds smoothed values forward)."""
    vals = list(np.asarray(values, np.float64))
    half = window // 2
    for i in range(half, len(vals) - half):
        vals[i] = round(float(np.mean(vals[i - half:i + half])))
    return np.asarray(vals)


def filter_frames(indoor_probs: Sequence[float],
                  person_flags: Sequence[bool],
                  image_files: Sequence[str]) -> Dict[str, List[str]]:
    """Reference ``filter_frames`` (filter_outdoor_maskrcnn_coco.py:158-166):
    smooth both signals, then list the frames flagged indoor / containing a
    person.  The person *detector* is pluggable (the reference pulls
    torchvision Mask-RCNN COCO weights — an external asset); everything
    downstream of the per-frame flags is implemented here."""
    indoor = gaussian_smooth_round(indoor_probs)
    person = smooth_window_round([float(p) for p in person_flags])
    files = np.asarray(image_files)
    return {
        "indoor_locs": [str(f) for f in files[np.argwhere(indoor).flatten()]],
        "person_locs": [str(f) for f in files[np.argwhere(person).flatten()]],
    }


def places365_indoor_probs(model, images_uint8, is_indoor_class: np.ndarray,
                           batch_size: int = 64, device="cuda") -> List[float]:
    """Per-frame indoor probability from the Places365 WideResNet-18 (the
    reference 5b driver uses a Places365 network the same way)."""
    import torch

    from .places365 import check_device, places_forward, preprocess_images

    dev = check_device(model, device)
    out: List[float] = []
    for s in range(0, len(images_uint8), batch_size):
        px = preprocess_images(images_uint8[s:s + batch_size], device=dev)
        with torch.inference_mode():
            probs = torch.softmax(places_forward(model, px)[0], dim=-1).cpu().numpy()
        out += [indoor_probability(p, is_indoor_class) for p in probs]
    return out


def pil_loader(p):
    """The default image loader of the drivers (PIL is imported when it
    is called)."""
    from PIL import Image
    return np.asarray(Image.open(p).convert("RGB"))


def write_indoor_tsv(out_dir, video_id: str, indoor_frames: Sequence[int]
                     ) -> Path:
    """indoor.tsv in the layout build_dataset reads
    (reference build_dataset.py:109-115: video_id\\tframe_id rows)."""
    d = Path(out_dir) / video_id
    d.mkdir(parents=True, exist_ok=True)
    path = d / "indoor.tsv"
    with open(path, "w") as f:
        for fid in indoor_frames:
            f.write(f"{video_id}\t{fid}\n")
    return path


def write_indoor_order_tsv(out_dir, video_id: str,
                           indoor_frames: Sequence[int]) -> Path:
    """indoor_order.tsv (reference filter_outdoor_resnet_place365.py
    ``order_frame``, :345-361 — one sorted frame list per video).  The
    reference's csv reader double-counts the first row; the sorted-set
    content is what downstream reads."""
    d = Path(out_dir) / video_id
    d.mkdir(parents=True, exist_ok=True)
    path = d / "indoor_order.tsv"
    with open(path, "w") as f:
        print(video_id, "\t", sorted(int(x) for x in indoor_frames), file=f)
    return path


def run_indoor_filter(frames_dir, out_dir, model, labels_io,
                      image_loader=None, batch_size: int = 64,
                      device="cuda") -> int:
    """Step 5a end-to-end (reference ``detection``, :271-341): per video,
    score every frame with the Places365 WideResNet-18 ``model``, write the
    indoor.tsv rows for frames the top-10 vote calls indoor (``io_image <
    0.5`` strictly, like the reference), plus the order file.  Videos with
    an existing output directory are skipped (the reference's resume
    semantics).  ``image_loader`` reads a frame (PIL by default).  Returns
    videos processed."""
    from .places365 import check_device, preprocess_images, score_batch

    dev = check_device(model, device)
    image_loader = image_loader or pil_loader
    out_dir = Path(out_dir)
    n_videos = 0
    for vid_dir in sorted(Path(frames_dir).iterdir()):
        if not vid_dir.is_dir():
            continue
        vid = vid_dir.name
        if (out_dir / vid).exists():
            continue  # reference "Skipping..." (:305-307)
        frames = sorted(vid_dir.glob("*.jpg"))
        indoor: List[int] = []
        for s in range(0, len(frames), batch_size):
            chunk = frames[s:s + batch_size]
            images = np.stack([image_loader(p) for p in chunk])
            dets = score_batch(model, preprocess_images(images, device=dev),
                               labels_io=np.asarray(labels_io), device=dev)
            for p, det in zip(chunk, dets):
                if det["is_indoor"][1]:
                    indoor.append(int(p.stem))
        write_indoor_tsv(out_dir, vid, indoor)
        write_indoor_order_tsv(out_dir, vid, indoor)
        n_videos += 1
    return n_videos


def run_maskrcnn_filter(frames_dir, out_dir, alexnet, is_indoor_class,
                        detector, image_loader=None, batch_size: int = 32,
                        device="cuda") -> int:
    """Step 5b end-to-end (reference ``filter_outdoor_maskrcnn_coco.py:
    158-180``): per video — skipping videos whose artifact already exists,
    the reference's resume semantics — score every frame's indoor
    probability (``classify_indoors``: the AlexNet-Places365 top-10 vote,
    ``places365.alexnet_indoor_probs``) and person flag (``classify_person``:
    Mask R-CNN's top-5 labels, ``maskrcnn.MaskRCNNDetector``), smooth both
    signals (gaussian sigma 6 / rolling window 6) and write the
    indoor_locs/person_locs artifact.  Frames are decoded ``batch_size`` at
    a time.  Returns videos processed."""
    from .places365 import alexnet_indoor_probs, check_device

    dev = check_device(alexnet, device)
    check_device(detector.model, dev)
    image_loader = image_loader or pil_loader
    out_dir = Path(out_dir)
    n_videos = 0
    for vid_dir in sorted(Path(frames_dir).iterdir()):
        if not vid_dir.is_dir():
            continue
        vid = vid_dir.name
        if (out_dir / vid / f"{vid}.json").exists() \
                or (out_dir / vid / f"{vid}.npy").exists():
            continue  # reference resume (:173)
        frames = sorted(vid_dir.glob("*.jpg"))
        indoor: List[float] = []
        person: List[bool] = []
        for s in range(0, len(frames), batch_size):
            chunk = [image_loader(p) for p in frames[s:s + batch_size]]
            stack = (np.stack(chunk) if chunk
                     else np.zeros((0, 224, 224, 3), np.uint8))
            indoor += list(alexnet_indoor_probs(
                alexnet, stack, np.asarray(is_indoor_class),
                batch_size=batch_size, device=dev))
            person += [detector.classify_person(img) for img in chunk]
        data = filter_frames(indoor, person, [p.name for p in frames])
        d = out_dir / vid
        d.mkdir(parents=True, exist_ok=True)
        with open(d / f"{vid}.json", "w") as f:
            json.dump(data, f)
        n_videos += 1
    return n_videos


def write_maskrcnn_filters(out_dir, video_id: str,
                           indoor_frames: Sequence[int],
                           person_frames: Sequence[int]) -> Path:
    """The Mask-RCNN filter artifact (reference stores an .npy dict with
    indoor_locs/person_locs, build_dataset.py:101-107; we use JSON)."""
    d = Path(out_dir) / video_id
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{video_id}.json"
    payload = {
        "indoor_locs": ["%04d.jpg" % f for f in indoor_frames],
        "person_locs": ["%04d.jpg" % f for f in person_frames],
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def load_maskrcnn_filters(path) -> Dict[str, List[str]]:
    p = Path(path)
    if p.suffix == ".npy":
        return np.load(p, allow_pickle=True)[()]
    with open(p) as f:
        return json.load(f)


def frame_passes(frame_id: int, *, indoor_resnet: Sequence[int],
                 maskrcnn: Dict[str, List[str]],
                 caption: str) -> bool:
    """Combined filter decision (reference build_dataset.py:100-135):
    keep a frame iff the Places365 filter voted indoor, Mask-RCNN voted
    indoor, Mask-RCNN saw no person, and the CLIP caption's object is not
    'person'."""
    name = "%04d.jpg" % frame_id
    if indoor_resnet is not None and frame_id not in indoor_resnet:
        return False
    if maskrcnn is not None:
        if name not in maskrcnn.get("indoor_locs", []):
            return False
        if name in maskrcnn.get("person_locs", []):
            return False
    if caption and caption.split(" with ")[-1] == "person":
        return False
    return True
