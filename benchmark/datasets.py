"""Writes a cell's data set from its traffic file's ``fixture`` section and
the run's seed, under a temporary directory (``TMPDIR``).

The files have the layouts the users' data has and the program reads:
the feature store (``VLNSTOR1``: header, records of f32 features, boxes,
class probabilities and, for panoramas, view and region angles, then the
key index), R2R task and beam-search JSONs with connectivity graphs and
distance tables, YouTube caption JSONs with instruction templates, and a
WordPiece vocabulary.  The layouts are those of the program's own test
fixtures (``youtube_vln_tpu_torch/data/fixtures.py``); the writers are
kept here so that a change to the program cannot change the traffic.  The
R2R split is sized from R2R's published statistics, which the traffic
files cite.

  kind "r2r": a split of ``n_scans`` scans of ``n_viewpoints`` panoramas
    (jittered grid graphs, edges ``edge_m`` long) whose keys share
    ``n_records`` distinct records of ``k_boxes`` regions; ``n_paths``
    shortest paths, 3 instructions each, each with a varying number of
    beam-search paths of varying lengths from the path's start, grown as a
    search tree (``build_r2r``);
  kind "ytb": ``n_videos`` videos of ``frames_per_video`` frames of
    ``k_boxes`` regions, every other frame captioned "<room> with
    <object>", and templates of 1-7 [MASK] slots.
"""
from __future__ import annotations

import json
import random
import struct
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOMS = ["bedroom", "kitchen", "bathroom", "hallway", "office", "porch"]
OBJECTS = ["bed", "table", "sink", "mirror", "desk", "chair"]
ACTIONS = ["forward", "left", "right"]
TEMPLATE_WORDS = ["walk", "into", "the", "and", "turn", "go", "past", "stop",
                  "then", "at", "wait", "there", "straight", "around",
                  "toward", "room", "with"]
SPLIT_BASE = {"train": 1000, "val_seen": 2000, "val_unseen": 3000}

MAGIC, VERSION, FLAG_PANO = b"VLNSTOR1", 1, 1
FEAT_DIM, PROB_DIM, N_VIEWS = 2048, 1601, 36
_HEADER = struct.Struct("<8sIIQQ")
_REC_HEADER = struct.Struct("<IIII")


def vocab() -> List[str]:
    """[PAD] = 0, [unused*] 1-100, [CLS] 101, [SEP] 102, [MASK] 103, then
    the words of the data."""
    return (["[PAD]"] + [f"[unused{i}]" for i in range(100)]
            + ["[CLS]", "[SEP]", "[MASK]", "[UNK]"]
            + sorted(set(ROOMS + OBJECTS + ACTIONS + TEMPLATE_WORDS + [".", ","])))


def write_store(path: Path, keys: List[str], k: int, pano: bool,
                rng: np.random.Generator, n_records: int = 0) -> None:
    """The store of ``keys``; with ``n_records`` > 0 the keys share that
    many distinct records (each key's drawn from ``rng``), else each key has
    its own."""
    n = n_records or len(keys)
    offsets = []
    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, VERSION, 0, 0, 0))
        for _ in range(n):
            offsets.append(f.tell())
            f.write(_REC_HEADER.pack(k, 640, 480, FLAG_PANO if pano else 0))
            x1, y1 = rng.uniform(0, 320, k), rng.uniform(0, 240, k)
            boxes = np.stack([x1, y1, x1 + rng.uniform(10, 320, k),
                              y1 + rng.uniform(10, 240, k)], axis=1)
            probs = rng.random((k, PROB_DIM), dtype=np.float32)
            probs /= probs.sum(-1, keepdims=True)
            parts = [rng.standard_normal((k, FEAT_DIM), dtype=np.float32),
                     boxes, probs]
            if pano:
                parts += [rng.uniform(-np.pi, np.pi, N_VIEWS),
                          rng.uniform(-0.5, 0.5, N_VIEWS),
                          rng.uniform(-np.pi, np.pi, k),
                          rng.uniform(-0.5, 0.5, k),
                          rng.integers(0, N_VIEWS, k)]
            for a in parts:
                f.write(np.ascontiguousarray(a, dtype="<f4").tobytes())
        at = f.tell()
        which = (rng.integers(0, n, len(keys)) if n_records
                 else np.arange(len(keys)))
        for key, r in zip(keys, which):
            kb = key.encode()
            f.write(struct.pack("<H", len(kb)) + kb
                    + struct.pack("<Q", offsets[int(r)]))
        f.seek(0)
        f.write(_HEADER.pack(MAGIC, VERSION, 0, len(keys), at))


def _write_json(path: Path, obj) -> None:
    with open(path, "w") as f:
        f.write(json.dumps(obj))


def scan_graph(rng: np.random.Generator, n: int, edge_m: float):
    """A navigation graph of ``n`` viewpoints: a jittered grid of pitch
    ``edge_m`` with every grid edge (so it is connected) and a quarter of
    the diagonals.  Returns (positions [n, 2], adjacency [n, n] bool,
    shortest distances [n, n], the next viewpoint on a shortest path
    [n, n], edges on that path [n, n])."""
    cols = int(np.ceil(np.sqrt(n)))
    grid = np.array([(j % cols, j // cols) for j in range(n)], float)
    xy = (grid + rng.uniform(-0.2, 0.2, grid.shape)) * edge_m
    d = np.abs(grid[:, None, :] - grid[None, :, :])
    adj = (d.sum(-1) == 1) | ((d == 1).all(-1) & (rng.random((n, n)) < 0.25))
    adj = np.triu(adj, 1)
    adj = adj | adj.T
    length = np.linalg.norm(xy[:, None] - xy[None], axis=-1)
    dist = np.where(adj, length, np.inf)
    np.fill_diagonal(dist, 0.0)
    nxt = np.where(adj, np.arange(n)[None, :], -1)
    np.fill_diagonal(nxt, np.arange(n))
    hops = np.where(adj, 1, 0)
    for k in range(n):                        # Floyd-Warshall
        via = dist[:, k:k + 1] + dist[k:k + 1, :]
        better = via < dist
        dist = np.where(better, via, dist)
        nxt = np.where(better, nxt[:, k:k + 1], nxt)
        hops = np.where(better, hops[:, k:k + 1] + hops[k:k + 1, :], hops)
    return xy, adj, dist, nxt, hops


def build_r2r(root: Path, seed: int, split: str, n_scans: int,
              n_viewpoints: int, n_records: int, edge_m: float, n_paths: int,
              path_edges: List[int], min_path_m: float, beams: List[int],
              beam_viewpoints: List[int], instruction_words: List[int],
              k_boxes: int, layout_seed: int) -> Dict[str, str]:
    """The split's scans, paths, instructions and beams are drawn from
    ``layout_seed`` (the same for every run: a split is fixed data); the
    features of the store, and which record each viewpoint reads, from
    ``seed``.  A path is a shortest path of ``path_edges`` edges and at
    least ``min_path_m`` metres; an instruction has ``beams`` ranked
    beam-search paths from the path's start, grown as a search tree (each
    beam shares a prefix of an earlier one and walks on), of
    ``beam_viewpoints`` viewpoints; the first follows the true path."""
    lay = np.random.default_rng(layout_seed)
    pick = random.Random(layout_seed)
    for sub in ("connectivity", "distances", "task", "beamsearch"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    (root / "vocab.txt").write_text("".join(t + "\n" for t in vocab()))
    base = SPLIT_BASE[split]
    scans = [f"scan{base + i}" for i in range(n_scans)]
    graphs, keys = {}, []
    for scan in scans:
        vps = [f"{scan}_vp{j}" for j in range(n_viewpoints)]
        xy, adj, dist, nxt, hops = scan_graph(lay, n_viewpoints, edge_m)
        items = []
        for j, vp in enumerate(vps):
            pose = [0.0] * 16
            pose[3], pose[7], pose[11] = float(xy[j, 0]), float(xy[j, 1]), 1.5
            items.append({"image_id": vp, "pose": pose, "included": True,
                          "unobstructed": adj[j].tolist(), "height": 1.5})
        _write_json(root / "connectivity" / f"{scan}_connectivity.json", items)
        _write_json(root / "distances" / f"{scan}_distances.json",
                    {vp: dict(zip(vps, row))
                     for vp, row in zip(vps, np.round(dist, 4).tolist())})
        ends = np.argwhere((hops >= path_edges[0]) & (hops <= path_edges[1])
                           & (dist >= min_path_m)).tolist()
        graphs[scan] = (vps, [np.flatnonzero(r).tolist() for r in adj], dist,
                        nxt, ends)
        keys += [f"{scan}-{vp}" for vp in vps]
    write_store(root / "matterport.vlnstore", keys, k_boxes, True,
                np.random.default_rng(seed), n_records)

    def shortest(g, a, b):
        _, _, _, nxt, _ = g
        out = [a]
        while out[-1] != b:
            out.append(int(nxt[out[-1], b]))
        return out

    def walk(g, prefix, n):
        """``prefix`` walked on to ``n`` viewpoints, not turning back where
        another way is open."""
        path = list(prefix)
        while len(path) < n:
            opts = g[1][path[-1]]
            fresh = [o for o in opts if o not in path] or \
                [o for o in opts if len(path) < 2 or o != path[-2]] or list(opts)
            path.append(pick.choice(fresh))
        return path

    words = sorted(set(ROOMS + OBJECTS + ACTIONS + TEMPLATE_WORDS))
    items, beam_items = [], []
    for p in range(n_paths):
        scan = scans[p % n_scans]
        g = graphs[scan]
        vps, _, dist, _, ends = g
        a, b = pick.choice(ends)
        gt = shortest(g, a, b)
        pid = base + p
        instructions = [" ".join(pick.choices(words, k=pick.randint(
            *instruction_words))) + " ." for _ in range(3)]
        items.append({"path_id": pid, "scan": scan,
                      "heading": pick.uniform(0, 2 * np.pi),
                      "path": [vps[v] for v in gt], "instructions": instructions,
                      "distance": float(dist[a, b])})
        for i in range(3):
            ranked = [gt]
            for _ in range(pick.randint(*beams) - 1):
                n = pick.randint(*beam_viewpoints)
                parent = pick.choice(ranked)
                t = pick.randint(1, min(len(parent), n - 1))
                ranked.append(walk(g, parent[:t], n))
            beam_items.append({"instr_id": f"{pid}_{i}",
                               "ranked_paths": [[[vps[v], 0.0, 0.0] for v in bp]
                                                for bp in ranked]})
    _write_json(root / "task" / f"R2R_{split}.json", items)
    _write_json(root / "beamsearch" / f"beams_{split}.json", beam_items)
    return dict(data_dir=str(root), store_path=str(root / "matterport.vlnstore"),
                vocab_path=str(root / "vocab.txt"))


def build_ytb(root: Path, seed: int, n_videos: int, frames_per_video: int,
              k_boxes: int) -> Dict[str, str]:
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "vocab.txt").write_text("".join(t + "\n" for t in vocab()))
    captions, keys = [], []
    for v in range(n_videos):
        vid = f"video{v:03d}"
        for f in range(frames_per_video):
            captions.append({
                "video_id": vid, "frame_id": f,
                "caption": (f"{ROOMS[int(rng.integers(6))]} with "
                            f"{OBJECTS[int(rng.integers(6))]}" if f % 2 == 0 else ""),
                "action": ACTIONS[int(rng.integers(3))], "merging": [f]})
            keys.append(f"{vid}/%04d" % f)
    _write_json(root / "ytb_train.json", captions)
    templates = []
    for n in range(1, 8):
        for a, b, end in (("walk into the [MASK]", "and turn [OMASK]", " ."),
                          ("go past the [MASK]", "then turn [OMASK]", " and stop .")):
            parts = []
            for i in range(n):
                parts.append(a)
                if i < n - 1:
                    parts.append(b)
            templates.append({"instructions": [" ".join(parts) + end]})
    _write_json(root / "templates.json", templates)
    write_store(root / "ytb.vlnstore", keys, k_boxes, False, rng)
    return dict(caption_path=str(root / "ytb_train.json"),
                skeleton_path=str(root / "templates.json"),
                store_path=str(root / "ytb.vlnstore"),
                vocab_path=str(root / "vocab.txt"))


def build(root, spec: Dict, seed: int, split: str = "train") -> Dict[str, str]:
    """The data set of a traffic file's ``fixture`` section under ``root``."""
    spec = dict(spec)
    kind = spec.pop("kind")
    root = Path(root)
    if kind == "r2r":
        return build_r2r(root, seed, split, **spec)
    if kind == "ytb":
        return build_ytb(root, seed, **spec)
    raise ValueError(f"unknown data set kind {kind!r}")
