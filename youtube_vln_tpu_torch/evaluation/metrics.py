"""R2R navigation metrics (Matterport3D protocol; a copy of
``youtube_vln_tpu/evaluation/metrics.py`` on the port's ``NavGraph``).

Matches reference ``scripts/calculate-metrics.py:60-202``: success =
nav_error < 3.0 m; reports trajectory length, nav error, oracle success
rate, success rate, SPL; asserts SPL <= SR and full instr_id coverage.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from ..data.nav_graph import compute_distances, load_nav_graphs


def load_task_splits(splits: Sequence[str], data_dir="data") -> List[Dict]:
    data = []
    for split in splits:
        assert split in ("train", "val_seen", "val_unseen", "test")
        with open(Path(data_dir) / "task" / f"R2R_{split}.json") as f:
            data += json.load(f)
    return data


class Evaluation:
    """Score beam-reranking result files."""

    def __init__(self, splits: Sequence[str], data_dir="data",
                 instructions_per_path: int = 3):
        self.error_margin = 3.0
        self.gt: Dict[int, Dict] = {}
        self.instr_ids = set()
        scans = set()
        for item in load_task_splits(splits, data_dir):
            self.gt[item["path_id"]] = item
            scans.add(item["scan"])
            self.instr_ids.update(
                f"{item['path_id']}_{i}" for i in range(instructions_per_path))
        self.graphs = load_nav_graphs(sorted(scans), data_dir)
        self.distances = {scan: compute_distances(g)
                          for scan, g in self.graphs.items()}

    def _nearest(self, scan, goal, path):
        near_id = path[0][0]
        near_d = self.distances[scan][near_id][goal]
        for item in path:
            d = self.distances[scan][item[0]][goal]
            if d < near_d:
                near_id, near_d = item[0], d
        return near_id

    def _score_item(self, instr_id: str, path) -> None:
        gt = self.gt[int(instr_id.split("_")[0])]
        scan = gt["scan"]
        start, goal = gt["path"][0], gt["path"][-1]
        assert start == path[0][0], \
            "Result trajectories should include the start position"
        final = path[-1][0]
        nearest = self._nearest(scan, goal, path)
        self.scores["nav_errors"].append(self.distances[scan][final][goal])
        self.scores["oracle_errors"].append(
            self.distances[scan][nearest][goal])
        distance = 0.0
        prev = path[0]
        for curr in path[1:]:
            if prev[0] != curr[0] and not self.graphs[scan].has_edge(
                    prev[0], curr[0]):
                raise ValueError(
                    f"trajectory edge {prev[0]} -> {curr[0]} not in the "
                    f"navigation graph of {scan}")
            distance += self.distances[scan][prev[0]][curr[0]]
            prev = curr
        self.scores["trajectory_lengths"].append(distance)
        self.scores["shortest_path_lengths"].append(
            self.distances[scan][start][goal])

    def score_file(self, output_file) -> Tuple[Dict[str, float], Dict]:
        with open(output_file) as f:
            return self.score_items(json.load(f))

    def score_items(self, items: List[Dict]) -> Tuple[Dict[str, float], Dict]:
        self.scores = defaultdict(list)
        remaining = set(self.instr_ids)
        for item in items:
            if item["instr_id"] in remaining:
                remaining.remove(item["instr_id"])
                self._score_item(item["instr_id"], item["trajectory"])
        assert not remaining, \
            f"Trajectories not provided for {len(remaining)} instruction ids"
        assert len(self.scores["nav_errors"]) == len(self.instr_ids)

        nav = np.asarray(self.scores["nav_errors"])
        oracle = np.asarray(self.scores["oracle_errors"])
        lengths = np.asarray(self.scores["trajectory_lengths"])
        shortest = np.asarray(self.scores["shortest_path_lengths"])
        success = nav < self.error_margin
        spl = np.where(success, shortest / np.maximum(lengths, shortest), 0.0)

        summary = {
            "length": float(np.mean(lengths)),
            "nav_error": float(np.mean(nav)),
            "oracle_success_rate": float(np.mean(
                oracle < self.error_margin)),
            "success_rate": float(np.mean(success)),
            "spl": float(np.mean(spl)),
        }
        assert summary["spl"] <= summary["success_rate"]
        return summary, dict(self.scores)
