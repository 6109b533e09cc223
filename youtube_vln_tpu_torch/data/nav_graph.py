"""R2R navigation graphs, precomputed distances, and heading chains (a copy
of ``youtube_vln_tpu/data/nav_graph.py`` without ``networkx``).

Matches reference ``utils/dataset/common.py:40-100`` (graph construction
from connectivity JSONs with euclidean edge weights, distance tables,
heading computation via atan2(dx, dy) — heading measured from north/y).

``NavGraph`` keeps what the JAX module reads from a ``networkx.Graph``, in
the same orders: nodes in insertion order (a viewpoint enters only through
an edge), neighbours in adjacency-insertion order, one weight per
undirected edge.  ``compute_distances`` is networkx's
``all_pairs_dijkstra_path_length`` step for step: the same heap entries
(distance, push counter, node), the same visit order and the same sums, so
its tables are equal and ``json.dump`` of them writes the same bytes.
"""
from __future__ import annotations

import heapq
import itertools
import json
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np

PathLike = Union[str, Path]


class NavGraph:
    """An undirected weighted graph over viewpoint ids, with a ``position``
    ([x, y, z] float64) per node that has an edge."""

    def __init__(self):
        self._adj: Dict[str, Dict[str, float]] = {}
        self.position: Dict[str, np.ndarray] = {}

    def add_edge(self, u: str, v: str, weight: float) -> None:
        for node in (u, v):
            if node not in self._adj:
                self._adj[node] = {}
        self._adj[u][v] = weight
        self._adj[v][u] = weight

    def nodes(self) -> List[str]:
        return list(self._adj)

    def neighbors(self, v: str) -> Iterator[str]:
        return iter(self._adj[v])

    def has_edge(self, u: str, v: str) -> bool:
        return u in self._adj and v in self._adj[u]

    def weight(self, u: str, v: str) -> float:
        return self._adj[u][v]


def load_nav_graphs(scans: Sequence[str],
                    data_dir: PathLike = "data") -> Dict[str, NavGraph]:
    graphs: Dict[str, NavGraph] = {}
    for scan in scans:
        with open(Path(data_dir) / "connectivity"
                  / f"{scan}_connectivity.json") as f:
            items = json.load(f)
        g = NavGraph()
        for i, item in enumerate(items):
            if not item["included"]:
                continue
            pos_i = np.array([item["pose"][3], item["pose"][7],
                              item["pose"][11]])
            for j, conn in enumerate(item["unobstructed"]):
                if conn and items[j]["included"]:
                    g.position[item["image_id"]] = pos_i
                    assert items[j]["unobstructed"][i], \
                        "Graph should be undirected"
                    pos_j = np.array([items[j]["pose"][3],
                                      items[j]["pose"][7],
                                      items[j]["pose"][11]])
                    g.add_edge(item["image_id"], items[j]["image_id"],
                               weight=float(np.linalg.norm(pos_i - pos_j)))
        graphs[scan] = g
    return graphs


def load_distances(scans: Sequence[str],
                   data_dir: PathLike = "data") -> Dict[str, Dict]:
    out = {}
    for scan in scans:
        with open(Path(data_dir) / "distances"
                  / f"{scan}_distances.json") as f:
            out[scan] = json.load(f)
    return out


def _dijkstra(graph: NavGraph, source: str) -> Dict[str, float]:
    """Distances from ``source``, keyed in the order they settle."""
    dist: Dict[str, float] = {}
    seen = {source: 0}
    counter = itertools.count()
    fringe = [(0, next(counter), source)]
    while fringe:
        d_v, _, v = heapq.heappop(fringe)
        if v in dist:
            continue
        dist[v] = d_v
        for u, cost in graph._adj[v].items():
            d_u = d_v + cost
            if u in dist:
                continue
            if u not in seen or d_u < seen[u]:
                seen[u] = d_u
                heapq.heappush(fringe, (d_u, next(counter), u))
    return dist


def compute_distances(graph: NavGraph) -> Dict[str, Dict[str, float]]:
    """All-pairs shortest paths (used when distance JSONs are absent,
    mirroring calculate-metrics.py:84-85)."""
    return {src: _dijkstra(graph, src) for src in graph.nodes()}


def get_viewpoints(scan_list, graphs, features_reader) -> Dict[str, set]:
    """Viewpoints present in both the nav graph and the feature reader
    (reference common.py:302-309)."""
    out = {}
    for scan in scan_list:
        graph_vps = set(graphs[scan].nodes())
        out[scan] = features_reader.viewpoints[scan] & graph_vps
    return out


def get_headings(g: NavGraph, path: Sequence[str],
                 first_heading: float) -> List[float]:
    """Heading at each viewpoint: first is given, the rest point at the next
    node; heading measured clockwise from +y (reference common.py:85-100)."""
    pos = g.position
    headings = [first_heading]
    for source, target in zip(path[:-1], path[1:]):
        dx = pos[target][0] - pos[source][0]
        dy = pos[target][1] - pos[source][1]
        headings.append(float(np.arctan2(dx, dy)))
    return headings
