"""The port's navigation graphs (``youtube_vln_tpu_torch/data/nav_graph.py``,
no networkx) against the JAX package's (networkx): the same nodes, in the
same order, the same neighbour order and edge weights, bit-equal positions
and headings, exactly equal distance tables whose JSON is byte-equal, and
equal ``get_viewpoints``.  Graphs: the R2R fixture's 2.0 m grid (full of
tied shortest paths), and a connectivity file with an excluded viewpoint,
an isolated one and irregular weights."""
import json

import numpy as np
import pytest

from youtube_vln_tpu.data import fixtures as jfix
from youtube_vln_tpu.data import nav_graph as jng
from youtube_vln_tpu_torch.data import features_reader as pfr
from youtube_vln_tpu_torch.data import nav_graph as png


def _irregular_connectivity(root, scan, n=14, seed=0):
    """Random positions (irregular float weights), random symmetric
    visibility; viewpoint 3 excluded, viewpoint 5 included but with no
    included neighbour (so it is not a node), viewpoint 7 connected only
    to the excluded one."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-7.0, 7.0, (n, 3))
    vis = rng.random((n, n)) < 0.35
    vis = np.triu(vis, 1)
    vis = vis | vis.T
    vis[5, :] = vis[:, 5] = False
    vis[7, :] = vis[:, 7] = False
    vis[7, 3] = vis[3, 7] = True
    items = []
    for i in range(n):
        pose = [0.0] * 16
        pose[3], pose[7], pose[11] = (float(x) for x in pos[i])
        items.append({"image_id": f"{scan}_v{i:02d}", "pose": pose,
                      "included": i != 3,
                      "unobstructed": [bool(x) for x in vis[i]],
                      "height": 1.5})
    (root / "connectivity").mkdir(parents=True, exist_ok=True)
    with open(root / "connectivity" / f"{scan}_connectivity.json", "w") as fh:
        json.dump(items, fh)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    root = tmp_path_factory.mktemp("nav")
    paths = jfix.build_r2r_fixture(root, n_scans=2, n_viewpoints=16)
    for seed, scan in enumerate(("irrA", "irrB")):
        _irregular_connectivity(root, scan, seed=seed)
    scans = ["scan0", "scan1", "irrA", "irrB"]
    return (root, paths, scans, jng.load_nav_graphs(scans, root),
            png.load_nav_graphs(scans, root))


def test_nodes_edges_weights_and_positions_equal(graphs):
    _, _, scans, jg, pg = graphs
    for scan in scans:
        j, p = jg[scan], pg[scan]
        assert p.nodes() == list(j.nodes()), scan
        jpos = {k: v for k, v in j.nodes(data="position")}
        for v in j.nodes():
            assert list(p.neighbors(v)) == list(j.neighbors(v)), (scan, v)
            for u in j.neighbors(v):
                assert p.has_edge(v, u) and p.weight(v, u) == j[v][u]["weight"]
            assert p.position[v].dtype == jpos[v].dtype == np.float64
            assert np.array_equal(p.position[v], jpos[v])
        assert set(p.position) == set(j.nodes())
    irr = pg["irrA"]
    assert not {"irrA_v03", "irrA_v05", "irrA_v07"} & set(irr.nodes())
    assert not irr.has_edge("irrA_v00", "irrA_v03")


def test_headings_bit_equal(graphs):
    _, _, scans, jg, pg = graphs
    rng = np.random.default_rng(4)
    for scan in scans:
        nodes = pg[scan].nodes()
        for _ in range(20):
            path = [nodes[i] for i in rng.integers(0, len(nodes), 6)]
            first = float(rng.uniform(0, 6.28))
            got = png.get_headings(pg[scan], path, first)
            want = jng.get_headings(jg[scan], path, first)
            assert got == want
            assert all(type(h) is float for h in got)


def test_distances_equal_and_json_bytes_equal(graphs):
    root, _, scans, jg, pg = graphs
    for scan in scans:
        got, want = png.compute_distances(pg[scan]), jng.compute_distances(jg[scan])
        assert got == want
        assert list(got) == list(want)
        for src in want:
            assert list(got[src]) == list(want[src]), (scan, src)
        assert json.dumps(got) == json.dumps(want)
    # the fixture's distance files are networkx's; the port reads them back
    assert png.load_distances(["scan0"], root) == jng.load_distances(["scan0"], root)
    assert png.load_distances(["scan0"], root)["scan0"] == png.compute_distances(pg["scan0"])


def test_get_viewpoints_equal(graphs):
    root, paths, _, jg, pg = graphs
    reader = pfr.PanoFeaturesReader(paths["store_path"])
    try:
        scans = ["scan0", "scan1"]
        got = png.get_viewpoints(scans, pg, reader)
        assert got == jng.get_viewpoints(scans, jg, reader)
        assert got["scan0"] and all(isinstance(v, str) for v in got["scan0"])
    finally:
        reader.close()
