"""The port's R2R metrics (``youtube_vln_tpu_torch/evaluation/metrics.py``)
against the JAX package's: equal summaries and per-item lists from
``Evaluation.score_items`` on seeded trajectories over the R2R fixture
(exact: both sum the same distances), a trajectory edge off the graph
raises ``ValueError`` in both, a missing instruction fails both."""
import json

import numpy as np
import pytest

from youtube_vln_tpu.data import fixtures as jfix
from youtube_vln_tpu.evaluation import metrics as jm
from youtube_vln_tpu_torch.evaluation import metrics as pm


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics")
    jfix.build_r2r_fixture(root, n_viewpoints=16, n_beams=6, path_len=5)
    beams = json.loads((root / "beamsearch" / "beams_val_seen.json").read_text())
    return root, beams


def _items(beams, seed):
    """One trajectory per instruction: a random ranked beam, sometimes with
    a repeated viewpoint (a stop in place)."""
    rng = np.random.default_rng(seed)
    items = []
    for b in beams:
        path = b["ranked_paths"][int(rng.integers(len(b["ranked_paths"])))]
        path = [list(step) for step in path]
        if rng.random() < 0.3:
            path.insert(1, list(path[0]))
        items.append({"instr_id": b["instr_id"], "trajectory": path})
    return items


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_items_equal(data, seed):
    root, beams = data
    items = _items(beams, seed)
    got = pm.Evaluation(["val_seen"], root).score_items(items)
    want = jm.Evaluation(["val_seen"], root).score_items(items)
    assert got == want
    summary, per_item = got
    assert set(summary) == {"length", "nav_error", "oracle_success_rate",
                            "success_rate", "spl"}
    assert len(per_item["nav_errors"]) == len(beams)


def test_score_file_and_splits_equal(data, tmp_path):
    root, beams = data
    path = tmp_path / "results.json"
    path.write_text(json.dumps(_items(beams, 5)))
    assert pm.Evaluation(["val_seen"], root).score_file(path) == \
        jm.Evaluation(["val_seen"], root).score_file(path)
    splits = ["train", "val_unseen"]
    assert pm.load_task_splits(splits, root) == jm.load_task_splits(splits, root)


def test_off_graph_edge_raises_in_both(data):
    root, beams = data
    items = _items(beams, 0)
    ev = pm.Evaluation(["val_seen"], root)
    first = items[0]["trajectory"][0][0]
    graph = ev.graphs[ev.gt[int(items[0]["instr_id"].split("_")[0])]["scan"]]
    far = next(v for v in graph.nodes()
               if v != first and not graph.has_edge(first, v))
    items[0]["trajectory"] = [[first, 0.0, 0.0], [far, 0.0, 0.0]]
    for mod in (pm, jm):
        with pytest.raises(ValueError, match="not in the navigation graph"):
            mod.Evaluation(["val_seen"], root).score_items(items)


def test_missing_instruction_fails_in_both(data):
    root, beams = data
    items = _items(beams, 0)[1:]
    for mod in (pm, jm):
        with pytest.raises(AssertionError, match="not provided"):
            mod.Evaluation(["val_seen"], root).score_items(items)
