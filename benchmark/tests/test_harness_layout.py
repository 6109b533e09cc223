"""The harness finds every file ``BENCHMARK.json`` names, picks up a cell
added by data files alone, prints the result line the contract asks for,
refuses to run without a card, and loads nothing of JAX."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

REPO = harness.REPO


def test_every_named_file_is_found():
    spec = harness.load_spec()
    for c in spec["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("benchmark/configs/")
    for m in spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"], spec)
        assert harness.load_module("drivers", cell.traffic["driver"]).run
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert cell.limits, f"{w['name']} has no limits file"
        for m in cell.per_layer:
            assert m["moves"] in names


def test_a_cell_of_data_files_alone_is_picked_up(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns(".cache"))
    traffic = json.loads((root / "traffic" / "r2r_val_bs1.json").read_text())
    traffic["batch_size"] = 8
    (root / "traffic" / "r2r_val_bs8.json").write_text(json.dumps(traffic))
    spec = harness.load_spec()
    spec["workloads"].append({"name": "rerank.r2r_val_bs8", "config": "lily_ranker",
                              "traffic": "r2r_val_bs8", "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "rerank.r2r_val_bs1" in m.get("workloads", []):
            m["workloads"].append("rerank.r2r_val_bs8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("rerank.r2r_val_bs8", root=root)
    assert cell.traffic["batch_size"] == 8 and cell.traffic["driver"] == "rerank"
    assert {m["name"] for m in cell.end_to_end} == {
        "rerank_beams_per_s", "rerank_p95_ms", "setup_s"}
    assert len(cell.per_layer) == 5


class _Trace:
    busy_s, window_s = 1.25, 2.5
    group_s = {"eager": 0.5}

    def breakdown(self):
        return {"device_ops": [["k", 0.5]], "idle_gaps": [["bench.host_wait", 0.1]]}


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    cell = harness.load_cell("rerank.r2r_val_bs1")
    run = harness.Run(cell=cell, model=harness.model_dict(cell.config), seed=1,
                      trace=traced, setup_s=20.0, window_s=30.0, units=10,
                      flops=3e14, end_to_end={"rerank_beams_per_s": 400.0,
                                              "rerank_p95_ms": 90.0},
                      host_wait_ms=[5.0, 7.0], traced=_Trace() if traced else None,
                      traced_units=5 if traced else 0, memory_peak_bytes=123,
                      checks=[("score_gap", 0.01, 0.05), ("bad_scores", 0, 0)],
                      attempted=10)
    out = json.loads(json.dumps(harness.report(run, "NVIDIA H100 80GB HBM3")))
    assert list(out)[-1] == "compared"
    assert out["correct"] is True and out["attempted"] == 10 and out["failed"] == 0
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 123
    if traced:
        assert dev["busy_s"] == 1.25 and dev["window_s"] == 2.5
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["metrics"]["host_wait_ms.rerank"] == {"value": 6.0, "unit": "ms"}
        # busy 0.25 s a request against the window's 3 s
        assert out["metrics"]["device_idle.rerank"]["value"] == pytest.approx(
            100 * (1 - 0.25 / 3))
        assert out["metrics"]["eager_ms.rerank"]["value"] == pytest.approx(100.0)
        assert "attn_roofline.rerank" not in out["metrics"]    # nothing to read
    else:
        assert set(out["metrics"]) == {"rerank_beams_per_s", "rerank_p95_ms", "setup_s"}
        assert out["metrics"]["setup_s"] == {"value": 20.0, "unit": "s"}
    run.checks.append(("bad_scores", 1, 0))
    assert harness.report(run, "x")["correct"] is False
    run.checks = [("score_gap", 0.01, None)]
    assert harness.report(run, "x")["correct"] is False


def test_without_a_card_it_fails_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    for cmd in (["python3", "benchmark/run.py"], ["python3", "-m", "benchmark.run"]):
        p = subprocess.run(cmd + ["--workload", "rerank.r2r_val_bs1", "--seed",
                                  str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                           cwd=REPO, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout == ""
        assert "needs 1 CUDA device" in p.stderr


LOAD_ALL = """
import sys, json
sys.path.insert(0, {repo!r})
import benchmark.run, benchmark.calibrate, benchmark.harness as h
from benchmark.drivers import rerank, train
for m in {metrics!r}:
    h.load_module("metrics", m)
import youtube_vln_tpu_torch.models, youtube_vln_tpu_torch.parallel.train_step
import youtube_vln_tpu_torch.evaluation.beam_eval, youtube_vln_tpu_torch.data.loader
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_nothing_it_runs_loads_jax():
    metrics = [m["name"] for m in harness.load_spec()["per_layer"]]
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", LOAD_ALL.format(repo=str(REPO),
                                                              metrics=metrics)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "youtube_vln_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "youtube_vln_tpu"}


def test_the_whole_name_check(monkeypatch):
    monkeypatch.setitem(sys.modules, "youtube_vln_tpu_torch_fake", sys)
    assert "youtube_vln_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "youtube_vln_tpu.x", sys)
    assert "youtube_vln_tpu" in harness.forbidden_loaded()


REFERENCE_ONLY = """
import sys, json
sys.path.insert(0, {repo!r})
import benchmark.reference.lily, benchmark.reference.train, benchmark.reference.philox
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_the_reference_imports_nothing_of_the_program():
    p = subprocess.run([sys.executable, "-c", REFERENCE_ONLY.format(repo=str(REPO))],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & {"youtube_vln_tpu_torch", "youtube_vln_tpu", "jax", "jaxlib"}
    for path in (harness.ROOT / "reference").glob("*.py"):
        assert "youtube_vln_tpu" not in path.read_text(), path
