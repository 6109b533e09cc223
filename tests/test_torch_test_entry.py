"""The port's ``test`` entry (``youtube_vln_tpu_torch/entries/test.py``)
against the JAX package's ``test.py`` on ``build_full_fixture``: each
package reads its own fixture and the same checkpoint (written by JAX
``save_checkpoint``), in f32 on the CPU.  Scores agree within 1e-4, the
results JSON and SR/SPL through both packages' ``Evaluation`` are equal;
the port's step-dedup transport equals its dense one exactly, and
``--random_testing`` equals JAX's.  One configuration has head dim 64 at
S_q * S_kv >= 4096 so that the attention wrappers of B1/B2 (their plain
versions, on the CPU) run inside the entry."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from youtube_vln_tpu.config import LilyConfig as JaxLilyConfig
from youtube_vln_tpu.data import fixtures as jfix
from youtube_vln_tpu.evaluation.metrics import Evaluation as JaxEvaluation
from youtube_vln_tpu.models import init_lily_params
from youtube_vln_tpu.training.checkpoint import save_checkpoint
from youtube_vln_tpu_torch.data import fixtures as pfix
from youtube_vln_tpu_torch.entries import calculate_metrics as pcalc
from youtube_vln_tpu_torch.entries import test as ptest
from youtube_vln_tpu_torch.evaluation.metrics import Evaluation
from youtube_vln_tpu_torch.ops import attention as A

from conftest import REPO_ROOT, load_entry

SCORE_TOL = 1e-4
GEOM = ["--max_instruction_length", "32", "--max_path_length", "4",
        "--compute_dtype", "float32", "--split", "val_unseen"]
# the fixture's tiny.json widened so the vision and co-attention heads have
# D = 64; with 32 boxes a step, S_v = 128: 128 x 128 and 32 x 128 scores
WIDE = dict(v_hidden_size=128, v_num_attention_heads=2, v_intermediate_size=128,
            bi_hidden_size=128, bi_num_attention_heads=2)
CONFIGS = {"tiny": ({}, 5), "d64": (WIDE, 32)}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("entry")
    out = {"root": root,
           "jax": jfix.build_full_fixture(root / "jax" / "data"),
           "port": pfix.build_full_fixture(root / "port" / "data")}
    base = json.loads(Path(out["jax"]["config_file"]).read_text())
    for name, (overrides, _) in CONFIGS.items():
        cfg_path = root / f"{name}.json"
        cfg_path.write_text(json.dumps({**base, **overrides}))
        cfg = JaxLilyConfig.from_json_file(cfg_path)
        cfg.ranking = True
        params = jax.tree_util.tree_map(
            np.asarray, init_lily_params(jax.random.PRNGKey(7), cfg))
        out[name] = (str(cfg_path),
                     save_checkpoint(str(root), f"ckpt_{name}", params, cfg))
    out["runs"] = {}
    return out


def _flags(env, pkg, config, save_name, extra=()):
    paths = env[pkg]
    cfg_path, ckpt = env[config]
    return GEOM + [
        "--max_num_boxes", str(CONFIGS[config][1]),
        "--data_dir", paths["data_dir"], "--bert_tokenizer", paths["vocab_path"],
        "--img_feature", paths["pano_store"], "--config_file", cfg_path,
        "--from_pretrained", ckpt, "--save_name", save_name,
        "--output_dir", str(env["root"] / pkg / "result")] + list(extra)


def _run(env, pkg, config, extra=()):
    """(scores, results, results path) of one entry run, cached."""
    key = (pkg, config, tuple(extra))
    if key not in env["runs"]:
        name = f"{config}{''.join(extra).replace('-', '_')}"
        if pkg == "jax":
            path = load_entry("test").main(_flags(env, pkg, config, name, extra))
        else:
            path = ptest.main(_flags(env, pkg, config, name, extra)
                              + ["--device", "cpu"])
        split = "val_unseen"
        scores = json.loads((Path(path).parent / f"_scores_{split}.json").read_text())
        env["runs"][key] = (scores, json.loads(Path(path).read_text()), path)
    return env["runs"][key]


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts the model's calls of the B1/B2 wrappers (on CPU tensors they
    run their plain versions)."""
    from youtube_vln_tpu_torch.models import layers, vilbert
    calls = {"attention": 0, "bi_attention": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            assert a[0].device.type == "cpu"
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(layers, "fused_attention",
                        counting("attention", A.fused_attention))
    monkeypatch.setattr(vilbert, "fused_bi_attention",
                        counting("bi_attention", A.fused_bi_attention))
    return calls


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_entry_matches_jax_test_py(env, config, wrapper_calls):
    want_scores, want_results, want_path = _run(env, "jax", config)
    got_scores, got_results, got_path = _run(env, "port", config)
    n_requests = len(got_results)
    assert n_requests == 15

    assert [iid for iid, _ in got_scores] == [iid for iid, _ in want_scores]
    got = np.array([row for _, row in got_scores])
    want = np.array([row for _, row in want_scores])
    assert got.shape == want.shape
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    real = np.isfinite(want)
    assert np.isfinite(got[real]).all()
    assert np.abs(got[real] - want[real]).max() <= SCORE_TOL
    assert got_results == want_results

    data_dir = env["port"]["data_dir"]
    summary, per_item = Evaluation(["val_unseen"], data_dir).score_file(got_path)
    jsummary, jper_item = JaxEvaluation(
        ["val_unseen"], env["jax"]["data_dir"]).score_file(want_path)
    assert summary == jsummary and per_item == jper_item
    assert summary["spl"] <= summary["success_rate"]

    # a fresh run: the wrappers run once per layer and request where the
    # head dim is 64 (tiny.json's heads are 8 and 12 wide: no wrapper)
    layers = (0, 0)
    if config == "d64":
        cfg = json.loads(Path(env[config][0]).read_text())
        layers = (cfg["v_num_hidden_layers"], len(cfg["v_biattention_id"]))
    before = dict(wrapper_calls)
    ptest.main(_flags(env, "port", config, f"{config}_count")
               + ["--device", "cpu"])
    assert (wrapper_calls["attention"] - before["attention"],
            wrapper_calls["bi_attention"] - before["bi_attention"]) == (
        layers[0] * n_requests, layers[1] * n_requests)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_dedup_equals_dense_through_the_entry(env, config):
    dedup_scores, dedup_results, _ = _run(env, "port", config)
    dense_scores, dense_results, _ = _run(env, "port", config,
                                          ["--no_dedup_beam_steps"])
    assert dedup_scores == dense_scores
    assert dedup_results == dense_results


def test_random_testing_matches_jax(env):
    got_scores, got_results, _ = _run(env, "port", "tiny", ["--random_testing"])
    want_scores, want_results, _ = _run(env, "jax", "tiny", ["--random_testing"])
    assert got_scores == want_scores
    assert got_results == want_results


def test_calculate_metrics_matches_the_script(env):
    _, _, got_path = _run(env, "port", "tiny")
    spec_path = REPO_ROOT / "scripts" / "calculate_metrics.py"
    import importlib.util
    spec = importlib.util.spec_from_file_location("calc_script", spec_path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    argv = [got_path, "--split", "val_unseen"]
    assert pcalc.main(argv + ["--data_dir", env["port"]["data_dir"]]) == \
        script.main(argv + ["--data_dir", env["jax"]["data_dir"]])
