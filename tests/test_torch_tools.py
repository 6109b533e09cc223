"""The port's tools on the CPU, on their plain twins at tiny sizes:
``entries/check_kernels.py`` (and a twin whose backward replays another
Philox seed, which the replay check must catch), ``profile_step``,
``bench_e2e``, ``bench_loader --eval`` against the JAX script's host
bytes, and ``northstar`` on a small R2R fixture.  Each JSON line carries
the keys of the JAX script's line where the quantity is the same (the key
sets below are read off those scripts)."""
import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from youtube_vln_tpu_torch import tiny_config
from youtube_vln_tpu_torch.entries import (bench_e2e, bench_loader,
                                           check_kernels, northstar,
                                           profile_step)
from youtube_vln_tpu_torch.ops import attention as A
from youtube_vln_tpu_torch.ops import epilogue as E

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
# 2 text, 1 vision and 1 connection layer; one head of dim 64 at the vision
# and co-attention sites (kernel sites); the reference feature and target
# widths; a 512-token vocabulary (the fixtures' holds 139); attention
# dropout off: the Philox twins of those sites, 80% of a
# step's CPU time, are held against JAX in test_torch_attention*.py and by
# the check_kernels tests here
TOOL_CONFIG = dict(num_hidden_layers=2, v_num_hidden_layers=1,
                   attention_probs_dropout_prob=0.0,
                   v_attention_probs_dropout_prob=0.0,
                   v_biattention_id=(0,), t_biattention_id=(1,), hidden_size=64,
                   num_attention_heads=1, intermediate_size=64,
                   v_hidden_size=64, v_num_attention_heads=1,
                   v_intermediate_size=64, bi_hidden_size=64,
                   bi_num_attention_heads=1, v_feature_size=2048,
                   v_target_size=1601, vocab_size=512,
                   max_position_embeddings=512)

# scripts/check_kernels_tpu.py:149-155
JAX_CHECK_KEYS = {"kernel_tpu_checks", "drop_frac", "epilogue_fd_rel", "attn_fd_rel",
                  "bi_attn_fd_rel", "multichip_dropout", "bwd_probe_attribution"}
# scripts/bench_e2e.py:160-183
JAX_E2E_DETAIL = {"device_only_traj_per_s", "host_bound_gap",
                  "effective_transport_mb_s", "e2e_step_ms", "device_step_ms",
                  "steps_timed", "batch", "host_batch_bytes", "dedup_candidates",
                  "num_workers", "device", "loss_last", "fixture_build_s"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tools' small steps do not oversubscribe the
    cores that the other test workers share."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    """The 2/1/1 config at the stores' widths, for the tools that read a
    fixture store."""
    path = tmp_path_factory.mktemp("config") / "tools_2_1_1.json"
    path.write_text(json.dumps(dataclasses.asdict(tiny_config(**TOOL_CONFIG))))
    return str(path)


@pytest.fixture(scope="module")
def narrow_config_file(tmp_path_factory):
    """The same with 64 features and 23 targets, for the tools that make
    their own batches (the 2048-wide visual embedding is most of a CPU
    forward at 30 beams)."""
    path = tmp_path_factory.mktemp("config") / "tools_2_1_1_narrow.json"
    path.write_text(json.dumps(dataclasses.asdict(
        tiny_config(**dict(TOOL_CONFIG, v_feature_size=64, v_target_size=23)))))
    return str(path)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_strings(script):
    """Every string constant of a JAX script or root entry, read by ``ast``
    without running it: the keys its JSON lines can carry, and its variant
    names."""
    tree = ast.parse((REPO / script).read_text())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def test_check_kernels_passes_on_the_plain_twins(capsys):
    """(a)-(c) and (e) on the CPU: the drop fraction in its band, mask replay
    by finite differences within 2e-2 of the bound, two launches bitwise
    equal, and one device, as the JAX script reports them."""
    out = check_kernels.main(CPU + ["--checks", "drop", "replay", "determinism",
                                    "multichip"])
    assert _last_json(capsys) == out
    assert out["kernel_tpu_checks"] == "ok" and out["failures"] == []
    assert JAX_CHECK_KEYS <= _jax_strings("scripts/check_kernels_tpu.py")
    assert JAX_CHECK_KEYS - {"bwd_probe_attribution"} <= set(out)
    assert abs(out["drop_frac"] - 0.1) < 5 * np.sqrt(0.09 / (2 * 101 * 256))
    for key in ("epilogue_fd_rel", "attn_fd_rel", "bi_attn_fd_rel"):
        assert out[key] < 1e-3, key
    # B1-B6, and B3 again on its wgmma route's shapes (bf16, D = 128)
    assert all(out["determinism"].values()) and len(out["determinism"]) == 7
    assert out["multichip_dropout"] == "skipped (1 device)"
    assert out["device"] == {"name": "cpu", "power_limit": None}


def test_check_kernels_attribution_on_a_small_model():
    """(d) at a 2/1/1-layer model on the CPU: the plain twins of the kernel
    path in f32 agree with the plain path, and in bf16 stay near its floor;
    on the CPU every kernel already runs its plain twin, so each per-kernel
    leg equals the kernel leg."""
    import torch
    cfg = tiny_config(**dict(TOOL_CONFIG, v_feature_size=64, v_target_size=23),
                      ranking=True, traj_judge=True)   # eval mode
    attr = check_kernels.bwd_probe_attribution(torch.device("cpu"), cfg)
    assert set(attr) == {"floor_bf16", "kernel_bf16", "kernel_f32",
                         "kernel_bf16_with_plain"}
    assert attr["kernel_f32"] <= check_kernels.ATTR_F32_TOL
    assert 0 < attr["floor_bf16"] and attr["kernel_bf16"] <= 2 * attr["floor_bf16"]
    assert attr["kernel_bf16_with_plain"] == dict.fromkeys(check_kernels.PLAIN_TWINS,
                                                           attr["kernel_bf16"])
    assert (cfg.use_attention_kernels, cfg.compute_dtype) == (True, "bfloat16")


def _other_seed(fn, at):
    """``fn`` with the positional seed at index ``at`` moved by one."""
    def replay(*args, **kw):
        args = list(args)
        args[at] += 1
        return fn(*args, **kw)
    return replay


@pytest.mark.parametrize("twin", ["attention", "epilogue"])
def test_check_kernels_catches_a_backward_on_another_mask(twin, monkeypatch, capsys):
    """A backward that replays another Philox seed than its forward drew
    fails the replay check, with the pair it broke named, by O(rate) of the
    bound along the gradient direction."""
    if twin == "attention":
        # (q, k, v, bias, do, rate, seed, direction, stream0, head0, heads_total)
        monkeypatch.setattr(A, "attention_bwd_reference",
                            _other_seed(A.attention_bwd_reference, 6))
        broken = {"attn_fd_rel", "bi_attn_fd_rel"}
    else:
        # (h, res, weight, do, rate, seed, row0)
        monkeypatch.setattr(E, "epilogue_bwd_reference",
                            _other_seed(E.epilogue_bwd_reference, 5))
        broken = {"epilogue_fd_rel"}
    with pytest.raises(SystemExit) as e:
        check_kernels.main(CPU + ["--checks", "replay"])
    assert e.value.code == 1
    out = _last_json(capsys)
    assert out["kernel_tpu_checks"] == "failed"
    assert {f.split()[0] for f in out["failures"]} == broken
    for key in broken:
        assert out[key] > 2 * check_kernels.FD_REL_TOL


def test_profile_step_variants(narrow_config_file, capsys):
    """``full`` and ``fwd`` of the 30RS step timed at a 2/1/1-layer model;
    the RBG variant has no counterpart."""
    out = profile_step.main(["full", "fwd", "--recipe", "30rs",
                             "--config_file", narrow_config_file,
                             "--batch_size", "1", "--steps", "1"] + CPU)
    assert _last_json(capsys)["profile_step"] == out["profile_step"]
    assert set(out["profile_step"]) == {"full", "fwd"}
    # every variant the port offers or refuses is one of the JAX script's
    assert (set(profile_step.VARIANTS) | set(profile_step.NO_COUNTERPART)
            <= _jax_strings("scripts/profile_step.py"))
    assert all(v > 0 for v in out["profile_step"].values())
    assert out["batch"] == [1, 6, 60, 808] and out["timing"] == "host clock"
    with pytest.raises(SystemExit, match="no counterpart"):
        profile_step.main(["full_rbg"] + CPU)


def test_bench_e2e_line(config_file, capsys):
    out = bench_e2e.main(["--config_file", config_file, "--batch_size", "1",
                          "--steps", "1", "--n_videos", "3"] + CPU)
    assert _last_json(capsys) == out
    assert JAX_E2E_DETAIL <= _jax_strings("scripts/bench_e2e.py")
    assert JAX_E2E_DETAIL <= set(out["detail"])
    detail = out["detail"]
    assert detail["steps_timed"] == 1 and detail["slab_overflow"] == 0
    # no workers: every batch collated on the Loader's thread
    assert detail["batch_assembly"]["in_place"] == 0
    assert detail["batch_assembly"]["collated"] >= 3
    assert detail["warm_batches"] == 2 and detail["epoch_start_ms"] > 0
    assert detail["host_batch_bytes"] == detail["h2d_batch_bytes"] > 0
    assert np.isfinite(detail["loss_last"])


def test_bench_loader_eval_bytes_match_jax(capsys):
    """Host bytes per instruction of the beam-eval items: the step-dedup row
    equal to the JAX script's; the dense row equal to the JAX package's
    dense item (the JAX script's ``dense`` row runs the default transport,
    which is step-dedup)."""
    spec = importlib.util.spec_from_file_location("jax_bench_loader",
                                                  REPO / "scripts" / "bench_loader.py")
    jbl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbl)
    import argparse
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        jbl.bench_eval(argparse.Namespace(items=1))
    jax_detail = json.loads(buf.getvalue().strip().splitlines()[-1])["detail"]
    out = bench_loader.main(["--eval", "--items", "1"])
    assert _last_json(capsys) == out
    detail = out["detail"]
    assert set(jax_detail) <= set(detail)
    for key in ("dedup_host_mb_per_instruction", "dedup_n_unique_padded",
                "dedup_dense_slots", "native_packer"):
        assert detail[key] == jax_detail[key], key
    assert round(detail["dedup_host_bytes_per_instruction"] / 2 ** 20, 1) == \
        jax_detail["dedup_host_mb_per_instruction"]
    assert detail["dense_host_bytes_per_instruction"] == _jax_dense_item_bytes(jbl)
    assert detail["transport_saving"] > 0.2


def _jax_dense_item_bytes(jbl):
    import tempfile

    from youtube_vln_tpu.config import RunConfig
    from youtube_vln_tpu.data import fixtures as F
    from youtube_vln_tpu.data.datasets import BeamDataset
    from youtube_vln_tpu.data.features_reader import PanoFeaturesReader
    from youtube_vln_tpu.data.tokenizer import load_tokenizer

    with tempfile.TemporaryDirectory() as root:
        paths = F.build_r2r_fixture(root, n_scans=1, n_viewpoints=25, n_paths=4,
                                    n_beams=30, path_len=8, k_boxes=101, seed=0)
        reader = PanoFeaturesReader(paths["store_path"])
        args = RunConfig(pretrain=False, ranking=True, batch_size=1,
                         max_instruction_length=60, max_path_length=8,
                         max_num_boxes=101, num_beams=1, dedup_beam_steps=False)
        ds = BeamDataset(args, f"{paths['data_dir']}/task/R2R_val_unseen.json",
                         f"{paths['data_dir']}/beamsearch/beams_val_unseen.json",
                         load_tokenizer(paths["vocab_path"]), reader, num_beams=1,
                         num_beams_strict=False, training=False, masked_vision=False,
                         masked_language=False, shuffle_visual_features=False,
                         data_dir=paths["data_dir"], seed=0)
        n = jbl._item_bytes(ds[0])
        reader.close()
    return n


def test_northstar_pass_and_fail(tmp_path, config_file, capsys):
    """The chain on a small R2R fixture: NO_EXPECTATION first, then PASS
    against its own ``calculate_metrics`` numbers, and FAIL with a non-zero
    exit against an expectation shifted by 5 points."""
    from youtube_vln_tpu_torch.data.fixtures import build_r2r_fixture
    paths = build_r2r_fixture(tmp_path / "data", n_paths=3, n_beams=4, path_len=3,
                              k_boxes=4)
    argv = ["--data_dir", paths["data_dir"], "--img_feature", paths["store_path"],
            "--from_pretrained", "bert-base-uncased", "--config_file", config_file,
            "--bert_tokenizer", paths["vocab_path"],
            "--output_dir", str(tmp_path / "result")] + CPU
    geometry = ["--extra", "--max_path_length", "3", "--max_num_boxes", "5"]
    first = northstar.main(argv + geometry)
    assert set(first) <= _jax_strings("scripts/northstar.py")
    assert first["northstar"] == "NO_EXPECTATION" and first["comparison"] == {}
    sr, spl = first["metrics"]["success_rate"], first["metrics"]["spl"]
    assert 0.0 <= spl <= sr <= 1.0
    passed = northstar.main(argv + ["--expected_sr", str(sr), "--expected_spl", str(spl),
                                    "--tolerance_pts", "0.01"] + geometry)
    assert passed["northstar"] == "PASS" and passed["metrics"] == first["metrics"]
    assert all(c["within_tolerance"] for c in passed["comparison"].values())
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        northstar.main(argv + ["--expected_sr", str(sr + 0.05), "--expected_spl",
                               str(spl)] + geometry)
    assert e.value.code == 1
    failed = _last_json(capsys)
    assert failed["northstar"] == "FAIL"
    assert not failed["comparison"]["success_rate"]["within_tolerance"]
    assert failed["comparison"]["spl"]["within_tolerance"]
    assert northstar.ensure_store(paths["store_path"]) == paths["store_path"]
