"""The port's beam re-ranking path (``eval_epoch`` / ``convert_scores``)
against the JAX package's ``build_score_step`` / ``eval_epoch`` /
``convert_scores`` on loader-layout batches: dense and step-dedup
transports, padded candidates (``opt_mask`` false), f32 at 1e-4."""
import json

import jax
import numpy as np
import pytest
import torch

from youtube_vln_tpu.config import tiny_config as jax_tiny_config
from youtube_vln_tpu.evaluation import beam_eval as jax_eval
from youtube_vln_tpu.models import init_lily_params
from youtube_vln_tpu_torch.config import tiny_config
from youtube_vln_tpu_torch.evaluation import beam_eval
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.models.weights import state_dict_from_jax_params
from youtube_vln_tpu_torch.parallel.train_step import expand_beam_steps

ATOL = 1e-4
NC, S_T, L, BOXES, N_U, FEAT = 4, 12, 3, 5, 6, 64


def _instruction(rng, n_real):
    tokens = np.zeros((NC, S_T), np.int32)
    mask = np.zeros((NC, S_T), np.int32)
    tokens[:n_real] = rng.integers(1, 256, (S_T,))   # one instruction per beam
    mask[:n_real, :9] = 1
    return tokens, mask


def dense_batch(seed, n_real=(3, 4)):
    """[bs, nc, ...] as the loader collates it: padded candidates are zero
    rows with opt_mask false."""
    rng = np.random.default_rng(seed)
    bs, s_v = len(n_real), L * BOXES
    b = {"instr_tokens": np.zeros((bs, NC, S_T), np.int32),
         "instr_mask": np.zeros((bs, NC, S_T), np.int32),
         "segment_ids": np.zeros((bs, NC, S_T), np.int32),
         "image_features": np.zeros((bs, NC, s_v, FEAT), np.float32),
         "image_locations": np.zeros((bs, NC, s_v, 12), np.float32),
         "image_mask": np.zeros((bs, NC, s_v), np.int32),
         "opt_mask": np.zeros((bs, NC), bool),
         "instr_id": np.array([[seed, i] for i in range(bs)], np.int64)}
    for i, n in enumerate(n_real):
        b["instr_tokens"][i], b["instr_mask"][i] = _instruction(rng, n)
        b["image_features"][i, :n] = rng.normal(size=(n, s_v, FEAT))
        locs = rng.random((n, s_v, 12))
        locs[..., 11] = np.repeat(np.arange(L), BOXES)
        b["image_locations"][i, :n] = locs
        b["image_mask"][i, :n] = 1
        b["image_mask"][i, :n, -1] = 0
        b["opt_mask"][i, :n] = True
    return b


def dedup_batch(seed, n_real=(3, 4)):
    """The step-dedup transport: n_u unique pano blocks (f16 features) and a
    per-beam step index; padded candidates index block 0."""
    rng = np.random.default_rng(seed)
    bs = len(n_real)
    b = {"instr_tokens": np.zeros((bs, NC, S_T), np.int32),
         "instr_mask": np.zeros((bs, NC, S_T), np.int32),
         "segment_ids": np.zeros((bs, NC, S_T), np.int32),
         "uniq_step_features": rng.normal(
             size=(bs, N_U, BOXES, FEAT)).astype(np.float16),
         "uniq_step_locations": rng.random((bs, N_U, BOXES, 12)).astype(np.float32),
         "uniq_step_mask": np.ones((bs, N_U, BOXES), np.int32),
         "step_index": np.zeros((bs, NC, L), np.int32),
         "opt_mask": np.zeros((bs, NC), bool),
         "instr_id": np.array([[seed, i] for i in range(bs)], np.int64)}
    b["uniq_step_locations"][..., 11] = rng.integers(0, L, (bs, N_U, BOXES))
    b["uniq_step_mask"][:, :, -1] = 0
    for i, n in enumerate(n_real):
        b["instr_tokens"][i], b["instr_mask"][i] = _instruction(rng, n)
        b["step_index"][i, :n] = rng.integers(0, N_U, (n, L))
        b["opt_mask"][i, :n] = True
    return b


@pytest.fixture(scope="module")
def models():
    jax_cfg = jax_tiny_config(v_feature_size=FEAT, ranking=True)
    cfg = tiny_config(v_feature_size=FEAT, ranking=True, compute_dtype="float32")
    params = jax.tree_util.tree_map(
        np.asarray, init_lily_params(jax.random.PRNGKey(0), jax_cfg))
    model = Lily(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return jax_cfg, params, cfg, model


def _assert_scores_match(ours, ref):
    assert [i for i, _ in ours] == [i for i, _ in ref]
    np.testing.assert_allclose(np.array([s for _, s in ours]),
                               np.array([s for _, s in ref]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("make", [dense_batch, dedup_batch])
def test_eval_epoch_matches_jax(models, make):
    jax_cfg, params, cfg, model = models
    batches = [make(11), make(12, n_real=(1, 2))]
    ref = jax_eval.eval_epoch(params, jax_cfg, batches)
    ours = beam_eval.eval_epoch(model, cfg, batches, device="cpu")
    _assert_scores_match(ours, ref)
    scores = np.array([s for _, s in ours])
    opt = np.concatenate([b["opt_mask"] for b in batches])
    assert np.isfinite(scores[opt]).all() and np.isneginf(scores[~opt]).all()
    assert ours[0][0] == "11_0" and ours[3][0] == "12_1"


def test_dedup_transport_scores_like_dense(models):
    """Host-expanding the dedup batch gives the dense layout; the port scores
    both identically (the on-device gather is exact)."""
    _, _, cfg, model = models
    dd = dedup_batch(5)
    dense = {k: v for k, v in dd.items()}
    idx = dd["step_index"]
    bs, nc, _ = idx.shape
    for uk, dk in (("uniq_step_features", "image_features"),
                   ("uniq_step_locations", "image_locations"),
                   ("uniq_step_mask", "image_mask")):
        x = dd[uk]
        rows = np.stack([x[i][idx[i].reshape(-1)] for i in range(bs)])
        dense[dk] = rows.reshape((bs, nc, L * BOXES) + x.shape[3:])
        del dense[uk]
    del dense["step_index"]
    a = beam_eval.eval_epoch(model, cfg, [dd], device="cpu")
    b = beam_eval.eval_epoch(model, cfg, [dense], device="cpu")
    assert a == b
    expanded = expand_beam_steps({k: torch.from_numpy(v) for k, v in dd.items()})
    np.testing.assert_array_equal(expanded["image_features"].numpy(),
                                  dense["image_features"])


def test_random_testing_matches_jax(models):
    jax_cfg, params, cfg, model = models
    batches = [dense_batch(1), dense_batch(2)]
    ref = jax_eval.eval_epoch(params, jax_cfg, batches, random_testing=True,
                              seed=3)
    ours = beam_eval.eval_epoch(model, cfg, batches, device="cpu",
                                random_testing=True, seed=3)
    assert ours == ref


@pytest.mark.parametrize("depth", [1, 2, 3, 8])
def test_prefetch_keeps_order_and_drops_nothing(depth):
    batches = [{"x": np.full((2,), i, np.int32)} for i in range(5)]
    got = [int(b["x"][0]) for b in beam_eval.prefetch_to_device(
        batches, torch.device("cpu"), depth)]
    assert got == list(range(5))


@pytest.mark.parametrize("exploration", [False, True])
def test_convert_scores_matches_jax(tmp_path, exploration):
    beams = [{"instr_id": "7_0", "ranked_paths": [["a", "b"], ["a", "c", "d"]],
              "exploration_path": ["a", "b", "c"]},
             {"instr_id": "7_1", "ranked_paths": [["x", "y"], ["x", "z"]],
              "exploration_path": ["x"]}]
    path = tmp_path / "beams.json"
    path.write_text(json.dumps(beams))
    # 7_0 picks beam 1; 7_1's argmax lands past its two ranked paths and
    # falls back to the beam-0 start viewpoint
    scores = [("7_0", [0.1, 0.9, float("-inf")]),
              ("7_1", [0.1, 0.2, 0.7])]
    ours = beam_eval.convert_scores(scores, path, exploration)
    assert ours == jax_eval.convert_scores(scores, path, exploration)
    assert ours[1]["trajectory"] == ["x"]


def test_score_step_needs_ranking_head(models):
    *_, model = models
    with pytest.raises(ValueError):
        beam_eval.build_score_step(model, tiny_config(ranking=False), "cpu")
