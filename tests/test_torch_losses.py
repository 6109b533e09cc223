"""The port's task losses (youtube_vln_tpu_torch/training/losses.py) against
the JAX package's (youtube_vln_tpu/training/losses.py) on shared random
batches with padded candidates: losses at 1e-5 relative, correct counts
exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtube_vln_tpu.training import losses as jl
from youtube_vln_tpu_torch.training import losses as tl

RTOL = 1e-5
BS, NC, S_V, S_T, C, V, M = 3, 5, 20, 12, 7, 31, 6


def _opt_mask(rng):
    opt = np.ones((BS, NC), bool)
    opt[1, -2:] = False          # padded candidates
    opt[2, -1] = False
    return opt


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.numpy(), np.float64),
                               np.asarray(want, np.float64), rtol=RTOL, atol=0)


def _both(fn_name, *args, **kw):
    """(port result, JAX result) of the loss ``fn_name`` on numpy args."""
    got = getattr(tl, fn_name)(*(torch.from_numpy(np.asarray(a)) for a in args), **kw)
    want = getattr(jl, fn_name)(*(jnp.asarray(a) for a in args), **kw)
    return got, want


def _dist(rng, *shape):
    x = rng.normal(size=shape)
    e = np.exp(x - x.max(-1, keepdims=True))
    p = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    p[..., 0] = 0.0                  # exact zeros exercise 0 * log 0 = 0
    return p


def test_masked_vision_loss():
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(BS * NC, S_V, C)).astype(np.float32)
    tmask = (rng.random((BS * NC, S_V)) < 0.15).astype(np.int32)
    got, want = _both("masked_vision_loss", pred, _dist(rng, BS * NC, S_V, C), tmask,
                      _opt_mask(rng).reshape(-1))
    _close(got, want)


@pytest.mark.parametrize("pre_gathered", [False, True])
def test_masked_vision_loss_sparse(pre_gathered):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, S_V, (BS * NC, M)).astype(np.int32)
    idx[:, -2:] = S_V                # padding sentinel
    shape = (BS * NC, M, C) if pre_gathered else (BS * NC, S_V, C)
    pred = rng.normal(size=shape).astype(np.float32)
    got, want = _both("masked_vision_loss_sparse", pred, idx,
                      _dist(rng, BS * NC, M, C), _opt_mask(rng).reshape(-1),
                      pre_gathered=pre_gathered, num_regions=S_V)
    _close(got, want)


@pytest.mark.parametrize("all_ignored", [False, True])
def test_masked_language_loss(all_ignored):
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(BS * NC, S_T, V)).astype(np.float32)
    targets = np.where(rng.random((BS * NC, S_T)) < 0.2,
                       rng.integers(0, V, (BS * NC, S_T)), -1).astype(np.int32)
    if all_ignored:
        targets[:] = -1              # 0, where torch's mean gives nan
    got, want = _both("masked_language_loss", pred, targets, _opt_mask(rng).reshape(-1))
    _close(got, want)


@pytest.mark.parametrize("ignore_row", [False, True])
def test_ranking_loss_train(ignore_row):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(BS, NC)).astype(np.float32)
    target = rng.integers(0, 2, BS).astype(np.int32)
    if ignore_row:
        target[1] = -1
    (loss, correct), (jloss, jcorrect) = _both("ranking_loss_train", logits,
                                               _opt_mask(rng), target)
    _close(loss, jloss)
    assert float(correct) == float(jcorrect)


def test_ranking_loss_eval():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(BS, NC)).astype(np.float32)
    target = (rng.random((BS, NC)) < 0.3).astype(np.float32)
    (loss, correct), (jloss, jcorrect) = _both("ranking_loss_eval", logits,
                                               _opt_mask(rng), target)
    _close(loss, jloss)
    assert float(correct) == float(jcorrect)


@pytest.mark.parametrize("pos_weight", [None, 2.5])
def test_bce_with_logits(pos_weight):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(BS, NC)) * 20).astype(np.float32)   # both tails
    z = (rng.random((BS, NC)) < 0.5).astype(np.float32)
    got, want = _both("_bce_with_logits", x, z, pos_weight=pos_weight)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    ref = torch.nn.functional.binary_cross_entropy_with_logits(
        torch.from_numpy(x), torch.from_numpy(z), reduction="none",
        pos_weight=None if pos_weight is None else torch.tensor(pos_weight))
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("layout", [
    dict(ranking_or_no_judge_data=False, pretrain=True, num_negatives=2),
    dict(ranking_or_no_judge_data=True, pretrain=True, num_negatives=2),
    dict(ranking_or_no_judge_data=True, pretrain=False, num_negatives=2),
    dict(ranking_or_no_judge_data=True, pretrain=False, num_negatives=0)])
def test_traj_judge_targets(layout):
    got = tl.traj_judge_targets(NC, **layout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jl.traj_judge_targets(NC, **layout)))
    assert got.any()                 # num_negatives=0: all positive, no NaN


def test_traj_judge_loss():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(BS, NC)).astype(np.float32)
    row = np.arange(NC) < 3
    (loss, correct), (jloss, jcorrect) = _both("traj_judge_loss", logits,
                                               _opt_mask(rng), row)
    _close(loss, jloss)
    assert float(correct) == float(jcorrect)


def _task_batch(rng, sparse_vision: bool):
    opt = _opt_mask(rng)
    n = BS * NC
    batch = dict(opt_mask=opt,
                 ranking_target=rng.integers(0, NC, BS).astype(np.int32),
                 instr_targets=np.where(rng.random((n, S_T)) < 0.2,
                                        rng.integers(0, V, (n, S_T)), -1).astype(np.int32))
    outputs = dict(ranking=rng.normal(size=(n, 1)).astype(np.float32),
                   traj=rng.normal(size=(n, 1)).astype(np.float32),
                   language=rng.normal(size=(n, S_T, V)).astype(np.float32))
    if sparse_vision:
        idx = rng.integers(0, S_V, (n, M)).astype(np.int32)
        idx[:, -1] = S_V
        batch.update(image_targets_idx=idx, image_targets=_dist(rng, n, M, C))
        outputs["vision"] = rng.normal(size=(n, S_V, C)).astype(np.float32)
    else:
        batch.update(image_targets=_dist(rng, n, S_V, C),
                     image_targets_mask=(rng.random((n, S_V)) < 0.15).astype(np.int32))
        outputs["vision"] = rng.normal(size=(n, S_V, C)).astype(np.float32)
    return outputs, batch


@pytest.mark.parametrize("training,sparse_vision", [
    (True, False), (True, True), (False, False)])
def test_compute_task_losses(training, sparse_vision):
    rng = np.random.default_rng(7)
    outputs, batch = _task_batch(rng, sparse_vision)
    if not training:   # eval ranking targets are multi-hot
        batch["ranking_target"] = (rng.random((BS, NC)) < 0.3).astype(np.float32)
    tasks = dict(ranking=True, traj_judge=True, masked_vision=True,
                 masked_language=True, pretrain=True, num_negatives=2,
                 traj_loss_scale=0.5, not_traj_judge_data=False, training=training)
    extra = dict(num_regions=S_V) if sparse_vision else {}
    total, metrics = tl.compute_task_losses(
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        {**{k: torch.from_numpy(v) for k, v in batch.items()}, **extra}, tasks)
    jtotal, jmetrics = jl.compute_task_losses(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        {**{k: jnp.asarray(v) for k, v in batch.items()}, **extra}, tasks)
    _close(total, jtotal)
    assert set(metrics) == set(jmetrics)
    for key, value in metrics.items():
        if key.startswith("correct/"):
            assert float(value) == float(jmetrics[key]), key
        else:
            _close(value, jmetrics[key])


def test_pad_packed_masks_padded_candidates():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(BS, NC)).astype(np.float32)
    got, want = _both("pad_packed", logits, _opt_mask(rng))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isneginf(got.numpy()[~_opt_mask(rng)]).all()
