"""The graphed train step (youtube_vln_tpu_torch/parallel/train_step.py,
``StepGraph``) on the card against the eager step, at the published widths
(``lily_base_config``, bf16, dropout 0.1) in the two training geometries
of the benchmark: the ranker at 30RS (16 x 6 candidates, dense transport,
B1-B4) and the four MRT heads (8 x 7 candidates, candidate-dedup, sparse
MLM and MVM targets, B5/B6 on).  From the same weights, batches and dropout
seeds, three graphed steps give the losses, every gradient and every
parameter after each optimizer step of three eager steps bit for bit under
torch's deterministic algorithms (the default ones accumulate some
gradients in an order of their own, and the test prints where eager runs
and the graphed run differ there); the kernels' launch counters read the
same; a fourth step on a batch of other shapes runs eagerly and counts
itself.  Marked ``cuda``: they skip without a card.

    python -m pytest --noconftest -m cuda tests/test_torch_train_graph_card.py -s
"""
import os

import numpy as np
import pytest
import torch

from youtube_vln_tpu_torch import lily_base_config
from youtube_vln_tpu_torch.config import RunConfig
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.ops import attention, epilogue, layer_norm
from youtube_vln_tpu_torch.ops.masking import max_masked_regions
from youtube_vln_tpu_torch.parallel import train_step as ts

S_T, L, BOXES, FEAT = 60, 8, 101, 2048
S_V = L * BOXES
STEPS = 3
DTYPE = "bfloat16"
GEOMETRIES = {
    "30rs": dict(heads=dict(ranking=True),
                 run=dict(ranking=True, pretrain=False, shuffle_visual_features=True,
                          learning_rate=4e-5),
                 b=16, nc=6),
    "mrt": dict(heads=dict(ranking=True, traj_judge=True, masked_vision=True,
                           masked_language=True, use_epilogue_kernels=True),
                run=dict(ranking=True, traj_judge=True, masked_vision=True,
                         masked_language=True, pretrain=True, learning_rate=2e-5),
                b=8, nc=7, n_u=4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(rng, g, b, cfg, device):
    """A loader-layout batch of the geometry: dense (30RS) or
    candidate-dedup with MLM, sparse MVM targets and the feature-zero mask
    (MRT); the last candidate of the last row padded."""
    nc = g["nc"]
    n_words = rng.integers(20, S_T, b)
    instr_mask = np.repeat((np.arange(S_T)[None] < n_words[:, None])[:, None],
                           nc, axis=1).astype(np.int32)
    tokens = rng.integers(1, cfg.vocab_size, (b, nc, S_T)).astype(np.int32) * instr_mask
    n = g.get("n_u", nc)
    mask = (rng.random((b, n, S_V)) < 0.8).astype(np.int32)
    mask[..., 0] = 1
    locs = rng.random((b, n, S_V, 12)).astype(np.float16)
    feats = rng.normal(size=(b, n, S_V, FEAT)).astype(np.float16)
    opt = np.ones((b, nc), bool)
    opt[-1, -1] = False
    out = {"instr_tokens": tokens, "instr_mask": instr_mask,
           "segment_ids": np.zeros_like(tokens), "opt_mask": opt,
           "instr_targets": np.full_like(tokens, -1),
           "ranking_target": np.zeros(b, np.int32)}
    if "n_u" not in g:
        out.update(image_features=feats, image_locations=locs, image_mask=mask)
    else:
        out.update(uniq_image_features=feats, uniq_image_locations=locs,
                   uniq_image_mask=mask,
                   cand_index=rng.integers(0, n, (b, nc)).astype(np.int32))
        lang = (rng.random((b, nc, S_T)) < 0.15) & (instr_mask > 0)
        out["instr_targets"] = np.where(lang, tokens, -1).astype(np.int32)
        m = max_masked_regions(S_V)
        idx = np.full((b, nc, m), S_V, np.int32)
        n_masked = int(0.15 * S_V)
        idx[..., :n_masked] = np.sort(rng.choice(S_V, n_masked, replace=False))
        out["image_targets_idx"] = idx
        t = rng.random((b, nc, m, cfg.v_target_size)).astype(np.float32)
        out["image_targets"] = (t / t.sum(-1, keepdims=True)).astype(np.float16)
        tmask = np.zeros((b, nc, S_V), np.int32)
        np.put_along_axis(tmask, np.minimum(idx, S_V - 1), 1, axis=2)
        out["image_targets_mask"] = tmask
        out["feature_zero_mask"] = (rng.random((b, nc, S_V)) < 0.1).astype(np.uint8)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _launches():
    return {**attention.LAUNCHES, **epilogue.LAUNCHES, **layer_norm.LAUNCHES}


def _run(g, card, batches, seeds, graphed):
    """Per step (loss/train, {name: grad}, {name: param}) on the host, and
    the launch counts of the steps: the build_train_step step (graphed), or
    its eager body (loss_fn, backward, optimizer)."""
    cfg = lily_base_config(compute_dtype=DTYPE, **g["heads"])
    model = Lily(cfg, device=card).init_weights(1234)
    args = RunConfig(num_negatives=2, weight_decay=0.01, lr_schedule="warmup_linear",
                     **g["run"])
    args.validate()
    optimizer, _ = ts.create_train_state(model, args, steps_per_epoch=100)
    names = dict(model.named_parameters())
    grads = []
    real_step = optimizer.step

    def step_reading_grads():
        grads.append({k: p.grad.detach().cpu() for k, p in names.items()
                      if p.grad is not None})
        real_step()

    optimizer.step = step_reading_grads
    tasks = ts._task_config(args, training=True)
    if graphed:
        step = ts.build_train_step(model, cfg, args, optimizer, card)
    else:
        def step(batch, seed):
            model.train()
            loss, metrics = ts.loss_fn(model, batch, tasks, seed)
            loss.backward()
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            return {k: v.detach() for k, v in metrics.items()}
    out = []
    attention.reset_launch_counts()
    epilogue.reset_launch_counts()
    layer_norm.reset_launch_counts()
    for batch, seed in zip(batches, seeds):
        loss = float(step(batch, seed)["loss/train"])
        out.append((loss, grads[-1],
                    {k: p.detach().cpu() for k, p in names.items()}))
    launches = _launches()
    return out, launches, step, cfg


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


@pytest.fixture(params=["deterministic", "default"])
def algorithms(request):
    """torch's deterministic algorithms on (cuBLAS's workspace set as they
    require), or its default ones, for the test's length."""
    was = torch.are_deterministic_algorithms_enabled()
    if request.param == "deterministic":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    yield request.param
    torch.use_deterministic_algorithms(was)


def _differing(x, y) -> dict:
    """{tensor: largest absolute difference} of the gradients and parameters
    of one step's readings that are not bitwise equal."""
    return {(part, k): _gap(x[i][k], y[i][k])
            for i, part in ((1, "grad"), (2, "param")) for k in x[i]
            if not torch.equal(x[i][k], y[i][k])}


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_graphed_steps_equal_eager_steps(card, geometry, algorithms):
    """With deterministic algorithms, two eager runs agree bit for bit and
    the graphed run must agree with them bit for bit at every step.  With
    the default ones, eager runs differ where a kernel accumulates in an
    order of its own (atomics); the test then prints, step by step, which
    tensors differ between the eager runs and between the graphed run and
    the first, and the largest gaps."""
    g = GEOMETRIES[geometry]
    cfg = lily_base_config(compute_dtype=DTYPE, **g["heads"])
    rng = np.random.default_rng(7)
    batches = [_batch(rng, g, g["b"], cfg, card) for _ in range(STEPS)]
    seeds = [int(s) for s in rng.integers(0, 2 ** 63, STEPS)]
    seeds[1] += 2 ** 63           # a seed past 2^63: its table entry is negative
    eager_a, launches_a, _, _ = _run(g, card, batches, seeds, graphed=False)
    eager_b, launches_b, _, _ = _run(g, card, batches, seeds, graphed=False)
    ts.reset_graph_counts()
    graphed, launches_g, step, _ = _run(g, card, batches, seeds, graphed=True)
    assert ts.GRAPH_COUNTS["captures"] == 1 and ts.GRAPH_COUNTS["replays"] == STEPS
    assert launches_g == launches_a == launches_b
    for i, (a, b, got) in enumerate(zip(eager_a, eager_b, graphed)):
        assert got[1].keys() == a[1].keys() and got[2].keys() == a[2].keys()
        eager_gap, graph_gap = _differing(b, a), _differing(got, a)
        print(f"{geometry} {algorithms} step {i}: loss {a[0]!r} {b[0]!r} "
              f"{got[0]!r}; eager runs differ in {len(eager_gap)} tensors "
              f"(largest {max(eager_gap.values(), default=0.0)!r}: "
              f"{sorted(eager_gap, key=eager_gap.get)[-3:]}), the graphed run "
              f"in {len(graph_gap)} (largest "
              f"{max(graph_gap.values(), default=0.0)!r}: "
              f"{sorted(graph_gap, key=graph_gap.get)[-3:]})")
        if algorithms == "deterministic":
            assert a[0] == b[0] and not eager_gap, (i, sorted(eager_gap)[:5])
            assert got[0] == a[0] and not graph_gap, (i, sorted(graph_gap)[:5])
    # a batch of other shapes runs eagerly and counts itself
    other = _batch(rng, g, g["b"] - 1, cfg, card)
    assert np.isfinite(float(step(other, 99)["loss/train"]))
    assert ts.GRAPH_COUNTS["eager_shape"] == 1
    assert ts.GRAPH_COUNTS["replays"] == STEPS
