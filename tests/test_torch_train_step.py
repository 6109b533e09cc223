"""The port's train and eval steps (youtube_vln_tpu_torch/parallel/
train_step.py) against the JAX package's (parallel/train_step.py), at
``tiny_config`` widened so that the vision self-attention and the
co-attention are kernel sites (head dim 64): on the CPU those run the
plain versions of B1-B4 inside the autograd Functions.  f32, dropout off
(every rate 0) unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtube_vln_tpu.config import RunConfig as JaxRunConfig
from youtube_vln_tpu.config import tiny_config as jax_tiny_config
from youtube_vln_tpu.models import init_lily_params
from youtube_vln_tpu.parallel import train_step as jts
from youtube_vln_tpu_torch.config import RunConfig, tiny_config
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.models.weights import state_dict_from_jax_params
from youtube_vln_tpu_torch.ops import attention as port_attention
from youtube_vln_tpu_torch.parallel import train_step as pts

B, NC, N_U, S_T, S_V, M = 2, 4, 3, 60, 80, 8
# head dim 64 on the vision and co-attention sides: kernel sites
WIDE = dict(v_hidden_size=128, v_num_attention_heads=2, v_intermediate_size=128,
            bi_hidden_size=128, bi_num_attention_heads=2)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  v_attention_probs_dropout_prob=0.0, v_hidden_dropout_prob=0.0,
                  fusion_dropout_prob=0.0)
ALL_TASKS = dict(ranking=True, traj_judge=True, masked_vision=True,
                 masked_language=True)
RANKING = dict(ranking=True)
# recipe 30RS and a pretraining-style run with every task
RUNS = {"30RS": dict(ranking=True, pretrain=False, shuffle_visual_features=True),
        "all_tasks": dict(**ALL_TASKS, pretrain=True)}


def _configs(heads, **overrides):
    kw = dict(WIDE, **NO_DROPOUT, **heads, **overrides)
    return jax_tiny_config(**kw), tiny_config(**kw, compute_dtype="float32")


def _pair(heads, seed=0, **overrides):
    jax_cfg, cfg = _configs(heads, **overrides)
    params = jax.tree_util.tree_map(np.asarray,
                                    init_lily_params(jax.random.PRNGKey(seed), jax_cfg))
    model = Lily(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return jax_cfg, cfg, params, model


def _dist(rng, *shape):
    e = np.exp(rng.normal(size=shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _batch(seed, cfg, masked=False, dedup=True, b=B):
    """A loader-layout batch: candidate-dedup transport (N_U unique
    trajectories, candidates 0 and 3 share one), one padded candidate, and
    with ``masked`` MLM targets, sparse MVM targets and the feature-zero
    mask."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (b, NC, S_T)).astype(np.int32)
    instr_mask = np.ones((b, NC, S_T), np.int32)
    instr_mask[:, :, 40:] = 0
    opt = np.ones((b, NC), bool)
    opt[-1, -1] = False
    cand = np.tile(np.array([0, 1, 2, 0], np.int32), (b, 1))
    uniq_mask = np.ones((b, N_U, S_V), np.int32)
    uniq_mask[:, :, 70:] = 0
    locs = rng.random((b, N_U, S_V, 12)).astype(np.float32)
    locs[..., 11] = rng.integers(0, 8, (b, N_U, S_V))
    batch = dict(
        instr_tokens=tokens, instr_mask=instr_mask,
        segment_ids=np.zeros_like(tokens),
        instr_targets=np.full_like(tokens, -1),
        uniq_image_features=rng.normal(size=(b, N_U, S_V, cfg.v_feature_size)).astype(np.float32),
        uniq_image_locations=locs, uniq_image_mask=uniq_mask, cand_index=cand,
        opt_mask=opt, ranking_target=np.zeros(b, np.int32))
    if masked:
        lang = rng.random((b, NC, S_T)) < 0.15
        batch["instr_targets"] = np.where(lang, tokens, -1).astype(np.int32)
        idx = np.full((b, NC, M), S_V, np.int32)
        idx[..., :5] = np.sort(rng.choice(70, 5, replace=False))
        batch["image_targets_idx"] = idx
        batch["image_targets"] = _dist(rng, b, NC, M, cfg.v_target_size)
        tmask = np.zeros((b, NC, S_V), np.int32)
        np.put_along_axis(tmask, np.minimum(idx, S_V - 1), 1, axis=2)
        batch["image_targets_mask"] = tmask
        batch["feature_zero_mask"] = (rng.random((b, NC, S_V)) < 0.1).astype(np.int32)
    return batch if dedup else _dense(batch)


def _dense(batch):
    """The same batch on the dense transport, expanded on the host."""
    out = {k: v for k, v in batch.items()
           if not k.startswith("uniq_") and k not in ("cand_index", "feature_zero_mask")}
    rows = np.arange(batch["cand_index"].shape[0])[:, None]
    idx = batch["cand_index"]
    feats = batch["uniq_image_features"][rows, idx]
    if "feature_zero_mask" in batch:
        feats = feats * (batch["feature_zero_mask"] == 0)[..., None]
    out["image_features"] = feats.astype(np.float32)
    out["image_locations"] = batch["uniq_image_locations"][rows, idx]
    out["image_mask"] = batch["uniq_image_mask"][rows, idx]
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_grads(model, batch, tasks, seed=None):
    model.zero_grad(set_to_none=True)
    loss, metrics = pts.loss_fn(model, _torch(batch), tasks, seed)
    loss.backward()
    return loss.detach(), metrics, {n: p.grad for n, p in model.named_parameters()}


def _assert_grads_close(got, want_tree, cfg, rtol):
    """Relative L2 per tensor.  A tensor whose gradient is zero in exact
    arithmetic (the key biases and the ranking head's bias: a softmax
    ignores a constant added to a row) carries only rounding noise, so each
    tensor's norm is floored at 1% of the global gradient norm."""
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, want_tree), cfg)
    floor = 1e-2 * float(np.sqrt(sum(np.sum(w.numpy().astype(np.float64) ** 2)
                                     for w in want.values())))
    for name, g in got.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        err, denom = np.linalg.norm(g - w), max(np.linalg.norm(w), floor)
        assert err <= rtol * denom, (name, err / denom)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_loss_fn_gradients_match_jax(run):
    heads = ALL_TASKS if run == "all_tasks" else RANKING
    jax_cfg, cfg, params, model = _pair(heads)
    args = RunConfig(**RUNS[run])
    tasks = pts._task_config(args, training=True)
    batch = _batch(1, cfg, masked=run == "all_tasks")
    model.train()
    loss, metrics, grads = _port_grads(model, batch, tasks, seed=5)

    jtasks = jts._task_config(JaxRunConfig(**RUNS[run]), training=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jts.loss_fn(p, jax_cfg, b, jtasks, jax.random.PRNGKey(5), True),
        has_aux=True))(params, jbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    _assert_grads_close(grads, jgrads, cfg, rtol=1e-4)
    # the kernel sites ran through the autograd Functions of B1-B4
    assert model.bert.encoder.v_layer[0].attention.self.num_heads == 2


@pytest.fixture(scope="module")
def jax_trajectory():
    """Five JAX train steps of recipe 30RS (one compile for the module)."""
    jax_cfg, cfg = _configs(RANKING)
    params = init_lily_params(jax.random.PRNGKey(2), jax_cfg)
    args = JaxRunConfig(**RUNS["30RS"], learning_rate=1e-3)
    state, tx, _ = jts.create_train_state(params, args, steps_per_epoch=2)
    step = jax.jit(jts.build_train_step(jax_cfg, args, tx))
    losses = []
    for i in range(5):
        batch = {k: jnp.asarray(v) for k, v in _batch(10 + i, cfg).items()}
        state, metrics = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss/train"]))
    return losses


def test_five_step_loss_trajectory_matches_jax(jax_trajectory):
    _, cfg, _, model = _pair(RANKING, seed=2)
    args = RunConfig(**RUNS["30RS"], learning_rate=1e-3)
    optimizer, _ = pts.create_train_state(model, args, steps_per_epoch=2)
    step = pts.build_train_step(model, cfg, args, optimizer, device="cpu")
    losses = [float(step(_batch(10 + i, cfg), seed=i)["loss/train"]) for i in range(5)]
    np.testing.assert_allclose(losses, jax_trajectory, rtol=1e-4)
    assert len(set(losses)) == 5     # the parameters move between steps


def test_accumulation_two_equals_one_on_the_same_rows():
    """ConstantLR, so both runs take the same step size; the parameters
    must move, or the equality would say nothing."""
    results = []
    for accum in (1, 2):
        _, cfg, _, model = _pair(RANKING, seed=3)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        args = RunConfig(**RUNS["30RS"], ConstantLR=True, learning_rate=1e-3,
                         gradient_accumulation_steps=accum)
        optimizer, _ = pts.create_train_state(model, args, steps_per_epoch=1)
        step = pts.build_train_step(model, cfg, args, optimizer, device="cpu")
        batch = _batch(20, cfg, b=4)
        if accum == 2:
            batch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
        metrics = step(batch, seed=0)
        results.append((metrics, {n: p.detach().clone() for n, p in model.named_parameters()}))
        moved = max(float((p - before[n]).abs().max()) for n, p in results[-1][1].items())
        assert moved > 1e-4
    (m1, p1), (m2, p2) = results
    np.testing.assert_allclose(float(m2["loss/ranking"]), float(m1["loss/ranking"]), rtol=1e-5)
    assert float(m2["correct/ranking"]) == float(m1["correct/ranking"])
    for name in p1:
        torch.testing.assert_close(p2[name], p1[name], rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_dedup_transport_equals_dense(masked):
    _, cfg, _, model = _pair(ALL_TASKS if masked else RANKING, seed=4)
    tasks = pts._task_config(RunConfig(**RUNS["all_tasks" if masked else "30RS"]),
                             training=True)
    model.eval()
    dedup = _port_grads(model, _batch(30, cfg, masked=masked), tasks)
    dense = _port_grads(model, _batch(30, cfg, masked=masked, dedup=False), tasks)
    torch.testing.assert_close(dedup[0], dense[0], rtol=1e-6, atol=0)
    for name, g in dedup[2].items():
        if g is None:
            assert dense[2][name] is None, name
        else:
            torch.testing.assert_close(g, dense[2][name], rtol=1e-5, atol=1e-7, msg=name)


def test_frozen_prefixes_get_no_gradient():
    _, cfg, _, model = _pair(RANKING, fixed_t_layer=2)
    tasks = pts._task_config(RunConfig(**RUNS["30RS"]), training=True)
    model.train()
    _, _, grads = _port_grads(model, _batch(40, cfg), tasks, seed=1)
    for name, g in grads.items():
        frozen = name.startswith(("bert.encoder.layer.0.", "bert.encoder.layer.1.",
                                  "bert.embeddings."))
        if frozen:
            assert g is None, name
    assert grads["bert.encoder.layer.2.output.dense.weight"] is not None
    assert grads["bert.encoder.v_layer.0.attention.self.query.weight"] is not None


def test_dropout_seed_repeats_and_differs():
    """Default dropout rates: a fixed seed repeats the loss and the
    gradients (kernel-site Philox masks and the generator sites alike), a
    different seed changes them."""
    cfg = tiny_config(**WIDE, **RANKING, compute_dtype="float32")
    model = Lily(cfg, device="cpu").init_weights(6).train()
    tasks = pts._task_config(RunConfig(**RUNS["30RS"]), training=True)
    batch = _batch(50, cfg)
    a = _port_grads(model, batch, tasks, seed=7)
    a_grads = {n: None if g is None else g.clone() for n, g in a[2].items()}
    b = _port_grads(model, batch, tasks, seed=7)
    c = _port_grads(model, batch, tasks, seed=8)
    assert float(a[0]) == float(b[0]) != float(c[0])
    name = "bert.encoder.v_layer.0.attention.self.query.weight"
    torch.testing.assert_close(a_grads[name], b[2][name], rtol=0, atol=0)
    assert not torch.equal(a_grads[name], c[2][name])


def test_train_step_counts_no_launches_on_the_cpu():
    _, cfg, _, model = _pair(RANKING)
    args = RunConfig(**RUNS["30RS"])
    optimizer, _ = pts.create_train_state(model, args, steps_per_epoch=1)
    step = pts.build_train_step(model, cfg, args, optimizer, device="cpu")
    port_attention.reset_launch_counts()
    metrics = step(_batch(60, cfg), seed=0)
    assert set(port_attention.LAUNCHES.values()) == {0}
    assert all(torch.is_tensor(v) and not v.requires_grad for v in metrics.values())


def test_eval_step_matches_jax():
    jax_cfg, cfg, params, model = _pair(RANKING, seed=7)
    batch = _batch(70, cfg)
    batch["ranking_target"] = (np.arange(NC)[None] == 0).repeat(B, 0).astype(np.float32)
    args = RunConfig(**RUNS["30RS"])
    got = pts.build_eval_step(model, cfg, args, device="cpu")(batch)
    want = jts.build_eval_step(jax_cfg, JaxRunConfig(**RUNS["30RS"]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)


def test_steps_refuse_a_missing_head():
    _, cfg, _, model = _pair(RANKING)
    args = RunConfig(ranking=True, traj_judge=True)
    optimizer, _ = pts.create_train_state(model, args, steps_per_epoch=1)
    with pytest.raises(ValueError):
        pts.build_train_step(model, cfg, args, optimizer, device="cpu")


def _fast_mode_accepted(monkeypatch):
    """``fast_mode`` broadcasts the text rows over as many image rows: a
    no-op on a flattened step batch, so under a data axis of 2 both
    builders build and the step's losses are bitwise those of the mode
    off, and the JAX ``loss_fn``'s with and without it (1e-4, f32)."""
    monkeypatch.setattr(pts.distributed, "data_world", lambda: 2)
    batch = _batch(80, tiny_config(**WIDE), b=2)
    # the eval layout's multi-hot target
    eval_batch = dict(batch, ranking_target=(np.arange(NC)[None] == 0)
                      .repeat(2, 0).astype(np.float32))
    args = RunConfig(**RUNS["30RS"])
    jtasks = jts._task_config(JaxRunConfig(**RUNS["30RS"]), training=True)
    got, want = {}, {}
    for on in (False, True):
        jax_cfg, cfg, params, model = _pair(RANKING, fast_mode=on)
        optimizer, _ = pts.create_train_state(model, args, steps_per_epoch=1)
        evals = pts.build_eval_step(model, cfg, args, device="cpu")(eval_batch)
        metrics = pts.build_train_step(model, cfg, args, optimizer,
                                       device="cpu")(batch, seed=0)
        got[on] = {k: float(v) for k, v in metrics.items()}
        got[on].update({"eval/" + k: float(v) for k, v in evals.items()})
        jloss, _ = jts.loss_fn(params, jax_cfg,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jtasks, jax.random.PRNGKey(0), True)
        want[on] = float(jloss)
    assert got[True] == got[False]
    for on in (False, True):
        np.testing.assert_allclose(got[True]["loss/train"], want[on], rtol=1e-4)


def _in_batch_pairs_refused(monkeypatch):
    """``in_batch_pairs`` gives the heads N² rows, which the JAX step's
    ``[bs, nc]`` reshape refuses for any N > 1 (JAX
    ``training/losses.py:214``): the JAX ``loss_fn`` raises on a batch of
    two, and under a data axis of 2 (always N > 1) both builders refuse the
    mode before any step; in one process they build (their outputs against
    JAX at one row: ``test_torch_model.py``)."""
    jax_cfg, cfg, params, model = _pair(RANKING, in_batch_pairs=True)
    batch = _batch(80, cfg, b=2)
    jtasks = jts._task_config(JaxRunConfig(**RUNS["30RS"]), training=True)
    with pytest.raises(TypeError, match="cannot reshape"):
        jts.loss_fn(params, jax_cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                    jtasks, jax.random.PRNGKey(0), True)
    args = RunConfig(**RUNS["30RS"])
    optimizer, _ = pts.create_train_state(model, args, steps_per_epoch=1)
    pts.build_train_step(model, cfg, args, optimizer, device="cpu")
    pts.build_eval_step(model, cfg, args, device="cpu")
    monkeypatch.setattr(pts.distributed, "data_world", lambda: 2)
    message = r"in_batch_pairs gives the heads N\^2 rows .*training/losses.py:214"
    with pytest.raises(ValueError, match=message):
        pts.build_train_step(model, cfg, args, optimizer, device="cpu")
    with pytest.raises(ValueError, match=message):
        pts.build_eval_step(model, cfg, args, device="cpu")


@pytest.mark.parametrize("mode", ["in_batch_pairs", "fast_mode"])
def test_batch_expansion_refused_under_a_data_axis(mode, monkeypatch):
    """Under a data axis the step builders refuse ``in_batch_pairs``, which
    the JAX step cannot run there either, and accept ``fast_mode``."""
    {"in_batch_pairs": _in_batch_pairs_refused,
     "fast_mode": _fast_mode_accepted}[mode](monkeypatch)


@pytest.mark.parametrize("overrides,valid", [
    (dict(), False),                                      # no objective
    (dict(ranking=True), True),
    (dict(ranking=True, traj_judge=True, pretrain=False), False),
    (dict(ranking=True, traj_judge=True, pretrain=False,
          shuffle_visual_features=True), True)])
def test_run_config_copies_the_jax_fields(overrides, valid):
    """Every field of the port's RunConfig exists in the JAX one with the
    same default (``use_attention_kernels`` under its JAX name,
    ``use_pallas_attention``), and validate() accepts and refuses the same
    runs."""
    import dataclasses
    port, ref = RunConfig(**overrides), JaxRunConfig(**overrides)
    renamed = {"use_attention_kernels": "use_pallas_attention"}
    for field in dataclasses.fields(RunConfig):
        assert getattr(port, field.name) == getattr(
            ref, renamed.get(field.name, field.name)), field.name
    for cfg in (port, ref):
        if valid:
            cfg.validate()
        else:
            with pytest.raises(ValueError):
                cfg.validate()
