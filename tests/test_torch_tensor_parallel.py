"""Tensor parallelism of the port over heads (``youtube_vln_tpu_torch/
parallel/mesh.py``, ``parallel/tensor.py``, the sharded layers of
``models/``), in one process and on gloo CPU processes (the launcher of
``tests/test_torch_distributed.py``) at the model config of
``tests/test_torch_engine.py`` (2/1/1 layers, head dim 64 at the vision
and co-attention sites, 32 boxes: those sites take the B1-B4 autograd
Functions, their plain versions here; the 32 x 32 text self-attention is
the head-sharded site of the XLA path):

  * the Philox head mapping: for M = 2 and 4 and D = 2 x M = 2 the
    ``dropout_keep`` masks of every shard, joined on the head dim, are the
    full mask bit for bit, and the identity mapping is the mask without it;
  * the B1-B4 wrappers on each head shard at dropout 0.1 give the head
    slice of the full call's outputs and gradients within 1e-6 (f32);
  * ``ModelShard.heads``' cover at the flagship's three attention sites
    for M = 2, 4, 8 and 16: the kept features partition the layer's in
    rank order, every head is covered, and where the heads divide each
    rank covers its own heads;
  * ``param_spec`` against the JAX ``param_shardings`` on every leaf of
    ``init_lily_params(lily_base_config)`` for M = 2, 4 and 8, the layout
    transposed, and the sharded ``Lily``'s own shapes against
    ``shard_state_dict`` (M = 2 to 16); the round trip of
    ``shard_state_dict`` bitwise; ``AdamWRef`` on the shards is the shard
    of ``AdamWRef`` on the whole;
  * ``gather_heads_from_model`` on two gloo ranks that keep different
    slices of the gathered tensor: each rank's input gradient is the sum
    of both ranks' contributions to its shard (``gather_from_model``'s is
    not);
  * the train step under ``--mesh_shape 1 2`` and ``2 2`` (f32, dropout 0)
    against the JAX ``Engine``'s step on the same global batch: the loss
    within 1e-4 relative and every parameter after the step within 2e-5;
    with dropout 0.1 at every site against the port's own run without a
    model axis (one process for ``1 2``, the data-parallel ``2 1`` for
    ``2 2``: the XLA path's generator is the data rank's): the losses of 2
    steps within 1e-5 relative, and the replicated parameters bitwise equal
    across the model ranks.  Both again under ``1 2`` for a config of 3
    heads at every site (text 48 = 3 x 16, vision and co-attention 192 = 3
    x 64), where each rank's features start or end inside a head.

``tests/test_torch_tensor_parallel_entry.py`` holds the checkpoints and
the MRT entry."""
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import run_ranks, worker_main
from youtube_vln_tpu_torch.ops import attention as A
from youtube_vln_tpu_torch.ops import philox
from youtube_vln_tpu_torch.parallel.mesh import param_spec

RATE = 0.1
LOSS_TOL, PARAM_TOL, DROPOUT_LOSS_TOL = 1e-4, 2e-5, 1e-5
# (model config, (D, M) mesh) of the spawned runs
MESHES = [("d64", (1, 2)), ("d64", (2, 2)), ("3heads", (1, 2))]
MESH_IDS = ["1x2", "2x2", "1x2-3heads"]
# the flagship's attention sites: (features, heads)
FLAGSHIP_SITES = {"text": (768, 12), "vision": (1024, 8), "co-attention": (1024, 8)}
# 3 heads at every site: under a model axis of 2 no rank holds whole heads
THREE_HEADS = dict(hidden_size=48, num_attention_heads=3, v_hidden_size=192,
                   v_num_attention_heads=3, bi_hidden_size=192,
                   bi_num_attention_heads=3)


# --------------------------------------------------------------------------- #
# the Philox head mapping
# --------------------------------------------------------------------------- #
def _shards(b, h, data, model):
    """(rows, heads, stream0, head0) of every shard of a (data, model) mesh
    over a [b, h] problem."""
    rows, heads = b // data, h // model
    return [(slice(d * rows, (d + 1) * rows), slice(m * heads, (m + 1) * heads),
             d * rows * h, m * heads) for d in range(data) for m in range(model)]


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("direction", [0, 1])
def test_dropout_keep_head_shards(data, model, direction):
    b, h, s_q, s_kv, seed = 4, 8, 37, 21, 0x5EED_0F_7E45
    full = philox.dropout_keep(seed, RATE, b, h, s_q, s_kv, direction)
    assert torch.equal(philox.dropout_keep(seed, RATE, b, h, s_q, s_kv, direction,
                                           stream0=0, head0=0, heads_total=h), full)
    got = torch.zeros_like(full)
    for rows, heads, stream0, head0 in _shards(b, h, data, model):
        got[rows, heads] = philox.dropout_keep(
            seed, RATE, b // data, h // model, s_q, s_kv, direction,
            stream0=stream0, head0=head0, heads_total=h)
    assert torch.equal(got, full)
    # the shards' masks are not one another's
    parts = [full[r, hd] for r, hd, _, _ in _shards(b, h, data, model)]
    assert not torch.equal(parts[0], parts[1])


def test_global_streams_refuse_heads_outside_the_problem():
    assert philox.global_streams(2, 3, 10, 3, 8).tolist() == [13, 14, 15, 21, 22, 23]
    with pytest.raises(ValueError, match="outside"):
        philox.global_streams(2, 3, 0, 6, 8)
    with pytest.raises(ValueError, match="outside"):
        A._problem(*[torch.zeros(2, 4, 8, 64)] * 3, torch.zeros(2, 8),
                   torch.zeros(2, 4, 8, 64), None, RATE, 1, 0, 0, 6, 8)


def _leaves(gen, *shapes):
    return [torch.randn(*s, generator=gen, dtype=torch.float64).float()
            .requires_grad_() for s in shapes]


def _check_head_shards(fn, inputs, heads_total, data, model, n_bias_rows):
    """``fn`` on every shard of a (data, model) mesh against the slice of
    ``fn`` on the whole problem: outputs and gradients within 1e-6."""
    full = fn(*inputs, stream0=0, head0=0, heads_total=0)
    full = full if isinstance(full, tuple) else (full,)
    gen = torch.Generator().manual_seed(9)
    cot = [torch.randn(o.shape, generator=gen) for o in full]
    grads = torch.autograd.grad(full, inputs, cot)
    b = inputs[0].shape[0]
    for rows, heads, stream0, head0 in _shards(b, heads_total, data, model):
        part = [x.detach()[rows, heads].requires_grad_() for x in inputs]
        out = fn(*part, stream0=stream0, head0=head0, heads_total=heads_total,
                 rows=rows)
        out = out if isinstance(out, tuple) else (out,)
        for o, f in zip(out, full):
            torch.testing.assert_close(o, f[rows, heads], rtol=0, atol=1e-6)
        g = torch.autograd.grad(out, part, [c[rows, heads] for c in cot])
        for gi, fi in zip(g, grads):
            torch.testing.assert_close(gi, fi[rows, heads], rtol=0, atol=1e-6)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_attention_wrappers_on_head_shards(data, model):
    """B1/B3 and B2/B4 through their autograd Functions (plain versions on
    the CPU) at dropout 0.1 on each shard of the heads (and rows) with
    their head0 / heads_total / stream0: the slice of the full call."""
    gen = torch.Generator().manual_seed(5)
    b, h, s, s_t, d = 4, 4, 40, 12, 64
    q, k, v = _leaves(gen, *[(b, h, s, d)] * 3)
    bias = torch.randn(b, s, generator=gen)

    def self_attention(q, k, v, rows=slice(None), **streams):
        return A.fused_attention(q, k, v, bias[rows], dropout_rate=RATE,
                                 seed=21, **streams)

    _check_head_shards(self_attention, [q, k, v], h, data, model, b)
    vis = _leaves(gen, *[(b, h, s, d)] * 3)
    txt = _leaves(gen, *[(b, h, s_t, d)] * 3)
    vb, tb = torch.randn(b, s, generator=gen), torch.randn(b, s_t, generator=gen)

    def co_attention(q1, k1, v1, q2, k2, v2, rows=slice(None), **streams):
        return A.fused_bi_attention(q1, k1, v1, q2, k2, v2, vb[rows], tb[rows],
                                    rate1=RATE, rate2=RATE, seed=22, **streams)

    _check_head_shards(co_attention, vis + txt, h, data, model, b)


# --------------------------------------------------------------------------- #
# the heads that cover a rank's features
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", [2, 4, 8, 16])
@pytest.mark.parametrize("site", list(FLAGSHIP_SITES))
def test_model_shard_cover_partitions_the_features(site, model):
    """``ModelShard.heads`` at a flagship site: the features each rank keeps
    of its covering heads are its own shard, so in rank order they
    partition the layer's; the covering heads hold every head; where the
    heads divide, each rank covers its own heads and nothing else."""
    from youtube_vln_tpu_torch.parallel.tensor import HeadCover, ModelShard

    hidden, num_heads = FLAGSHIP_SITES[site]
    d, f = hidden // num_heads, hidden // model
    kept, covered = [], set()
    for r in range(model):
        n, head0, off = ModelShard(r, model).heads(num_heads, hidden)
        assert n >= 1 and 0 <= off < d and off + f <= n * d
        kept.append((head0 * d + off, head0 * d + off + f))
        covered.update(range(head0, head0 + n))
        if num_heads % model == 0:
            assert (n, head0, off) == (num_heads // model, r * num_heads // model, 0)
        cover = HeadCover(ModelShard(r, model), num_heads, hidden)
        assert cover.split == (num_heads % model != 0)
        assert (cover.width, cover.span) == (f, slice(head0 * d, (head0 + n) * d))
    assert kept == [(r * f, (r + 1) * f) for r in range(model)]
    assert covered == set(range(num_heads))
    # an axis that divides neither the features nor the heads: all heads
    assert ModelShard(1, 5).heads(num_heads, hidden) == (num_heads, 0, 0)
    assert not HeadCover(ModelShard(1, 5), num_heads, hidden).split


# --------------------------------------------------------------------------- #
# the sharding rules
# --------------------------------------------------------------------------- #
def _jax_specs(model):
    """{port state-dict key: torch dim sharded or None} from the JAX
    ``param_shardings`` of ``init_lily_params(lily_base_config)`` (shapes
    only) on a 8 // model x model CPU mesh."""
    import jax
    from youtube_vln_tpu import lily_base_config as jax_base
    from youtube_vln_tpu.models import init_lily_params
    from youtube_vln_tpu.parallel.mesh import make_mesh, param_shardings
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.models.weights import _key_map

    jcfg = jax_base(ranking=True, traj_judge=True, masked_vision=True,
                    masked_language=True)
    shapes = jax.eval_shape(lambda: init_lily_params(jax.random.PRNGKey(0), jcfg))
    shardings = param_shardings(make_mesh((8 // model, model)), shapes, jcfg)
    n_leaves = len(jax.tree_util.tree_leaves(shapes))

    def dim(spec, transpose):
        names = list(spec)
        if "model" not in names:
            return None
        d = names.index("model")
        return 1 - d if transpose else d

    out = {}
    for key, path, kind in _key_map(lily_base_config()):
        node = shardings
        for p in path:
            node = node[p]
        if kind == "emb":
            out[f"{key}.weight"] = dim(node.spec, False)
        else:
            out[f"{key}.weight"] = dim(node["w"].spec, kind == "linear")
            out[f"{key}.bias"] = dim(node["b"].spec, False)
    out["cls.predictions.bias"] = dim(shardings["cls"]["decoder_bias"].spec, False)
    return out, n_leaves


@pytest.mark.parametrize("model", [2, 4, 8])
def test_param_spec_matches_jax_param_shardings(model):
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.models.weights import full_shapes

    want, n_leaves = _jax_specs(model)
    assert len(want) == n_leaves
    cfg = lily_base_config(ranking=True, traj_judge=True, masked_vision=True,
                           masked_language=True)
    shapes = full_shapes(cfg)
    got = {k: param_spec(k, shapes[k], {"data": 8 // model, "model": model})
           for k in want}
    assert got == want
    # the rules' corners
    c = "bert.encoder.c_layer.0"
    assert got[f"{c}.biOutput.dense1.weight"] is None
    assert got[f"{c}.biOutput.dense2.weight"] is None
    assert got[f"{c}.biattention.query1.weight"] == 0
    assert got[f"{c}.v_output.dense.weight"] == 1
    assert got["bert.encoder.layer.0.attention.output.dense.bias"] is None
    assert got["bert.embeddings.word_embeddings.weight"] == (0 if model == 2 else None)
    assert param_spec(f"{c}.biattention.query1.weight", shapes[
        f"{c}.biattention.query1.weight"], {"data": 8, "model": 1}) is None


@pytest.mark.parametrize("model", [2, 4, 8, 16])
def test_sharded_lily_holds_the_shards_of_shard_state_dict(model):
    """The modules of a ``Lily`` built with each ``ModelShard`` have the
    shapes that ``shard_state_dict`` cuts, and its ``init_weights`` draws
    the shards of the one process's weights (the test config at 2, the
    flagship's shapes on the meta device at 2 to 16: at 8 and 16 the
    text heads, at 16 every site's, split)."""
    import test_torch_engine as T
    from youtube_vln_tpu_torch import lily_base_config, tiny_config
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.models.weights import full_shapes, shard_state_dict
    from youtube_vln_tpu_torch.parallel.tensor import ModelShard

    cfg = lily_base_config(masked_language=True)
    full = {k: torch.empty(s, device="meta") for k, s in full_shapes(cfg).items()}
    for m in range(model):
        got = Lily(cfg, device="meta", shard=ModelShard(m, model)).state_dict()
        want = shard_state_dict(full, {"model": model}, m)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    if model != 2:
        return
    small = tiny_config(**T.MODEL)
    one = Lily(small, device="cpu").init_weights(3).state_dict()
    for m in range(model):
        got = Lily(small, device="cpu", shard=ModelShard(m, model)).init_weights(3)
        want = shard_state_dict(one, {"model": model}, m)
        for k, v in got.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_shard_state_dict_round_trip():
    from youtube_vln_tpu_torch import tiny_config
    from youtube_vln_tpu_torch.models.weights import (full_shapes,
                                                      merge_state_dicts,
                                                      shard_state_dict)
    cfg = tiny_config()
    gen = torch.Generator().manual_seed(1)
    shapes = full_shapes(cfg)
    full = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    for model in (2, 4):
        shards = [shard_state_dict(full, {"model": model}, m) for m in range(model)]
        assert any(s.shape != full[k].shape for k, s in shards[1].items())
        back = merge_state_dicts(shards, shapes)
        assert back.keys() == full.keys()
        for k in full:
            assert torch.equal(back[k], full[k]), k


def test_adamw_on_shards_is_the_shard_of_adamw():
    """``AdamWRef`` is per element (no global-norm clipping): stepping each
    shard alone gives the shards of the step on the whole tensor."""
    from youtube_vln_tpu_torch.training.optimization import AdamWRef

    gen = torch.Generator().manual_seed(2)
    w, g1, g2 = (torch.randn(6, 8, generator=gen) for _ in range(3))

    def run(p, grads):
        p = torch.nn.Parameter(p.clone())
        opt = AdamWRef([{"params": [p], "weight_decay": 0.01}], lambda s: 1e-2,
                       weight_decay=0.01)
        for g in grads:
            p.grad = g.clone()
            opt.step()
        return p.detach()

    whole = run(w, [g1, g2])
    for dim in (0, 1):
        parts = [run(a, [b, c]) for a, b, c in zip(w.chunk(2, dim), g1.chunk(2, dim),
                                                    g2.chunk(2, dim))]
        assert torch.equal(torch.cat(parts, dim), whole)


# --------------------------------------------------------------------------- #
# the train step on gloo ranks
# --------------------------------------------------------------------------- #
def run_steps(spec):
    """An ``Engine`` of ``spec["argv"]`` on this rank (any mesh), driven by
    hand: the steps ``spec["steps"]`` of epoch 0's batches, each with the
    seed the Engine would draw for it; after step ``spec.get("save_after")``
    a ``.bin`` (written by rank 0) and a ``.dcp`` (collective) under
    ``spec["out"]``.  Returns the per-step metrics, the gathered weights
    and this rank's own parameters."""
    from youtube_vln_tpu_torch.parallel import distributed
    from youtube_vln_tpu_torch.training import checkpoint as ckpt
    from youtube_vln_tpu_torch.training import engine as pengine
    from youtube_vln_tpu_torch.utils import cli, entry

    _, args = cli.parse_run_config(spec["argv"])
    engine = pengine.Engine(args, entry.build_model_config(args), device="cpu")
    rng = np.random.default_rng(args.seed)
    seeds = [int(rng.integers(0, 2 ** 64, dtype=np.uint64)) for _ in range(8)]
    engine.train_loader.set_epoch(0)
    batches = list(engine._device_batches(engine.train_loader))
    steps = []
    for i in spec["steps"]:
        metrics = engine._train_step(batches[i], seeds[i])
        steps.append({k: float(v) for k, v in metrics.items()})
        if i == spec.get("save_after"):
            out = Path(spec["out"])
            ckpt.save_checkpoint(out, spec["save_name"], engine.model, engine.cfg,
                                 optimizer=engine.optimizer,
                                 step=engine.optimizer.step_count,
                                 write=distributed.rank() == 0)
            ckpt.save_dcp(out, spec["save_name"], engine.model, engine.optimizer,
                          step=engine.optimizer.step_count)
    result = {"steps": steps, "step_batch": engine.step_batch,
              "mesh": (distributed.data_rank(), distributed.model_rank()),
              "full": ckpt.model_state_dict(engine.model, engine.cfg),
              "own": {n: p.detach().clone()
                      for n, p in engine.model.named_parameters()},
              "sharded": sorted(n for n, p in engine.model.named_parameters()
                                if hasattr(p, "tp_dim"))}
    engine.close()
    return result


GATHER_SHAPE = (2, 3, 8)            # a rank's shard of [2, 3, 16]
GATHER_KEEP = [slice(0, 12), slice(4, 16)]   # what each rank reads of it


def _gather_grads(gather):
    """``gather`` over the default group of 2 when rank r reads
    ``GATHER_KEEP[r]`` of the gathered tensor with weights ``w[r]``: (the
    gathered tensor, both ranks' shards, this rank's input gradient, the sum
    over both ranks of what they read of its shard)."""
    from youtube_vln_tpu_torch.parallel import distributed
    from youtube_vln_tpu_torch.parallel.tensor import ModelShard

    rank, f = distributed.rank(), GATHER_SHAPE[-1]
    gen = torch.Generator().manual_seed(17)
    shards = torch.randn(2, *GATHER_SHAPE, generator=gen)
    w = torch.randn(2, *GATHER_SHAPE[:-1], 2 * f, generator=gen)
    x = shards[rank].clone().requires_grad_()
    full = gather(x, ModelShard(rank, 2))
    keep = GATHER_KEEP[rank]
    (full[..., keep] * w[rank][..., keep]).sum().backward()
    read = torch.zeros_like(w)
    for r, k in enumerate(GATHER_KEEP):
        read[r][..., k] = w[r][..., k]
    return (full.detach(), torch.cat(list(shards), -1), x.grad,
            read.sum(0)[..., rank * f:(rank + 1) * f])


def _runs_task(spec):
    from youtube_vln_tpu_torch.parallel import tensor
    out = {name: run_steps(dict(run, out=spec["out"]))
           for name, run in spec["runs"].items()}
    if spec.get("gather"):
        out["gather"] = {"heads": _gather_grads(tensor.gather_heads_from_model),
                         "features": _gather_grads(tensor.gather_from_model)}
    return out


TASKS = {"runs": _runs_task}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """``test_torch_engine``'s environment, and under ``models`` each model
    config of ``MESHES`` with its file at dropout 0 and 0.1 and its
    JAX-written weights."""
    import json

    import jax
    import test_torch_engine as T
    from youtube_vln_tpu.config import LilyConfig as JaxLilyConfig
    from youtube_vln_tpu.models import init_lily_params
    from youtube_vln_tpu.training import checkpoint as jckpt

    env = T.build_env(tmp_path_factory.mktemp("tp"))
    env["models"] = {"d64": {k: env[k] for k in ("config_file",
                                                 "dropout_config_file", "weights")}}
    root = env["root"]
    three = {}
    for key, rate in (("config_file", 0.0), ("dropout_config_file", 0.1)):
        cfg = json.loads(Path(env[key]).read_text())
        cfg.update(THREE_HEADS, **{k: rate for k in T.DROPOUT})
        three[key] = root / f"3heads_{rate}.json"
        three[key].write_text(json.dumps(cfg))
    cfg = JaxLilyConfig.from_json_file(three["config_file"])
    cfg.ranking = cfg.traj_judge = cfg.masked_vision = cfg.masked_language = True
    params = jax.tree_util.tree_map(
        np.asarray, init_lily_params(jax.random.PRNGKey(8), cfg))
    three["weights"] = jckpt.save_checkpoint(str(root), "init_3heads", params, cfg)
    env["models"]["3heads"] = {k: str(v) for k, v in three.items()}
    return env


def tp_argv(env, pkg, mesh=(), dropout=False, extra=(), model="d64"):
    import test_torch_engine as T
    files = env["models"][model]
    # no validation splits: the steps read the training Loader alone
    out = T.flags(env, pkg, "finetune", ["--batch_size", "4", "--ConstantLR",
                                         "--no_test", *extra])
    out += ["--config_file", files["dropout_config_file" if dropout else
                                   "config_file"],
            "--from_pretrained", files["weights"]]
    if mesh:
        out += ["--mesh_shape", *map(str, mesh)]
    return out


@pytest.fixture(scope="module")
def tp_spawn(env):
    """The spawned runs of a world size, one spawn each: for every mesh of
    ``MESHES`` of that size one step at dropout 0 and two at dropout 0.1;
    the 2-rank processes also run the data-parallel ``2 1`` at dropout 0.1
    and the gather of ``_gather_grads``.  Returns each rank's results by
    run name (``<kind>_<model>_<D>x<M>``)."""
    cache = {}

    def spawn(world):
        if world not in cache:
            runs = {}
            meshes = [c for c in MESHES if c[1][0] * c[1][1] == world]
            for model, m in meshes + ([("d64", (2, 1))] if world == 2 else []):
                tag = f"{model}_{m[0]}x{m[1]}"
                if m[1] > 1:
                    runs[f"f32_{tag}"] = {"argv": tp_argv(env, "port", m, model=model),
                                          "steps": [0]}
                runs[f"dropout_{tag}"] = {
                    "argv": tp_argv(env, "port", m, dropout=True, model=model),
                    "steps": [0, 1]}
            cache[world] = run_ranks(Path(__file__), "runs",
                                     {"runs": runs, "gather": world == 2},
                                     env["root"] / f"tp_world{world}", world=world)
        return cache[world]

    return spawn


@pytest.fixture(scope="module")
def tp_runs(tp_spawn):
    """Each rank's runs of one (model config, mesh): {"f32": ..., "dropout":
    ...}."""
    def run(model, mesh):
        tag = f"_{model}_{mesh[0]}x{mesh[1]}"
        return [{k[:-len(tag)]: v for k, v in r.items() if k.endswith(tag)}
                for r in tp_spawn(mesh[0] * mesh[1])]

    return run


def test_gather_heads_sums_the_gradient_over_the_model_group(tp_spawn):
    """Two ranks read different, overlapping slices of the gathered tensor:
    ``gather_heads_from_model`` hands each rank the sum of both ranks'
    gradients of its shard; ``gather_from_model``, whose downstream is
    replicated, only its own."""
    for r in tp_spawn(2):
        full, want_full, got, want = r["gather"]["heads"]
        assert torch.equal(full, want_full)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        *_, got, want = r["gather"]["features"]
        assert not torch.allclose(got, want, rtol=0, atol=1e-2)


def _jax_one_step(env, model):
    """(metrics, parameters as the port's state dict) of the JAX Engine's
    first step on epoch 0's first batch."""
    import jax
    import test_torch_engine as T
    from youtube_vln_tpu_torch.models.weights import state_dict_from_jax_params

    engine = T.make_engine("jax", tp_argv(env, "jax", model=model))
    engine.train_loader.set_epoch(0)
    batch = next(iter(engine._device_batches(engine.train_loader, 1)))
    engine.rng, sub = jax.random.split(engine.rng)
    engine.state, metrics = engine._train_step(engine.state, batch, sub)
    params = jax.tree_util.tree_map(np.asarray, engine.state.params)
    metrics = {k: float(v) for k, v in metrics.items()}
    engine.close()
    return metrics, params


@pytest.fixture(scope="module")
def jax_step(env):
    """``_jax_one_step`` of each model config, computed once."""
    cache = {}

    def step(model):
        if model not in cache:
            cache[model] = _jax_one_step(env, model)
        return cache[model]

    return step


@pytest.mark.parametrize("config,mesh", MESHES, ids=MESH_IDS)
def test_tp_step_matches_the_jax_step(env, tp_runs, jax_step, config, mesh):
    from youtube_vln_tpu_torch.models.weights import state_dict_from_jax_params
    from youtube_vln_tpu_torch.utils import cli, entry

    ranks = tp_runs(config, mesh)
    data, model = mesh
    assert [r["f32"]["mesh"] for r in ranks] == [(d, m) for d in range(data)
                                                 for m in range(model)]
    assert [r["f32"]["step_batch"] for r in ranks] == [4 // data] * (data * model)
    want_metrics, params = jax_step(config)
    _, args = cli.parse_run_config(tp_argv(env, "port", model=config))
    want = state_dict_from_jax_params(params, entry.build_model_config(args))
    for r in ranks:
        got = r["f32"]
        assert got["steps"][0].keys() == want_metrics.keys()
        for k, v in want_metrics.items():
            if k.startswith("loss/"):
                np.testing.assert_allclose(got["steps"][0][k], v, rtol=LOSS_TOL,
                                           err_msg=k)
        assert len(got["sharded"]) > 20
        full = got["full"]
        for k, v in want.items():
            if k in full:
                torch.testing.assert_close(full[k], v, rtol=0, atol=PARAM_TOL,
                                           msg=k)
    assert (ranks[0]["f32"]["full"]["bert.encoder.layer.0.attention.self.query.weight"]
            .shape == want["bert.encoder.layer.0.attention.self.query.weight"].shape)


def _one_process_steps(env, model, n_steps=2):
    """The port's own one process: the dropout runs' steps."""
    assert not torch.distributed.is_initialized()
    return run_steps({"argv": tp_argv(env, "port", dropout=True, model=model),
                      "steps": list(range(n_steps))})


@pytest.fixture(scope="module")
def one_process(env):
    """``_one_process_steps`` of each model config, computed once."""
    cache = {}

    def run(model):
        if model not in cache:
            cache[model] = _one_process_steps(env, model)
        return cache[model]

    return run


@pytest.mark.parametrize("config,mesh", MESHES, ids=MESH_IDS)
def test_tp_dropout_steps_match_one_process(env, tp_runs, one_process, config,
                                            mesh):
    """Dropout 0.1 at every site: the masks of the run without a model axis
    (the kernel sites' head mapping, the XLA path's global draw at the text
    self-attention, the replicated sites' generator shared by the model
    ranks), so the losses agree within 1e-5 over 2 steps; the replicated
    parameters are bitwise equal across the model ranks and the sharded
    ones differ."""
    ranks = tp_runs(config, mesh)
    data, model = mesh
    reference = (one_process(config) if data == 1 else
                 tp_runs(config, (data, 1))[0]["dropout"])
    want = reference["steps"]
    for r in ranks:
        got = r["dropout"]["steps"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if k.startswith("loss/"):
                    np.testing.assert_allclose(g[k], w[k], rtol=DROPOUT_LOSS_TOL,
                                               err_msg=k)
    assert len({s["loss/train"] for s in want}) == 2
    for d in range(data):
        group = ranks[d * model:(d + 1) * model]
        sharded = set(group[0]["dropout"]["sharded"])
        for n, p in group[0]["dropout"]["own"].items():
            for other in group[1:]:
                q = other["dropout"]["own"][n]
                if n in sharded:
                    assert not torch.equal(p, q), n
                else:
                    assert torch.equal(p, q), n
    # the gathered weights after 2 steps: the reference's, up to rounding
    for k, v in reference["full"].items():
        torch.testing.assert_close(ranks[0]["dropout"]["full"][k], v, rtol=0,
                                   atol=PARAM_TOL, msg=k)


if __name__ == "__main__":
    worker_main(TASKS)
