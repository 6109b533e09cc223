"""The port's training engine (``youtube_vln_tpu_torch/training/engine.py``)
against the JAX package's (``youtube_vln_tpu/training/engine.py``) on
``build_full_fixture``: each package reads its own fixture (byte-identical,
``tests/test_torch_data.py``) and the same JAX-written ``.bin`` that
carries every tensor, in f32 on the CPU with dropout off.  The model
config is the fixture's ``tiny.json`` cut to 2 text layers, 1 vision layer
and 1 connection layer and widened to head dim 64 on the vision and
co-attention sides; with 32 boxes a step (S_v = 128) those sites run the
B1-B4 autograd Functions (their plain versions, on the CPU).

Per-step losses of ``Engine.train_epoch`` (both engines' ``_train_step``
wrapped to record) agree within 1e-4 for fine-tuning (ranking) and
four-task pretraining, with accumulation 1 and 2, and so do the
``evaluate`` dicts; the dataset wiring (``pretrain_caption_path``,
``testset_paths``) is equal over a grid of flags; a ``Subset`` keeps the
dataset's ``reseed``, so Loader batches with 2 workers equal JAX's;
``--remat`` leaves the loss and every gradient as they are at dropout 0.1;
``--profile_dir`` writes a Chrome trace with the host spans as its
named ranges."""
import itertools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from youtube_vln_tpu.config import LilyConfig as JaxLilyConfig
from youtube_vln_tpu.data import fixtures as jfix
from youtube_vln_tpu.data import loader as jloader
from youtube_vln_tpu.models import init_lily_params
from youtube_vln_tpu.training import checkpoint as jckpt
from youtube_vln_tpu.training import engine as jengine
from youtube_vln_tpu.utils import cli as jcli
from youtube_vln_tpu.utils import entry as jentry
from youtube_vln_tpu_torch.data import fixtures as pfix
from youtube_vln_tpu_torch.data import loader as ploader
from youtube_vln_tpu_torch.ops import attention as A
from youtube_vln_tpu_torch.parallel import train_step as pts
from youtube_vln_tpu_torch.training import engine as pengine
from youtube_vln_tpu_torch.utils import cli as pcli
from youtube_vln_tpu_torch.utils import entry as pentry
from youtube_vln_tpu_torch.utils import spans

LOSS_TOL = 1e-4
DROPOUT = ("hidden_dropout_prob", "attention_probs_dropout_prob",
           "v_hidden_dropout_prob", "v_attention_probs_dropout_prob",
           "fusion_dropout_prob")
# tiny.json cut in depth and widened to head dim 64 where the kernels run
MODEL = dict(num_hidden_layers=2, v_num_hidden_layers=1, v_biattention_id=[0],
             t_biattention_id=[1], v_hidden_size=128, v_num_attention_heads=2,
             v_intermediate_size=128, bi_hidden_size=128,
             bi_num_attention_heads=2, **{k: 0.0 for k in DROPOUT})
GEOM = ["--max_instruction_length", "32", "--max_path_length", "4",
        "--max_num_boxes", "32", "--min_path_length", "3",
        "--min_captioned", "2", "--max_captioned", "4",
        "--num_beams", "4", "--num_beams_train", "3",
        "--compute_dtype", "float32", "--learning_rate", "1e-3",
        "--batch_size", "2", "--num_workers", "0"]
FINETUNE = ["--pretrain", "False", "--ranking", "--shuffle_visual_features"]
PRETRAIN = ["--pre_dataset", "ytb", "--prefix", "merge+", "--masked_vision",
            "--masked_language", "--ranking", "--traj_judge"]
RECIPES = {"finetune": FINETUNE, "pretrain": PRETRAIN}


def build_env(root):
    """Both packages' fixtures, the model config (dropout off; a second one
    at dropout 0.1) and the JAX-written checkpoint of every tensor."""
    env = {"root": root,
           "jax": jfix.build_full_fixture(root / "jax" / "data"),
           "port": pfix.build_full_fixture(root / "port" / "data")}
    base = json.loads(Path(env["jax"]["config_file"]).read_text())
    cfg_path = root / "d64.json"
    cfg_path.write_text(json.dumps({**base, **MODEL}))
    env["config_file"] = str(cfg_path)
    drop_path = root / "d64_dropout.json"
    drop_path.write_text(json.dumps({**base, **MODEL,
                                     **{k: 0.1 for k in DROPOUT}}))
    env["dropout_config_file"] = str(drop_path)
    cfg = JaxLilyConfig.from_json_file(cfg_path)
    cfg.ranking = cfg.traj_judge = cfg.masked_vision = cfg.masked_language = True
    params = jax.tree_util.tree_map(
        np.asarray, init_lily_params(jax.random.PRNGKey(7), cfg))
    env["weights"] = jckpt.save_checkpoint(str(root), "init", params, cfg)
    return env


def flags(env, pkg, recipe, extra=()):
    paths = env[pkg]
    return GEOM + RECIPES[recipe] + [
        "--data_dir", paths["data_dir"], "--bert_tokenizer", paths["vocab_path"],
        "--config_file", env["config_file"], "--from_pretrained", env["weights"],
        "--img_feature", paths["pano_store"], "--ytb_feature", paths["ytb_store"],
        "--skeleton_path", paths["skeleton_path"],
        "--output_dir", str(env["root"] / pkg / "result")] + list(extra)


def make_engine(pkg, argv):
    if pkg == "jax":
        _, args = jcli.parse_run_config(argv)
        return jengine.Engine(args, jentry.build_model_config(args))
    _, args = pcli.parse_run_config(argv)
    return pengine.Engine(args, pentry.build_model_config(args), device="cpu")


def target_twins(batch) -> int:
    """Rows of a train batch whose ranking target has an identical twin
    among the other real candidates.  Their logits are equal up to the
    rounding of each row's place in the products, so the argmax, and with
    it ``correct/ranking``, may pick either of the two on either stack."""
    lead = batch["opt_mask"].shape[:-1]
    b = int(np.prod(lead))
    nc = batch["opt_mask"].shape[-1]
    flat = {k: np.asarray(v).reshape((b,) + np.asarray(v).shape[len(lead):])
            for k, v in batch.items()}
    target = flat["ranking_target"]
    if target.ndim != 1:
        return 0
    cand = [k for k, v in flat.items() if v.ndim >= 2 and v.shape[1] == nc
            and k not in ("opt_mask", "cand_index")]
    twins = 0
    for row in range(b):
        t = int(target[row])
        if t < 0:
            continue

        def sig(c):
            parts = [flat[k][row, c].tobytes() for k in cand]
            if "cand_index" in flat:
                u = int(flat["cand_index"][row, c])
                parts += [flat[k][row, u].tobytes() for k in flat
                          if k.startswith("uniq_")]
            return b"".join(parts)

        others = [c for c in range(nc) if c != t and flat["opt_mask"][row, c]]
        twins += any(sig(c) == sig(t) for c in others)
    return twins


def record_steps(pkg, engine):
    """Wraps ``engine._train_step``; returns the list that gets each step's
    (metrics, target twins of its batch)."""
    out = []
    step = engine._train_step
    if pkg == "jax":
        def recording(state, batch, rng):
            state, metrics = step(state, batch, rng)
            out.append((metrics, target_twins(batch)))
            return state, metrics
    else:
        def recording(batch, seed):
            metrics = step(batch, seed)
            out.append((metrics, target_twins(
                {k: v.numpy() for k, v in batch.items()})))
            return metrics
    engine._train_step = recording
    return out


def to_floats(steps):
    return [({k: float(v) for k, v in m.items()}, twins)
            for m, twins in steps]


def assert_losses_close(got, want, tol=LOSS_TOL):
    """loss/* within ``tol``; correct/* equal, but for the rows of a step
    whose target has a twin (``target_twins``)."""
    assert len(got) == len(want) > 0
    for i, ((g, g_twins), (w, w_twins)) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), i
        assert g_twins == w_twins, i
        for k in w:
            if k.startswith("correct/"):
                # correct/traj is a count over its total, divided in
                # another order: 1e-6 of it
                slack = g_twins if k == "correct/ranking" else 0
                assert abs(g[k] - w[k]) <= slack + 1e-6 * abs(w[k]), (
                    i, k, g[k], w[k], slack)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=tol,
                                           atol=tol * 1e-2, err_msg=(i, k))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return build_env(tmp_path_factory.mktemp("engine"))


@pytest.fixture(scope="module")
def epochs(env):
    """(per-step metrics, evaluate dicts) of one epoch for every package,
    recipe and accumulation, cached."""
    cache = {}

    def run(pkg, recipe, accum):
        key = (pkg, recipe, accum)
        if key not in cache:
            engine = make_engine(pkg, flags(env, pkg, recipe, [
                "--gradient_accumulation_steps", str(accum)]))
            steps = record_steps(pkg, engine)
            engine.train_epoch(0)
            evals = {name: engine.evaluate(name, 0)
                     for name in sorted(engine.eval_loaders)}
            engine.close()
            cache[key] = (to_floats(steps), evals)
        return cache[key]

    return run


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_train_epoch_losses_match_jax(epochs, recipe, accum, monkeypatch):
    calls = {"attention": 0, "bi_attention": 0}
    for name in calls:
        fn = getattr(A, f"fused_{name}")

        def counting(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(f"youtube_vln_tpu_torch.models."
                            f"{'layers' if name == 'attention' else 'vilbert'}"
                            f".fused_{name}", counting)
    want, _ = epochs("jax", recipe, accum)
    got, _ = epochs("port", recipe, accum)
    assert_losses_close(got, want)
    # the parameters moved: the losses are a trajectory, not one point
    assert len({m["loss/train"] for m, _ in got}) > 1
    # the kernel sites ran their autograd Functions (plain versions here)
    assert calls["attention"] > 0 and calls["bi_attention"] > 0


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_evaluate_matches_jax(epochs, recipe, accum):
    _, want = epochs("jax", recipe, accum)
    _, got = epochs("port", recipe, accum)
    splits = ["test"] if recipe == "pretrain" else ["val_seen", "val_unseen"]
    assert sorted(got) == sorted(want) == splits
    for name in splits:
        assert got[name].keys() == want[name].keys()
        for k, v in want[name].items():
            if k.startswith("accuracy/"):
                assert 0.0 <= got[name][k] <= 1.0
            np.testing.assert_allclose(got[name][k], v, rtol=LOSS_TOL,
                                       err_msg=(name, k))


GRID = list(itertools.product(
    [["--ranking"], ["--traj_judge"], ["--ranking", "--traj_judge"],
     ["--traj_judge", "--not_traj_judge_data"]],
    [[], ["--negative_style", "shuffle_instruction"],
     ["--negative_style", "another_path", "--feather_note", "_f"]],
    [["--pre_dataset", "ytb"], ["--pre_dataset", "bnb", "--prefix", "merge+"]]))


@pytest.mark.parametrize("argv", [sum(g, []) for g in GRID],
                         ids=range(len(GRID)))
def test_dataset_paths_match_jax(argv):
    argv = argv + ["--data_dir", "d"]
    _, jargs = jcli.parse_run_config(argv)
    _, pargs = pcli.parse_run_config(argv)
    assert pengine.testset_paths(pargs) == jengine.testset_paths(jargs)
    for split in ("train", "test"):
        assert (pengine.pretrain_caption_path(pargs, split)
                == jengine.pretrain_caption_path(jargs, split))


def test_subset_keeps_reseed_with_workers(env):
    """Subsets of the YTb training set, as --mini/--debug make them: the
    Subset delegates ``reseed``, so the Loader seeds each item and 2 forked
    workers give JAX's batches."""
    batches = {}
    for pkg, cli, engine, loader in (("jax", jcli, jengine, jloader),
                                     ("port", pcli, pengine, ploader)):
        _, args = cli.parse_run_config(flags(env, pkg, "pretrain"))
        full, test, reader = engine.load_pretrain_datasets(
            args, engine.resolve_tokenizer(args))
        train = engine._maybe_subset(full, len(full) - 2)
        assert isinstance(train, engine.Subset) and len(train) == len(full) - 2
        assert hasattr(train, "reseed") and hasattr(test, "reseed")
        out = []
        for epoch in (0, 1):
            ld = loader.Loader(train, 2, shuffle=True, seed=3, num_workers=2)
            ld.set_epoch(epoch)
            out += list(ld)
        batches[pkg] = out
        reader.close()
    assert len(batches["port"]) == len(batches["jax"]) > 2
    for got, want in zip(batches["port"], batches["jax"]):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_subset_hides_only_its_own_fields():
    sub = pengine.Subset([10, 11, 12], [2, 0])
    assert len(sub) == 2 and sub[0] == 12 and sub[1] == 10
    with pytest.raises(AttributeError):
        sub.__missing_dunder__
    assert pengine._maybe_subset([1, 2], 5) == [1, 2]


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_remat_keeps_loss_and_gradients(env, recipe):
    """At dropout 0.1 the recompute must draw the masks of the forward: the
    loss and every gradient with --remat equal those without it."""
    grads = {}
    for remat in (False, True):
        extra = ["--config_file", env["dropout_config_file"]]
        engine = make_engine("port", flags(env, "port", recipe, extra + (
            ["--remat"] if remat else [])))
        assert engine.cfg.remat is remat
        engine.train_loader.set_epoch(0)
        batch = next(iter(engine.train_loader))
        model = engine.model
        model.train()
        tasks = pts._task_config(engine.args, training=True)
        loss, _ = pts.loss_fn(model, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, tasks, 1234)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        g = torch.autograd.grad(loss, [p for p in model.parameters()
                                       if p.requires_grad], allow_unused=True)
        grads[remat] = (float(loss.detach()), dict(zip(names, g)))
        engine.close()
    (l0, g0), (l1, g1) = grads[False], grads[True]
    assert abs(l0 - l1) <= 1e-6 * max(1.0, abs(l0))
    assert g0.keys() == g1.keys()
    n_grads = 0
    for k in g0:
        assert (g0[k] is None) == (g1[k] is None), k
        if g0[k] is not None:
            np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
            n_grads += 1
    assert n_grads > 100


def test_remat_recomputes_only_under_autograd(env, monkeypatch):
    """Eval mode and no_grad run each block once; train mode under
    autograd runs the vision layer's kernel site again in the backward."""
    from youtube_vln_tpu_torch.models import layers
    engine = make_engine("port", flags(env, "port", "finetune", ["--remat"]))
    engine.train_loader.set_epoch(0)
    batch = {k: torch.from_numpy(v)
             for k, v in next(iter(engine.train_loader)).items()}
    calls = []

    def counting(*a, **k):
        calls.append(torch.is_grad_enabled())
        return A.fused_attention(*a, **k)

    monkeypatch.setattr(layers, "fused_attention", counting)
    model, tasks = engine.model, pts._task_config(engine.args, True)
    model.eval()
    pts.loss_fn(model, batch, tasks)[0].backward()
    assert calls == [True]            # one vision layer, no recompute
    model.train()
    with torch.no_grad():
        pts.loss_fn(model, batch, tasks, 5)
    assert calls == [True, False]
    loss = pts.loss_fn(model, batch, tasks, 5)[0]
    assert len(calls) == 3
    loss.backward()
    assert calls == [True, False, True, True]   # recomputed in the backward
    engine.close()


def test_profile_dir_writes_a_trace(env, tmp_path):
    trace_dir = tmp_path / "traces"
    engine = make_engine("port", flags(env, "port", "finetune",
                                       ["--profile_dir", str(trace_dir)]))
    engine.train_epoch(0)
    engine.train_epoch(1)             # profiles the first epoch only
    engine.close()
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    assert [t.name for t in traces] == [
        f"train_epoch0_steps2-{len(engine.train_loader) - 1}.pt.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    # the port's host spans name the trace's ranges while it profiles
    names = {e.get("name") for e in events}
    assert {"step", "step.forward", "step.backward", "step.optimizer",
            "feed.transfer", "loader.next"} <= names
    assert spans.span("a") is spans.span("b")


def _plain_launchers(monkeypatch):
    """The launch branch of the B1-B4 autograd Functions taken on CPU
    tensors, as on CUDA ones, with the plain versions as launchers."""
    def bias_or_zeros(bias, b, s):
        return torch.zeros(b, s) if bias is None else bias

    def attention_fwd(q, k, v, bias, rate, seed, want_lse, *streams,
                      seed_slot=None):
        bias = bias_or_zeros(bias, q.shape[0], k.shape[2])
        lse = A.attention_lse_reference(q, k, bias) if want_lse else None
        return (A.attention_reference(q, k, v, bias, rate, seed, 0, *streams),
                lse, (q, k, v, bias))

    def attention_bwd(q, k, v, bias, o, do, lse, rate, seed, *streams,
                      seed_slot=None):
        return A.attention_bwd_reference(q, k, v, bias, do, rate, seed, 0,
                                         *streams)

    def bi_attention_fwd(q1, k1, v1, q2, k2, v2, v_bias, t_bias, rate1, rate2,
                         seed, want_lse, *streams, seed_slot=None):
        vb = bias_or_zeros(v_bias, q1.shape[0], k1.shape[2])
        tb = bias_or_zeros(t_bias, q1.shape[0], k2.shape[2])
        ctx1, ctx2 = A.bi_attention_reference(q1, k1, v1, q2, k2, v2, vb, tb,
                                              rate1, rate2, seed, *streams)
        lse1, lse2 = ((A.attention_lse_reference(q2, k1, vb),
                       A.attention_lse_reference(q1, k2, tb)) if want_lse
                      else (None, None))
        return ctx1, ctx2, lse1, lse2, (q1, k1, v1, q2, k2, v2, vb, tb)

    def bi_attention_bwd(q1, k1, v1, q2, k2, v2, vb, tb, ctx1, ctx2, lse1,
                         lse2, do1, do2, rate1, rate2, seed, *streams,
                         seed_slot=None):
        return A.bi_attention_bwd_reference(q1, k1, v1, q2, k2, v2, vb, tb,
                                            do1, do2, rate1, rate2, seed,
                                            *streams)

    monkeypatch.setattr(A, "_on_cpu", lambda *t: False)
    for name, fn in (("_attention_fwd", attention_fwd),
                     ("_attention_bwd", attention_bwd),
                     ("_bi_attention_fwd", bi_attention_fwd),
                     ("_bi_attention_bwd", bi_attention_bwd)):
        monkeypatch.setattr(A, name, fn)


def test_remat_through_the_launch_branch(env, monkeypatch):
    """On the card the kernel sites take the launch branch of their autograd
    Functions, whose backward must unpack each saved tensor once: the
    recompute of activation checkpointing refuses a second unpack.  With
    that branch forced, --remat still gives the gradients of the run
    without it, at dropout 0.1."""
    _plain_launchers(monkeypatch)
    grads = {}
    for remat in (False, True):
        extra = ["--config_file", env["dropout_config_file"]]
        engine = make_engine("port", flags(env, "port", "pretrain", extra + (
            ["--remat"] if remat else [])))
        engine.train_loader.set_epoch(0)
        batch = {k: torch.from_numpy(v)
                 for k, v in next(iter(engine.train_loader)).items()}
        engine.model.train()
        loss, _ = pts.loss_fn(engine.model, batch,
                              pts._task_config(engine.args, True), 99)
        loss.backward()
        grads[remat] = {n: p.grad.clone() for n, p in
                        engine.model.named_parameters() if p.grad is not None}
        engine.close()
    assert grads[False].keys() == grads[True].keys()
    for k, g in grads[False].items():
        np.testing.assert_allclose(grads[True][k].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
