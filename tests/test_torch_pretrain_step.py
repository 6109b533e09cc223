"""The pretraining path of the port, YTb fixture -> YTbDataset (MLM + MVM
masking) -> Loader -> build_train_step, against the JAX package's on the
same fixture: each package reads batches from its own loader (the same
seeds give the same batches, tests/test_torch_data.py), and trains the
four MRT tasks (masked language, masked vision, ranking, trajectory
judgement) at ``tiny_config`` widened so that the vision self-attention and
the co-attention are kernel sites (head dim 64); f32, dropout off, the
sparse MVM targets and the candidate-dedup transport of the pretraining
recipe."""
import jax
import numpy as np
import pytest
import torch

from youtube_vln_tpu.config import RunConfig as JaxRunConfig
from youtube_vln_tpu.config import tiny_config as jax_tiny_config
from youtube_vln_tpu.data import datasets as jds
from youtube_vln_tpu.data import features_reader as jfr
from youtube_vln_tpu.data import fixtures as jfix
from youtube_vln_tpu.data import loader as jloader
from youtube_vln_tpu.data import tokenizer as jtok
from youtube_vln_tpu.models import init_lily_params
from youtube_vln_tpu.parallel import train_step as jts
from youtube_vln_tpu_torch.config import RunConfig, tiny_config
from youtube_vln_tpu_torch.data import datasets as pds
from youtube_vln_tpu_torch.data import features_reader as pfr
from youtube_vln_tpu_torch.data import fixtures as pfix
from youtube_vln_tpu_torch.data import loader as ploader
from youtube_vln_tpu_torch.data import tokenizer as ptok
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.models.weights import state_dict_from_jax_params
from youtube_vln_tpu_torch.parallel import train_step as pts

TASKS = dict(ranking=True, traj_judge=True, masked_vision=True, masked_language=True)
# head dim 64 on the vision and co-attention sides; the store's 2048-d
# features and 1601 detector classes
MODEL = dict(v_hidden_size=128, v_num_attention_heads=2, v_intermediate_size=128,
             bi_hidden_size=128, bi_num_attention_heads=2, v_feature_size=2048,
             v_target_size=1601, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0, v_attention_probs_dropout_prob=0.0,
             v_hidden_dropout_prob=0.0, fusion_dropout_prob=0.0, **TASKS)
# the pretraining recipe (README: pretrain.py --pre_dataset ytb
# --masked_vision --masked_language --ranking --traj_judge) at fixture size
RUN = dict(pretrain=True, pre_dataset="ytb", max_instruction_length=32,
           max_path_length=4, max_num_boxes=5, min_path_length=3, min_captioned=2,
           max_captioned=4, num_negatives=2, learning_rate=1e-3, **TASKS)
BATCH, STEPS = 2, 5


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return {name: fix.build_ytb_fixture(tmp_path_factory.mktemp(name), seed=1)
            for name, fix in (("jax", jfix), ("port", pfix))}


def _batches(ds_mod, fr_mod, tok_mod, loader_mod, args, paths, n, accum):
    """The first n batches of the package's own Loader (epochs 0, 1, ...)."""
    reader = fr_mod.YTbFeaturesReader(paths["store_path"])
    ds = ds_mod.YTbDataset(args=args, caption_path=paths["caption_path"],
                           tokenizer=tok_mod.load_tokenizer(paths["vocab_path"]),
                           features_reader=reader, masked_vision=True,
                           masked_language=True, training=True, seed=0)
    loader = loader_mod.Loader(ds, BATCH, shuffle=True, seed=4, drop_last=True)
    out, epoch = [], 0
    try:
        while len(out) < n:
            loader.set_epoch(epoch)
            out += [b if accum == 1 else loader_mod.microbatch_reshape(b, accum)
                    for b in loader]
            epoch += 1
    finally:
        reader.close()
    return out[:n]


def _jax_losses(paths, accum):
    args = JaxRunConfig(**RUN, skeleton_path=paths["skeleton_path"],
                        gradient_accumulation_steps=accum)
    cfg = jax_tiny_config(**MODEL)
    params = init_lily_params(jax.random.PRNGKey(0), cfg)
    state, tx, _ = jts.create_train_state(params, args, steps_per_epoch=3)
    step = jax.jit(jts.build_train_step(cfg, args, tx))
    metrics = []
    for i, batch in enumerate(_batches(jds, jfr, jtok, jloader, args, paths, STEPS, accum)):
        state, m = step(state, batch, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params


def _port_model(params):
    cfg = tiny_config(**MODEL, compute_dtype="float32")
    model = Lily(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg), strict=True)
    return cfg, model


@pytest.mark.parametrize("accum", [1, 2])
def test_five_step_mrt_trajectory_matches_jax(paths, accum):
    want, params = _jax_losses(paths["jax"], accum)
    cfg, model = _port_model(params)
    args = RunConfig(**RUN, skeleton_path=paths["port"]["skeleton_path"],
                     gradient_accumulation_steps=accum)
    args.validate()
    optimizer, _ = pts.create_train_state(model, args, steps_per_epoch=3)
    step = pts.build_train_step(model, cfg, args, optimizer, device="cpu")
    got = [{k: float(v) for k, v in step(batch, seed=i).items()}
           for i, batch in enumerate(_batches(pds, pfr, ptok, ploader, args,
                                              paths["port"], STEPS, accum))]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for key in ("loss/train", "loss/language", "loss/vision", "loss/ranking",
                    "loss/traj"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=(i, key))
        for key in g:
            if key.startswith("correct/"):
                # a count over its total, divided in another order
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6, err_msg=(i, key))
    assert all(g["loss/vision"] > 0 and g["loss/language"] > 0 for g in got)
    assert len({g["loss/train"] for g in got}) == STEPS   # the parameters move


def test_accumulation_two_equals_one_on_the_same_rows(paths):
    """One global batch of 4 as one step or two micro-steps of the same 2
    rows each (the batch repeated, so every per-micro-step mean, the
    masked-token and masked-region means included, equals the global one);
    ConstantLR, so both runs take the same step size, and the parameters
    must move, or the equality would say nothing."""
    args1 = RunConfig(**RUN, skeleton_path=paths["port"]["skeleton_path"],
                      ConstantLR=True)
    batch = _batches(pds, pfr, ptok, ploader, args1, paths["port"], 1, 1)[0]
    double = {k: np.concatenate([v, v]) for k, v in batch.items()}
    params = init_lily_params(jax.random.PRNGKey(3), jax_tiny_config(**MODEL))
    results = []
    for accum in (1, 2):
        cfg, model = _port_model(params)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        args = RunConfig(**RUN, skeleton_path=paths["port"]["skeleton_path"],
                         ConstantLR=True, gradient_accumulation_steps=accum)
        optimizer, _ = pts.create_train_state(model, args, steps_per_epoch=1)
        step = pts.build_train_step(model, cfg, args, optimizer, device="cpu")
        metrics = step(double if accum == 1 else ploader.microbatch_reshape(double, 2),
                       seed=0)
        after = {n: p.detach().clone() for n, p in model.named_parameters()}
        assert max(float((after[n] - before[n]).abs().max()) for n in after) > 1e-4
        results.append((metrics, after))
    (m1, p1), (m2, p2) = results
    for key in m1:
        if key.startswith("loss/"):
            np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=1e-5,
                                       err_msg=key)
        else:
            assert float(m2[key]) == float(m1[key]), key
    for name in p1:
        torch.testing.assert_close(p2[name], p1[name], rtol=1e-5, atol=1e-6, msg=name)
