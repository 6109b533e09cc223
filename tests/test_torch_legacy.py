"""The port's legacy ViLBERT heads (youtube_vln_tpu_torch/models/legacy.py)
against the JAX package's (models/legacy.py), at ``tiny_config`` widened to
head dim 64 on the vision and co-attention sides, with 60 text and 80
visual tokens, so those sites run the B1-B4 autograd Functions' plain
versions on the CPU.  f32: eval outputs 1e-4 (of the largest), gradients
with dropout off 1e-4 (relative L2 per tensor); the hard-coded head
dropouts active in train mode (their drop fractions, statistically); the
reference's weight-norm key names loaded with ``strict=True``."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtube_vln_tpu.config import tiny_config as jax_tiny_config
from youtube_vln_tpu.models import init_lily_params
from youtube_vln_tpu.models import legacy as JL
from youtube_vln_tpu_torch.config import tiny_config
from youtube_vln_tpu_torch.models import legacy as PL
from youtube_vln_tpu_torch.models.weights import legacy_state_dict_from_jax_params

N, S_T, S_V, LABELS = 3, 60, 80, 11
# head dim 64 on the vision and co-attention sides: kernel sites
WIDE = dict(v_hidden_size=128, v_num_attention_heads=2, v_intermediate_size=128,
            bi_hidden_size=128, bi_num_attention_heads=2)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  v_attention_probs_dropout_prob=0.0, v_hidden_dropout_prob=0.0)


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _params(cfg, seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, init_lily_params(jax.random.PRNGKey(seed), cfg))
    cls = jax.tree_util.tree_map(np.asarray, JL.init_simple_classifier(
        jax.random.PRNGKey(seed + 1), cfg.bi_hidden_size, 2 * cfg.bi_hidden_size, LABELS))
    return params, cls


def _models(**overrides):
    kw = dict(WIDE, **overrides)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw, compute_dtype="float32")
    params, cls = _params(jcfg)
    pre = PL.BertForMultiModalPreTraining(cfg, device="cpu")
    pre.load_state_dict(legacy_state_dict_from_jax_params(params, cfg), strict=True)
    vl = PL.VILBertForVLTasks(cfg, LABELS, device="cpu")
    vl.load_state_dict(legacy_state_dict_from_jax_params(params, cfg, cls), strict=True)
    return jcfg, params, cls, pre.eval(), vl.eval()


def _batch(seed=0, n=N):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 256, size=(n, S_T)).astype(np.int32)
    t_mask = np.ones((n, S_T), np.int32)
    t_mask[:, 45:] = 0
    segments = rng.integers(0, 2, size=(n, S_T)).astype(np.int32)
    feats = rng.normal(size=(n, S_V, 64)).astype(np.float32)
    locs = rng.random(size=(n, S_V, 12)).astype(np.float32)
    locs[..., 11] = rng.integers(0, 8, size=(n, S_V))
    v_mask = np.ones((n, S_V), np.int32)
    v_mask[:, 70:] = 0
    return tokens, feats, locs, segments, t_mask, v_mask


def _t(batch):
    return [torch.from_numpy(x) for x in batch]


def test_eval_outputs_match_jax():
    jcfg, params, cls, pre, vl = _models()
    batch = _batch()
    want = jax.jit(lambda p, b: JL.multimodal_pretraining_forward(p, jcfg, *b))(
        params, tuple(map(jnp.asarray, batch)))
    want_vl = jax.jit(lambda p, c, b: JL.vl_tasks_forward(p, jcfg, c, *b))(
        params, cls, tuple(map(jnp.asarray, batch)))
    with torch.inference_mode():
        got = pre(*_t(batch))
        got_vl = vl(*_t(batch))
    assert [tuple(g.shape) for g in got] == [(N, S_T, 256), (N, S_V, 23), (N, 2)]
    for g, w in zip(got, want):
        close(g.numpy(), w, 1e-4)
    assert got_vl.shape == (N, LABELS) and got_vl.dtype == torch.float32
    close(got_vl.numpy(), want_vl, 1e-4)


def _assert_grads_close(got, want, rtol):
    """Relative L2 per tensor, each norm floored at 1% of the global one."""
    floor = 1e-2 * float(np.sqrt(sum(np.sum(w.numpy().astype(np.float64) ** 2)
                                     for w in want.values())))
    for name, g in got.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        err, denom = np.linalg.norm(g - w), max(np.linalg.norm(w), floor)
        assert err <= rtol * denom, (name, err / denom)


@pytest.mark.parametrize("head", ["pretraining", "vl_tasks"])
def test_gradients_match_jax_with_dropout_off(head):
    jcfg, params, cls, pre, vl = _models(**NO_DROPOUT)
    cfg = pre.cfg
    batch = _batch(1)
    rng = np.random.default_rng(2)
    if head == "pretraining":
        w = [rng.normal(size=s).astype(np.float32)
             for s in ((N, S_T, 256), (N, S_V, 23), (N, 2))]

        def jloss(p):
            outs = JL.multimodal_pretraining_forward(p, jcfg, *map(jnp.asarray, batch))
            return sum(jnp.sum(o * x) for o, x in zip(outs, w))

        model = pre
        loss = sum((o * torch.from_numpy(x)).sum() for o, x in zip(model(*_t(batch)), w))
        jgrads = jax.jit(jax.grad(jloss))(params)
        want = legacy_state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    else:
        w = rng.normal(size=(N, LABELS)).astype(np.float32)

        def jloss(p, c):
            return jnp.sum(JL.vl_tasks_forward(p, jcfg, c, *map(jnp.asarray, batch)) * w)

        model = vl
        loss = (model(*_t(batch)) * torch.from_numpy(w)).sum()
        jgrads, jcls = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, cls)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        want = legacy_state_dict_from_jax_params(to_np(jgrads), cfg, to_np(jcls))
    loss.backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    # the decoder is tied to the word embedding: one parameter, one gradient
    want.pop("cls.predictions.decoder.weight", None)
    _assert_grads_close(got, want, rtol=1e-4)


def test_head_dropouts_active_in_train_mode():
    """Dropout(0.1) on the fused pool and the classifier's Dropout(0.5)
    act in train mode (XLA-path sites: the keep probability is quantised
    to 230/256 and 128/256), with every other rate 0; the same seed gives
    the same output, eval mode none of it."""
    _, _, _, pre, vl = _models(**NO_DROPOUT)
    batch = _t(_batch(3, n=16))
    seen = {}
    hooks = [pre.cls.bi_seq_relationship.register_forward_pre_hook(
                 lambda m, a: seen.__setitem__("pool", a[0].clone())),
             vl.vil_prediction.main[0].register_forward_hook(
                 lambda m, a, out: seen.__setitem__("h0", out.clone())),
             vl.vil_prediction.main[3].register_forward_pre_hook(
                 lambda m, a: seen.__setitem__("hidden", a[0].clone()))]
    with torch.no_grad():
        pre(*batch)
        pool_eval = seen["pool"]
        vl(*batch)
        assert torch.equal(seen["hidden"], torch.relu(seen["h0"]))
        pre.train()
        vl.train()
        with pytest.raises(ValueError):
            vl(*batch)
        pre(*batch, seed=5)
        first = vl(*batch, seed=5)
        assert torch.equal(first, vl(*batch, seed=5))
        assert not torch.equal(first, vl(*batch, seed=6))
    for h in hooks:
        h.remove()
    # (the value before the site, after it, the keep probability)
    for before, after, keep in ((pool_eval, seen["pool"], 230 / 256),
                                (torch.relu(seen["h0"]), seen["hidden"], 128 / 256)):
        live = before != 0
        dropped = (after == 0) & live
        frac = float(dropped.sum()) / float(live.sum())
        assert abs(frac - (1 - keep)) < 0.05, frac
        kept = ~dropped & live
        torch.testing.assert_close(after[kept], before[kept] / keep)


def test_weight_norm_keys_load_strictly():
    """``torch.nn.utils.weight_norm(nn.Linear, dim=None)``'s state dict
    (``weight_g`` 0-dim, ``weight_v``, ``bias``) loads into
    ``WeightNormLinear`` and gives the same output."""
    torch.manual_seed(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = torch.nn.utils.weight_norm(torch.nn.Linear(16, 5), dim=None)
    with torch.no_grad():
        ref.weight_g.mul_(1.7)
    sd = ref.state_dict()
    assert sd["weight_g"].dim() == 0 and set(sd) == {"weight_g", "weight_v", "bias"}
    wn = PL.WeightNormLinear(16, 5, device="cpu")
    wn.load_state_dict(sd, strict=True)
    x = torch.randn(4, 16)
    torch.testing.assert_close(wn(x), ref(x))
    cls = PL.SimpleClassifier(16, 32, 5, device="cpu")
    assert set(cls.state_dict()) == {f"main.{i}.{k}" for i in (0, 3)
                                     for k in ("weight_g", "weight_v", "bias")}


def test_constructors_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tiny_config()
    for make in (lambda: PL.BertForMultiModalPreTraining(cfg),
                 lambda: PL.VILBertForVLTasks(cfg, 3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model = PL.VILBertForVLTasks(cfg, 3, device="cpu").init_weights(0)
    wn = model.vil_prediction.main[0]
    assert torch.allclose(wn.weight_g, torch.linalg.vector_norm(wn.weight_v))
