"""The port's Lily model against the JAX ``lily_forward`` / ``bert_model``.

Weights cross over with ``state_dict_from_jax_params``; inputs are made
from a seed with numpy; comparisons are in f32 at 1e-4 (JAX matmuls at
"highest" precision, set by conftest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtube_vln_tpu.config import lily_base_config as jax_base_config
from youtube_vln_tpu.config import tiny_config as jax_tiny_config
from youtube_vln_tpu.models import init_lily_params, lily_forward
from youtube_vln_tpu.models.torch_io import params_to_state_dict
from youtube_vln_tpu.models.vilbert import bert_model
from youtube_vln_tpu_torch.config import lily_base_config, tiny_config
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.models.weights import (normalize_state_dict,
                                                  state_dict_from_jax_params)

ATOL = 1e-4
HEADS = dict(ranking=True, traj_judge=True, masked_vision=True,
             masked_language=True)
# flagship widths, depth cut to 2 text / 1 vision / 1 connection layer
FLAGSHIP_CUT = dict(num_hidden_layers=2, v_num_hidden_layers=1,
                    v_biattention_id=(0,), t_biattention_id=(1,))


def _batch(seed, n, s_t, s_v, v_feat, vocab):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, size=(n, s_t)).astype(np.int32)
    t_mask = np.ones((n, s_t), np.int32)
    t_mask[:, s_t - s_t // 4:] = 0
    segments = rng.integers(0, 2, size=(n, s_t)).astype(np.int32)
    feats = rng.normal(size=(n, s_v, v_feat)).astype(np.float32)
    locs = rng.random(size=(n, s_v, 12)).astype(np.float32)
    locs[..., 11] = rng.integers(0, 8, size=(n, s_v))
    v_mask = np.ones((n, s_v), np.int32)
    v_mask[:, s_v - s_v // 8:] = 0
    v_mask[-1] = 0          # a padded candidate: every visual key masked
    return tokens, feats, locs, segments, t_mask, v_mask


def _pair(jax_cfg, port_cfg, seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, init_lily_params(jax.random.PRNGKey(seed), jax_cfg))
    model = Lily(port_cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, port_cfg),
                          strict=True)
    return params, model.eval()


def _compare_heads(params, model, jax_cfg, batch, **idx):
    fwd = jax.jit(lambda p, b, i: lily_forward(p, jax_cfg, *b, **i))
    ref = fwd(params, tuple(jnp.asarray(x) for x in batch),
              {k: jnp.asarray(v) for k, v in idx.items()})
    with torch.inference_mode():
        out = model(*(torch.from_numpy(x) for x in batch),
                    **{k: torch.from_numpy(v) for k, v in idx.items()})
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    return out


@pytest.mark.parametrize("sparse_heads", [False, True])
def test_tiny_all_heads_match_jax(sparse_heads):
    jax_cfg = jax_tiny_config(**HEADS)
    port_cfg = tiny_config(**HEADS, compute_dtype="float32")
    params, model = _pair(jax_cfg, port_cfg)
    batch = _batch(0, 3, 12, 20, 64, 256)
    idx = {}
    if sparse_heads:
        rng = np.random.default_rng(9)
        idx = dict(language_target_idx=rng.integers(0, 12, (3, 4)).astype(np.int32),
                   vision_target_idx=rng.integers(0, 20, (3, 5)).astype(np.int32))
    out = _compare_heads(params, model, jax_cfg, batch, **idx)
    if sparse_heads:
        assert out["language"].shape == (3, 4, 256)
        assert out["vision"].shape == (3, 5, 23)


def test_flagship_widths_all_heads_match_jax():
    """Flagship widths (768 text / 1024 vision and bi, 8 and 12 heads) at
    cut depth; S_v = 202 routes the vision self-attention and the
    co-attention through the kernel wrappers (their plain versions here)."""
    jax_cfg = jax_base_config(**FLAGSHIP_CUT, **HEADS)
    port_cfg = lily_base_config(**FLAGSHIP_CUT, **HEADS,
                                compute_dtype="float32")
    params, model = _pair(jax_cfg, port_cfg)
    _compare_heads(params, model, jax_cfg, _batch(1, 2, 60, 202, 2048, 30522))


@pytest.mark.parametrize("mode", [
    dict(in_batch_pairs=True), dict(fast_mode=True),
    dict(fixed_t_layer=2), dict(with_coattention=False),
    dict(use_attention_kernels=False)])
def test_encoder_modes_match_jax(mode):
    jax_mode = {k: v for k, v in mode.items() if k != "use_attention_kernels"}
    jax_cfg = jax_tiny_config(**jax_mode)
    port_cfg = tiny_config(**mode, compute_dtype="float32")
    params, model = _pair(jax_cfg, port_cfg, seed=3)
    tokens, feats, locs, segments, t_mask, v_mask = _batch(2, 2, 12, 20, 64, 256)
    if mode.get("fast_mode"):
        # one instruction row broadcast over all image rows
        tokens, segments, t_mask = tokens[:1], segments[:1], t_mask[:1]
    batch = (tokens, feats, locs, segments, t_mask, v_mask)
    ref = jax.jit(lambda p, b: bert_model(p, jax_cfg, *b))(
        params, tuple(jnp.asarray(x) for x in batch))
    with torch.inference_mode():
        out = model.bert(*(torch.from_numpy(x) for x in batch))
    for name, a, b in zip(("seq_t", "seq_v", "pooled_t", "pooled_v"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


def test_reference_checkpoint_loads_strict_and_scores_the_same():
    """The JAX package's reference-layout export (q_dense zeros, the tied
    decoder, the ``model_state_dict`` wrapper, gamma/beta names) loads with
    strict=True after normalize_state_dict."""
    jax_cfg = jax_tiny_config(**HEADS)
    port_cfg = tiny_config(**HEADS, compute_dtype="float32")
    params, carried = _pair(jax_cfg, port_cfg, seed=5)
    sd = params_to_state_dict(params, jax_cfg)
    legacy = {k.replace("LayerNorm.weight", "LayerNorm.gamma")
               .replace("LayerNorm.bias", "LayerNorm.beta"): v
              for k, v in sd.items()}
    model = Lily(port_cfg, device="cpu")
    model.load_state_dict(normalize_state_dict({"model_state_dict": legacy}),
                          strict=True)
    model.eval()
    assert (model.cls.predictions.decoder.weight
            is model.bert.embeddings.word_embeddings.weight)
    batch = _batch(4, 2, 12, 20, 64, 256)
    out = _compare_heads(params, model, jax_cfg, batch)
    with torch.inference_mode():
        ref = carried(*(torch.from_numpy(x) for x in batch))
    for key in ref:
        torch.testing.assert_close(out[key], ref[key], rtol=0, atol=0)


def test_normalize_adds_missing_bert_prefix():
    sd = {"embeddings.LayerNorm.gamma": np.ones(3, np.float32),
          "encoder.layer.0.output.dense.weight": np.zeros((2, 2), np.float32),
          "cls.predictions.bias": np.zeros(3, np.float32)}
    out = normalize_state_dict(sd)
    assert sorted(out) == ["bert.embeddings.LayerNorm.weight",
                           "bert.encoder.layer.0.output.dense.weight",
                           "cls.predictions.bias"]
    assert all(isinstance(v, torch.Tensor) for v in out.values())


def test_train_mode_is_refused():
    """Train mode without a dropout seed is refused; with one, the outputs
    are finite, repeat for the seed and differ from eval mode."""
    model = Lily(tiny_config(**HEADS), device="cpu").init_weights(0)
    batch = [torch.from_numpy(x) for x in _batch(0, 2, 8, 8, 64, 256)]
    with pytest.raises(ValueError):
        model(*batch)
    with torch.no_grad():
        train = model(*batch, seed=11)
        again = model(*batch, seed=11)
        evals = model.eval()(*batch)
    for key in evals:
        assert torch.isfinite(train[key]).all(), key
        torch.testing.assert_close(train[key], again[key], rtol=0, atol=0)
        assert not torch.equal(train[key], evals[key]), key


def test_seeded_init_is_deterministic():
    cfg = tiny_config()
    a = Lily(cfg, device="cpu").init_weights(7).state_dict()
    b = Lily(cfg, device="cpu").init_weights(7).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert float(a["bert.embeddings.word_embeddings.weight"][0].abs().sum()) == 0


@pytest.mark.parametrize("rate", [0.1, 0.5, 1.0])
def test_xla_path_dropout_quantises_the_keep_rate(rate):
    """The JAX package's XLA-path dropout (models/layers.py:78-94): uint8
    draws, keep probability thresh / 256 with thresh = round(keep * 256)
    (230 / 256 = 0.8984 at rate 0.1), kept values scaled by 256 / thresh,
    zeros where thresh is 0."""
    from youtube_vln_tpu_torch.models.layers import DropoutRng, dropout
    x = torch.ones(256, 1024)
    y = dropout(x, rate, DropoutRng(3, "cpu"))
    thresh = min(round((1.0 - rate) * 256), 255)
    if thresh == 0:
        assert not y.any()
        return
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 256.0 / thresh))
    n, p = x.numel(), thresh / 256
    assert abs(int(kept.sum()) - n * p) <= 4 * (n * p * (1 - p)) ** 0.5
    assert torch.equal(dropout(x, rate, None), x)
