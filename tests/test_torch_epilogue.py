"""The port's fused dropout + residual + LayerNorm epilogue
(youtube_vln_tpu_torch/ops/epilogue.py, kernels B5/B6): the plain version
and the autograd Function against the JAX package's Pallas kernels run in
interpret mode on the CPU (rate 0, as tests/test_epilogue.py runs them;
the TPU PRNG has no interpreter), the epilogue's Philox mask, the site
rule against ``select_epilogue_fn``, and the model's routing.

The CUDA kernels are held to the same plain version on the card by
chip_smoke.py, with the same masks.
"""
import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtube_vln_tpu.config import tiny_config as jax_tiny_config
from youtube_vln_tpu.models import layers as jax_layers
from youtube_vln_tpu.ops import epilogue as jax_epilogue
from youtube_vln_tpu_torch.config import tiny_config
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.models.layers import LayerNorm
from youtube_vln_tpu_torch.ops import epilogue as E
from youtube_vln_tpu_torch.ops import philox

RATE = 0.1
SHAPES = [(4, 104, 256), (1, 101, 256)]


def _inputs(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    return (rng.normal(size=shape).astype(dtype), rng.normal(size=shape).astype(dtype),
            rng.normal(size=d).astype(np.float32), rng.normal(size=d).astype(np.float32))


def _t(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_forward(dtype, shape):
    h, res, w, b = _inputs(0, shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_epilogue.pallas_dropout_add_ln(
        jnp.asarray(h, jdt), jnp.asarray(res, jdt),
        {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tdt = getattr(torch, dtype)
    th, tres, tw, tb = _t(h, res, w, b)
    got = E.epilogue_reference(th.to(tdt), tres.to(tdt), tw, tb)
    assert got.dtype == tdt
    # bf16: reduction-order noise in the f32 statistics can flip the final
    # bf16 rounding (the tolerance of tests/test_epilogue.py)
    tol = dict(atol=1e-5, rtol=0) if dtype == "float32" else dict(atol=5e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_function_gradients_match_pallas(shape):
    h, res, w, b = _inputs(1, shape)

    def loss(h, res, w, b):
        return jnp.sum(jnp.sin(jax_epilogue.pallas_dropout_add_ln(
            h, res, {"w": w, "b": b})))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (h, res, w, b)))
    leaves = _t(h, res, w, b, grad=True)
    out = E.fused_dropout_add_ln(*leaves)
    got = torch.autograd.grad(torch.sin(out).sum(), leaves)
    for name, g, r in zip(("dh", "dres", "dw", "db"), got, want):
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=2e-6 * scale, err_msg=name)


def test_reference_is_the_layer_norm_path_at_rate_0():
    h, res, w, b = _t(*_inputs(2, (3, 7, 128)))
    ln = LayerNorm(128)
    with torch.no_grad():
        ln.weight.copy_(w)
        ln.bias.copy_(b)
    for dtype in (torch.float32, torch.bfloat16):
        x, r = h.to(dtype), res.to(dtype)
        assert torch.equal(E.epilogue_reference(x, r, w, b), ln(x + r))


# --------------------------------------------------------------------------- #
# the epilogue's Philox mask
# --------------------------------------------------------------------------- #
def _philox_scalar(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    m = 0xFFFFFFFF
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & m, (p0 >> 32) ^ c3 ^ k1, p0 & m)
        k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
    return c0, c1, c2, c3


def test_epilogue_mask_known_answers():
    """The scalar Philox meets Random123's known answers, and the epilogue
    mask is word (col % 4) of counter (row, col // 4, 0, 2) under the
    64-bit seed's key, kept at or above rate * 2^32."""
    assert _philox_scalar((0, 0, 0, 0), (0, 0)) == (
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)
    assert _philox_scalar((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
                          (0xa4093822, 0x299f31d0)) == (
        0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)
    seed = (7 << 40) + 12345
    keep = philox.epilogue_keep(seed, RATE, 70, 1024)
    key = philox.seed_key(seed)
    thresh = philox.keep_threshold(RATE)
    for row, col in ((0, 0), (0, 3), (1, 4), (69, 1023), (33, 514), (12, 7)):
        word = _philox_scalar((row, col // 4, 0, philox.EPILOGUE_DIRECTION), key)[col % 4]
        assert bool(keep[row, col]) == (word >= thresh), (row, col)
    # rows are global: a block of rows equals the same rows of the whole
    assert torch.equal(philox.epilogue_keep(seed, RATE, 70, 1024)[40:],
                       keep[40:])
    assert not torch.equal(philox.epilogue_keep(seed + 1, RATE, 70, 1024), keep)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_epilogue_drop_fraction_within_four_sigma(rate):
    keep = philox.epilogue_keep(2024, rate, 256, 1024)
    n = keep.numel()
    dropped = n - int(keep.sum())
    assert abs(dropped - n * rate) <= 4 * (n * rate * (1 - rate)) ** 0.5


def test_backward_replays_the_forward_mask():
    """Where the forward dropped h, h does not reach the output and dh is
    exactly 0; kept entries carry dy / (1 - rate)."""
    h, res, w, b = _t(*_inputs(3, (2, 50, 256)))
    out = E.epilogue_reference(h, res, w, b, RATE, 77)
    keep = philox.epilogue_keep(77, RATE, 100, 256).view(h.shape)
    assert 0 < int((~keep).sum()) < keep.numel()
    h2 = torch.where(keep, h, h + 100.0)
    assert torch.equal(E.epilogue_reference(h2, res, w, b, RATE, 77), out)
    do = torch.from_numpy(np.random.default_rng(4).normal(size=h.shape).astype(np.float32))
    dh, dres, _, _ = E.epilogue_bwd_reference(h, res, w, do, RATE, 77)
    assert torch.equal(dh == 0, ~keep)
    torch.testing.assert_close(dh[keep], dres[keep] / (1 - RATE), rtol=1e-6, atol=0)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_plain_backward_matches_autograd_of_eager_ops(rate):
    """The plain backward against autograd through eager dropout, add and
    LayerNorm with the same mask (f32)."""
    h, res, w, b = _inputs(5, (3, 40, 256))
    do = torch.from_numpy(np.random.default_rng(6).normal(size=h.shape).astype(np.float32))
    got = E.epilogue_bwd_reference(*_t(h, res, w), do, rate, 9)
    leaves = _t(h, res, w, b, grad=True)
    x = leaves[0]
    if rate:
        keep = philox.epilogue_keep(9, rate, 120, 256).view(h.shape)
        x = torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)
    y = x + leaves[1]
    u = y.mean(-1, keepdim=True)
    yhat = (y - u) * torch.rsqrt((y - u).square().mean(-1, keepdim=True) + 1e-12)
    want = torch.autograd.grad(leaves[2] * yhat + leaves[3], leaves, do)
    for name, g, r in zip(("dh", "dres", "dw", "db"), got, want):
        scale = max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6 * scale, msg=name)


def test_function_runs_the_plain_versions_on_the_cpu():
    h, res, w, b = _inputs(7, (2, 30, 128))
    leaves = _t(h, res, w, b, grad=True)
    E.reset_launch_counts()
    out = E.fused_dropout_add_ln(*leaves, dropout_rate=RATE, seed=3)
    do = torch.ones_like(out)
    got = torch.autograd.grad(out, leaves, do)
    want = E.epilogue_bwd_reference(*_t(h, res, w), do, RATE, 3)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert torch.equal(out, E.epilogue_reference(*_t(h, res, w, b), RATE, 3))
    assert set(E.LAUNCHES.values()) == {0}


def test_epilogue_struct_mirrors_the_c_layout():
    """struct Epilogue in csrc/epilogue.cu: 12 pointers, 3 ints, then
    struct vln_philox::Dropout (36 bytes), which ends on the pointers'
    alignment."""
    assert E._Epilogue.n_rows.offset == 12 * 8
    assert E._Epilogue.n_blocks.offset == 12 * 8 + 8
    assert E._Epilogue.dropout.offset == 12 * 8 + 12
    assert ctypes.sizeof(E._Epilogue) == 12 * 8 + 12 + 36


# --------------------------------------------------------------------------- #
# the site rule and the model's routing
# --------------------------------------------------------------------------- #
class _Shaped:
    """Stands in for an array in the JAX rule: shape and size only."""

    def __init__(self, shape):
        self.shape, self.size = shape, math.prod(shape)

    def reshape(self, *shape):
        return self

    def __add__(self, other):
        return self


def _jax_picks_kernel(monkeypatch, shape, rate, train) -> bool:
    """Whether ``select_epilogue_fn``'s fn sends this site to the Pallas
    kernel (the kernel call and the XLA path are replaced by recorders)."""
    calls = []
    monkeypatch.setattr(jax_epilogue, "_fused_epilogue",
                        lambda *a: calls.append("kernel") or _Shaped(shape))
    monkeypatch.setattr(jax_layers, "layer_norm", lambda x, p: calls.append("xla") or x)
    monkeypatch.setattr(jax_layers, "dropout", lambda x, *a: x)
    cfg = jax_tiny_config(use_pallas_attention=True, use_pallas_epilogue=True)
    fn = jax_epilogue.select_epilogue_fn(cfg, platform="tpu")
    fn(_Shaped(shape), _Shaped(shape), {"w": None, "b": None}, rate,
       jax.random.PRNGKey(0), train)
    assert len(calls) == 1
    return calls[0] == "kernel"


@pytest.mark.parametrize("shape,rate,train,want", [
    ((56, 808, 1024), RATE, True, True),     # pretraining vision stream
    ((56, 60, 768), RATE, True, False),      # text stream: too small
    ((96, 60, 768), RATE, True, True),       # 4.42 M elements
    ((56, 808, 96), RATE, True, False),      # D not a multiple of 128
    ((56, 808, 1024), RATE, False, False),   # eval
    ((56, 808, 1024), 0.0, True, False)])    # no dropout
def test_site_rule_matches_select_epilogue_fn(monkeypatch, shape, rate, train, want):
    assert _jax_picks_kernel(monkeypatch, shape, rate, train) == want
    assert E.use_epilogue_kernel_for(math.prod(shape), shape[-1], rate, train) == want


WIDE = dict(v_hidden_size=128, v_num_attention_heads=2, v_intermediate_size=128,
            bi_hidden_size=128, bi_num_attention_heads=2)


def _forward(cfg, seed=0, train=True):
    rng = np.random.default_rng(seed)
    n, s_t, s_v = 3, 12, 20
    model = Lily(cfg, device="cpu").init_weights(1).train(train)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (n, s_t)))
    feats = torch.from_numpy(rng.normal(size=(n, s_v, cfg.v_feature_size)).astype(np.float32))
    locs = torch.from_numpy(rng.random((n, s_v, 12)).astype(np.float32))
    return model(tokens, feats, locs, seed=11)


@pytest.mark.parametrize("knobs,calls", [
    (dict(use_epilogue_kernels=True), 8),
    (dict(use_epilogue_kernels=False), 0),
    (dict(use_epilogue_kernels=True, use_attention_kernels=False), 0)])
def test_model_calls_the_function_at_the_vision_sites(monkeypatch, knobs, calls):
    """With the size threshold at 0, the 2 vision layers (attention and
    feed-forward outputs) and the 2 connection layers (BiOutput vision side
    and vision feed-forward) are the sites: the text stream (width 32) is
    not a multiple of 128."""
    seen = []
    fused = E.fused_dropout_add_ln

    def record(h, res, weight, bias, **kw):
        seen.append((tuple(h.shape), kw["dropout_rate"]))
        return fused(h, res, weight, bias, **kw)

    monkeypatch.setattr(E, "MIN_FUSED_ELEMENTS", 0)
    monkeypatch.setattr(E, "fused_dropout_add_ln", record)
    cfg = tiny_config(**WIDE, ranking=True, compute_dtype="float32", **knobs)
    out = _forward(cfg)
    assert len(seen) == calls
    assert all(shape[-1] == 128 and rate == cfg.v_hidden_dropout_prob
               for shape, rate in seen)
    assert torch.isfinite(out["ranking"]).all()
    # eval mode runs no site
    seen.clear()
    _forward(cfg, train=False)
    assert not seen


def test_knob_changes_nothing_without_dropout(monkeypatch):
    monkeypatch.setattr(E, "MIN_FUSED_ELEMENTS", 0)
    no_dropout = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                      v_attention_probs_dropout_prob=0.0, v_hidden_dropout_prob=0.0,
                      fusion_dropout_prob=0.0)
    outs = [_forward(tiny_config(**WIDE, **no_dropout, ranking=True, masked_vision=True,
                                 compute_dtype="float32", use_epilogue_kernels=knob))
            for knob in (False, True)]
    for key in outs[0]:
        assert torch.equal(outs[0][key], outs[1][key]), key


def test_knob_with_dropout_draws_the_kernel_masks(monkeypatch):
    """Dropout on: the knob moves the vision sites to the Philox rule, so
    the outputs differ, and a fixed seed repeats them."""
    monkeypatch.setattr(E, "MIN_FUSED_ELEMENTS", 0)
    cfgs = [tiny_config(**WIDE, ranking=True, compute_dtype="float32",
                        use_epilogue_kernels=knob) for knob in (False, True, True)]
    off, on, again = (_forward(c)["ranking"] for c in cfgs)
    assert not torch.equal(off, on)
    assert torch.equal(on, again)


# --------------------------------------------------------------------------- #
# B6's grid and layout query (the kernel runs only on the card)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_rows,want", [
    (56 * 808, 264),     # pretraining vision sites: one wave of 2 x 132 blocks
    (1001, 251),         # fewer rows than a wave holds: ceil(1001 / 4)
    (1056, 264),         # exactly one wave of 4-row blocks
    (1, 1)])
def test_bwd_grid_is_one_wave(n_rows, want):
    """A stub occupancy of 2 resident blocks of 4 rows on each of 132 SMs:
    the grid is one wave, or the blocks the rows need when fewer."""
    assert E._bwd_blocks(n_rows, rows_per_block=4, blocks_per_sm=2, sms=132) == want


def test_bwd_grid_refuses_a_kernel_that_fits_no_block():
    with pytest.raises(RuntimeError, match="fits no block"):
        E._bwd_blocks(45_248, rows_per_block=4, blocks_per_sm=0, sms=132)


def test_bwd_layout_reads_the_c_query_in_field_order(monkeypatch):
    """``_bwd_layout`` names vln_epilogue_bwd_layout's out[6] by
    ``BWD_LAYOUT_FIELDS`` (the order of csrc/epilogue.cu) and raises on a
    CUDA error."""
    import contextlib
    import re

    source = (E._build.CSRC / "epilogue.cu").read_text()
    c_order = re.search(r"const int layout\[\] = \{(.*?)\};", source, re.S).group(1)
    assert [x.strip() for x in c_order.split(",")][:3] == [
        "B6_ROWS", "B6_THREADS", "blocks"]
    assert len(E.BWD_LAYOUT_FIELDS) == 6 == len(c_order.split(","))

    def query(is_bf16, out):
        for i in range(6):
            out[i] = 10 * i + is_bf16
        return 0 if is_bf16 else 98

    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(E, "_kernel", lambda name, argtypes: query)
    E._bwd_layout.cache_clear()
    try:
        layout = E._bwd_layout(True, 0)
        assert layout == {f: 10 * i + 1 for i, f in enumerate(E.BWD_LAYOUT_FIELDS)}
        assert layout["blocks_per_sm"] == 21
        with pytest.raises(RuntimeError, match="CUDA error 98"):
            E._bwd_layout(False, 0)
    finally:
        E._bwd_layout.cache_clear()
