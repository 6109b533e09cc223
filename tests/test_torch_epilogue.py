"""The port's fused dropout + residual + LayerNorm epilogue
(youtube_vln_tpu_torch/ops/epilogue.py, kernels B5/B6): the plain version
and the autograd Function against the JAX package's Pallas kernels run in
interpret mode on the CPU (rate 0, as tests/test_epilogue.py runs them;
the TPU PRNG has no interpreter), the epilogue's Philox mask, the site
rule against ``select_epilogue_fn``, and the model's routing.  Then the
LayerNorm of every other site (ops/layer_norm.py): its Function against
the eager formula and the JAX ``layer_norm``, the XLA-path dropout draw
before it, and the launches of both kernels' branches in a train step.

The CUDA kernels are held to the same plain versions on the card by
chip_smoke.py, with the same masks, and by tests/test_torch_layer_norm_card.py.
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
from benchmark import counts
from benchmark.reference import lily as ref_lily
from youtube_vln_tpu_torch.config import tiny_config
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.models.layers import (DropoutRng, LayerNorm,
                                                 dropout_add_ln)
from youtube_vln_tpu_torch.ops import _build
from youtube_vln_tpu_torch.ops import epilogue as E
from youtube_vln_tpu_torch.ops import layer_norm as LN
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
    struct vln_philox::Dropout (48 bytes, with its seed table's pointer)
    on the pointers' alignment."""
    assert E._Epilogue.n_rows.offset == 12 * 8
    assert E._Epilogue.n_blocks.offset == 12 * 8 + 8
    assert E._Epilogue.dropout.offset == 12 * 8 + 16
    assert ctypes.sizeof(E._Epilogue) == 12 * 8 + 16 + 48


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

    source = (_build.CSRC / "epilogue.cu").read_text()
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


# --------------------------------------------------------------------------- #
# the LayerNorm of every site that B5/B6 do not take (ops/layer_norm.py)
# --------------------------------------------------------------------------- #
def _eager_layer_norm(x, w, b):
    """The port's LayerNorm before it had a kernel, op for op (the JAX
    ``layer_norm``)."""
    x32 = x.float()
    u = x32.mean(-1, keepdim=True)
    s = (x32 - u).square().mean(-1, keepdim=True)
    return (w * ((x32 - u) * torch.rsqrt(s + 1e-12)) + b).to(x.dtype)


def _bf16_ulp(t):
    """The spacing of bf16 numbers at |t| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(t.abs().float().clamp_min(2.0 ** -120))) - 7)


def _ln_inputs(seed, d, dtype):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.normal(size=(2, 37, d)) + 0.5).astype(np.float32)
    dy = rng.normal(size=(2, 37, d)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    b = (0.1 * rng.normal(size=d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    # bf16 operands rounded once, then both sides read the same values
    x, dy = (torch.from_numpy(a).to(tdt) for a in (x, dy))
    return x, dy, torch.from_numpy(w), torch.from_numpy(b)


def _want(against, x, dy, w, b):
    """(y, dx, dw, db) of the eager formula (torch autograd) or of the JAX
    ``layer_norm`` (jax.vjp), on the same values."""
    if against == "eager":
        leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(),
                  b.clone().requires_grad_()]
        y = _eager_layer_norm(*leaves)
        return (y.detach(), *torch.autograd.grad(y, leaves, dy))
    jdt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32

    def j(t):
        return jnp.asarray(t.float().numpy(), jdt if t.dim() == 3 else jnp.float32)

    y, vjp = jax.vjp(lambda x, w, b: jax_layers.layer_norm(x, {"w": w, "b": b}),
                     j(x), j(w), j(b))
    grads = vjp(j(dy))
    return tuple(torch.from_numpy(np.array(t, np.float32)) for t in (y, *grads))


@pytest.mark.parametrize("against", ["eager", "jax"])
@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_the_eager_formula_and_jax(dtype, d, against):
    """``layer_norm`` under autograd (``LayerNormFn``: the plain forward and
    the closed-form backward the kernel computes) against the eager formula
    and the JAX ``layer_norm``: y and dx in x's dtype, dw and db in f32."""
    x, dy, w, b = _ln_inputs(d, d, dtype)
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(),
              b.clone().requires_grad_()]
    y = LN.layer_norm(*leaves)
    got = (y.detach(), *torch.autograd.grad(y, leaves, dy))
    want = _want(against, x, dy, w, b)
    assert [t.dtype for t in got] == [x.dtype, x.dtype, torch.float32, torch.float32]
    if against == "eager":
        # the CPU runs the formula itself
        assert torch.equal(got[0], want[0])
    for name, g, r in zip(("y", "dx", "dw", "db"), got, want):
        g, r = g.float(), r.float()
        scale = float(r.abs().max())
        # f32: the two sides differ by the order of their f32 sums, a few
        # ulps of the largest value (ROADMAP D1 asks 1e-4; 1e-5 holds)
        tol = torch.full_like(r, 1e-5 * scale)
        if dtype == "bfloat16" and name in ("y", "dx"):
            # one bf16 ulp: the same f32 value to a few ulps rounds to
            # neighbouring bf16 numbers at most, beside that f32 floor
            # where dx cancels to near 0
            tol = torch.maximum(_bf16_ulp(r), tol)
        assert bool(((g - r).abs() <= tol).all()), (name, float((g - r).abs().max()))


def test_layer_norm_struct_mirrors_the_c_layout():
    """struct LayerNormCall in csrc/layer_norm.cu: 10 pointers, then 3 ints,
    padded to the pointers' alignment."""
    assert LN._LayerNormCall.n_rows.offset == 10 * 8
    assert LN._LayerNormCall.n_blocks.offset == 10 * 8 + 8
    assert ctypes.sizeof(LN._LayerNormCall) == 10 * 8 + 16


@pytest.mark.parametrize("n_rows,want", [
    (16 * 6 * 808, 132),   # 30RS vision sites: one wave of 132 blocks
    (1001, 126),           # fewer rows than a wave holds: ceil(1001 / 8)
    (1056, 132),           # exactly one wave of 8-row blocks
    (1, 1)])
def test_layer_norm_bwd_grid_is_one_wave(n_rows, want):
    assert LN._bwd_blocks(n_rows, wave=132) == want


def test_layer_norm_bwd_grid_refuses_a_kernel_that_fits_no_block():
    with pytest.raises(RuntimeError, match="fits no block"):
        LN._bwd_blocks(5760, wave=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ranker_site_draws_the_xla_path_mask(monkeypatch, dtype):
    """A dropout + add + LayerNorm site of the ranker (``use_epilogue_kernels``
    off, a vision-width site that B5 would take with it on) draws the uint8
    mask of the JAX ``dropout`` from the forward's generator, as the port
    did before the LayerNorm had a kernel: the same draws in the same order,
    so the output and the generator's state after the call are bitwise
    those of the eager code, and no kernel seed is taken."""
    monkeypatch.setattr(E, "MIN_FUSED_ELEMENTS", 0)
    cfg = tiny_config(**WIDE, ranking=True, use_epilogue_kernels=False)
    tdt = getattr(torch, dtype)
    h, res, w, b = (torch.from_numpy(a) for a in _inputs(5, (4, 101, 128)))
    h, res = h.to(tdt), res.to(tdt)
    ln = LayerNorm(128)
    with torch.no_grad():
        ln.weight.copy_(w)
        ln.bias.copy_(b)
    rng, twin = DropoutRng(1234, "cpu"), DropoutRng(1234, "cpu")
    rate = cfg.v_hidden_dropout_prob
    out = dropout_add_ln(h, res, ln, rate, rng, cfg)
    thresh = round((1.0 - rate) * 256)
    bits = torch.randint(0, 256, h.shape, dtype=torch.uint8, generator=twin.generator)
    dropped = torch.where(bits < thresh, h * (256.0 / thresh), 0.0).to(tdt)
    assert torch.equal(out, _eager_layer_norm(dropped + res, w, b))
    assert torch.equal(rng.generator.get_state(), twin.generator.get_state())
    assert rng.sites == 0


def _counting_launchers(monkeypatch):
    """The launch branches of the epilogue and LayerNorm Functions forced on
    the CPU, each launcher its plain version that counts as the kernel's
    does."""
    def epi_fwd(h, res, w, b, rate, seed, row0=0, seed_slot=None):
        E.LAUNCHES["epilogue_fwd"] += 1
        d = h.shape[-1]
        h, res = h.reshape(-1, d), res.reshape(-1, d)
        return E.epilogue_reference(h, res, w, b, rate, seed, row0), (h, res, w)

    def epi_bwd(h, res, w, do, rate, seed, row0=0, seed_slot=None):
        E.LAUNCHES["epilogue_bwd"] += 1
        return E.epilogue_bwd_reference(h, res, w, do.reshape(h.shape), rate,
                                        seed, row0)

    def ln_fwd(x, w, b):
        LN.LAUNCHES["layer_norm_fwd"] += 1
        x = x.reshape(-1, x.shape[-1])
        return LN.layer_norm_reference(x, w, b), x

    def ln_bwd(x, w, dy):
        LN.LAUNCHES["layer_norm_bwd"] += 1
        return LN.layer_norm_bwd_reference(x, w, dy.reshape(x.shape))

    for module, name, fn in ((E, "_epilogue_fwd", epi_fwd), (E, "_epilogue_bwd", epi_bwd),
                             (LN, "_fwd", ln_fwd), (LN, "_bwd", ln_bwd)):
        monkeypatch.setattr(module, name, fn)
    monkeypatch.setattr(E, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(LN, "_on_cpu", lambda *t: False)


@pytest.mark.parametrize("knob", [False, True])
def test_train_step_launches_at_every_layer_norm_site(monkeypatch, knob):
    """A train forward and backward with both Functions on their launch
    branches: B5/B6 launch at the sites ``counts.epilogue_sites`` gives
    (none with the knob off, as in the ranker), the LayerNorm kernels at
    every other LayerNorm site, once forward and once backward each; the
    gradients are those of the CPU branches."""
    monkeypatch.setattr(E, "MIN_FUSED_ELEMENTS", 0)
    monkeypatch.setattr(ref_lily, "MIN_FUSED_ELEMENTS", 0)
    cfg = tiny_config(**WIDE, ranking=True, compute_dtype="float32",
                      use_epilogue_kernels=knob)
    n, s_t, s_v = 3, 12, 20
    runs = []
    for forced in (False, True):
        with monkeypatch.context() as m:
            if forced:
                _counting_launchers(m)
            E.reset_launch_counts()
            LN.reset_launch_counts()
            model = Lily(cfg, device="cpu").init_weights(1).train()
            rng = np.random.default_rng(0)
            tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (n, s_t)))
            feats = torch.from_numpy(rng.normal(size=(n, s_v, cfg.v_feature_size))
                                     .astype(np.float32))
            locs = torch.from_numpy(rng.random((n, s_v, 12)).astype(np.float32))
            out = model(tokens, feats, locs, seed=11)["ranking"]
            out.float().square().sum().backward()
            runs.append(({k: p.grad.clone() for k, p in model.named_parameters()
                          if p.grad is not None}, dict(E.LAUNCHES), dict(LN.LAUNCHES)))
    (plain, *_), (forced, epi, ln) = runs
    sites = counts.epilogue_sites(
        {"use_epilogue_kernels": knob, "use_attention_kernels": True,
         "hidden_size": cfg.hidden_size, "v_hidden_size": cfg.v_hidden_size,
         "v_num_hidden_layers": cfg.v_num_hidden_layers,
         "v_biattention_id": cfg.v_biattention_id}, n, s_t, s_v)
    assert sites == (8 if knob else 0)
    assert epi == {"epilogue_fwd": sites, "epilogue_bwd": sites}
    # embeddings, two per text and vision layer, four per connection layer
    ln_sites = (2 + 2 * cfg.num_hidden_layers + 2 * cfg.v_num_hidden_layers
                + 4 * len(cfg.v_biattention_id))
    assert ln == {"layer_norm_fwd": ln_sites - sites, "layer_norm_bwd": ln_sites - sites}
    assert plain.keys() == forced.keys()
    for k in plain:
        assert torch.equal(plain[k], forced[k]), k
