"""The port's attention backward (B3/B4 plain versions and the autograd
Functions of youtube_vln_tpu_torch/ops/attention.py) and its Philox dropout
(ops/philox.py).

The plain backward versions are held to ``jax.grad`` through the JAX
package's Pallas kernels, run in interpret mode on the CPU (f32, 1e-5).
The CUDA kernels are held to the same plain versions on the card by
chip_smoke.py, with the same Philox masks.
"""
import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtube_vln_tpu.ops.attention import (pallas_attention_core,
                                           pallas_bi_attention)
from youtube_vln_tpu_torch.ops import _build
from youtube_vln_tpu_torch.ops import attention as port
from youtube_vln_tpu_torch.ops import philox

TOL = dict(rtol=1e-5, atol=1e-5)
RATE = 0.1


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _eighths(rng, *shape):
    """Multiples of 1/8 in [-1, 1]: with D = 64 every score q k^T / 8 is
    exact in f32 in any order of summation, so a row whose keys all carry
    -10000 (rounded at the f32 ulp of 10000) rounds alike in both stacks."""
    return (rng.integers(-8, 9, size=shape) / 8).astype(np.float32)


def _bias(rng, b, s, masked_row=None):
    bias = (rng.random((b, s)) >= 0.9).astype(np.float32) * -10000.0
    if masked_row is not None:
        bias[masked_row] = -10000.0      # a padded candidate
    return bias


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _jax_mask(bias):
    return jnp.asarray(bias[:, None, None, :])


def _leaves(*xs):
    return [torch.from_numpy(x).requires_grad_() for x in xs]


@pytest.mark.parametrize("b,h,sq,skv,d,masked_row", [
    (2, 2, 64, 64, 64, None),
    (1, 2, 61, 67, 128, None),     # ragged query and key lengths
    (2, 2, 60, 128, 64, 1),        # text -> vision shape, a fully masked row
])
def test_b3_plain_matches_pallas_grad(b, h, sq, skv, d, masked_row):
    rng = np.random.default_rng(sq * 100 + skv)
    draw = _normal if masked_row is None else _eighths
    q, k = draw(rng, b, h, sq, d), draw(rng, b, h, skv, d)
    v = _normal(rng, b, h, skv, d)
    do = _normal(rng, b, h, sq, d)
    bias = _bias(rng, b, skv, masked_row)

    def loss(q, k, v):
        return jnp.sum(pallas_attention_core(q, k, v, _jax_mask(bias)) * do)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    got = port.attention_bwd_reference(*_t(q, k, v, bias, do))
    for name, a, r in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL, err_msg=name)


@pytest.mark.parametrize("s_v,s_t,d,masked_row", [
    (128, 60, 64, 0),              # a padded candidate on both sides
    (67, 61, 128, None)])          # ragged lengths
def test_b4_plain_matches_pallas_grad(s_v, s_t, d, masked_row):
    rng = np.random.default_rng(s_v + s_t + d)
    b, h = 2, 2
    draw = _normal if masked_row is None else _eighths
    vis = [draw(rng, b, h, s_v, d) for _ in range(3)]
    txt = [draw(rng, b, h, s_t, d) for _ in range(3)]
    vb, tb = _bias(rng, b, s_v, masked_row), _bias(rng, b, s_t, masked_row)
    do1, do2 = _normal(rng, b, h, s_t, d), _normal(rng, b, h, s_v, d)

    def loss(*ops):
        c1, c2 = pallas_bi_attention(*ops, _jax_mask(vb), _jax_mask(tb))
        return jnp.sum(c1 * do1) + jnp.sum(c2 * do2)

    ref = jax.grad(loss, argnums=tuple(range(6)))(*(jnp.asarray(x) for x in vis + txt))
    got = port.bi_attention_bwd_reference(*_t(*vis, *txt, vb, tb, do1, do2))
    for name, a, r in zip(("q1", "k1", "v1", "q2", "k2", "v2"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_attention_fn_matches_autograd_of_plain_forward(rate):
    """FusedAttentionFn on CPU tensors (plain forward + plain backward that
    replays the mask) against torch.autograd through the plain forward."""
    rng = np.random.default_rng(11)
    q, k, v = _normal(rng, 2, 2, 61, 64), _normal(rng, 2, 2, 67, 64), _normal(rng, 2, 2, 67, 64)
    do = torch.from_numpy(_normal(rng, 2, 2, 61, 64))
    bias = torch.from_numpy(_bias(rng, 2, 67, 1))
    fn_in, ref_in = _leaves(q, k, v), _leaves(q, k, v)
    out = port.fused_attention(*fn_in, bias, dropout_rate=rate, seed=77)
    ref = port.attention_reference(*ref_in, bias, rate, 77)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    got = torch.autograd.grad(out, fn_in, do)
    want = torch.autograd.grad(ref, ref_in, do)
    for name, a, r in zip("qkv", got, want):
        torch.testing.assert_close(a, r, **TOL, msg=name)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_bi_attention_fn_matches_autograd_of_plain_forward(rate):
    rng = np.random.default_rng(12)
    vis = [_normal(rng, 2, 2, 70, 64) for _ in range(3)]
    txt = [_normal(rng, 2, 2, 60, 64) for _ in range(3)]
    vb, tb = (torch.from_numpy(_bias(rng, 2, s, 0)) for s in (70, 60))
    do1, do2 = (torch.from_numpy(_normal(rng, 2, 2, s, 64)) for s in (60, 70))
    fn_in, ref_in = _leaves(*vis, *txt), _leaves(*vis, *txt)
    out = port.fused_bi_attention(*fn_in, vb, tb, rate1=rate, rate2=rate, seed=5)
    ref = port.bi_attention_reference(*ref_in, vb, tb, rate, rate, 5)
    got = torch.autograd.grad(out, fn_in, (do1, do2))
    want = torch.autograd.grad(ref, ref_in, (do1, do2))
    for name, a, r in zip(("q1", "k1", "v1", "q2", "k2", "v2"), got, want):
        torch.testing.assert_close(a, r, **TOL, msg=name)


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors (kat_vectors)."""
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0),
             (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((0xffffffff,) * 4, (0xffffffff,) * 2,
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
             (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))):
        got = philox.philox4x32(*ctr, key)
        assert [int(w) for w in got] == list(want)


def test_dropout_mask_is_deterministic_and_seeded():
    a = philox.dropout_keep(123, RATE, 2, 3, 40, 50)
    assert torch.equal(a, philox.dropout_keep(123, RATE, 2, 3, 40, 50))
    assert not torch.equal(a, philox.dropout_keep(124, RATE, 2, 3, 40, 50))
    # 64-bit seeds: the high word is part of the key
    assert not torch.equal(philox.dropout_keep(1 << 40, RATE, 1, 1, 40, 50),
                           philox.dropout_keep(0, RATE, 1, 1, 40, 50))
    # one element is a pure function of (seed, stream, row, key, direction):
    # a sub-block equals the mask of the whole
    word = philox.philox4x32(7, 9, 1 * 3 + 2, 0, philox.seed_key(123))[0]
    assert bool(a[1, 2, 7, 9]) == (int(word) >= philox.keep_threshold(RATE))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_rate_within_four_sigma(rate):
    keep = philox.dropout_keep(2024, rate, 2, 8, 128, 128)
    n = keep.numel()
    dropped = n - int(keep.sum())
    assert abs(dropped - n * rate) <= 4 * (n * rate * (1 - rate)) ** 0.5


def test_backward_replays_the_forward_mask():
    """With V the identity the forward returns P~ itself (the dropped and
    rescaled probabilities); the plain backward's dV must be P~^T dO with
    that same P~, and dropped entries are exactly 0 in P~."""
    rng = np.random.default_rng(4)
    s = d = 64
    q, k = _t(_normal(rng, 1, 2, s, d), _normal(rng, 1, 2, s, d))
    v = torch.eye(s).expand(1, 2, s, d).contiguous()
    do = torch.from_numpy(_normal(rng, 1, 2, s, d))
    p_drop = port.attention_reference(q, k, v, None, RATE, 99)
    keep = philox.dropout_keep(99, RATE, 1, 2, s, s)
    assert torch.equal(p_drop == 0, ~keep)
    _, _, dv = port.attention_bwd_reference(q, k, v, None, do, RATE, 99)
    torch.testing.assert_close(dv, p_drop.transpose(-1, -2) @ do, **TOL)


def test_bi_attention_directions_draw_different_masks():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_normal(rng, 1, 2, 64, 64))
    ctx1, ctx2 = port.bi_attention_reference(x, x, x, x, x, x, None, None,
                                             RATE, RATE, 3)
    assert not torch.equal(ctx1, ctx2)
    same1, same2 = port.bi_attention_reference(x, x, x, x, x, x, None, None)
    torch.testing.assert_close(same1, same2, rtol=0, atol=0)
    assert not torch.equal(philox.dropout_keep(3, RATE, 1, 2, 64, 64, 0),
                           philox.dropout_keep(3, RATE, 1, 2, 64, 64, 1))


def test_site_seeds_differ_and_repeat():
    seeds = [philox.site_seed(42, i) for i in range(64)]
    assert len(set(seeds)) == 64
    assert seeds == [philox.site_seed(42, i) for i in range(64)]
    assert all(0 <= s < 2 ** 64 for s in seeds)


def test_bwd_problem_struct_mirrors_the_c_layout():
    """struct BwdProblem in csrc/attention_bwd.cu: 11 pointers, 24 int64
    strides, 2 ints, then struct vln_philox::Dropout (24 bytes)."""
    assert port._BwdProblem.q_sb.offset == 11 * 8
    assert port._BwdProblem.dv_ss.offset == 11 * 8 + 23 * 8
    assert port._BwdProblem.s_q.offset == 280
    assert port._BwdProblem.dropout.offset == 288
    assert ctypes.sizeof(port._BwdProblem) == 288 + 24


def test_library_name_covers_shared_headers(tmp_path, monkeypatch):
    """The built library's name hashes the .cu, every header under csrc/
    and the flags: editing the shared Philox header names a new library,
    so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert set(_build.SOURCES) == {"attention_fwd", "attention_bwd"}
    with open(csrc / "philox.cuh", "a") as f:
        f.write("// edited\n")
    for name in _build.SOURCES:
        assert _build.library_path(name) != before[name]
    assert _build.library_path("attention_fwd").parent == _build.BUILD_DIR
