"""The port's attention (youtube_vln_tpu_torch/ops/attention.py) against the
JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_attention.py runs them.

On the CPU the wrappers take their plain PyTorch versions, so these tests
hold the plain versions of B1 and B2 to the TPU kernels' semantics (f32,
1e-5).  The CUDA kernels are held to the same plain versions on the card by
chip_smoke.py.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtube_vln_tpu.ops.attention import (pallas_attention_core,
                                           pallas_bi_attention, use_pallas_for)
from youtube_vln_tpu_torch.models.layers import split_heads
from youtube_vln_tpu_torch.ops import attention as port

ATOL = 1e-5


def _qkv(rng, b, h, s, d):
    return rng.normal(size=(b, h, s, d)).astype(np.float32)


def _bias(rng, b, s, keep=0.9):
    row = (rng.random((b, s)) < keep).astype(np.float32)
    return (1.0 - row) * -10000.0


def _jax_mask(bias):
    return jnp.asarray(bias[:, None, None, :])


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("b,h,sq,skv,d", [
    (2, 4, 64, 64, 64),
    (1, 2, 128, 64, 128),   # cross-attention shape
    (1, 2, 128, 60, 128),   # non-aligned kv length (vision -> text)
    (1, 2, 61, 67, 64),     # ragged query and key lengths
])
def test_b1_plain_matches_pallas(b, h, sq, skv, d):
    rng = np.random.default_rng(sq * 1000 + skv)
    q, k, v = _qkv(rng, b, h, sq, d), _qkv(rng, b, h, skv, d), _qkv(rng, b, h, skv, d)
    bias = _bias(rng, b, skv)
    ref = pallas_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                _jax_mask(bias))
    out = port.fused_attention(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_b1_masked_keys_are_blocked():
    """Perturbing masked-out values leaves the output unchanged (as
    tests/test_attention.py:test_mask_fully_blocks_keys)."""
    rng = np.random.default_rng(1)
    b, h, s, d = 1, 2, 64, 64
    q, k, v = _qkv(rng, b, h, s, d), _qkv(rng, b, h, s, d), _qkv(rng, b, h, s, d)
    bias = np.zeros((b, s), np.float32)
    bias[:, s // 2:] = -10000.0
    out = port.fused_attention(_t(q), _t(k), _t(v), _t(bias))
    v2 = v.copy()
    v2[:, :, s // 2:] += 100.0
    out2 = port.fused_attention(_t(q), _t(k), _t(v2), _t(bias))
    np.testing.assert_allclose(out.numpy(), out2.numpy(), atol=ATOL)
    ref = pallas_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                _jax_mask(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_b1_fully_masked_rows_stay_finite():
    """A padded candidate masks every real key: the softmax is near-uniform
    over them, exactly as the TPU kernel computes it, never NaN."""
    rng = np.random.default_rng(2)
    b, h, s, d = 2, 2, 60, 64
    q, k, v = _qkv(rng, b, h, s, d), _qkv(rng, b, h, s, d), _qkv(rng, b, h, s, d)
    bias = np.zeros((b, s), np.float32)
    bias[1] = -10000.0
    out = port.fused_attention(_t(q), _t(k), _t(v), _t(bias)).numpy()
    assert np.isfinite(out).all()
    ref = pallas_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                _jax_mask(bias))
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("s_v,s_t,d", [(128, 60, 64), (202, 60, 128)])
def test_b2_plain_matches_pallas(s_v, s_t, d):
    rng = np.random.default_rng(s_v + d)
    b, h = 2, 2
    q1, k1, v1 = (_qkv(rng, b, h, s_v, d) for _ in range(3))
    q2, k2, v2 = (_qkv(rng, b, h, s_t, d) for _ in range(3))
    vb, tb = _bias(rng, b, s_v), _bias(rng, b, s_t)
    ref1, ref2 = pallas_bi_attention(
        *(jnp.asarray(x) for x in (q1, k1, v1, q2, k2, v2)),
        _jax_mask(vb), _jax_mask(tb))
    ctx1, ctx2 = port.fused_bi_attention(
        *(_t(x) for x in (q1, k1, v1, q2, k2, v2)), _t(vb), _t(tb))
    assert ctx1.shape == (b, h, s_t, d) and ctx2.shape == (b, h, s_v, d)
    np.testing.assert_allclose(ctx1.numpy(), np.asarray(ref1), atol=ATOL)
    np.testing.assert_allclose(ctx2.numpy(), np.asarray(ref2), atol=ATOL)


def test_cpu_wrappers_launch_nothing():
    rng = np.random.default_rng(3)
    q = _t(_qkv(rng, 1, 2, 64, 64)).requires_grad_()
    port.reset_launch_counts()
    out = port.fused_attention(q, q, q, None)
    ctx1, ctx2 = port.fused_bi_attention(q, q, q, q, q, q)
    (out.sum() + ctx1.sum() + ctx2.sum()).backward()
    assert q.grad is not None
    assert port.LAUNCHES == {"attention_fwd": 0, "bi_attention_fwd": 0,
                             "attention_bwd": 0, "bi_attention_bwd": 0}


@pytest.mark.parametrize("s_q,s_kv,d", [
    (808, 808, 128), (60, 808, 128), (808, 60, 128), (60, 60, 64),
    (808, 808, 96), (64, 64, 64), (63, 64, 64), (202, 202, 128)])
def test_dispatch_matches_pallas_heuristic(s_q, s_kv, d):
    assert port.use_kernel_for(s_q, s_kv, d) == use_pallas_for(s_q, s_kv, d)


def test_dropout_is_refused():
    """Rates outside [0, 1) are refused; a rate inside it is accepted, and a
    fixed seed repeats its mask while another seed changes it."""
    q = _t(_qkv(np.random.default_rng(8), 1, 2, 64, 64))
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError):
            port.fused_attention(q, q, q, dropout_rate=rate)
        with pytest.raises(ValueError):
            port.fused_bi_attention(q, q, q, q, q, q, rate1=rate)
    out = port.fused_attention(q, q, q, dropout_rate=0.1, seed=3)
    torch.testing.assert_close(
        out, port.fused_attention(q, q, q, dropout_rate=0.1, seed=3), rtol=0, atol=0)
    assert not torch.equal(out, port.fused_attention(q, q, q, dropout_rate=0.1, seed=4))
    assert not torch.equal(out, port.fused_attention(q, q, q))
    ctx = port.fused_bi_attention(q, q, q, q, q, q, rate1=0.1, rate2=0.1, seed=3)
    again = port.fused_bi_attention(q, q, q, q, q, q, rate1=0.1, rate2=0.1, seed=3)
    for a, b in zip(ctx, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_non_cuda_device_is_refused():
    q = torch.zeros(1, 1, 64, 64, device="meta")
    with pytest.raises(ValueError):
        port.fused_attention(q, q, q)


def test_key_bias_layout_is_checked():
    with pytest.raises(ValueError):
        port._key_bias(torch.zeros(2, 1, 1, 5), 2, 5, "cpu")
    assert port._key_bias(None, 2, 5, "cpu").shape == (2, 5)


def test_operand_keeps_split_heads_views():
    """split_heads yields a transposed view; the kernel reads it through its
    strides without a copy.  A view off the 16-byte grid is copied."""
    x = torch.randn(3, 10, 4 * 64)
    q = split_heads(x, 4)
    assert not q.is_contiguous()
    assert port._operand(q, q).data_ptr() == q.data_ptr()
    odd = torch.randn(3, 10, 4 * 64 + 1)[..., 1:].reshape(3, 10, 4, 64)
    fixed = port._operand(odd.transpose(1, 2), q)
    assert fixed.is_contiguous() and fixed.data_ptr() % 16 == 0


def test_output_is_a_merge_heads_view():
    q = torch.zeros(2, 3, 5, 64)
    out = port._output(q)
    assert out.shape == q.shape
    assert out.transpose(1, 2).is_contiguous()


def test_problem_struct_mirrors_the_c_layout():
    """struct Problem in csrc/attention_fwd.cu: 6 pointers, 12 int64
    strides, 2 ints, then struct vln_philox::Dropout of csrc/philox.cuh
    (4 uint32, a float, an int, the uint32 offset, heads_total and
    head0), padded to the pointers' alignment."""
    assert ctypes.sizeof(port._Dropout) == 9 * 4
    assert port._Dropout.offset.offset == 6 * 4
    assert port._Dropout.heads_total.offset == 7 * 4
    assert port._Dropout.head0.offset == 8 * 4
    assert ctypes.sizeof(port._Problem) == 6 * 8 + 12 * 8 + 2 * 4 + 9 * 4 + 4
    assert port._Problem.q_sb.offset == 48
    assert port._Problem.o_ss.offset == 48 + 11 * 8
    assert port._Problem.s_kv.offset == 148
    assert port._Problem.dropout.offset == 152
