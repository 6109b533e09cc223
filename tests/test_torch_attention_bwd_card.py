"""The wgmma route of B3 and B4 (youtube_vln_tpu_torch/ops/csrc/
attention_bwd.cu, ``attention_bwd_kernel<128>``) on the card, against the
plain backward (``attention_bwd_reference``, ``bi_attention_bwd_reference``)
with the same Philox masks: the fine-tuning shapes with a padded candidate,
odd lengths, a shard of the heads and of the rows, a second launch bitwise
the first, and the route's launch counter.
Marked ``cuda``: they skip without a card (the kernel needs nvcc and an
H100).

    python -m pytest --noconftest -m cuda tests/test_torch_attention_bwd_card.py
"""
import pytest
import torch

from youtube_vln_tpu_torch.ops import attention as A

RATE, SEED, D = 0.1, 0x5EED, 128
# kernel against the plain version: max abs error over max(1, max |plain|);
# 1e-2 is about two and a half bf16 ulps at the largest output (the bound
# chip_smoke.py holds B1-B4 to)
REL_TOL = 1e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _heads(gen, b, h, s):
    """[b, h, s, D] bf16 as the model lays it out: a view of [b, s, h, D]."""
    x = torch.randn(b, s, h, D, generator=gen, device=gen.device)
    return x.to(torch.bfloat16).transpose(1, 2)


def _operands(card, b, h, s_q, s_kv, rate=RATE, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    q, do = _heads(gen, b, h, s_q), _heads(gen, b, h, s_q)
    k, v = _heads(gen, b, h, s_kv), _heads(gen, b, h, s_kv)
    drop = torch.rand(b, s_kv, generator=gen, device=card) < 0.1
    bias = torch.where(drop, -10000.0, 0.0)
    bias[0] = -10000.0           # a padded candidate: every key masked
    out, lse, _ = A._attention_fwd(q, k, v, bias, rate, SEED, True)
    return q, k, v, bias, out, do, lse


def _close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        g, w = g.float(), w.float()
        assert bool(torch.isfinite(g).all()), name
        err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
        assert err <= REL_TOL, (name, err)


def _bwd(ops, rate=RATE, *streams):
    return A._attention_bwd(*ops, rate, SEED, *streams)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s_q,s_kv,rate", [
    (96, 8, 808, 808, 0.1),      # fine-tuning (30RS): B*H = 768
    (96, 8, 808, 808, 0.0),
    (3, 2, 809, 809, 0.1),
    (2, 3, 200, 809, 0.1),
    (2, 3, 809, 200, 0.1),
    (4, 2, 128, 128, 0.1),
    (2, 2, 101, 809, 0.1),
    (2, 2, 1, 300, 0.1),
    (2, 3, 300, 17, 0.1),
    (2, 2, 101, 100, 0.1)])      # short on both sides: the two-pass kernel
def test_wgmma_route_matches_the_plain_version(card, b, h, s_q, s_kv, rate):
    ops = _operands(card, b, h, s_q, s_kv, rate)
    A.reset_launch_counts()
    got = _bwd(ops, rate)
    wgmma = A.bwd_route(torch.bfloat16, D, [(s_q, s_kv)]) == "wgmma"
    assert A.LAUNCHES["attention_bwd"] == 1
    assert A.LAUNCHES["attention_bwd_wgmma"] == int(wgmma)
    assert wgmma == (max(s_q, s_kv) >= 128)
    q, k, v, bias, out, do, lse = ops
    _close(got, A.attention_bwd_reference(q, k, v, bias, do, rate, SEED))
    again = _bwd(ops, rate)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
def test_a_shard_of_heads_or_rows_is_the_full_launch_sliced(card):
    """Heads [2, 6) of 8 passed with head0 / heads_total, and rows [4, 8)
    of 12 passed with stream0 = 4 * 8, draw the masks of the whole problem:
    their gradients are the full launch's slice, bit for bit, and match the
    plain version given the same mapping."""
    ops = _operands(card, 12, 8, 808, 808, seed=1)
    full = _bwd(ops)
    A.reset_launch_counts()
    # the bias is per key, not per head; a shard's LSE is its own, contiguous
    heads = [x if i == 3 else x[:, 2:6] for i, x in enumerate(ops)]
    heads[6] = heads[6].contiguous()
    got = _bwd(heads, RATE, 0, 2, 8)
    assert all(torch.equal(g, f[:, 2:6]) for g, f in zip(got, full))
    q, k, v, bias, out, do, lse = heads
    _close(got, A.attention_bwd_reference(q, k, v, bias, do, RATE, SEED, 0, 0, 2, 8))
    rows = [x[4:8] for x in ops]
    got = _bwd(rows, RATE, 4 * 8)
    assert all(torch.equal(g, f[4:8]) for g, f in zip(got, full))
    q, k, v, bias, out, do, lse = rows
    _close(got, A.attention_bwd_reference(q, k, v, bias, do, RATE, SEED, 0, 4 * 8))
    assert A.LAUNCHES["attention_bwd_wgmma"] == 2


@pytest.mark.cuda
def test_b4_on_the_wgmma_route_matches_the_plain_version(card):
    """B4 at the fine-tuning shape (96 x 8 heads, 60 text <-> 808 vision
    tokens, dropout 0.1 both ways): both directions in one launch on the
    wgmma route, twice bitwise equal."""
    gen = torch.Generator(device=card).manual_seed(2)
    vis = [_heads(gen, 96, 8, 808) for _ in range(3)]
    txt = [_heads(gen, 96, 8, 60) for _ in range(3)]
    vb = torch.where(torch.rand(96, 808, generator=gen, device=card) < 0.1, -10000.0, 0.0)
    tb = torch.zeros(96, 60, device=card)
    tb[0] = -10000.0
    do1, do2 = _heads(gen, 96, 8, 60), _heads(gen, 96, 8, 808)
    c1, c2, l1, l2, _ = A._bi_attention_fwd(*vis, *txt, vb, tb, RATE, RATE, SEED, True)
    A.reset_launch_counts()
    got = A._bi_attention_bwd(*vis, *txt, vb, tb, c1, c2, l1, l2, do1, do2, RATE, RATE,
                              SEED)
    assert A.LAUNCHES["bi_attention_bwd"] == A.LAUNCHES["attention_bwd_wgmma"] == 1
    want = A.bi_attention_bwd_reference(*vis, *txt, vb, tb, do1, do2, RATE, RATE, SEED)
    _close(got[:3], want[:3])
    _close(got[3:], want[3:])
    again = A._bi_attention_bwd(*vis, *txt, vb, tb, c1, c2, l1, l2, do1, do2, RATE, RATE,
                                SEED)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
