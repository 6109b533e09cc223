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
    # (7, 9) reads word 1 of the group counter (7, 4, stream, 0); (15, 9)
    # word 3 of the same call; (23, 48) word 2 of counter (15, 24, ...)
    thresh, key = philox.keep_threshold(RATE), philox.seed_key(123)
    for (i, j), ctr, w in (((7, 9), (7, 4), 1), ((15, 9), (7, 4), 3),
                           ((23, 48), (15, 24), 2), ((0, 0), (0, 0), 0)):
        word = philox.philox4x32(*ctr, 1 * 3 + 2, 0, key)[w]
        assert bool(a[1, 2, i, j]) == (int(word) >= thresh)


def _group_words(seed, rate, stream, i0, j0, direction=0):
    """The four keep bits of one Philox call: the group of rows {i0, i0 + 8}
    and keys {j0, j0 + 1} (i0 % 16 < 8, j0 even)."""
    words = philox.philox4x32(((i0 >> 4) << 3) | (i0 & 7), j0 >> 1, stream,
                              direction, philox.seed_key(seed))
    return [int(w) >= philox.keep_threshold(rate) for w in words]


def test_one_philox_call_serves_a_two_by_two_group():
    """Rows {i0, i0 + 8} x keys {j0, j0 + 1} read words x, y, z, w of one
    call, in that order; no two groups share a counter."""
    keep = philox.dropout_keep(31, 0.5, 1, 3, 48, 40, direction=1)
    for i0 in (0, 5, 16, 23, 39):
        for j0 in (0, 6, 38):
            bits = _group_words(31, 0.5, 2, i0, j0, direction=1)
            assert bits == [bool(keep[0, 2, i0, j0]), bool(keep[0, 2, i0, j0 + 1]),
                            bool(keep[0, 2, i0 + 8, j0]),
                            bool(keep[0, 2, i0 + 8, j0 + 1])], (i0, j0)
    counters = {(((i >> 4) << 3) | (i & 7), j >> 1)
                for i in range(48) for j in range(40)}
    assert len(counters) == 48 * 40 // 4


@pytest.mark.parametrize("s_q,s_kv", [(1, 808), (17, 61), (61, 17), (808, 1),
                                      (808, 808)])
def test_dropout_mask_tiles_are_slices_of_the_whole(s_q, s_kv):
    """The mask of any tile, at origins that are no multiple of 16 or 64,
    equals that tile's slice of the whole mask: every bit is a pure
    function of (row, key), as the forward and both backward passes need."""
    whole = philox.dropout_keep(2025, RATE, 1, 2, s_q, s_kv, direction=1)
    rng = np.random.default_rng(s_q * 1000 + s_kv)
    for rows in (1, 17, 61, 808):
        for cols in (1, 17, 61, 808):
            if rows > s_q or cols > s_kv:
                continue
            q0 = int(rng.integers(0, s_q - rows + 1))
            k0 = int(rng.integers(0, s_kv - cols + 1))
            tile = philox.dropout_keep(2025, RATE, 1, 2, rows, cols, direction=1,
                                       q0=q0, k0=k0)
            assert torch.equal(tile, whole[:, :, q0:q0 + rows, k0:k0 + cols]), (
                q0, k0, rows, cols)
    for q0, k0 in ((3, 5), (13, 1), (9, 63)):   # odd origins against the whole
        rows, cols = min(s_q - q0, 17), min(s_kv - k0, 17)
        if rows > 0 and cols > 0:
            tile = philox.dropout_keep(2025, RATE, 1, 2, rows, cols, direction=1,
                                       q0=q0, k0=k0)
            assert torch.equal(tile, whole[:, :, q0:q0 + rows, k0:k0 + cols])


def _query_order(p):
    """attention_bwd.cu query_order: the query row at position p of a
    16-query block of the dK/dV pass."""
    return 8 * (p & 1) + 4 * (p >> 3) + ((p >> 1) & 3)


def test_kernel_fragments_hold_whole_groups():
    """What each thread of the bf16 kernels holds of an m16n8 accumulator
    (rows {g, g + 8} x columns {2t, 2t + 1} of each n-tile, lane = 4g + t)
    is one Philox group in every pass: the forward and the dQ pass in the
    plain layout (rows queries, columns keys), the dK/dV pass in the
    transposed layout with its keys read in the order 0, 2, .., 14, 1, .., 15
    and its queries in query_order."""
    assert sorted(_query_order(p) for p in range(16)) == list(range(16))

    def group(i, j):
        return ((i >> 4) << 3) | (i & 7), j >> 1

    for warp in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for n in range(8):      # forward / dQ: 16 rows x 8 keys per n-tile
                rows = (16 * warp + g, 16 * warp + g + 8)
                keys = (8 * n + 2 * t, 8 * n + 2 * t + 1)
                assert len({group(i, j) for i in rows for j in keys}) == 1
            for n in range(4):      # dK/dV: 16 keys x 8 query positions
                keys = (16 * warp + 2 * g, 16 * warp + 2 * g + 1)   # rows g, g + 8
                block, col = 16 * (n >> 1), 8 * (n & 1) + 2 * t
                queries = (block + _query_order(col), block + _query_order(col + 1))
                assert len({group(i, j) for i in queries for j in keys}) == 1
                assert queries[1] == queries[0] + 8 and keys[0] % 2 == 0


def _row_key(r):
    """attention_bwd.cu wg::row_key: the key (of a warpgroup's 64) that row
    r of the wgmma route's K and V tiles holds."""
    return (r & ~15) + 2 * (r & 7) + ((r >> 3) & 1)


def test_wgmma_fragments_hold_whole_groups():
    """The wgmma route's S^T accumulator (m64n64: element n of lane 4g + t
    of warp w at row 16w + g + 8 ((n >> 1) & 1), column 8 (n >> 2) + 2t +
    (n & 1)), with K and V rows in row_key order, holds keys 2g and 2g + 1
    of the warp's 16 and queries i, i + 8 of the same Philox group, and
    wg::keep_bits puts bit k of group (m, e) on element 8m + e + 2k."""
    assert sorted(_row_key(r) for r in range(64)) == list(range(64))

    def group(i, j):
        return ((i >> 4) << 3) | (i & 7), j >> 1

    for warp in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for n in range(32):
                key = _row_key(16 * warp + g + 8 * ((n >> 1) & 1))
                query = 8 * (n >> 2) + 2 * t + (n & 1)
                m, e = n >> 3, n & 1
                i0, j0 = 16 * m + 2 * t + e, 16 * warp + 2 * g
                assert (query - i0, key - j0) == (8 * ((n >> 2) & 1), (n >> 1) & 1)
                assert group(query, key) == group(i0, j0)
                word = 2 * ((query >> 3) & 1) + (key & 1)   # philox.cuh
                assert n == 8 * m + e + 2 * word


@pytest.mark.parametrize("dtype,d,shapes,route", [
    (torch.bfloat16, 128, [(808, 808)], "wgmma"),           # B3, 30RS and MRT
    (torch.float32, 128, [(808, 808)], "f32"),              # the parity route
    (torch.bfloat16, 128, [(60, 808), (808, 60)], "wgmma"),  # B4, measured faster
    (torch.float32, 128, [(60, 808), (808, 60)], "f32"),
    (torch.bfloat16, 128, [(128, 1)], "wgmma"),
    (torch.bfloat16, 128, [(127, 127)], "mma_sync"),        # short on both sides
    (torch.bfloat16, 128, [(60, 808), (65, 65)], "mma_sync"),
    (torch.bfloat16, 64, [(808, 808)], "mma_sync"),
    (torch.float32, 64, [(60, 60)], "f32")])
def test_bwd_route_by_shape(dtype, d, shapes, route):
    assert port.bwd_route(dtype, d, shapes) == route


def test_wrappers_hand_each_route_its_scratch(monkeypatch):
    """B3 and B4 on CPU tensors with the launch intercepted: the wgmma
    route's problems carry their three scratch buffers (sized by 64-row
    query tiles) and no Delta, the other routes Delta alone; the counter
    counts the wgmma launches only."""
    seen = []
    monkeypatch.setattr(port, "_launch", lambda name, p0, p1, q: seen.append(p0))
    port.reset_launch_counts()

    def ops(b, s, n, dtype):
        return [torch.zeros(b, 2, s, 128, dtype=dtype) for _ in range(n)]

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, o, do = ops(1, 808, 5, dtype)
        lse = torch.zeros(1, 2, 808)
        port._attention_bwd(q, k, v, torch.zeros(1, 808), o, do, lse, 0.1, 5)
    wg, f32 = seen
    assert wg.delta is None and f32.stats is None and f32.delta is not None
    delta, stats, dq_acc, ready = wg.scratch
    assert delta is None and f32.scratch[0] is not None
    tiles = 2 * 13    # b * h * ceil(808 / 64)
    assert (stats.numel(), dq_acc.numel(), ready.numel()) == (
        tiles * 128, tiles * 64 * 128, tiles)
    assert (wg.stats, wg.dq_acc, wg.dq_ready) == tuple(
        t.data_ptr() for t in (stats, dq_acc, ready))
    vis, txt = ops(1, 808, 3, torch.bfloat16), ops(1, 60, 3, torch.bfloat16)
    fwd = (torch.zeros(1, 2, 60, 128, dtype=torch.bfloat16),
           torch.zeros(1, 2, 808, 128, dtype=torch.bfloat16),
           torch.zeros(1, 2, 60), torch.zeros(1, 2, 808))
    port._bi_attention_bwd(*vis, *txt, torch.zeros(1, 808), torch.zeros(1, 60),
                           *fwd, *ops(1, 60, 1, torch.bfloat16),
                           *ops(1, 808, 1, torch.bfloat16), 0.1, 0.1, 5)
    text_queries = seen[-1]      # problem 0: 60 text queries over 808 keys
    assert text_queries.delta is None and text_queries.scratch[1].numel() == 2 * 128
    assert port.LAUNCHES["attention_bwd"] == 2
    assert port.LAUNCHES["bi_attention_bwd"] == 1
    assert port.LAUNCHES["attention_bwd_wgmma"] == 2


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
    strides, 2 ints, struct vln_philox::Dropout (48 bytes, with its seed
    table's pointer), then the wgmma route's 3 scratch pointers."""
    assert port._BwdProblem.q_sb.offset == 11 * 8
    assert port._BwdProblem.dv_ss.offset == 11 * 8 + 23 * 8
    assert port._BwdProblem.s_q.offset == 280
    assert port._BwdProblem.dropout.offset == 288
    assert port._BwdProblem.stats.offset == 288 + 48
    assert port._BwdProblem.dq_ready.offset == 288 + 48 + 2 * 8
    assert ctypes.sizeof(port._BwdProblem) == 288 + 48 + 3 * 8


def test_library_name_covers_shared_headers(tmp_path, monkeypatch):
    """The built library's name hashes the .cu, every header under csrc/
    and the flags: editing the shared Philox header names a new library,
    so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert set(_build.SOURCES) == {"attention_fwd", "attention_bwd", "epilogue",
                                  "layer_norm"}
    headers = sorted(h.name for h in csrc.glob("*.cuh"))
    assert {"philox.cuh", "mma.cuh", "rows.cuh", "hopper.cuh"} <= set(headers)
    for header in headers:
        before = {name: _build.library_path(name) for name in _build.SOURCES}
        with open(csrc / header, "a") as f:
            f.write("// edited\n")
        for name in _build.SOURCES:
            assert _build.library_path(name) != before[name], (header, name)
    assert _build.library_path("attention_fwd").parent == _build.BUILD_DIR
