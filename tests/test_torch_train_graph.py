"""What the graphed train step (youtube_vln_tpu_torch/parallel/train_step.py,
``StepGraph``) needs of the rest of the port, on the CPU: the per-step seed
table is the ``DropoutRng.kernel_seed`` sequence, the kernels' Dropout
struct carries the table's pointer and each site's index (and without a
table is byte for byte the by-value struct), the wrappers of B1-B5 hand the
slot to every launch, the model draws from a caller's ``DropoutRng`` what
it draws from the seed, and a step on the CPU runs eagerly and counts
itself.  The graph itself needs a card: tests/test_torch_train_graph_card.py.
"""
import ctypes

import numpy as np
import pytest
import torch

from youtube_vln_tpu_torch.config import RunConfig, tiny_config
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.models.layers import DropoutRng
from youtube_vln_tpu_torch.ops import attention as A
from youtube_vln_tpu_torch.ops import epilogue as E
from youtube_vln_tpu_torch.ops.philox import EPILOGUE_DIRECTION, seed_key, site_seed
from youtube_vln_tpu_torch.parallel import train_step as ts

# head dim 64 on the vision and co-attention sides: kernel sites
WIDE = dict(v_hidden_size=128, v_num_attention_heads=2, v_intermediate_size=128,
            bi_hidden_size=128, bi_num_attention_heads=2)


class _ByValueDropout(ctypes.Structure):
    """``struct vln_philox::Dropout`` as it was before the seed table: the
    by-value seed and nine 32-bit words."""
    _fields_ = ([(n, ctypes.c_uint32) for n in
                 ("seed_lo", "seed_hi", "threshold", "direction")]
                + [("keep_scale", ctypes.c_float), ("enabled", ctypes.c_int)]
                + [(n, ctypes.c_uint32) for n in ("offset", "heads_total",
                                                  "head0")])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 63 + 5, 2 ** 64 - 1])
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_seed_table_is_the_kernel_seed_sequence(seed, rank):
    rng = DropoutRng(seed, "cpu", rank)
    want = [rng.kernel_seed() for _ in range(37)]
    table = np.array(DropoutRng.seed_table_of(seed, 37), dtype=np.int64)
    assert table.view(np.uint64).tolist() == want
    assert want == [site_seed(seed, n) for n in range(1, 38)]
    # the generator of the other sites, as a fresh DropoutRng seeds it
    assert rng.generator.initial_seed() == DropoutRng.generator_seed(seed, rank)


def test_seed_slot_follows_the_kernel_sites():
    table = torch.zeros(3, dtype=torch.int64)
    rng = DropoutRng(11, "cpu", seed_table=table)
    slots = []
    for _ in range(3):
        rng.kernel_seed()
        slots.append(rng.seed_slot())
    assert all(t is table for t, _ in slots)
    assert [i for _, i in slots] == [0, 1, 2]
    assert DropoutRng(11, "cpu").seed_slot() is None


@pytest.mark.parametrize("rate,seed,direction,offset,heads,head0", [
    (0.1, 0x5EED, 0, 0, 0, 0), (0.0, 2 ** 64 - 3, 1, 768, 8, 4),
    (0.25, 2 ** 40 + 9, EPILOGUE_DIRECTION, 12345, 0, 0)])
def test_dropout_struct_without_a_table_is_the_by_value_one(rate, seed, direction,
                                                            offset, heads, head0):
    got = A._dropout(rate, seed, direction, offset, heads, head0)
    lo, hi = seed_key(seed)
    old = _ByValueDropout(lo, hi, min(int(rate * 2 ** 32), 2 ** 32 - 1), direction,
                          1.0 / (1.0 - rate), int(rate > 0.0), offset, heads, head0)
    raw = bytes(got)
    assert raw[:ctypes.sizeof(old)] == bytes(old)
    assert raw[ctypes.sizeof(old):] == bytes(len(raw) - ctypes.sizeof(old))
    assert got.seeds is None and got.site == 0


def test_dropout_struct_holds_the_table_and_each_sites_index():
    table = torch.zeros(5, dtype=torch.int64)
    for site in range(5):
        got = A._dropout(0.1, 99, 0, 16, 8, 0, seed_slot=(table, site))
        plain = A._dropout(0.1, 99, 0, 16, 8, 0)
        assert got.seeds == table.data_ptr() and got.site == site
        # everything else of the mask is the by-value launch's
        for name, _ in _ByValueDropout._fields_:
            assert getattr(got, name) == getattr(plain, name), name
    for bad in ((table, 5), (table, -1), (table.int(), 0), (table.view(5, 1), 0),
                (torch.zeros(10, dtype=torch.int64)[::2], 0)):
        with pytest.raises(ValueError):
            A._dropout(0.1, 99, 0, seed_slot=bad)


@pytest.fixture
def launches(monkeypatch):
    """The kernel launchers of B1-B5 forced on the CPU, recording the
    Dropout settings of every problem they are handed instead of
    launching."""
    seen = []

    def attention_launch(name, p0, p1, q):
        seen.append((name, p0.dropout, p1.dropout if p1.s_q else None))

    def row_launch(source, name, call, x):
        seen.append((name, call.dropout, None))

    monkeypatch.setattr(A, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(E, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(A, "_launch", attention_launch)
    monkeypatch.setattr(E._rowwise, "launch", row_launch)
    return seen


def test_wrappers_hand_the_slot_to_every_launch(launches):
    table = torch.zeros(4, dtype=torch.int64)
    gen = torch.Generator().manual_seed(0)

    def heads(s):
        return torch.randn(2, 2, s, 64, generator=gen).requires_grad_()

    q, k, v = heads(64), heads(80), heads(80)
    A.fused_attention(q, k, v, dropout_rate=0.1, seed=5,
                      seed_slot=(table, 1)).sum().backward()
    q2, k2, v2 = heads(16), heads(16), heads(16)
    ctx1, ctx2 = A.fused_bi_attention(q, k, v, q2, k2, v2, rate1=0.1, rate2=0.1,
                                      seed=6, seed_slot=(table, 2))
    (ctx1.sum() + ctx2.sum()).backward()
    h = torch.randn(4, 128, generator=gen)
    E.fused_dropout_add_ln(h, h, torch.ones(128), torch.zeros(128),
                           dropout_rate=0.1, seed=7, seed_slot=(table, 3))
    names = [name for name, *_ in launches]
    assert names == ["attention_fwd", "attention_bwd", "attention_fwd",
                     "attention_bwd", "epilogue_fwd"]
    sites = [1, 1, 2, 2, 3]
    for (name, d0, d1), site in zip(launches, sites):
        for d in (d0, d1):
            if d is not None:
                assert (d.seeds, d.site) == (table.data_ptr(), site), name


def test_model_draws_the_same_from_a_callers_rng():
    """Lily in train mode with dropout on, from an int seed and from a
    ``DropoutRng`` that holds a used generator and a seed table: the same
    outputs bit for bit (the plain versions read the by-value seed), the
    generator re-seeded as a fresh one, and one table entry per kernel
    site."""
    cfg = tiny_config(**WIDE, ranking=True, compute_dtype="float32")
    model = Lily(cfg, device="cpu").init_weights(3).train()
    rng = np.random.default_rng(0)
    n, s_t, s_v = 2, 60, 80       # every vision and co-attention site a kernel site
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (n, s_t)))
    feats = torch.from_numpy(rng.normal(size=(n, s_v, cfg.v_feature_size))
                             .astype(np.float32))
    locs = torch.from_numpy(rng.random((n, s_v, 12)).astype(np.float32))
    seed = 2 ** 63 + 17
    want = model(tokens, feats, locs, seed=seed)["ranking"]
    gen = torch.Generator()
    torch.rand(100, generator=gen)
    table = torch.zeros(64, dtype=torch.int64)
    caller = DropoutRng(seed, "cpu", generator=gen, seed_table=table)
    got = model(tokens, feats, locs, seed=caller)["ranking"]
    assert torch.equal(got, want)
    # one kernel site a vision layer and one a connection layer
    assert caller.sites == cfg.v_num_hidden_layers + len(cfg.v_biattention_id)


def test_cpu_steps_run_eagerly_and_count():
    cfg = tiny_config(**WIDE, ranking=True, compute_dtype="float32")
    model = Lily(cfg, device="cpu").init_weights(0)
    args = RunConfig(ranking=True, pretrain=False)
    optimizer, _ = ts.create_train_state(model, args, steps_per_epoch=10)
    step = ts.build_train_step(model, cfg, args, optimizer, device="cpu")
    rng = np.random.default_rng(1)
    b, nc, s_t, s_v = 1, 2, 8, 20
    batch = {
        "instr_tokens": rng.integers(1, cfg.vocab_size, (b, nc, s_t)).astype(np.int32),
        "instr_mask": np.ones((b, nc, s_t), np.int32),
        "segment_ids": np.zeros((b, nc, s_t), np.int32),
        "instr_targets": np.full((b, nc, s_t), -1, np.int32),
        "image_features": rng.normal(size=(b, nc, s_v, cfg.v_feature_size)).astype(np.float16),
        "image_locations": rng.random((b, nc, s_v, 12)).astype(np.float16),
        "image_mask": np.ones((b, nc, s_v), np.int32),
        "opt_mask": np.ones((b, nc), bool),
        "ranking_target": np.zeros((b,), np.int32)}
    ts.reset_graph_counts()
    for seed in (1, 2):
        assert np.isfinite(float(step(batch, seed)["loss/train"]))
    assert ts.GRAPH_COUNTS == dict(ts.GRAPH_COUNTS, captures=0, replays=0, eager_cpu=2)
    assert all(p.grad is None for p in model.parameters())
