"""The frozen counts at the flagship shapes, pinned to the numbers the
port's own harness reported (``chip_smoke.py``, PERF.md)."""
import json

import pytest

from benchmark import counts, harness


@pytest.fixture(scope="module")
def ranker():
    return harness.model_dict(json.loads((harness.ROOT / "configs" / "lily_ranker.json").read_text()))


@pytest.fixture(scope="module")
def mrt():
    return harness.model_dict(json.loads((harness.ROOT / "configs" / "lily_mrt.json").read_text()))


def test_model_operations(ranker):
    assert counts.forward_flops(ranker, 60, 808) / 1e9 == pytest.approx(159.81, abs=0.005)
    assert counts.train_flops(ranker, 60, 808) / 1e9 == pytest.approx(479.42, abs=0.01)
    step_s = 96 * counts.train_flops(ranker, 60, 808) / counts.PEAK_BF16_FLOPS
    assert step_s * 1e3 == pytest.approx(46.54, abs=0.005)


def test_heads(ranker, mrt):
    assert counts.head_flops(ranker) == 2 * (1024 * 768 + 1024 * 1024 + 1024)
    assert counts.head_flops(mrt, 32, 208) == 2 * (
        1024 * 768 + 1024 * 1024 + 2 * 1024 + 32 * (768 * 768 + 768 * 30522)
        + 208 * (1024 * 1024 + 1024 * 1601))


@pytest.mark.parametrize("fn,args,ms", [
    (counts.attention_fwd, (96, 8, 808, 808, 128, True), 0.2596),
    (counts.attention_bwd, (96, 8, 808, 808, 128), 0.6489),
])
def test_kernel_bounds(fn, args, ms):
    assert counts.bound_s(*fn(*args)) * 1e3 == pytest.approx(ms, abs=5e-5)


def test_kernel_bounds_per_unit(ranker, mrt):
    b2 = [a + b for a, b in zip(counts.attention_fwd(96, 8, 60, 808, 128, True),
                                counts.attention_fwd(96, 8, 808, 60, 128, True))]
    assert counts.bound_s(*b2) * 1e3 == pytest.approx(0.2047, abs=5e-4)
    train = counts.kernel_bounds_s(ranker, 96, 60, 808, train=True)
    assert set(train) == {"attention"}
    assert counts.kernel_bounds_s(mrt, 56, 60, 808, train=True)["epilogue"] > 0
    b5 = counts.bound_s(*counts.epilogue_fwd(45248, 1024), counts.PEAK_F32_FLOPS)
    assert b5 * 1e3 == pytest.approx(0.0830, abs=5e-4)
    b6 = counts.bound_s(*counts.epilogue_bwd(45248, 1024), counts.PEAK_F32_FLOPS)
    assert b6 * 1e3 == pytest.approx(0.1383, abs=5e-4)


def test_expected_launches(ranker, mrt):
    assert counts.expected_launches(ranker, 30, 60, 808, False) == {
        "attention_fwd_kernel": 12}
    assert counts.expected_launches(ranker, 96, 60, 808, True) == {
        "attention_fwd_kernel": 12, "attention_bwd_kernel": 12, "delta_kernel": 12}
    got = counts.expected_launches(mrt, 56, 60, 808, True)
    assert got["epilogue_fwd_kernel"] == got["epilogue_bwd_kernel"] == 24
    assert got["column_sum_kernel"] == 24
