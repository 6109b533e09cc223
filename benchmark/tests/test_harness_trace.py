"""The trace reduction on a hand-made Chrome trace: the segment between
its two markers, union of device intervals, groups by kernel name, launch
counts, idle gaps by host span."""
import pytest

from benchmark import readers, trace


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


EVENTS = [
    ev("kernel", "void at::cuda::(anonymous namespace)::spin_kernel(long)", 0, 2),
    ev("kernel", "void at::cuda::(anonymous namespace)::spin_kernel(long)", 1000, 2),
    ev("kernel", "void attention_fwd_kernel<__nv_bfloat16, 128>(Problem, Problem)", 100, 100),
    ev("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 150, 100),   # overlaps
    ev("kernel", "nvjet_tst_128x304_64x3_2x1_v_bz_coopA_bias_TNT", 250, 50),
    ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 300, 50),
    ev("kernel", "void delta_kernel<__nv_bfloat16, 128>(BwdProblem)", 800, 100),
    ev("kernel", "void epilogue_fwd_kernel<__nv_bfloat16>(Epilogue)", 950, 100),  # crosses the end
    ev("kernel", "void attention_fwd_kernel<float, 64>(Problem, Problem)", 2000, 10),  # outside
]
# host spans (s) on a clock on which the first marker was launched at 5.0
SPANS = [("bench.host_wait", 5.0004, 5.0007)]


def test_trace_reduction():
    t = trace.Trace(EVENTS, SPANS, 5.0)
    assert t.window_s == pytest.approx(1e-3)
    # device busy: [100, 350), [800, 900) and [950, 1000)
    assert t.busy_s == pytest.approx(400e-6)
    assert t.group_s["attention_fwd"] == pytest.approx(100e-6)
    assert t.group_s["eager"] == pytest.approx(100e-6)
    assert t.group_s["gemm"] == pytest.approx(50e-6)
    assert t.group_s["copies"] == pytest.approx(50e-6)
    assert t.group_s["attention_bwd"] == pytest.approx(100e-6)
    assert t.group_s["epilogue"] == pytest.approx(50e-6)
    assert t.launches["attention_fwd_kernel"] == 1
    assert t.launches["delta_kernel"] == 1 and t.launches["epilogue_fwd_kernel"] == 1
    assert [(n, round(s * 1e6)) for n, s in t.idle_gaps] == [
        ("bench.host_wait", 450), ("other", 100), ("other", 50)]
    names = [n for n, _ in t.breakdown()["device_ops"]]
    assert "attention_fwd_kernel<__nv_bfloat16, 128>" in names


class _Run:
    traced_units = 2
    bounds_s = {"attention": 25e-6}
    flops, window_s, units = 0.0, 1e-3, 2

    def __init__(self):
        self.traced = trace.Trace(EVENTS, SPANS, 5.0)


def test_a_segment_needs_both_markers():
    with pytest.raises(RuntimeError, match="markers"):
        trace.Trace(EVENTS[1:])


def test_readers():
    run = _Run()
    assert readers.roofline(run, ("attention_fwd",), "attention") == pytest.approx(50.0)
    assert readers.roofline(run, ("epilogue",), "missing") is None
    assert readers.eager_ms(run) == pytest.approx(0.05)
    # busy 200 us a unit of the window's 500
    assert readers.device_idle(run) == pytest.approx(60.0)
    assert readers.mfu(run) is None


@pytest.mark.parametrize("bad_segments", [0, 1, 2])
def test_a_bad_segment_is_taken_once_more(monkeypatch, bad_segments):
    from benchmark import harness
    import contextlib
    taken = []

    @contextlib.contextmanager
    def traced(result, device):
        yield
        result.append(trace.Segment(None, SPANS, 5.0, 5.001))

    def read(seg):
        events = EVENTS[1:] if len(taken) <= bad_segments else EVENTS
        return trace.Trace(events, seg.spans, seg.host_t0)

    monkeypatch.setattr(trace, "warm_up", lambda device: None)
    monkeypatch.setattr(trace, "traced", traced)
    monkeypatch.setattr(trace, "read", read)

    class Run:
        traced = None
        expected_launches = {"attention_fwd_kernel": 1, "delta_kernel": 1,
                             "epilogue_fwd_kernel": 1}

    run = Run()
    body = lambda: taken.append(1)  # noqa: E731
    if bad_segments == 2:
        with pytest.raises(RuntimeError, match="markers"):
            harness.traced_segment(run, None, body, 1)
    else:
        harness.traced_segment(run, None, body, 1)
        assert run.traced.launches["attention_fwd_kernel"] == 1
    assert len(taken) == min(bad_segments + 1, 2)


@pytest.mark.cuda
def test_a_segment_on_the_card(card):
    import torch
    a = torch.randn(2048, 2048, device=card, dtype=torch.bfloat16)
    trace.warm_up(card)
    segs = []
    with trace.traced(segs, card):
        for _ in range(4):
            (a @ a).add_(1.0)
    t = trace.read(segs[0])
    assert 0.0 < t.busy_s <= t.window_s
    assert t.group_s.get("gemm", 0.0) > 0.0 and t.group_s.get("eager", 0.0) > 0.0
