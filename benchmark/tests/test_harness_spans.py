"""The readings of the program's host spans (``program_spans.py``) on a
hand-made Chrome trace with program spans, launching runtime calls and
correlation ids: idle-gap labels, device idle under the feed by interval
intersection, busy time by phase; none without spans; and the probe's
window on a small cell on the CPU."""
import time

import pytest
import torch

from benchmark import harness, program_spans, readers, spans_probe, trace
from benchmark.tests import small

HOST_T0 = 5.0
RUNTIME_LAG = -10      # the launching calls' clock runs 10 us behind the device's


def ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launched(name, ts, dur, corr, at, cat="kernel"):
    """A device event and the runtime call that launched it at host us ``at``."""
    return [ev(cat, name, ts, dur, corr),
            ev("cuda_runtime", "cudaLaunchKernel", RUNTIME_LAG + at, 3, corr)]


SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
EVENTS = (launched(SPIN, 0, 2, 1, 0) + launched(SPIN, 1000, 2, 2, 1000)
          + launched("Memcpy HtoD (Pinned -> Device)", 320, 20, 3, 310, "gpu_memcpy")
          + launched("void attention_fwd_kernel<__nv_bfloat16, 128>(Problem, Problem)",
                     450, 100, 4, 420)
          + launched("void attention_bwd_kernel<__nv_bfloat16, 128>(BwdProblem)",
                     550, 100, 5, 510)
          # launched inside step.optimizer, run after it closed
          + launched("void multi_tensor_apply_kernel<AdamW>(int)", 750, 50, 6, 680)
          + launched("void at::native::elementwise_kernel<128, 2>(int)", 850, 50, 7, 720)
          + [ev("kernel", "void at::native::reduce_kernel<512, 1>(int)", 920, 20, 99)])


def host(us):
    return HOST_T0 + us * 1e-6


BENCH = [("bench.host_wait", host(100), host(400)), ("bench.step", host(400), host(700))]
PROGRAM = [(n, host(a), host(b), lane) for n, a, b, lane in (
    ("loader.item", 0, 200, "worker"),
    ("loader.next", 110, 300, "main"), ("feed.transfer", 300, 398, "main"),
    ("step", 400, 700, "main"), ("step.forward", 410, 500, "main"),
    ("step.backward", 500, 600, "main"), ("step.optimizer", 600, 690, "main"))]


class _Run:
    units, traced_units = 2, 1
    program_segment, segment_events, segment_host_t0 = PROGRAM, EVENTS, HOST_T0
    program_window = PROGRAM
    segment_launches = {"attention_fwd": 1, "bi_attention_fwd": 0,
                        "attention_bwd": 0, "bi_attention_bwd": 1,
                        "epilogue_fwd": 0, "epilogue_bwd": 0}

    def __init__(self):
        self.traced = program_spans.labelled(EVENTS, BENCH, PROGRAM, HOST_T0)


def test_idle_gaps_take_the_innermost_span_of_either_kind():
    gaps = _Run().traced.idle_gaps
    # [0, 320) mid 160: loader.next inside bench.host_wait;
    # [340, 450) mid 395: feed.transfer inside bench.host_wait
    assert [(n, round(s * 1e6)) for n, s in gaps[:2]] == [
        ("loader.next", 320), ("feed.transfer", 110)]
    assert "bench.host_wait" not in [n for n, _ in gaps]


def test_idle_under_the_feed_is_an_intersection():
    # idle [0, 320) and [340, 450) against the feed's [110, 398):
    # 210 + 58 us, per traced unit
    assert program_spans.idle_feed_ms(_Run()) == pytest.approx(0.268)


def test_busy_time_by_phase():
    got = program_spans.phases_ms(_Run())
    assert got == pytest.approx({"step.forward": 0.1, "step.backward": 0.1,
                                 "step.optimizer": 0.05, "outside": 0.07,
                                 "unlinked": 0.02, "busy": 0.34})
    assert sum(v for k, v in got.items() if k != "busy") == pytest.approx(got["busy"])
    assert program_spans.optimizer_ms(_Run()) == pytest.approx(0.05)


def test_window_readings_and_launches():
    run = _Run()
    assert program_spans.loader_ms(run) == pytest.approx(0.19 / 2)
    assert program_spans.transfer_ms(run) == pytest.approx(0.098 / 2)
    assert program_spans.dispatch_ms(run) == pytest.approx(0.3 / 2)
    assert program_spans.item_ms(run) == pytest.approx(0.2)
    assert program_spans.segment_dispatch_ms(run) == pytest.approx(0.3)
    got = program_spans.launches(run)
    assert got["attention_fwd_kernel"] == {
        "program": {"attention_fwd": 1, "bi_attention_fwd": 0}, "trace": 1}
    assert got["attention_bwd_kernel"]["trace"] == 1
    assert sum(got["attention_bwd_kernel"]["program"].values()) == 1


class _Bare:
    units, traced_units, traced = 2, 1, None


@pytest.mark.parametrize("reader", [
    "loader_ms", "transfer_ms", "item_ms", "dispatch_ms", "idle_feed_ms",
    "optimizer_ms", "phases_ms", "segment_dispatch_ms", "split_ms", "counts",
    "launches"])
def test_no_spans_read_none(reader):
    assert getattr(program_spans, reader)(_Bare()) is None


@pytest.mark.parametrize("workload", ["rerank.r2r_val_bs1", "finetune.30rs"])
def test_the_probe_records_the_window(workload):
    """The small cell on the CPU with spans on in its window: the feed's
    wait splits into the Loader and the transfer, which lie inside it."""
    c = small.cell(workload)
    r = spans_probe.ProbedRun(cell=c, model=harness.model_dict(c.config),
                              seed=2 ** 31 + 777, trace=False, probe=True)
    driver = harness.load_module("drivers", c.traffic["driver"])
    traced = trace.traced
    with spans_probe.instrumented(r):
        driver.run(r, seconds=2.0, device=torch.device("cpu"),
                   started=time.time(), build_dir=harness.CACHE / "kernels")
    assert harness.verdict(r)
    names = {s[0] for s in r.program_window}
    assert {"loader.next", "loader.item", "feed.transfer"} <= names
    assert ("score" if workload.startswith("rerank") else "step.optimizer") in names
    wait = readers.host_wait_ms(r)
    split = program_spans.loader_ms(r) + program_spans.transfer_ms(r)
    assert 0.5 * wait < split <= 1.05 * wait
    assert program_spans.dispatch_ms(r) > 0 and program_spans.item_ms(r) > 0
    assert trace.traced is traced
