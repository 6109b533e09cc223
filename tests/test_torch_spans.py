"""The port's host spans (``utils/spans.py``): off they record nothing and
cost one shared no-op; on they record nested spans with their lanes, at
the Loader (both paths, worker times on the parent's clock), the device
feed, the train step and the beam scorer; ``annotate`` names the
profiler's ranges."""
import threading

import numpy as np
import pytest
import torch

from youtube_vln_tpu_torch import tiny_config
from youtube_vln_tpu_torch.config import RunConfig
from youtube_vln_tpu_torch.data.loader import Loader
from youtube_vln_tpu_torch.device import prefetch_to_device, to_device
from youtube_vln_tpu_torch.evaluation.beam_eval import build_score_step
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.parallel import train_step as pts
from youtube_vln_tpu_torch.utils import spans


@pytest.fixture
def recorded():
    """Spans on in the test body, off again after it."""
    spans.start()
    try:
        yield
    finally:
        spans.stop()
        spans.annotate(False)


def _names(record, lane="main"):
    return [n for n, _, _, ln in sorted(record, key=lambda s: s[1]) if ln == lane]


def _inside(inner, outer):
    return outer[1] <= inner[1] <= inner[2] <= outer[2]


def test_off_records_nothing():
    assert not spans.recording()
    a, b = spans.span("a"), spans.span("b")
    assert a is b
    with a:
        spans.record("c", 1.0, 2.0)
    assert spans.stop() == []
    spans.start()
    assert spans.stop() == []


def test_on_records_nested_spans_with_their_lanes(recorded):
    with spans.span("outer"):
        with spans.span("inner"):
            pass
    done = threading.Event()

    def other():
        with spans.span("threaded"):
            pass
        done.set()

    t = threading.Thread(target=other, name="loader")
    t.start()
    t.join(timeout=10)
    assert done.is_set() and not t.is_alive()
    spans.record("reported", 1.0, 2.0, lane="worker")
    got = {s[0]: s for s in spans.stop()}
    assert [got[n][3] for n in ("outer", "inner", "threaded", "reported")] == [
        "main", "main", "loader", "worker"]
    assert _inside(got["inner"], got["outer"])
    assert got["reported"][1:3] == (1.0, 2.0)
    assert not spans.recording()


class _Items:
    """10 small items of two candidates each."""

    def __len__(self):
        return 10

    def num_candidates(self):
        return 2

    def __getitem__(self, i):
        return {"opt_mask": np.ones(2, bool),
                "image_features": np.full((2, 3, 4), i, np.float32),
                "ranking_target": np.asarray(0, np.int32)}


@pytest.mark.parametrize("num_workers, shm", [(0, True), (2, True), (2, False)])
def test_loader_spans(recorded, num_workers, shm):
    """One ``loader.item`` an item, one ``loader.next`` a batch and one
    that finds the epoch's end, with ``loader.wait`` inside them; an item's
    span, on the parent's clock even from a worker, ends before the
    ``loader.next`` that yields its batch.  A ``loader.collate`` a batch,
    except where the workers write the batches in place (shared memory,
    a static layout): none there."""
    loader = Loader(_Items(), 4, shuffle=False, drop_last=False,
                    num_workers=num_workers, use_shared_memory=shm)
    batches = list(loader)
    record = spans.stop()
    assert [len(b["opt_mask"]) for b in batches] == [4, 4, 2]
    nexts = sorted((s for s in record if s[0] == "loader.next"), key=lambda s: s[1])
    assert len(nexts) == 4 and {s[3] for s in nexts} == {"main"}
    items = [s for s in record if s[0] == "loader.item"]
    assert len(items) == 10
    assert {s[3] for s in items} == {"loader" if num_workers == 0 else "worker"}
    items.sort(key=lambda s: s[2])
    for i, nxt in enumerate(nexts[:3]):
        assert max(s[2] for s in items[4 * i:4 * i + 4]) <= nxt[2]
    waits = [s for s in record if s[0] == "loader.wait"]
    assert waits and all(any(_inside(w, n) for n in nexts) for w in waits)
    collates = [s for s in record if s[0] == "loader.collate"]
    in_place = 3 if num_workers and shm else 0
    assert loader.batch_assembly == {"in_place": in_place, "collated": 3 - in_place}
    assert len(collates) == 3 - in_place
    if num_workers:
        assert all(any(_inside(c, n) for n in nexts) for c in collates)
    else:
        assert {s[3] for s in collates} == {"loader"}


def test_feed_spans_on_the_cpu(recorded):
    batches = [{"x": np.arange(6, dtype=np.float32).reshape(2, 3)} for _ in range(3)]
    out = list(prefetch_to_device(iter(batches), torch.device("cpu"), 2))
    to_device(batches[0], torch.device("cpu"))
    record = spans.stop()
    assert len(out) == 3
    # the transfers on the feed thread; a wait for each take on the
    # consumer's, the one that finds the end included
    assert _names(record, "feed") == ["feed.transfer"] * 3
    assert _names(record) == ["feed.wait"] * 4


def _train_batch(cfg, bs=2, nc=3, s_t=8, s_v=6, seed=0):
    rng = np.random.default_rng(seed)
    opt = np.ones((bs, nc), bool)
    opt[-1, -1] = False
    return dict(
        instr_tokens=rng.integers(1, cfg.vocab_size, (bs, nc, s_t)).astype(np.int32),
        instr_mask=np.ones((bs, nc, s_t), np.int32),
        segment_ids=np.zeros((bs, nc, s_t), np.int32),
        instr_targets=np.full((bs, nc, s_t), -1, np.int32),
        image_features=rng.normal(size=(bs, nc, s_v, cfg.v_feature_size)).astype(np.float32),
        image_locations=rng.random((bs, nc, s_v, 12)).astype(np.float32),
        image_mask=np.ones((bs, nc, s_v), np.int32),
        opt_mask=opt, ranking_target=np.zeros(bs, np.int32))


def test_train_step_spans(recorded):
    cfg = tiny_config(ranking=True, compute_dtype="float32")
    model = Lily(cfg, device="cpu").init_weights(0)
    args = RunConfig(ranking=True)
    optimizer, _ = pts.create_train_state(model, args, steps_per_epoch=1)
    step = pts.build_train_step(model, cfg, args, optimizer, device="cpu")
    step(_train_batch(cfg), seed=3)
    record = spans.stop()
    assert _names(record) == ["step", "step.forward", "step.backward",
                              "step.optimizer"]
    got = {s[0]: s for s in record}
    assert all(_inside(got[n], got["step"])
               for n in ("step.forward", "step.backward", "step.optimizer"))
    assert (got["step.forward"][2] <= got["step.backward"][1]
            and got["step.backward"][2] <= got["step.optimizer"][1])


def test_score_step_spans(recorded):
    cfg = tiny_config(ranking=True, compute_dtype="float32")
    model = Lily(cfg, device="cpu").init_weights(0)
    score = build_score_step(model, cfg, "cpu")
    out = score(to_device(_train_batch(cfg), torch.device("cpu")))
    record = spans.stop()
    assert out.shape == (2, 3) and torch.isinf(out[-1, -1])
    assert _names(record) == ["score", "score.expand", "score.forward", "score.pad"]
    got = {s[0]: s for s in record}
    assert all(_inside(got[n], got["score"])
               for n in ("score.expand", "score.forward", "score.pad"))


def test_annotate_names_the_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile
    spans.annotate(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.span("feed.transfer"):
                torch.ones(4).add_(1.0)
    finally:
        spans.annotate(False)
    assert "feed.transfer" in {e.key for e in prof.key_averages()}
    assert not spans.recording() and spans.span("a") is spans.span("b")
