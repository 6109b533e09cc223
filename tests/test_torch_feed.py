"""The port's device feed (``device.prefetch_to_device``): a thread named
``feed`` iterates the batches and moves them to the device ahead of their
use.  On the CPU: order, lookahead, errors, closing and the counters; on
the card (marker ``cuda``): the copies on their own stream equal the
synchronous ``to_device`` and a step right after a take reads them."""
import collections
import sys
import threading
import time
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from youtube_vln_tpu_torch import device as pdevice
from youtube_vln_tpu_torch.data import loader as ploader
from youtube_vln_tpu_torch.data.loader import Loader
from youtube_vln_tpu_torch.device import FEED_COUNTS, prefetch_to_device, to_device

CPU = torch.device("cpu")


def _batches(n, size=2):
    return [{"x": np.full((size,), i, np.int32),
             "y": np.arange(3, dtype=np.float32) + i} for i in range(n)]


def _feed_threads():
    return {t for t in threading.enumerate() if t.name == "feed"}


def _started(before):
    """The feed threads started since ``before`` (a set of threads)."""
    return _feed_threads() - before


def _wait_for(cond, timeout=1.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    return cond()


@pytest.mark.parametrize("n", [0, 1, 5])
@pytest.mark.parametrize("depth", [1, 2, 3, 8])
def test_order_and_nothing_dropped(depth, n):
    want = _batches(n)
    got = list(prefetch_to_device(iter(want), CPU, depth))
    assert len(got) == n
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), w[k])


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_never_more_than_depth_ahead(depth):
    """While the consumer holds batch k the source has been asked for at
    most ``depth`` batches past it, and given time it has been asked for
    exactly that many (the lookahead is kept)."""
    n, asked = 8, [0]

    def source():
        for i in range(n):
            asked[0] = i + 1
            yield {"x": np.full((2,), i, np.int32)}

    for k, b in enumerate(prefetch_to_device(source(), CPU, depth)):
        assert int(b["x"][0]) == k
        want = min(n, k + 1 + depth)
        assert _wait_for(lambda: asked[0] >= want)
        time.sleep(0.005)       # room to run further ahead, were it allowed
        assert asked[0] == want


def test_an_error_reaches_the_consumer_in_place():
    def source():
        for i in range(3):
            yield {"x": np.full((2,), i, np.int32)}
        raise ValueError("batch 3 is bad")

    before = _feed_threads()
    it = prefetch_to_device(source(), CPU, 2)
    got = [int(next(it)["x"][0]) for _ in range(3)]
    assert got == [0, 1, 2]
    with pytest.raises(ValueError, match="batch 3 is bad"):
        next(it)
    assert next(it, None) is None           # the batches end there
    assert all(not t.is_alive() for t in _started(before))


@pytest.mark.parametrize("how", ["close", "collect"])
def test_a_consumer_that_stops_early_stops_the_thread(how):
    log = []

    def source():
        try:
            for i in range(10):
                log.append(i)
                yield {"x": np.full((2,), i, np.int32)}
        finally:
            log.append("finally")

    before = _feed_threads()
    it = prefetch_to_device(source(), CPU, 2)
    for k, b in enumerate(it):
        if k == 1:
            break
    threads = _started(before)
    assert len(threads) == 1
    if how == "close":
        it.close()
    else:
        del it, b
    for t in threads:
        t.join(timeout=2.0)
        assert not t.is_alive()
    assert _wait_for(lambda: "finally" in log, 2.0)
    # asked for batches 0-1 and at most 2 beyond them, never again after
    assert [x for x in log if x != "finally"] == list(range(len(log) - 1))
    assert len(log) - 1 <= 4


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


def test_a_loader_closed_mid_epoch_unlinks_its_slabs():
    """The benchmark's wrapping (a generator over the Loader keeping each
    host batch, under the feed): closing the feed, then the wrapper,
    mid-epoch ends the Loader's pool and unlinks its shared slabs."""
    loader = Loader(_Items(), 2, shuffle=False, drop_last=True, num_workers=2)
    kept = collections.deque()

    def host():
        for batch in loader:
            kept.append(batch)
            yield batch

    wrapper = host()
    feed = prefetch_to_device(wrapper, CPU, 2)
    first = next(feed)
    np.testing.assert_array_equal(first["image_features"].numpy(),
                                  kept.popleft()["image_features"])
    names = [s.name for s in ploader._WORKER_SLABS]
    assert names
    feed.close()
    wrapper.close()                   # raises if the feed thread still ran it
    # a generator closed at a yield outside any try keeps its locals (here
    # the Loader's iterator) until it is freed in some 3.12 releases
    del feed, wrapper
    assert ploader._WORKER_SLABS is None
    for name in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)


class _Rows(_Items):
    """24 items of 1-3 candidates: rows padded, batches written in place."""

    def __len__(self):
        return 24

    def num_candidates(self):
        return 3

    def __getitem__(self, i):
        cur = 1 + i % 3
        return {"opt_mask": np.ones(cur, bool),
                "image_features": np.full((cur, 3, 4), i, np.float32),
                "ranking_target": np.asarray(i, np.int32)}


def test_held_host_batches_stay_equal_to_their_collate_twins():
    """The benchmark's pattern: a 2-worker Loader under the feed, its host
    batches kept in a FIFO until their take.  Every third host batch is
    then held to the end while the others are dropped, so slabs are
    reused beside held ones: each held batch still equals ``collate`` of
    its items after every later batch has been taken.  The interpreter
    switches threads as often as it can, since a slab goes back to the
    free list on whichever thread drops the last view of its batch."""
    ds = _Rows()
    loader = Loader(ds, 2, shuffle=False, drop_last=True, num_workers=2)
    twins = [ploader.collate([ds[2 * j], ds[2 * j + 1]], 3) for j in range(12)]
    fifo = collections.deque()

    def host():
        for batch in loader:
            fifo.append(batch)
            yield batch

    held = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for j, dev in enumerate(prefetch_to_device(host(), CPU, 2)):
            batch = fifo.popleft()
            for k, v in twins[j].items():
                np.testing.assert_array_equal(dev[k].numpy(), v)
            if j % 3 == 0:
                held.append((j, batch))
            del batch, dev
    finally:
        sys.setswitchinterval(interval)
    assert len(held) == 4 and not fifo
    assert loader.batch_assembly == {"in_place": 12, "collated": 0}
    for j, batch in held:
        assert list(batch) == list(twins[j])
        for k, v in twins[j].items():
            assert batch[k].dtype == v.dtype
            np.testing.assert_array_equal(batch[k], v, err_msg=f"{j} {k}")


def test_feed_counts_count_every_take():
    """Four takes of three batches (the last finds the end); the first
    waits for its batch, the others find theirs ready."""
    gate = threading.Event()

    def source():
        gate.wait(2.0)
        yield from _batches(3)

    before = dict(FEED_COUNTS)
    timer = threading.Timer(0.2, gate.set)
    timer.start()
    it = prefetch_to_device(source(), CPU, 8)
    first = next(it)
    assert _wait_for(lambda: FEED_COUNTS["takes"] == before["takes"] + 1)
    time.sleep(0.05)                  # the rest and the end are queued
    rest = list(it)
    timer.join(timeout=1.0)
    assert int(first["x"][0]) == 0 and len(rest) == 2
    assert FEED_COUNTS["takes"] - before["takes"] == 4
    assert FEED_COUNTS["ready"] - before["ready"] == 2


def test_many_feeds_at_once_keep_order_and_counts():
    """More consumers than cores, each with its own feed, with the
    interpreter switching threads as often as it can: every consumer gets
    its batches in order and every take is counted."""
    n_feeds, n = 12, 30
    out = [None] * n_feeds
    before = dict(FEED_COUNTS)

    def consume(j):
        src = ({"x": np.full((2,), j * 1000 + i, np.int32)} for i in range(n))
        out[j] = [int(b["x"][0]) for b in prefetch_to_device(src, CPU, 2)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(j,)) for j in range(n_feeds)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
    finally:
        sys.setswitchinterval(interval)
    assert all(not t.is_alive() for t in threads)
    assert out == [[j * 1000 + i for i in range(n)] for j in range(n_feeds)]
    assert FEED_COUNTS["takes"] - before["takes"] == n_feeds * (n + 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_side_stream_batches_equal_the_synchronous_copy(card):
    """Batches of 64 MB a tensor, each of other values, copied on the
    feed's stream: bitwise those of ``to_device`` on the current stream,
    and a step launched right after the take (a clone on the current
    stream) reads the copied values, not memory the copy has yet to
    fill."""
    rng = np.random.default_rng(7)
    host = [{"f": rng.standard_normal((4096, 4096), dtype=np.float32),
             "i": rng.integers(0, 1 << 30, (1024, 1024), dtype=np.int64),
             "m": rng.random((64, 64)) < 0.5} for _ in range(6)]
    seen = []
    for b, h in zip(prefetch_to_device(iter(host), card, 2), host):
        seen.append({k: v.clone() for k, v in b.items()})
        torch.cuda._sleep(1_000_000)     # later batches copy behind a busy stream
    torch.cuda.synchronize()
    assert len(seen) == len(host)
    for got, h in zip(seen, host):
        want = to_device(h, card)
        for k in h:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k
            assert np.array_equal(got[k].cpu().numpy(), h[k]), k
