"""Host-side batching (a copy of ``youtube_vln_tpu/data/loader.py``; the
device stage is the port's ``device.to_device``).

Replaces torch DataLoader + DistributedSampler + pin_memory/non_blocking
(reference ``utils/dataset/dataset_init.py:190-249``, ``utils/
distributed.py:156-180``) with:

  * deterministic per-epoch shuffling (seed+epoch), sharded across ranks by
    ``shard_indices`` the way DistributedSampler shards by rank
  * static-shape collation: candidate counts are padded to the dataset's
    ``num_candidates()`` upper bound and masked via ``opt_mask`` — every
    batch has the same shapes
  * a background producer thread with a bounded queue (host pipelining),
    or a fork-based worker pool (``num_workers > 0``) whose workers only
    assemble numpy items and never call into torch

Batches are dicts of numpy arrays; ``build_train_step`` moves them to the
device (``device.to_device``), and ``device.prefetch_to_device``
overlaps that copy with the previous step.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import logging
import multiprocessing as mp
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..utils import spans

_MALLOC_TUNED = False


def _tune_malloc_for_large_buffers() -> None:
    """Keep multi-hundred-MB batch buffers in glibc's reused arena.

    By default allocations past M_MMAP_THRESHOLD get a FRESH mmap, so with
    prefetch holding the previous batches alive every collate repaid its
    full page-fault bill (~2.3 s/batch at the flagship geometry, ~8x the
    actual copy time — scripts/bench_loader.py).  Raising the mmap/trim
    thresholds makes freed batch memory cycle warm.  Footprint grows to
    the peak concurrent-batch watermark, which is exactly the prefetch
    depth.  No-op off glibc."""
    global _MALLOC_TUNED
    if _MALLOC_TUNED:
        return
    _MALLOC_TUNED = True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except Exception:
        pass

# fork-inherited state for worker processes (set right before Pool
# creation; tasks pickle only (epoch, idx) pairs, never the dataset)
_WORKER_DATASET = None
_WORKER_SEED = 0
_WORKER_SLABS = None      # list of multiprocessing.shared_memory.SharedMemory


def _item_seed(seed: int, epoch: int, idx: int) -> int:
    h = hashlib.blake2s(f"{seed}:{epoch}:{idx}".encode(),
                        digest_size=4).digest()
    return int.from_bytes(h, "little")


def _get_item(epoch, idx):
    ds = _WORKER_DATASET
    if hasattr(ds, "reseed"):
        ds.reseed(_item_seed(_WORKER_SEED, epoch, idx))
    return ds[idx]


def _fetch(task):
    """Worker: (item, t0, t1), the times of its assembly."""
    epoch, idx = task
    t0 = spans.clock()
    item = _get_item(epoch, idx)
    return item, t0, spans.clock()


def _pack_into_slab(item, slab) -> Optional[list]:
    """Write all arrays into the shared slab; returns the schema
    [(key, dtype, shape, offset), ...] or None if the slab is too small."""
    total = sum(np.asarray(v).nbytes for v in item.values())
    if total > slab.size:
        return None
    schema = []
    offset = 0
    buf = slab.buf
    for k, v in item.items():
        a = np.asarray(v)
        shape = a.shape  # before ascontiguousarray, which promotes 0-d to 1-d
        a = np.ascontiguousarray(a)
        n = a.nbytes
        buf[offset:offset + n] = a.view(np.uint8).reshape(-1).data
        schema.append((k, a.dtype.str, shape, offset))
        offset += n
    return schema


def _fetch_shm(task, slot):
    """Worker: build the item, write it into slab ``slot`` (handed out by
    the parent, which owns the free list) and return only the schema,
    with the times of the item's assembly and packing.  Falls back to
    pickling the item when it exceeds the slab size, counted loudly by the
    parent (shm_fallbacks)."""
    epoch, idx = task
    t0 = spans.clock()
    item = _get_item(epoch, idx)
    schema = _pack_into_slab(item, _WORKER_SLABS[slot])
    if schema is None:
        return ("pickle", "slab_overflow", item, t0, spans.clock())
    return ("shm", schema, None, t0, spans.clock())


def _unpack_from_slab(slab, schema):
    out = {}
    for k, dtype, shape, offset in schema:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        out[k] = np.frombuffer(slab.buf, dtype=dtype, count=int(np.prod(shape)),
                               offset=offset).reshape(shape)
    return out


def shard_indices(n: int, *, shuffle: bool, seed: int, epoch: int,
                  num_shards: int = 1, shard: int = 0,
                  drop_last: bool = False) -> np.ndarray:
    """DistributedSampler-style index sharding."""
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    if num_shards > 1:
        if drop_last:
            usable = (n // num_shards) * num_shards
            order = order[:usable]
        else:  # pad by wrapping, like DistributedSampler
            pad = (-len(order)) % num_shards
            if pad:
                # np.tile handles pad > n (dataset smaller than ~half the
                # shard count, e.g. a --debug subset on a 16-process pod):
                # order[:pad] alone comes up short there, shards end up
                # UNEQUAL, and ranks with fewer batches exit the epoch
                # while the rest block forever in the step collective
                reps = np.tile(order, pad // max(len(order), 1) + 1)
                order = np.concatenate([order, reps[:pad]])
        order = order[shard::num_shards]
    return order


BATCH_KEYS = ("ranking_target", "image_features", "image_locations",
              "image_mask", "image_targets", "image_targets_mask",
              "image_targets_idx", "instr_tokens", "instr_mask",
              "instr_targets", "segment_ids", "opt_mask",
              # candidate-dedup transport (datasets.py:_finalize dedup
              # branch): uniq_* arrays carry one row per UNIQUE trajectory
              # (a per-dataset constant < nc), the others stay per-candidate
              "uniq_image_features", "uniq_image_locations",
              "uniq_image_mask", "cand_index", "feature_zero_mask",
              # beam-eval step-dedup transport (datasets.py:
              # _finalize_step_dedup): uniq_step_* carry one row per
              # UNIQUE (viewpoint, heading, step) pano block, already
              # bucket-padded by the dataset; step_index is per-candidate
              "uniq_step_features", "uniq_step_locations",
              "uniq_step_mask", "step_index")


def collate(samples: Sequence[Dict[str, np.ndarray]], nc: int,
            with_instr_id: bool = False,
            nc_uniq: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Stack items into [bs, nc, ...] batch arrays, zero-padding the
    candidate dim (opt_mask marks the real rows; scalar ranking_target
    stays [bs]).  ``uniq_*`` keys pad dim 0 to ``nc_uniq`` (the
    dataset's static unique-trajectory count; falls back to the first
    item's) so every batch keeps one shape.  Each key fills ONE batch
    allocation directly — a pad-per-item-then-stack route costs two
    copies and ~bs allocations per key, which dominated the feed rate
    at the flagship item size (see scripts/bench_loader.py)."""
    bs = len(samples)
    first = samples[0]
    batch: Dict[str, np.ndarray] = {}
    for k in BATCH_KEYS:
        if k not in first:
            continue
        v0 = np.asarray(first[k])
        if k == "ranking_target" and v0.ndim == 0:
            batch[k] = np.stack([np.asarray(s[k]) for s in samples])
            continue
        dtype = bool if k == "opt_mask" else v0.dtype
        # uniq_* rows: the dataset's static count when it has one, else
        # the batch max (items bucket-pad their own uniq dims, so with
        # bs > 1 mixed buckets pad up to the largest in the batch)
        n0 = (nc_uniq or max(np.asarray(s[k]).shape[0] for s in samples)
              ) if k.startswith("uniq_") else nc
        arr = np.empty((bs, n0) + v0.shape[1:], dtype)
        for i, s in enumerate(samples):
            v = np.asarray(s[k])
            cur = v.shape[0]
            arr[i, :cur] = v
            if cur < n0:
                arr[i, cur:] = 0
        batch[k] = arr
    if with_instr_id:
        batch["instr_id"] = np.stack([np.asarray(s["instr_id"])
                                      for s in samples])
    return batch


class Loader:
    """Iterable over collated batches with background prefetch.

    batch_size semantics follow the reference: the caller passes the
    *per-step* batch size (global batch // grad-accum // world already
    applied by the engine, dataset_init.py:204-208).

    num_workers > 0 assembles items in a fork-based process pool (the
    reference's DataLoader workers, num_workers=3 per GPU).  Sampling is
    deterministic in (seed, epoch, index) regardless of worker count.
    Collate runs in the CONSUMER process and is memory-bandwidth-bound.
    On starved hosts leave num_workers=0 — the transport overhead cannot
    be amortized without CPUs.  Items that overflow the shared-memory slabs
    fall back to pickling LOUDLY (warning + ``shm_fallbacks`` counter).
    The pool forks: a worker inherits the dataset and runs only numpy and
    the store reader (the datasets import no torch), so forking from a
    process that has initialised CUDA is safe for these workers.
    While ``utils.spans`` records, the Loader opens ``loader.next``,
    ``loader.wait``, ``loader.collate`` and ``loader.item`` (a worker times
    each item and the parent records it).
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool,
                 seed: int = 1, num_shards: int = 1, shard: int = 0,
                 drop_last: Optional[bool] = None,
                 prefetch: int = 2, num_candidates: Optional[int] = None,
                 with_instr_id: bool = False, num_workers: int = 0,
                 use_shared_memory: bool = True):
        _tune_malloc_for_large_buffers()
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard = shard
        self.drop_last = shuffle if drop_last is None else drop_last
        self.prefetch = prefetch
        self.nc = num_candidates or dataset.num_candidates()
        self.nc_uniq = getattr(dataset, "num_unique_candidates",
                               lambda: None)()
        self.with_instr_id = with_instr_id
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.epoch = 0
        # pickle fallbacks off the shared-memory transport, kept loud on
        # purpose (each is a ~40-90 MB pickle on the hot path) and COUNTED
        # BY CAUSE: "slab_overflow" means the slab probe under-sized the
        # slots
        self.shm_fallbacks = 0
        self.shm_fallbacks_by_reason: Dict[str, int] = {}
        self._slab_bytes: Optional[int] = None  # probe once, not per epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(shard_indices(len(self.dataset), shuffle=self.shuffle,
                              seed=self.seed, epoch=self.epoch,
                              num_shards=self.num_shards, shard=self.shard,
                              drop_last=self.drop_last))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _produce(self, q: queue.Queue, order: np.ndarray):
        try:
            buf: List[Dict] = []
            for idx in order:
                with spans.span("loader.item"):
                    if hasattr(self.dataset, "reseed"):
                        # same per-item seeding as the worker-pool path, so
                        # num_workers never changes the sampled data
                        self.dataset.reseed(
                            _item_seed(self.seed, self.epoch, int(idx)))
                    buf.append(self.dataset[int(idx)])
                if len(buf) == self.batch_size:
                    q.put(self._collate(buf))
                    buf = []
            if buf and not self.drop_last:
                q.put(self._collate(buf))
            q.put(None)
        except BaseException as e:  # surface worker errors to the consumer
            q.put(e)

    def _order(self) -> np.ndarray:
        order = shard_indices(len(self.dataset), shuffle=self.shuffle,
                              seed=self.seed, epoch=self.epoch,
                              num_shards=self.num_shards, shard=self.shard,
                              drop_last=self.drop_last)
        if self.drop_last:
            order = order[: (len(order) // self.batch_size)
                          * self.batch_size]
        return order

    def _collate(self, buf: List[Dict]) -> Dict[str, np.ndarray]:
        with spans.span("loader.collate"):
            return collate(buf, self.nc, self.with_instr_id, self.nc_uniq)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """The batches, each under a ``loader.next`` span from the resume
        of the path that makes them to its yield (and one more for the call
        that finds the epoch's end)."""
        batches = (self._iter_multiprocess() if self.num_workers > 0
                   else self._iter_threaded())
        try:
            while True:
                with spans.span("loader.next"):
                    batch = next(batches, None)
                if batch is None:
                    return
                yield batch
        finally:
            batches.close()

    def _iter_threaded(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q, order),
                             name="loader", daemon=True)
        t.start()
        while True:
            with spans.span("loader.wait"):
                item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def _iter_multiprocess(self) -> Iterator[Dict[str, np.ndarray]]:
        """Fork-based worker pool.  Item sampling is deterministic in
        (seed, epoch, index) regardless of worker count: each worker
        reseeds the dataset RNGs per item.

        Transport: with use_shared_memory (default) workers write arrays
        into preallocated SharedMemory slabs, one per task, handed out by
        the parent, and send only the schema through the result pipe — no
        pickling of the ~40-90 MB items.  Slots are recycled after
        collation copies the views."""
        global _WORKER_DATASET, _WORKER_SEED, _WORKER_SLABS
        order = self._order()
        ctx = mp.get_context("fork")
        _WORKER_DATASET = self.dataset
        _WORKER_SEED = self.seed
        tasks = [(self.epoch, int(i)) for i in order]

        slabs = []
        if self.use_shared_memory and tasks:
            from multiprocessing import shared_memory
            # size from several probes spread across the epoch, not just
            # item 0: variable-size layouts (--dedup_beam_steps buckets
            # uniq step blocks in multiples of STEP_BUCKET) vary by
            # integer factors between items, which a single probe + 25%
            # headroom cannot cover (every larger item would take the
            # loud pickle-fallback cliff).  _get_item reseeds per item,
            # so probing does not disturb worker determinism.
            if self._slab_bytes is None:
                # item geometry is epoch-independent (shapes are static or
                # bucketed), so probe once per Loader: each probe assembles
                # a full item in the parent (29-555 ms at flagship
                # geometry) — re-probing every epoch would stall each
                # epoch start for ~4 item times.  The 25% headroom plus the
                # loud pickle fallback covers any residual spread.
                n = len(tasks)
                probe_idx = sorted({0, n // 3, (2 * n) // 3, n - 1})
                self._slab_bytes = 4096 + int(1.25 * max(
                    sum(np.asarray(v).nbytes for v in
                        _get_item(*tasks[i]).values())
                    for i in probe_idx))
            slab_bytes = self._slab_bytes
            n_slots = self.num_workers + self.batch_size + 2
            for i in range(n_slots):
                slabs.append(shared_memory.SharedMemory(
                    create=True, size=slab_bytes))
            _WORKER_SLABS = slabs

        try:
            with ctx.Pool(self.num_workers) as pool:
                if slabs:
                    # the parent hands out the slots, a task only when one
                    # is free and in task order: workers never wait for a
                    # slot, and the next item in order always has one (a
                    # worker-side free queue starves when workers that run
                    # ahead hold every slot while the parent waits for the
                    # in-order item)
                    free = list(range(len(slabs)))
                    pending = collections.deque()
                    todo = iter(tasks)

                    def submit():
                        while free:
                            task = next(todo, None)
                            if task is None:
                                return
                            slot = free.pop()
                            pending.append((pool.apply_async(
                                _fetch_shm, (task, slot)), slot))

                    submit()
                    buf: List[Dict] = []
                    used_slots: List[int] = []
                    while pending:
                        res, slot = pending.popleft()
                        with spans.span("loader.wait"):
                            kind, payload, item, t0, t1 = res.get()
                        spans.record("loader.item", t0, t1, "worker")
                        if kind == "shm":
                            buf.append(_unpack_from_slab(slabs[slot], payload))
                            used_slots.append(slot)
                        else:
                            self.shm_fallbacks += 1
                            self.shm_fallbacks_by_reason[payload] = \
                                self.shm_fallbacks_by_reason.get(payload,
                                                                 0) + 1
                            if self.shm_fallbacks_by_reason[payload] == 1:
                                logging.getLogger(__name__).warning(
                                    "loader fell back to pickle transport "
                                    "(%s; slab %d bytes) — a performance "
                                    "cliff (loader.shm_fallbacks_by_reason "
                                    "counts occurrences by cause)", payload,
                                    slabs[0].size)
                            buf.append(item)
                            free.append(slot)
                        if len(buf) == self.batch_size:
                            yield self._collate(buf)
                            buf = []
                            free.extend(used_slots)
                            used_slots = []
                        submit()
                    if buf and not self.drop_last:
                        yield self._collate(buf)
                else:
                    buf = []
                    chunk = max(1, self.batch_size // self.num_workers)
                    items = pool.imap(_fetch, tasks, chunksize=chunk)
                    while True:
                        with spans.span("loader.wait"):
                            got = next(items, None)
                        if got is None:
                            break
                        item, t0, t1 = got
                        spans.record("loader.item", t0, t1, "worker")
                        buf.append(item)
                        if len(buf) == self.batch_size:
                            yield self._collate(buf)
                            buf = []
                    if buf and not self.drop_last:
                        yield self._collate(buf)
        finally:
            # a consumer that stops mid-epoch leaves the items of the batch
            # it was handed in ``buf``, each a view of its slab: dropped
            # first, since a slab that is still viewed cannot close
            buf = None
            for slab in slabs:
                try:
                    slab.unlink()   # free the segment even if views linger
                except Exception:
                    pass
                try:
                    slab.close()
                except Exception:
                    pass
            _WORKER_SLABS = None


def microbatch_reshape(batch: Dict[str, np.ndarray], accum: int
                       ) -> Dict[str, np.ndarray]:
    """[A*b, ...] -> [A, b, ...] leading microbatch axis for the
    accumulation loop of ``build_train_step``."""
    def r(x):
        return x.reshape((accum, x.shape[0] // accum) + x.shape[1:])
    return {k: r(v) for k, v in batch.items()}
