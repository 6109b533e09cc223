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
    assemble numpy items and never call into torch; where the batch layout
    is static, each worker writes its item straight into its row of a
    batch-shaped shared-memory slab, so the consumer collates nothing

Batches are dicts of numpy arrays; ``build_train_step`` moves them to the
device (``device.to_device``).  ``device.prefetch_to_device`` iterates the
Loader on a thread of its own (``feed``), so that its wait (and collate,
where the layout is dynamic), the pin and the copy of the next batches
overlap the step.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import logging
import multiprocessing as mp
import os
import queue
import threading
import weakref
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

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
_WORKER_SLABS = None      # the epoch's shared segments (SharedMemory)
_WORKER_LAYOUT = None     # the static batch layout (_Layout) of _fill_row
_WORKER_ROWS: Dict[str, tuple] = {}   # a worker's batch slabs, by name


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


# --------------------------------------------------------------------------- #
# batch-shaped slabs: the workers collate in place
# --------------------------------------------------------------------------- #
_ALIGN = 64             # each key's block starts on a cache line


class _Field(NamedTuple):
    """One key of a static batch layout: its batch array is ``shape`` of
    ``dtype`` at ``offset`` in the slab.  A ``stacked`` key takes a whole
    item value per row (a scalar ``ranking_target``, ``instr_id``); the
    others take ``item[:cur]`` and zeros after it, as ``collate`` pads."""
    key: str
    dtype: str
    shape: Tuple[int, ...]
    offset: int
    stacked: bool
    item_dtype: str


class _Layout(NamedTuple):
    fields: Tuple[_Field, ...]
    nbytes: int


def _batch_layout(probes: Sequence[Dict], bs: int, nc: int,
                  nc_uniq: Optional[int], with_instr_id: bool
                  ) -> Optional[_Layout]:
    """The layout of ``collate(items, nc, with_instr_id, nc_uniq)`` for
    every batch of ``bs`` items like ``probes``, or None when it is not
    static: the probes disagree on a key, a dtype or a trailing shape, a
    ``uniq_*`` key has no static count (step-dedup items bucket-pad their
    own), or a key is one ``collate`` cannot take or pads by item."""
    keys = [k for k in BATCH_KEYS if k in probes[0]]
    if any([k for k in BATCH_KEYS if k in p] != keys for p in probes):
        return None
    fields, offset = [], 0
    for k in keys + (["instr_id"] if with_instr_id else []):
        if any(k not in p for p in probes):
            return None
        vs = [np.asarray(p[k]) for p in probes]
        v0 = vs[0]
        if any(v.dtype != v0.dtype for v in vs):
            return None
        stacked = k == "instr_id" or (k == "ranking_target" and v0.ndim == 0)
        if stacked:
            # np.stack's dtype is the items' own: strings grow with them
            if v0.dtype.kind not in "biuf" or any(v.shape != v0.shape
                                                  for v in vs):
                return None
            shape, dtype = (bs,) + v0.shape, v0.dtype
        else:
            if k.startswith("uniq_") and not nc_uniq:
                return None
            n0 = nc_uniq if k.startswith("uniq_") else nc
            if v0.ndim == 0 or any(v.shape[1:] != v0.shape[1:]
                                   or v.shape[0] > n0 for v in vs):
                return None
            shape = (bs, n0) + v0.shape[1:]
            dtype = np.dtype(bool) if k == "opt_mask" else v0.dtype
        fields.append(_Field(k, dtype.str, shape, offset, stacked, v0.dtype.str))
        nbytes = int(np.prod(shape)) * dtype.itemsize
        offset += -(-nbytes // _ALIGN) * _ALIGN
    return _Layout(tuple(fields), max(offset, _ALIGN))


def _misfit(item, layout: _Layout) -> bool:
    """Whether ``item`` does not fit its row of ``layout``: another set of
    batch keys, or a key of another dtype or shape."""
    keys = {k for k in BATCH_KEYS if k in item}
    if keys != {f.key for f in layout.fields if f.key != "instr_id"}:
        return True
    for f in layout.fields:
        if f.key not in item:
            return True
        v = np.asarray(item[f.key])
        if v.dtype.str != f.item_dtype:
            return True
        if f.stacked:
            if v.shape != f.shape[1:]:
                return True
        elif v.ndim != len(f.shape) - 1 or v.shape[1:] != f.shape[2:] \
                or v.shape[0] > f.shape[1]:
            return True
    return False


def _write_row(arrays: Dict[str, np.ndarray], layout: _Layout, row: int,
               item) -> None:
    """``collate``'s inner loop for one item: its values into row ``row``
    of the batch ``arrays``, zero-padded past each value's length."""
    for f in layout.fields:
        v = np.asarray(item[f.key])
        arr = arrays[f.key]
        if f.stacked:
            arr[row] = v
            continue
        cur = v.shape[0]
        arr[row, :cur] = v
        if cur < f.shape[1]:
            arr[row, cur:] = 0


def _arrays(buffer, layout: _Layout, n: Optional[int] = None
            ) -> Dict[str, np.ndarray]:
    """The batch's arrays over the slab ``buffer`` (a uint8 array); with
    ``n``, the first ``n`` rows of each."""
    out = {}
    for f in layout.fields:
        dtype = np.dtype(f.dtype)
        count = int(np.prod(f.shape))
        flat = buffer[f.offset:f.offset + count * dtype.itemsize]
        out[f.key] = flat.view(dtype).reshape(f.shape)[:n]
    return out


def _fill_row(task, name: str, row: int):
    """Worker: build item ``task`` and write it into row ``row`` of the
    batch slab ``name`` (attached by name once per worker: the parent
    makes slabs as the epoch needs them, after the pool forked).  Returns (item, t0, t1) with item None
    when it was written, or the item itself when it does not fit the
    layout, for the parent to write and count."""
    epoch, idx = task
    t0 = spans.clock()
    item = _get_item(epoch, idx)
    if _misfit(item, _WORKER_LAYOUT):
        return item, t0, spans.clock()
    if name not in _WORKER_ROWS:
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(name=name)
        _WORKER_ROWS[name] = (shm, _arrays(
            np.frombuffer(shm.buf, np.uint8), _WORKER_LAYOUT))
    _write_row(_WORKER_ROWS[name][1], _WORKER_LAYOUT, row, item)
    return None, t0, spans.clock()


class _Slab:
    """A batch-shaped shared-memory segment, and the address of the
    parent's mapping of it."""

    def __init__(self, nbytes: int):
        from multiprocessing import shared_memory
        self.shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self.name = self.shm.name
        self.nbytes = nbytes
        self.fresh = True        # not yet handed out, so maybe not written
        view = np.frombuffer(self.shm.buf, np.uint8)
        self.address = view.ctypes.data
        del view                # no buffer export outlives this line


class _Window:
    """The base of the arrays of one batch handed out of a slab.

    Its arrays reach the mapping through ``__array_interface__``, which
    takes no buffer export, so the segment can close once the window is
    gone; the window keeps the slab, and so the mapping, alive until
    then."""

    def __init__(self, slab: _Slab):
        self.slab = slab
        self.__array_interface__ = {"data": (slab.address, False),
                                    "shape": (slab.nbytes,), "typestr": "|u1",
                                    "version": 3}


class _BatchSlabs:
    """The batch slabs of one epoch.

    A slab is handed out as a batch of arrays (``lease``) and goes back to
    the free list when the last of them, or any view of one, is gone: a
    ``weakref.finalize`` on the batch's ``_Window``.  With none free,
    ``take`` makes another while /dev/shm keeps room for it beside the
    slabs not yet written and an eighth of /dev/shm's size; else it
    returns None and that batch is collated from pickled items (a write
    to a full /dev/shm would kill the worker with SIGBUS).  ``close`` unlinks
    every slab and closes those not handed out; a batch that outlives its
    epoch keeps its mapping, which closes when the batch goes."""

    def __init__(self, layout: _Layout):
        self.layout = layout
        self.slabs: List[_Slab] = []
        self._free: List[_Slab] = []
        self._leased = set()
        self._unwritten = 0      # slabs made but not yet handed out once
        self._lock = threading.RLock()   # a finalizer may run on any thread
        self._open = True

    def _room(self) -> bool:
        try:
            st = os.statvfs("/dev/shm")
        except OSError:          # no such file system to run out of
            return True
        free = st.f_bavail * st.f_frsize
        need = (self._unwritten + 1) * self.layout.nbytes
        return free - need >= st.f_blocks * st.f_frsize // 8

    def take(self) -> Optional[_Slab]:
        with self._lock:
            if self._free:
                return self._free.pop()
        if not self._room():
            return None
        slab = _Slab(self.layout.nbytes)
        with self._lock:
            self.slabs.append(slab)
            self._unwritten += 1
        return slab

    def write_row(self, slab: _Slab, row: int, item) -> None:
        _write_row(_arrays(np.asarray(_Window(slab)), self.layout),
                   self.layout, row, item)

    def lease(self, slab: _Slab, n: int) -> Dict[str, np.ndarray]:
        """The first ``n`` rows of the batch in ``slab``, as ``collate``
        would return them."""
        window = _Window(slab)
        with self._lock:
            self._leased.add(slab)
            if slab.fresh:
                slab.fresh = False
                self._unwritten -= 1
        weakref.finalize(window, self._give_back, slab).atexit = False
        return _arrays(np.asarray(window), self.layout, n)

    def _give_back(self, slab: _Slab) -> None:
        with self._lock:
            self._leased.discard(slab)
            if self._open:
                self._free.append(slab)
                return
        slab.shm.close()

    def close(self) -> None:
        with self._lock:
            self._open = False
            idle = [s for s in self.slabs if s not in self._leased]
            self._free = []
        for slab in self.slabs:
            try:
                slab.shm.unlink()
            except FileNotFoundError:
                pass
        for slab in idle:
            slab.shm.close()


class Loader:
    """Iterable over collated batches with background prefetch.

    batch_size semantics follow the reference: the caller passes the
    *per-step* batch size (global batch // grad-accum // world already
    applied by the engine, dataset_init.py:204-208).

    num_workers > 0 assembles items in a fork-based process pool (the
    reference's DataLoader workers, num_workers=3 per GPU).  Sampling is
    deterministic in (seed, epoch, index) regardless of worker count.
    Where the batch layout is static (every key's batch shape known from
    probe items), the workers write each item into its row of a
    batch-shaped shared-memory slab and the batch is handed out as views
    of it, equal to ``collate``'s; else collate runs in the CONSUMER
    process over item slabs.  ``batch_assembly`` counts the batches of
    each kind.  On starved hosts leave num_workers=0 — the transport
    overhead cannot be amortized without CPUs.  Items that overflow the
    shared-memory slabs, or do not fit the batch layout, travel pickled
    LOUDLY (warning + ``shm_fallbacks`` counter).
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
        # item slots, "layout_misfit" an item unlike the probes of the
        # static batch layout, "shm_full" a batch /dev/shm had no room for
        self.shm_fallbacks = 0
        self.shm_fallbacks_by_reason: Dict[str, int] = {}
        # the yielded batches: written in place by the workers, or collated
        self.batch_assembly = {"in_place": 0, "collated": 0}
        # (static batch layout or None, item slab bytes): probe once
        self._probed: Optional[Tuple[Optional[_Layout], int]] = None

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
        self.batch_assembly["collated"] += 1
        with spans.span("loader.collate"):
            return collate(buf, self.nc, self.with_instr_id, self.nc_uniq)

    def _fallback(self, reason: str, nbytes: int) -> None:
        self.shm_fallbacks += 1
        n = self.shm_fallbacks_by_reason.get(reason, 0) + 1
        self.shm_fallbacks_by_reason[reason] = n
        if n == 1:
            logging.getLogger(__name__).warning(
                "loader fell back to pickle transport (%s; slab %d bytes) — "
                "a performance cliff (loader.shm_fallbacks_by_reason counts "
                "occurrences by cause)", reason, nbytes)

    def _probe(self, tasks) -> Tuple[Optional[_Layout], int]:
        """Items from several points of the epoch, not just item 0: the
        static batch layout they share, if any, and the item slab size.
        Variable-size layouts (--dedup_beam_steps buckets uniq step blocks
        in multiples of STEP_BUCKET) vary by integer factors between items,
        which a single probe + 25% headroom cannot cover (every larger item
        would take the loud pickle-fallback cliff).  _get_item reseeds per
        item, so probing does not disturb worker determinism.  Item
        geometry is epoch-independent (shapes are static or bucketed), so
        this runs once per Loader: each probe assembles a full item in the
        parent (29-555 ms at flagship geometry)."""
        n = len(tasks)
        probes = [_get_item(*tasks[i])
                  for i in sorted({0, n // 3, (2 * n) // 3, n - 1})]
        layout = _batch_layout(probes, self.batch_size, self.nc,
                               self.nc_uniq, self.with_instr_id)
        slab_bytes = 4096 + int(1.25 * max(
            sum(np.asarray(v).nbytes for v in p.values()) for p in probes))
        return layout, slab_bytes

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
                del batch       # a slab frees as soon as the consumer lets go
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

        Transport, with use_shared_memory (default): where the probes give
        a static batch layout, batch-shaped SharedMemory slabs
        (``_BatchSlabs``): the parent hands out a batch's tasks, each with
        its slab and row, once it has a slab for it, and yields the batch
        as views of the slab when every row is in; a slab is reused only
        once nothing views it.  Else one slab per item, handed out by the
        parent, and only the schema goes through the result pipe; slots
        are recycled after collation copies the views.  Either way no
        ~40-90 MB item is pickled.  Without it, pickled items."""
        global _WORKER_DATASET, _WORKER_SEED, _WORKER_SLABS, _WORKER_LAYOUT
        order = self._order()
        ctx = mp.get_context("fork")
        _WORKER_DATASET = self.dataset
        _WORKER_SEED = self.seed
        tasks = [(self.epoch, int(i)) for i in order]

        slabs = []
        batch_slabs = None
        if self.use_shared_memory and tasks:
            if self._probed is None:
                self._probed = self._probe(tasks)
            layout, slab_bytes = self._probed
            if layout is not None:
                from multiprocessing import resource_tracker
                # workers attach to slabs made after the fork by name: with
                # the tracker running before the fork they register with
                # it, not each with one of its own that unlinks at its exit
                resource_tracker.ensure_running()
                batch_slabs = _BatchSlabs(layout)
                _WORKER_LAYOUT = layout
                _WORKER_SLABS = batch_slabs.slabs
            else:
                from multiprocessing import shared_memory
                n_slots = self.num_workers + self.batch_size + 2
                for i in range(n_slots):
                    slabs.append(shared_memory.SharedMemory(
                        create=True, size=slab_bytes))
                _WORKER_SLABS = slabs

        buf: List[Dict] = []
        try:
            with ctx.Pool(self.num_workers) as pool:
                if batch_slabs is not None:
                    # the batch gathered next and up to ``prefetch`` more
                    # in the workers' queue, in task order
                    groups = (tasks[i:i + self.batch_size]
                              for i in range(0, len(tasks), self.batch_size))
                    queued = collections.deque()
                    while True:
                        while len(queued) <= max(1, self.prefetch):
                            group = next(groups, None)
                            if group is None:
                                break
                            queued.append(self._submit(pool, group,
                                                       batch_slabs))
                        if not queued:
                            break
                        batch = self._gather(*queued.popleft(), batch_slabs)
                        yield batch
                        del batch
                elif slabs:
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
                            self._fallback(payload, slabs[0].size)
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
            # it was handed in ``buf``, each a view of its item slab:
            # dropped first, since a slab that is still viewed cannot close
            # (batch slabs are viewed without a buffer export: those still
            # handed out close when their batch goes)
            buf = None
            if batch_slabs is not None:
                batch_slabs.close()
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
            _WORKER_LAYOUT = None

    def _submit(self, pool, group, batch_slabs: _BatchSlabs):
        """The tasks of one batch to the workers, each with its row of the
        batch's slab; pickled where /dev/shm has no room for another."""
        slab = batch_slabs.take()
        if slab is None:
            return None, [pool.apply_async(_fetch, (t,)) for t in group]
        return slab, [pool.apply_async(_fill_row, (t, slab.name, row))
                      for row, t in enumerate(group)]

    def _gather(self, slab: Optional[_Slab], results,
                batch_slabs: _BatchSlabs) -> Dict[str, np.ndarray]:
        """The batch of ``_submit`` once every row is in: views of its
        slab, or collated from the pickled items."""
        items = []
        for row, res in enumerate(results):
            with spans.span("loader.wait"):
                item, t0, t1 = res.get()
            spans.record("loader.item", t0, t1, "worker")
            if slab is None:
                self._fallback("shm_full", batch_slabs.layout.nbytes)
                items.append(item)
            elif item is not None:
                self._fallback("layout_misfit", batch_slabs.layout.nbytes)
                batch_slabs.write_row(slab, row, item)
        if slab is None:
            return self._collate(items)
        self.batch_assembly["in_place"] += 1
        return batch_slabs.lease(slab, len(results))


def microbatch_reshape(batch: Dict[str, np.ndarray], accum: int
                       ) -> Dict[str, np.ndarray]:
    """[A*b, ...] -> [A, b, ...] leading microbatch axis for the
    accumulation loop of ``build_train_step``."""
    def r(x):
        return x.reshape((accum, x.shape[0] // accum) + x.shape[1:])
    return {k: r(v) for k, v in batch.items()}
