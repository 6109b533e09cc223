"""VLN feature store — the replacement for the reference's LMDB databases
(``utils/dataset/features_reader.py:16-66``); a copy of
``youtube_vln_tpu/data/store.py`` with its converters (``merge_stores``,
``convert_lmdb``), reading and writing the same files.

The reference stores pickled dicts with base64-encoded float buffers inside
LMDB and pays pickle+base64+concat costs on every training-loop read.  Here
records are raw little-endian float32 laid out for zero-copy mmap reads, an
order-of-magnitude cheaper on the host CPU that has to feed the device:

    file := header | record bodies | index
    header (32B): magic 'VLNSTOR1' | u32 version | u32 flags
                  | u64 n_records | u64 index_offset
    body (per record):
        u32 K (num boxes) | u32 image_w | u32 image_h | u32 rflags
        f32 features[K,2048] | f32 boxes[K,4] | f32 cls_prob[K,1601]
        if rflags & PANO:
            f32 view_heading[36] | f32 view_elevation[36]
            f32 feat_heading[K] | f32 feat_elevation[K] | f32 feat_view_idx[K]
    index: per record u16 key_len | key utf8 | u64 offset

Readers: a C++ mmap reader (native/vlnstore.cc, loaded via ctypes) for the
hot path, with a pure-Python mmap fallback with identical semantics.  The
shared library is located from the root of the checkout (``native/``), and
built there with ``make`` on first use when it is missing; ``get_native()``
is None when neither works.  ``convert_lmdb`` reads the reference's LMDB
databases through the optional ``lmdb`` package, imported inside the call.
"""
from __future__ import annotations

import bisect
import ctypes
import mmap
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

MAGIC = b"VLNSTOR1"
VERSION = 1
FLAG_PANO = 1

FEAT_DIM = 2048
BOX_DIM = 4
PROB_DIM = 1601
N_VIEWS = 36

_HEADER = struct.Struct("<8sIIQQ")
_REC_HEADER = struct.Struct("<IIII")


@dataclass
class StoreRecord:
    num_boxes: int
    image_w: int
    image_h: int
    features: np.ndarray      # [K, 2048] f32
    boxes: np.ndarray         # [K, 4] f32 (x1,y1,x2,y2 in pixels)
    cls_prob: np.ndarray      # [K, 1601] f32
    view_heading: Optional[np.ndarray] = None     # [36] f32
    view_elevation: Optional[np.ndarray] = None   # [36] f32
    feat_heading: Optional[np.ndarray] = None     # [K] f32
    feat_elevation: Optional[np.ndarray] = None   # [K] f32
    feat_view_index: Optional[np.ndarray] = None  # [K] f32

    @property
    def is_pano(self) -> bool:
        return self.feat_heading is not None


class StoreWriter:
    """Streaming writer; records are appended, index written on close."""

    def __init__(self, path: Union[str, Path]):
        self._path = Path(path)
        self._f = open(self._path, "wb")
        self._f.write(_HEADER.pack(MAGIC, VERSION, 0, 0, 0))
        self._index: List[Tuple[str, int]] = []
        self._seen: set = set()

    def add(self, key: str, rec: StoreRecord) -> None:
        if key in self._seen:
            # readers dict-dedup the index and then reject the file as
            # corrupt (index count != n_records) — failing an 80 GB
            # conversion at OPEN time with a misleading message; refuse
            # the duplicate at write time instead
            raise ValueError(f"duplicate store key {key!r}")
        self._seen.add(key)
        f = self._f
        offset = f.tell()
        k = rec.num_boxes
        rflags = FLAG_PANO if rec.is_pano else 0
        f.write(_REC_HEADER.pack(k, rec.image_w, rec.image_h, rflags))

        def put(a, shape):
            a = np.ascontiguousarray(a, dtype=np.float32)
            assert a.shape == shape, (a.shape, shape)
            f.write(a.tobytes())

        put(rec.features, (k, FEAT_DIM))
        put(rec.boxes, (k, BOX_DIM))
        put(rec.cls_prob, (k, PROB_DIM))
        if rflags & FLAG_PANO:
            put(rec.view_heading, (N_VIEWS,))
            put(rec.view_elevation, (N_VIEWS,))
            put(rec.feat_heading, (k,))
            put(rec.feat_elevation, (k,))
            put(rec.feat_view_index, (k,))
        self._index.append((key, offset))

    def close(self) -> None:
        f = self._f
        index_offset = f.tell()
        for key, offset in self._index:
            kb = key.encode("utf-8")
            f.write(struct.pack("<H", len(kb)))
            f.write(kb)
            f.write(struct.pack("<Q", offset))
        f.seek(0)
        f.write(_HEADER.pack(MAGIC, VERSION, 0, len(self._index), index_offset))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
            return
        # Do NOT finalize on failure: close() writes a valid header+index
        # for however many records landed before the exception, and a
        # TRUNCATED store that parses cleanly is silently served by every
        # reader (an 80 GB conversion dying halfway would then "work"
        # with most viewpoints missing).  Drop the partial file instead —
        # the converter is idempotent and re-runs from the source.
        self._f.close()
        try:
            self._path.unlink()
        except OSError:
            pass


def _load_native() -> Optional[ctypes.CDLL]:
    native_dir = Path(__file__).resolve().parent.parent.parent / "native"
    lib = native_dir / "libvlnstore.so"
    if not lib.exists() and (native_dir / "Makefile").exists():
        import subprocess
        subprocess.run(["make", "-C", str(native_dir)], check=False,
                       capture_output=True)
    if not lib.exists():
        return None
    try:
        dll = ctypes.CDLL(str(lib))
    except OSError:
        return None
    dll.vlnstore_open.restype = ctypes.c_void_p
    dll.vlnstore_open.argtypes = [ctypes.c_char_p]
    dll.vlnstore_close.argtypes = [ctypes.c_void_p]
    if hasattr(dll, "vlnstore_pack_path"):
        dll.vlnstore_pack_path.restype = ctypes.c_int
        dll.vlnstore_pack_path.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
    if hasattr(dll, "vlnstore_pack_path_f16"):
        dll.vlnstore_pack_path_f16.restype = ctypes.c_int
        dll.vlnstore_pack_path_f16.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
    if hasattr(dll, "vlnstore_gather_probs"):
        dll.vlnstore_gather_probs.restype = ctypes.c_int
        dll.vlnstore_gather_probs.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
    if hasattr(dll, "vlnstore_pack_pano_path"):
        dll.vlnstore_pack_pano_path.restype = ctypes.c_int
        dll.vlnstore_pack_pano_path.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
    if hasattr(dll, "vlnstore_pack_pano_steps_f16"):
        dll.vlnstore_pack_pano_steps_f16.restype = ctypes.c_int
        dll.vlnstore_pack_pano_steps_f16.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
    return dll


_NATIVE = None
_NATIVE_TRIED = False


def get_native():
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE = _load_native()
        _NATIVE_TRIED = True
    return _NATIVE


def _parse_record(buf, offset: int,
                  extent_limit: Optional[int] = None) -> StoreRecord:
    k, w, h, rflags = _REC_HEADER.unpack_from(buf, offset)
    if extent_limit is not None:
        # full-extent check BEFORE any frombuffer: a corrupt num_boxes whose
        # derived extent stays inside the file would otherwise silently
        # serve neighbor-record or index bytes as f32 features (the native
        # reader declines such records; the fallback must be loud, not
        # quieter).  extent_limit is the next record's start — the tightest
        # provable end, records being laid out back to back.
        n_floats = k * (FEAT_DIM + BOX_DIM + PROB_DIM)
        if rflags & FLAG_PANO:
            n_floats += 2 * N_VIEWS + 3 * k
        if offset + _REC_HEADER.size + 4 * n_floats > extent_limit:
            raise ValueError(
                f"corrupt store record at offset {offset}: num_boxes={k} "
                f"extends past its record region end {extent_limit}")
    p = offset + _REC_HEADER.size

    def take(shape):
        nonlocal p
        n = int(np.prod(shape))
        a = np.frombuffer(buf, dtype="<f4", count=n, offset=p).reshape(shape)
        p += 4 * n
        return a

    feats = take((k, FEAT_DIM))
    boxes = take((k, BOX_DIM))
    probs = take((k, PROB_DIM))
    if rflags & FLAG_PANO:
        vh = take((N_VIEWS,))
        ve = take((N_VIEWS,))
        fh = take((k,))
        fe = take((k,))
        fv = take((k,))
        return StoreRecord(k, w, h, feats, boxes, probs, vh, ve, fh, fe, fv)
    return StoreRecord(k, w, h, feats, boxes, probs)


class Store:
    """Read-only mmap store.  Uses the native reader for key lookup when the
    shared library is built; record parsing is zero-copy numpy either way."""

    def __init__(self, path: Union[str, Path]):
        self._path = Path(path)
        self._file = open(self._path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, _flags, n_records, index_offset = _HEADER.unpack_from(
            self._mm, 0)
        if magic != MAGIC:
            raise ValueError(f"not a VLN store: {path}")
        if version != VERSION:
            raise ValueError(f"unsupported store version {version}")
        self._body_end = index_offset  # record bodies end where the index starts
        self._native = get_native()
        self._handle = None
        self._offsets: Dict[str, int] = {}
        if self._native is not None:
            self._handle = self._native.vlnstore_open(
                str(self._path).encode())
            if not self._handle:
                self._native = None
        # the index is always parsed in ONE pass over the mmap — the
        # native handle used to be re-enumerated key-by-key (two ctypes
        # round-trips per record, O(n) FFI for shards with 100k+ keys)
        # only to rebuild this same dict; the handle stays open purely
        # for the pack_path fast path
        try:
            p = index_offset
            for _ in range(n_records):
                (klen,) = struct.unpack_from("<H", self._mm, p)
                p += 2
                key = self._mm[p:p + klen].decode("utf-8")
                p += klen
                (off,) = struct.unpack_from("<Q", self._mm, p)
                p += 8
                # record bodies live in [header, index_offset); an offset
                # outside that range would hand _parse_record / the C
                # packers an out-of-bounds pointer
                if off < _HEADER.size or off + _REC_HEADER.size > index_offset:
                    raise ValueError(
                        f"corrupt store {path}: record offset {off} for "
                        f"key {key!r} outside body region "
                        f"[{_HEADER.size}, {index_offset})")
                self._offsets[key] = off
            if len(self._offsets) != n_records:
                raise ValueError(
                    f"corrupt store {path}: expected {n_records} records, "
                    f"index has {len(self._offsets)}")
            self._sorted_offs = sorted(set(self._offsets.values()))
        except Exception:
            self.close()  # don't leak the mmap/fd/native handle
            raise

    @property
    def keys(self):
        return self._offsets.keys()

    def __len__(self):
        return len(self._offsets)

    def __contains__(self, key: str):
        return key in self._offsets

    def get(self, key: str) -> StoreRecord:
        off = self._offsets.get(key)
        if off is None:
            raise KeyError(key)
        i = bisect.bisect_right(self._sorted_offs, off)
        end = self._sorted_offs[i] if i < len(self._sorted_offs) \
            else self._body_end
        return _parse_record(self._mm, off, extent_limit=end)

    @staticmethod
    def _marshal_step_keys(step_keys):
        """(keys_arr, off_arr, n_steps) ctypes marshalling shared by the
        path packers and the probs gather."""
        flat = []
        offsets = [0]
        for keys in step_keys:
            flat += [k.encode() for k in keys]
            offsets.append(len(flat))
        return ((ctypes.c_char_p * len(flat))(*flat),
                (ctypes.c_int64 * len(offsets))(*offsets), len(step_keys))

    def pack_path(self, step_keys, max_steps: int, max_boxes: int):
        """Native gather+normalize+pad+concat of one candidate path
        (native/vlnstore.cc:vlnstore_pack_path).  step_keys: sequence of
        key tuples, one per real step.  Returns (features, locations,
        probs, mask) shaped [max_steps*max_boxes, ...], or None when the
        native library is unavailable (callers fall back to Python)."""
        if self._native is None or self._handle is None or \
                not hasattr(self._native, "vlnstore_pack_path"):
            return None
        keys_arr, off_arr, n_steps = self._marshal_step_keys(step_keys)
        n = max_steps * max_boxes
        f = np.empty((n, 2048), np.float32)
        l = np.empty((n, 12), np.float32)
        p = np.empty((n, PROB_DIM), np.float32)
        m = np.empty((n,), np.int32)
        ret = self._native.vlnstore_pack_path(
            self._handle, keys_arr, off_arr, n_steps, max_steps, max_boxes,
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            l.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if ret != 0:
            return None
        return f, l, p, m

    def pack_path_f16(self, step_keys, max_steps: int, max_boxes: int):
        """Dedup-transport variant of pack_path: features come back as
        float16 (the H2D dtype, converted in C with the same
        round-to-nearest-even as numpy astype) and probs are NOT
        materialized — fetch target rows post-masking with
        ``gather_probs``.  Returns (features_f16, locations, mask) or
        None (python fallback)."""
        if self._native is None or self._handle is None or \
                not hasattr(self._native, "vlnstore_pack_path_f16"):
            return None
        keys_arr, off_arr, n_steps = self._marshal_step_keys(step_keys)
        n = max_steps * max_boxes
        f = np.empty((n, 2048), np.float16)
        l = np.empty((n, 12), np.float32)
        m = np.empty((n,), np.int32)
        ret = self._native.vlnstore_pack_path_f16(
            self._handle, keys_arr, off_arr, n_steps, max_steps, max_boxes,
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            l.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if ret != 0:
            return None
        return f, l, m

    def gather_probs(self, step_keys, region_ids, max_boxes: int):
        """Class-probability rows for specific packed-region ids of a path
        (row indices of the array pack_path would have produced); ids
        should be ascending.  Returns [len(ids), 1601] f32 or None."""
        if self._native is None or self._handle is None or \
                not hasattr(self._native, "vlnstore_gather_probs"):
            return None
        keys_arr, off_arr, n_steps = self._marshal_step_keys(step_keys)
        ids = np.ascontiguousarray(region_ids, np.int32)
        out = np.empty((len(ids), PROB_DIM), np.float32)
        ret = self._native.vlnstore_gather_probs(
            self._handle, keys_arr, off_arr, len(step_keys), max_boxes,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ids),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if ret != 0:
            return None
        return out

    def pack_pano_path(self, keys, headings, next_headings, max_steps: int,
                       max_boxes: int):
        """Native pano-path packer (one key + heading pair per step,
        native/vlnstore.cc:vlnstore_pack_pano_path); None -> python
        fallback."""
        if self._native is None or self._handle is None or \
                not hasattr(self._native, "vlnstore_pack_pano_path"):
            return None
        n_steps = len(keys)
        keys_arr = (ctypes.c_char_p * n_steps)(
            *[k.encode() for k in keys])
        h_arr = (ctypes.c_double * n_steps)(*[float(x) for x in headings])
        nh_arr = (ctypes.c_double * n_steps)(
            *[float(x) for x in next_headings])
        n = max_steps * max_boxes
        f = np.empty((n, 2048), np.float32)
        l = np.empty((n, 12), np.float32)
        p = np.empty((n, PROB_DIM), np.float32)
        m = np.empty((n,), np.int32)
        ret = self._native.vlnstore_pack_pano_path(
            self._handle, keys_arr, h_arr, nh_arr, n_steps, max_steps,
            max_boxes,
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            l.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if ret != 0:
            return None
        return f, l, p, m

    def pack_pano_steps_f16(self, keys, headings, next_headings, steps,
                            max_boxes: int, out=None):
        """Batched single-step pano packer for the beam-eval host path
        (native/vlnstore.cc:vlnstore_pack_pano_steps_f16): n independent
        (key, heading, next_heading, step-position) blocks written in one
        C call — f16 features (bit-matching astype(float16) of the f32
        pack), f32 locations, int32 mask, NO class probabilities.  A None
        or empty key emits the empty-step block.  ``out`` may carry
        preallocated C-contiguous (f16, locs, mask) arrays with at least
        n*max_boxes leading rows (e.g. the bucket-padded item buffers);
        rows past n*max_boxes are left untouched.  Returns (f, l, m) or
        None when the native library is unavailable."""
        if self._native is None or self._handle is None or \
                not hasattr(self._native, "vlnstore_pack_pano_steps_f16"):
            return None
        n_blocks = len(keys)
        keys_arr = (ctypes.c_char_p * n_blocks)(
            *[(k or "").encode() for k in keys])
        h_arr = (ctypes.c_double * n_blocks)(*[float(x) for x in headings])
        nh_arr = (ctypes.c_double * n_blocks)(
            *[float(x) for x in next_headings])
        s_arr = (ctypes.c_int32 * n_blocks)(*[int(x) for x in steps])
        n = n_blocks * max_boxes
        if out is None:
            f = np.empty((n, 2048), np.float16)
            l = np.empty((n, 12), np.float32)
            m = np.empty((n,), np.int32)
        else:
            f, l, m = out
            # real if/raise, NOT assert: the C call writes
            # n_blocks*max_boxes rows of (2048/12/1) through raw pointers,
            # so an undersized/non-contiguous/wrong-dtype buffer corrupts
            # the heap instead of raising — and `python -O` strips asserts,
            # which is exactly when this guard must still hold (callers
            # pass row-major [blocks, boxes, d] or [rows, d] views; only
            # total capacity matters)
            if not all(a.flags.c_contiguous for a in (f, l, m)):
                raise ValueError("pack_pano_steps_f16 out buffers must be "
                                 "C-contiguous")
            if not (f.dtype == np.float16 and l.dtype == np.float32
                    and m.dtype == np.int32):
                raise ValueError(
                    f"pack_pano_steps_f16 out dtypes must be "
                    f"(float16, float32, int32), got "
                    f"({f.dtype}, {l.dtype}, {m.dtype})")
            if f.size < n * 2048 or l.size < n * 12 or m.size < n:
                raise ValueError(
                    f"pack_pano_steps_f16 out buffers undersized for "
                    f"{n_blocks} blocks x {max_boxes} boxes")
        ret = self._native.vlnstore_pack_pano_steps_f16(
            self._handle, keys_arr, h_arr, nh_arr, s_arr, n_blocks,
            max_boxes,
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            l.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if ret != 0:
            return None
        return f, l, m

    def close(self):
        if self._handle and self._native is not None:
            self._native.vlnstore_close(self._handle)
            self._handle = None
        try:
            self._mm.close()
        except BufferError:
            # zero-copy arrays parsed from this store are still alive; the
            # mapping is released when they are garbage collected
            pass
        self._file.close()


# --------------------------------------------------------------------------- #
# converters
# --------------------------------------------------------------------------- #
def merge_stores(paths: Sequence[Union[str, Path]],
                 out_path: Union[str, Path]) -> int:
    """Merge several store shards into ONE store file (streaming, zero-copy
    record views).  Duplicate keys resolve LAST-shard-wins — the same
    semantics as opening the shards as a multi-shard FeaturesReader
    (features_reader.py merges key spaces in shard order, reference
    :17-42).

    Why: the native path packers only engage when every key of a path
    lives in one shard (a packed path is one C call against one mmap);
    a reference-layout migration (11 LMDBs -> 11 stores via
    convert_lmdb) would silently fall back to the ~3x slower Python
    assembly for any path spanning shards.  Merge once offline, read one
    store forever.  Returns the merged record count."""
    winner: Dict[str, int] = {}
    stores: List[Store] = []
    try:
        # open inside the try — a corrupt later shard must not leak the
        # mmaps/fds/native handles of the shards already opened
        for p in paths:
            stores.append(Store(p))
        for i, s in enumerate(stores):
            for k in s.keys:
                winner[k] = i
        n = 0
        with StoreWriter(out_path) as w:
            for i, s in enumerate(stores):
                for k in s.keys:
                    if winner[k] != i:
                        continue  # a later shard overrides this key
                    w.add(k, s.get(k))
                    n += 1
        return n
    finally:
        for s in stores:
            s.close()


def convert_lmdb(lmdb_path: Union[str, Path], out_path: Union[str, Path],
                 pano: bool = False) -> int:
    """Convert a reference LMDB (pickled dicts, features_reader.py:124-150 /
    193-233 formats) into a VLN store.  Requires the ``lmdb`` package."""
    import base64
    import pickle

    try:
        import lmdb
    except ImportError as e:  # lmdb is optional
        raise RuntimeError(
            "lmdb is not installed; convert on a machine that has it") from e

    env = lmdb.open(str(lmdb_path), readonly=True, lock=False)
    n = 0
    with StoreWriter(out_path) as w, env.begin(write=False) as txn:
        keys = pickle.loads(txn.get(b"keys"))
        for bkey in keys:
            item = pickle.loads(txn.get(bkey))
            key = bkey.decode()

            def dec(name_old, name_new, dim):
                if name_old in item:
                    a = np.frombuffer(item[name_old], dtype=np.float32)
                else:
                    a = np.frombuffer(base64.b64decode(item[name_new]),
                                      dtype=np.float32)
                return a.reshape((-1, dim))

            if pano:
                feats = np.frombuffer(base64.b64decode(item["features"]),
                                      np.float32).reshape(-1, FEAT_DIM)
                boxes = np.frombuffer(base64.b64decode(item["boxes"]),
                                      np.float32).reshape(-1, BOX_DIM)
                probs = np.frombuffer(base64.b64decode(item["cls_prob"]),
                                      np.float32).reshape(-1, PROB_DIM)
                b64v = lambda f: np.frombuffer(base64.b64decode(item[f]),
                                               np.float32)
                rec = StoreRecord(
                    len(boxes), int(item["image_w"]), int(item["image_h"]),
                    feats, boxes, probs,
                    view_heading=b64v("viewHeading"),
                    view_elevation=b64v("viewElevation"),
                    feat_heading=b64v("featureHeading"),
                    feat_elevation=b64v("featureElevation"),
                    feat_view_index=b64v("featureViewIndex"))
            else:
                old = "image_width" in item
                feats = dec("feature", "features", FEAT_DIM)
                boxes = dec("bbox", "boxes", BOX_DIM)
                probs = dec("cls_prob", "cls_prob", PROB_DIM)
                rec = StoreRecord(
                    len(boxes),
                    int(item["image_width" if old else "image_w"]),
                    int(item["image_height" if old else "image_h"]),
                    feats, boxes, probs)
            w.add(key, rec)
            n += 1
    return n
