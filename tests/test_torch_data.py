"""The port's host data pipeline for pretraining (youtube_vln_tpu_torch/
data/*, ops/masking.py) against the JAX package's (youtube_vln_tpu/data/*,
ops/masking.py): the fixtures write the same bytes, the store, readers
and tokenizer return the same arrays, and the YTb/BnB items, collated
batches and Loader batches are equal, dtypes included, for the same seeds.
Each package reads its own fixture.  The port's worker pool delivers every
item through its shared-memory slabs."""
import filecmp

import numpy as np
import pytest

from youtube_vln_tpu.config import RunConfig as JaxRunConfig
from youtube_vln_tpu.data import datasets as jds
from youtube_vln_tpu.data import features_reader as jfr
from youtube_vln_tpu.data import fixtures as jfix
from youtube_vln_tpu.data import loader as jloader
from youtube_vln_tpu.data import store as jstore
from youtube_vln_tpu.data import tokenizer as jtok
from youtube_vln_tpu.ops import masking as jmask
from youtube_vln_tpu_torch.config import RunConfig
from youtube_vln_tpu_torch.data import datasets as pds
from youtube_vln_tpu_torch.data import features_reader as pfr
from youtube_vln_tpu_torch.data import fixtures as pfix
from youtube_vln_tpu_torch.data import loader as ploader
from youtube_vln_tpu_torch.data import store as pstore
from youtube_vln_tpu_torch.data import tokenizer as ptok
from youtube_vln_tpu_torch.ops import masking as pmask

# the same packages, side by side
JAX = dict(ds=jds, fr=jfr, fix=jfix, loader=jloader, store=jstore, tok=jtok,
           args=JaxRunConfig)
PORT = dict(ds=pds, fr=pfr, fix=pfix, loader=ploader, store=pstore, tok=ptok,
            args=RunConfig)
DATASETS = {"ytb": ("YTbDataset", "YTbFeaturesReader", "build_ytb_fixture"),
            "bnb": ("BnBDataset", "BnBFeaturesReader", "build_bnb_fixture")}
# transports: dense targets, sparse targets, sparse + candidate dedup
TRANSPORTS = {"dense": dict(sparse_vision_targets=False),
              "sparse": dict(sparse_vision_targets=True, dedup_candidates=False),
              "dedup": dict(sparse_vision_targets=True, dedup_candidates=True)}


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """{(package, dataset): path map}, each package writing its own."""
    out = {}
    for pkg_name, pkg in (("jax", JAX), ("port", PORT)):
        for name, (_, _, builder) in DATASETS.items():
            root = tmp_path_factory.mktemp(f"{pkg_name}_{name}")
            out[pkg_name, name] = getattr(pkg["fix"], builder)(root, seed=3)
    return out


# the builders of whole directories: every file they write is compared
TREE_BUILDERS = {"r2r": "build_r2r_fixture", "full": "build_full_fixture"}


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("name", sorted(DATASETS) + sorted(TREE_BUILDERS))
def test_fixtures_write_identical_files(fixtures, name, tmp_path):
    if name in DATASETS:
        jax_paths, port_paths = fixtures["jax", name], fixtures["port", name]
        assert jax_paths.keys() == port_paths.keys()
        for key in jax_paths:
            assert filecmp.cmp(jax_paths[key], port_paths[key], shallow=False), key
        return
    # the R2R fixture (task, beam, connectivity and distances JSONs, pano
    # store, vocab) and the full data directory, byte for byte
    roots = {}
    for pkg_name, pkg in (("jax", JAX), ("port", PORT)):
        roots[pkg_name] = tmp_path / pkg_name
        paths = getattr(pkg["fix"], TREE_BUILDERS[name])(roots[pkg_name], seed=1)
        assert all(str(v).startswith(str(roots[pkg_name])) for v in paths.values())
    files = _tree(roots["jax"])
    assert files == _tree(roots["port"])
    for sub in ("connectivity", "distances", "task", "beamsearch"):
        assert any(f.startswith(sub + "/") for f in files), sub
    for rel in files:
        assert filecmp.cmp(roots["jax"] / rel, roots["port"] / rel, shallow=False), rel


def _args(pkg, name, paths, **kw):
    base = dict(pretrain=True, pre_dataset=name, ranking=True,
                max_instruction_length=32, max_path_length=4, max_num_boxes=5,
                min_path_length=3, min_captioned=2, max_captioned=4,
                num_negatives=2, shuffler="different", negative_style="normal",
                skeleton_path=paths["skeleton_path"] if name == "ytb" else "")
    base.update(kw)
    return pkg["args"](**base)


def _dataset(pkg, name, paths, masked, training=True, **kw):
    ds_cls, reader_cls, _ = DATASETS[name]
    args = _args(pkg, name, paths, masked_vision=masked, masked_language=masked, **kw)
    reader = getattr(pkg["fr"], reader_cls)(paths["store_path"])
    testsets = None if training else {
        "ranking": paths["testset_path"],
        "traj": paths.get("traj_testset_path", paths["testset_path"])}
    ds = getattr(pkg["ds"], ds_cls)(
        args=args, caption_path=paths["caption_path"],
        tokenizer=pkg["tok"].load_tokenizer(paths["vocab_path"]),
        features_reader=reader, masked_vision=masked, masked_language=masked,
        training=training, testset_path=testsets, seed=0)
    return ds, reader


def _assert_items_equal(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (what, k, x.dtype, y.dtype)
        assert np.array_equal(x, y), (what, k)


def _no_native(monkeypatch):
    for mod in (jstore, pstore):
        monkeypatch.setattr(mod, "_NATIVE", None)
        monkeypatch.setattr(mod, "_NATIVE_TRIED", True)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
@pytest.mark.parametrize("masked", [True, False], ids=["mlm_mvm", "unmasked"])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_items_equal(fixtures, monkeypatch, name, masked, transport, native):
    if not native:
        _no_native(monkeypatch)
    elif jstore.get_native() is None:
        pytest.fail("the native store library did not build")
    jds_, jr = _dataset(JAX, name, fixtures["jax", name], masked, **TRANSPORTS[transport])
    pds_, pr = _dataset(PORT, name, fixtures["port", name], masked, **TRANSPORTS[transport])
    try:
        assert len(jds_) == len(pds_) > 0
        assert jds_.num_candidates() == pds_.num_candidates()
        assert jds_.num_unique_candidates() == pds_.num_unique_candidates()
        for i in range(len(jds_)):
            jds_.reseed(100 + i)
            pds_.reseed(100 + i)
            _assert_items_equal(jds_[i], pds_[i], i)
    finally:
        jr.close()
        pr.close()


@pytest.mark.parametrize("traj_judge", [False, True])
def test_frozen_testset_items_equal(fixtures, traj_judge):
    """Eval items come from the frozen testset (YTb)."""
    kw = dict(traj_judge=traj_judge, ranking=not traj_judge)
    jds_, jr = _dataset(JAX, "ytb", fixtures["jax", "ytb"], False, training=False, **kw)
    pds_, pr = _dataset(PORT, "ytb", fixtures["port", "ytb"], False, training=False, **kw)
    try:
        assert len(jds_) == len(pds_) > 0
        for i in range(len(jds_)):
            _assert_items_equal(jds_[i], pds_[i], i)
    finally:
        jr.close()
        pr.close()


def test_store_and_readers_return_equal_arrays(fixtures):
    paths_j, paths_p = fixtures["jax", "ytb"], fixtures["port", "ytb"]
    js, ps = jstore.Store(paths_j["store_path"]), pstore.Store(paths_p["store_path"])
    jr, pr = jfr.YTbFeaturesReader(paths_j["store_path"]), pfr.YTbFeaturesReader(paths_p["store_path"])
    try:
        keys = sorted(js.keys)
        assert keys == sorted(ps.keys)
        for key in keys[:6]:
            a, b = js.get(key), ps.get(key)
            for field in ("num_boxes", "image_w", "image_h", "features", "boxes", "cls_prob"):
                assert np.array_equal(getattr(a, field), getattr(b, field)), field
        step_keys = [(keys[0], keys[1]), (keys[2],), (keys[3], keys[4], keys[5])]
        for ja, pa in zip(jr[step_keys[0]], pr[step_keys[0]]):
            assert ja.dtype == pa.dtype and np.array_equal(ja, pa)
        for method, call_args in (("pack_path", (step_keys, 4, 5)),
                                  ("pack_path_f16", (step_keys, 4, 5)),
                                  ("gather_probs", (step_keys, [0, 3, 7, 12], 5))):
            got, want = getattr(pr, method)(*call_args), getattr(jr, method)(*call_args)
            assert got is not None and want is not None, method
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert g.dtype == w.dtype and np.array_equal(g, w), method
    finally:
        for x in (js, ps, jr, pr):
            x.close()


def test_tokenizers_agree(fixtures):
    jt = jtok.load_tokenizer(fixtures["jax", "ytb"]["vocab_path"])
    pt = ptok.load_tokenizer(fixtures["port", "ytb"]["vocab_path"])
    assert jt.vocab == pt.vocab
    for text in ("Walk into the kitchen, then turn left.",
                 "go past the BED and stop at the mirror !",
                 "unknownword [MASK] table [SEP]"):
        assert pt.tokenize(text) == jt.tokenize(text)
        assert pt.encode(text) == jt.encode(text)


def _loader_batches(pkg, paths, num_workers, epoch):
    ds, reader = _dataset(pkg, "ytb", paths, True, **TRANSPORTS["dedup"],
                          traj_judge=True)
    try:
        loader = pkg["loader"].Loader(ds, batch_size=2, shuffle=True, seed=5,
                                      num_workers=num_workers, drop_last=True)
        loader.set_epoch(epoch)
        return [{k: np.array(v) for k, v in b.items()} for b in loader]
    finally:
        reader.close()


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_equal(fixtures, num_workers):
    for epoch in (0, 1):
        want = _loader_batches(JAX, fixtures["jax", "ytb"], num_workers, epoch)
        got = _loader_batches(PORT, fixtures["port", "ytb"], num_workers, epoch)
        assert len(got) == len(want) > 0
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_items_equal(g, w, (epoch, i))
            _assert_items_equal(ploader.microbatch_reshape(g, 2),
                                jloader.microbatch_reshape(w, 2), (epoch, i))


def test_collate_and_shard_indices_equal(fixtures):
    ds, reader = _dataset(PORT, "ytb", fixtures["port", "ytb"], True, **TRANSPORTS["dedup"])
    try:
        items = [ds[i] for i in range(3)]
    finally:
        reader.close()
    for with_id in (False, True):
        _assert_items_equal(ploader.collate(items, 9, with_id, 7),
                            jloader.collate(items, 9, with_id, 7), with_id)
    for kw in (dict(shuffle=True, num_shards=4, shard=1),
               dict(shuffle=True, num_shards=3, shard=2, drop_last=True),
               dict(shuffle=False)):
        assert np.array_equal(ploader.shard_indices(10, seed=2, epoch=1, **kw),
                              jloader.shard_indices(10, seed=2, epoch=1, **kw))
    for seed, epoch, idx in ((0, 0, 0), (1, 3, 17), (99, 2, 123456)):
        assert ploader._item_seed(seed, epoch, idx) == jloader._item_seed(seed, epoch, idx)


# --------------------------------------------------------------------------- #
# masking: the same draws give the same masks
# --------------------------------------------------------------------------- #
def _region_inputs(seed, n=7, s=20, c=11):
    rng = np.random.default_rng(seed)
    mask = (rng.random((n, s)) < 0.8).astype(np.int32)
    probs = rng.random((n, s, c)).astype(np.float32)
    feats = rng.normal(size=(n, s, 16)).astype(np.float32)
    return feats, probs, mask


def _same(fn_name, *args, **kw):
    outs = [getattr(mod, fn_name)(*args, rng=np.random.default_rng(42), **kw)
            for mod in (jmask, pmask)]
    for a, b in zip(*outs):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), fn_name


def test_masking_functions_draw_the_same_masks():
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 3000, (7, 32)).astype(np.int32)
    tokens[:, 5] = pmask.ACTION_TOKEN_IDS[0]
    mask = (rng.random((7, 32)) < 0.9).astype(np.int32)
    for rate in (0.0, 0.5):
        _same("randomize_tokens_np", tokens, mask, 3000, 103, mask_action_rate=rate)
    feats, probs, mask = _region_inputs(1)
    _same("randomize_regions_np", feats, probs, mask)
    _same("randomize_regions_sparse_np", feats, probs, mask)
    _same("randomize_regions_sparse_dedup_np", [probs[0], probs[1], probs[2]],
          mask[:3], [0, 1, 0, 2, 2, 1, 0], dtype=np.float16)
    for a, b in zip(jmask.unmasked_region_targets(probs, mask),
                    pmask.unmasked_region_targets(probs, mask)):
        assert np.array_equal(a, b)
    for s in (1, 20, 101, 808, 1000):
        assert pmask.max_masked_regions(s) == jmask.max_masked_regions(s)


class _Items:
    """48 small items of one candidate each: per-item work is trivial, so
    any wait in the worker pool is the transport's."""

    def __len__(self):
        return 48

    def num_candidates(self):
        return 1

    def __getitem__(self, i):
        return {"opt_mask": np.ones(1, bool),
                "image_features": np.full((1, 4, 8), i, np.float16),
                "ranking_target": np.asarray(0, np.int32)}


def test_worker_pool_never_runs_out_of_slots():
    """Batches of 16 from 3 workers over the shared-memory slabs: every item
    arrives through a slab (none falls back to pickling for want of a free
    slot), and the batches hold the items in order."""
    loader = ploader.Loader(_Items(), 16, shuffle=False, drop_last=True,
                            num_workers=3)
    batches = list(loader)
    assert loader.shm_fallbacks == 0, loader.shm_fallbacks_by_reason
    got = np.concatenate([b["image_features"][:, 0, 0, 0] for b in batches])
    np.testing.assert_array_equal(got, np.arange(48))


@pytest.mark.filterwarnings("error::pytest.PytestUnraisableExceptionWarning")
def test_loader_stopped_mid_epoch_closes_its_slabs():
    """A consumer that stops after one batch of a 2-worker Loader: the
    items that still view a slab are dropped before the slabs close, so no
    ``BufferError`` is raised from ``SharedMemory.__del__``."""
    import gc
    import sys

    unraisable = []
    hook, sys.unraisablehook = sys.unraisablehook, unraisable.append
    try:
        batches = iter(ploader.Loader(_Items(), 4, shuffle=False, drop_last=True,
                                      num_workers=2))
        first = next(batches)
        batches.close()
        del batches
        gc.collect()
    finally:
        sys.unraisablehook = hook
    assert not unraisable, [u.exc_value for u in unraisable]
    np.testing.assert_array_equal(first["image_features"][:, 0, 0, 0], np.arange(4))
