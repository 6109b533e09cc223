"""The port's R2R ``BeamDataset`` (``youtube_vln_tpu_torch/data/
datasets.py``) against the JAX package's: items equal, keys and dtypes
included, at the same seeds, on the dense transport, the step-dedup one and
the f16 fast path, with the native and the numpy store reader; eval items
with batch_size != 1 (tiling) and eval-time shuffled negatives; the 30RS
training selection over 3 epochs of reseeding; the trajectory-judge items
over all three shuffle types; and Loader batches with ``instr_id``, with 0
and 2 workers.  The step-dedup item, expanded by the port's
``expand_beam_steps``, equals the dense item bit for bit.  Each package
reads its own R2R fixture."""
import numpy as np
import pytest
import torch

from youtube_vln_tpu.config import RunConfig as JaxRunConfig
from youtube_vln_tpu.data import datasets as jds
from youtube_vln_tpu.data import features_reader as jfr
from youtube_vln_tpu.data import fixtures as jfix
from youtube_vln_tpu.data import loader as jloader
from youtube_vln_tpu.data import store as jstore
from youtube_vln_tpu.data import tokenizer as jtok
from youtube_vln_tpu_torch.config import RunConfig
from youtube_vln_tpu_torch.data import datasets as pds
from youtube_vln_tpu_torch.data import features_reader as pfr
from youtube_vln_tpu_torch.data import fixtures as pfix
from youtube_vln_tpu_torch.data import loader as ploader
from youtube_vln_tpu_torch.data import store as pstore
from youtube_vln_tpu_torch.data import tokenizer as ptok
from youtube_vln_tpu_torch.parallel.train_step import expand_beam_steps

JAX = dict(ds=jds, fr=jfr, fix=jfix, loader=jloader, tok=jtok, args=JaxRunConfig)
PORT = dict(ds=pds, fr=pfr, fix=pfix, loader=ploader, tok=ptok, args=RunConfig)
FIXTURE = dict(n_viewpoints=9, n_beams=6, path_len=5, seed=2)
# eval transports: (dedup_beam_steps, io_dtype); dense f16 is the fast path
# (_packed_paths_f16), dedup f32 assembles each unique block on its own
TRANSPORTS = {"dense_f32": (False, "float32"), "dense_f16_fast": (False, "float16"),
              "dedup_f16": (True, "float16"), "dedup_f32": (True, "float32")}


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    return {name: pkg["fix"].build_r2r_fixture(
                tmp_path_factory.mktemp(f"r2r_{name}"), **FIXTURE)
            for name, pkg in (("jax", JAX), ("port", PORT))}


def _dataset(pkg, paths, split, *, training, shuffle_visual=False,
             masked=False, **kw):
    base = dict(pretrain=False, ranking=True, batch_size=1,
                max_instruction_length=32, max_path_length=4, max_num_boxes=5,
                num_negatives=2, num_beams=4, num_beams_train=4)
    base.update(kw)
    args = pkg["args"](**base)
    reader = pkg["fr"].PanoFeaturesReader(paths["store_path"])
    root = paths["data_dir"]
    ds = pkg["ds"].BeamDataset(
        args, f"{root}/task/R2R_{split}.json",
        f"{root}/beamsearch/beams_{split}.json",
        pkg["tok"].load_tokenizer(paths["vocab_path"]), reader,
        num_beams=args.num_beams_train if training else args.num_beams,
        num_beams_strict=False, training=training, masked_vision=masked,
        masked_language=masked, shuffle_visual_features=shuffle_visual,
        data_dir=root, seed=0)
    return ds, reader


def _pair(fixtures, split, **kw):
    return (_dataset(JAX, fixtures["jax"], split, **kw),
            _dataset(PORT, fixtures["port"], split, **kw))


def _assert_items_equal(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (what, k, x.dtype, y.dtype)
        assert x.shape == y.shape and np.array_equal(x, y), (what, k)


def _no_native(monkeypatch):
    for mod in (jstore, pstore):
        monkeypatch.setattr(mod, "_NATIVE", None)
        monkeypatch.setattr(mod, "_NATIVE_TRIED", True)


def _compare(pair, seeds_of):
    (jd, jr), (pd_, pr) = pair
    try:
        assert len(jd) == len(pd_) > 0
        assert jd.num_candidates() == pd_.num_candidates()
        assert jd.max_beam_count() == pd_.max_beam_count()
        assert jd.step_dedup == pd_.step_dedup
        items = []
        for i in range(len(jd)):
            for seed in seeds_of(i):
                jd.reseed(seed)
                pd_.reseed(seed)
                want, got = jd[i], pd_[i]
                _assert_items_equal(want, got, (i, seed))
                items.append(got)
        return items
    finally:
        jr.close()
        pr.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
def test_eval_items_equal(fixtures, monkeypatch, transport, native):
    if not native:
        _no_native(monkeypatch)
    elif pstore.get_native() is None:
        pytest.fail("the native store library did not build")
    dedup, io_dtype = TRANSPORTS[transport]
    items = _compare(_pair(fixtures, "val_unseen", training=False,
                           dedup_beam_steps=dedup, io_dtype=io_dtype),
                     lambda i: [50 + i])
    assert len(items) == 15
    assert all(("step_index" in it) == dedup for it in items)


@pytest.mark.parametrize("dedup", [False, True], ids=["dense", "dedup"])
def test_eval_items_tiled_and_shuffled_equal(fixtures, dedup):
    """batch_size != 1: every item tiled or trimmed to num_beams; with
    shuffled-visual negatives appended after the successful beams."""
    for kw in (dict(batch_size=2), dict(batch_size=2, num_beams=5),
               dict(batch_size=1, shuffle_visual=True)):
        items = _compare(_pair(fixtures, "val_seen", training=False,
                               dedup_beam_steps=dedup, **kw),
                         lambda i: [70 + i])
        if kw["batch_size"] != 1:
            n = kw.get("num_beams", 4)
            assert all(it["opt_mask"].shape == (n,) for it in items)


def test_dedup_item_expands_to_the_dense_item(fixtures):
    """expand_beam_steps (the port's device-side gather) of a step-dedup
    item equals the dense item, bit for bit, in f16 and f32."""
    for io_dtype in ("float16", "float32"):
        dense_ds, dr = _dataset(PORT, fixtures["port"], "val_unseen",
                                training=False, dedup_beam_steps=False,
                                io_dtype=io_dtype)
        dedup_ds, ddr = _dataset(PORT, fixtures["port"], "val_unseen",
                                 training=False, dedup_beam_steps=True,
                                 io_dtype=io_dtype)
        try:
            n_shared = 0
            for i in range(len(dense_ds)):
                dense, dedup = dense_ds[i], dedup_ds[i]
                idx = dedup["step_index"]
                n_shared += idx.size - len(np.unique(idx))
                batch = {k: torch.from_numpy(np.asarray(v)[None])
                         for k, v in dedup.items() if k != "instr_id"}
                out = expand_beam_steps(batch)
                for k in ("image_features", "image_locations", "image_mask"):
                    got = out[k][0].numpy()
                    assert got.dtype == dense[k].dtype, k
                    assert np.array_equal(got, dense[k]), (i, k)
                for k in ("instr_tokens", "instr_mask", "instr_targets",
                          "segment_ids", "ranking_target", "opt_mask",
                          "instr_id"):
                    assert np.array_equal(dedup[k], dense[k]), k
            assert n_shared > 0   # beams share steps on this fixture
        finally:
            dr.close()
            ddr.close()


@pytest.mark.parametrize("masked", [False, True], ids=["ranking", "mlm_mvm"])
def test_30rs_training_selection_equal(fixtures, masked):
    """Recipe 30RS (--ranking --shuffle_visual_features, num_beams_train 4)
    over 3 epochs of per-item reseeding (the Loader's seeds): the success
    draws, the failure draws and the shuffled negatives take the same
    random.Random and numpy streams."""
    seeds = lambda i: [jloader._item_seed(1, epoch, i) for epoch in range(3)]
    items = _compare(_pair(fixtures, "train", training=True,
                           shuffle_visual=True, masked=masked,
                           masked_vision=masked, masked_language=masked),
                     seeds)
    targets = {int(it["ranking_target"]) for it in items}
    assert targets == {0, -1}          # both selection branches ran
    assert all(it["opt_mask"].shape == (6,) for it in items)


def test_traj_judge_items_cover_every_shuffle_type(fixtures):
    """Judge-only training items (--traj_judge without --ranking): the
    shuffle type is drawn per item; enough seeds hit types 1, 2 and 3
    (type 3 replaces steps per candidate, the documented fix)."""
    (jd, jr), (pd_, pr) = _pair(fixtures, "train", training=True,
                                shuffle_visual=True, ranking=False,
                                traj_judge=True)
    hit = set()
    try:
        assert pd_.traj_judge_only and jd.num_candidates() == pd_.num_candidates() == 3
        for seed in range(12):
            for i in range(len(jd)):
                pd_.reseed(100 * seed + i)
                hit.add(_shuffle_type(pd_, i))
                jd.reseed(100 * seed + i)
                pd_.reseed(100 * seed + i)
                _assert_items_equal(jd[i], pd_[i], (seed, i))
    finally:
        jr.close()
        pr.close()
    assert hit == {1, 2, 3}


def _shuffle_type(ds, i):
    """The shuffle type item ``i`` draws at the dataset's current seed:
    replay the item's random.Random draws up to the type draw."""
    state = ds.rng.getstate()
    np_state = ds.np_rng.bit_generator.state
    seen = []
    real = ds.rng.randint

    def spy(a, b):
        value = real(a, b)
        if (a, b) == (1, 3) and not seen:
            seen.append(value)
        return value

    ds.rng.randint = spy
    try:
        ds[i]
    finally:
        del ds.rng.randint
        ds.rng.setstate(state)
        ds.np_rng.bit_generator.state = np_state
    return seen[0]


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("dedup", [False, True], ids=["dense", "dedup"])
def test_loader_batches_equal(fixtures, num_workers, dedup):
    """test.py's Loader: batch 1, every ranked path, instr_id carried."""
    def batches(pkg, paths):
        ds, reader = _dataset(pkg, paths, "val_unseen", training=False,
                              dedup_beam_steps=dedup, io_dtype="float16")
        try:
            loader = pkg["loader"].Loader(
                ds, batch_size=1, shuffle=False, drop_last=False,
                num_candidates=ds.max_beam_count(), with_instr_id=True,
                num_workers=num_workers)
            return [{k: np.array(v) for k, v in b.items()} for b in loader]
        finally:
            reader.close()

    want = batches(JAX, fixtures["jax"])
    got = batches(PORT, fixtures["port"])
    assert len(got) == len(want) == 15
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_items_equal(g, w, i)
        assert g["instr_id"].shape == (1, 2)
