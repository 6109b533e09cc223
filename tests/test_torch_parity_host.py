"""Direct parity of the port's host functions with the JAX package's, for
the branches that the callers' tests never reach: the shufflers, the
sampling helpers, the trajectory samplers and every negative style
(``data/sampling.py``), the tokenization cache and the instruction
generators (``data/instructions.py``), the tokenizer, the store writer,
the readers' base classes, the cosine schedules' cycle counts
(``training/optimization.py``), ``utils/misc.py``,
``utils/cli.py:args_to_run_config``,
``training/checkpoint.py:is_orbax_checkpoint``, the host prefetch and the
host collectives of one process (``parallel/distributed.py``).

Each case runs the same inputs, built from a seed, through both packages,
each with a ``random.Random`` of the same seed where the function draws,
and requires equal results (exact: host code) and the same number of draws
(the generators' next value after the call).  The index from a JAX name to
its test is ``tests/test_torch_counterparts.py``."""
import copy
import random
import re
import types

import jax
import numpy as np
import pytest
import torch

from youtube_vln_tpu.data import features_reader as jfr
from youtube_vln_tpu.data import fixtures as jfix
from youtube_vln_tpu.data import instructions as jins
from youtube_vln_tpu.data import loader as jloader
from youtube_vln_tpu.data import sampling as jsam
from youtube_vln_tpu.data import store as jstore
from youtube_vln_tpu.data import tokenizer as jtok
from youtube_vln_tpu.parallel import distributed as jdist
from youtube_vln_tpu.training import checkpoint as jckpt
from youtube_vln_tpu.training import optimization as jopt
from youtube_vln_tpu.utils import cli as jcli
from youtube_vln_tpu.utils import misc as jmisc
from youtube_vln_tpu_torch import device as pdevice
from youtube_vln_tpu_torch.data import features_reader as pfr
from youtube_vln_tpu_torch.data import fixtures as pfix
from youtube_vln_tpu_torch.data import instructions as pins
from youtube_vln_tpu_torch.data import sampling as psam
from youtube_vln_tpu_torch.data import store as pstore
from youtube_vln_tpu_torch.data import tokenizer as ptok
from youtube_vln_tpu_torch.parallel import distributed as pdist
from youtube_vln_tpu_torch.training import checkpoint as pckpt
from youtube_vln_tpu_torch.training import optimization as popt
from youtube_vln_tpu_torch.utils import cli as pcli
from youtube_vln_tpu_torch.utils import misc as pmisc


def _both(jax_fn, port_fn, make_args, seed=0):
    """``(jax result, port result)`` of the two functions on fresh copies of
    ``make_args()``'s arguments, each drawing from ``random.Random(seed)``
    passed as ``rng`` (up to 40 items of a generator; an exception is the
    result ``("raised", type, message)``); fatal unless both drew as
    often."""
    out = []
    for fn in (jax_fn, port_fn):
        rng = random.Random(seed)
        args, kwargs = make_args()
        try:
            result = fn(*args, rng=rng, **kwargs)
            if hasattr(result, "__next__"):
                result = [x for _, x in zip(range(40), result)]
        except Exception as e:  # noqa: BLE001 - the raise is compared
            result = ("raised", type(e).__name__, str(e))
        out.append((result, rng.random()))
    (got_jax, next_jax), (got_port, next_port) = out
    assert next_jax == next_port, "the two draw a different number of times"
    return got_jax, got_port


# --------------------------------------------------------------------------- #
# data/sampling.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["different", "two", "nonadj"])
@pytest.mark.parametrize("n", [3, 6, 9])
def test_shufflers_match_jax(name, n):
    """The three shufflers of ``load_shuffler``; n 6 and 9 sit on either
    side of ``shuffle_different``'s exhaustive / lazy switch.  At n 3 the
    non-adjacent shuffler finds no partner for the middle item, and both
    raise."""
    got_jax, got_port = _both(jsam.load_shuffler(name), psam.load_shuffler(name),
                              lambda: ((list(range(10, 10 + n)),), {}), seed=n)
    assert got_jax == got_port
    assert (got_port[0] == "raised") == (name == "nonadj" and n == 3), got_port
    with pytest.raises(ValueError, match="Unexpected shuffling mode"):
        psam.load_shuffler(name + "x")
    with pytest.raises(ValueError, match="Unexpected shuffling mode"):
        jsam.load_shuffler(name + "x")


def _videos(seed, n_videos=4, n_frames=12):
    """``frames_by_video`` of the YTb layout: every third frame captionless,
    merged groups on some frames."""
    rng = np.random.default_rng(seed)
    out = {}
    for v in range(n_videos):
        frames = []
        for f in range(n_frames):
            frame = {"frame_id": int(f * 3 + v),
                     "caption": "" if f % 3 == 2 else f"room {v} with thing {f}"}
            if f % 4 == 1:
                frame["merging"] = [int(f * 3 + v), int(f * 3 + v + 1)]
            frames.append(frame)
        rng.shuffle(frames)
        out[f"vid{v}"] = frames
    return out


def _listings(seed, n_listings=5, n_photos=8):
    """``photos_by_listing`` and ``photo_id_to_caption`` of the BnB layout:
    odd photos captionless (a token sum below 204), a few merged ids."""
    rng = np.random.default_rng(seed)
    photos, captions = {}, {}
    pid = 0
    for l in range(n_listings):
        ids = []
        for p in range(n_photos):
            tokens = ([101, 102] if p % 2 else
                      [101] + rng.integers(200, 900, 4).tolist() + [102])
            captions[pid] = {"instruction_tokens": [tokens]}
            ids.append(pid if p % 5 else (pid,))
            pid += 1
        photos[1000 + l] = ids
    return photos, captions


SAMPLING_HELPERS = {
    "random_fill": lambda: (([0, 2], [1, 3], ["a", "c"], ["b", "d"]), {}),
    "random_caption_image": lambda: ((sorted(_videos(1)), _videos(1)), {}),
    "random_captionless_image": lambda: ((sorted(_videos(2)), _videos(2)), {}),
    "random_image": lambda: ((sorted(_listings(3)[0]), _listings(3)[0]), {}),
}


@pytest.mark.parametrize("name", sorted(SAMPLING_HELPERS))
def test_sampling_helpers_match_jax(name):
    for seed in range(5):
        got_jax, got_port = _both(getattr(jsam, name), getattr(psam, name),
                                  SAMPLING_HELPERS[name], seed=seed)
        assert got_jax == got_port


def test_sampling_pure_helpers_match_jax():
    """``is_captionless`` on an id and a merged tuple, ``merge_images`` /
    ``merge_frames`` (as sets: both build them from a set), ``ytb_key`` and
    ``drop_small_listings``."""
    photos, captions = _listings(4)
    for pid in [0, 1, (0, 1), (1, 3), (1,)]:
        assert jsam.is_captionless(pid, captions) == psam.is_captionless(pid, captions)
    assert psam.is_captionless((1, 3), captions) and not psam.is_captionless(0, captions)
    items = [{"photo_id": 1}, {"photo_id": 2, "merging": [2]},
             {"photo_id": 3, "merging": [3, 4]}, {"photo_id": 5, "frame_id": 5}]
    frames = [{"frame_id": 1}, {"frame_id": 2, "merging": [2, 7]}, {"frame_id": 9}]
    assert set(jsam.merge_images(items)) == set(psam.merge_images(items)) == {1, 2, (3, 4), 5}
    assert set(jsam.merge_frames(frames)) == set(psam.merge_frames(frames))
    assert jsam.ytb_key("abc", 7) == psam.ytb_key("abc", 7) == "abc/0007"
    sizes = {1: [1, 2, 3], 2: [1], 3: [1, 2, 3, 4]}
    assert jsam.drop_small_listings(sizes, 3) == psam.drop_small_listings(sizes, 3)


def _ytb_key_trajectory(frames, video_id, n):
    ids = sorted(f["frame_id"] for f in frames[video_id] if f["caption"])
    return ids[:n]


TRAJECTORIES = {
    # a window around the key frames
    "ytb": lambda: (("vid1", _videos(5), _ytb_key_trajectory(_videos(5), "vid1", 6)),
                    dict(min_length=4, max_length=7, min_captioned=2, max_captioned=5)),
    # two adjacent key frames: the span is topped up with random frames
    "ytb_short_span": lambda: (("vid2", _videos(5), _ytb_key_trajectory(_videos(5), "vid2", 2)),
                               dict(min_length=5)),
    "bnb_in_listing": lambda: ((1002, _listings(6)[0], _listings(6)[1]), {}),
    "bnb_out_listing": lambda: ((1002, sorted(_listings(6)[0]), _listings(6)[0],
                                 _listings(6)[1]), {}),
}
TRAJECTORY_FN = {"ytb": "ytb_trajectory", "ytb_short_span": "ytb_trajectory",
                 "bnb_in_listing": "bnb_trajectory_in_listing",
                 "bnb_out_listing": "bnb_trajectory_out_listing"}


@pytest.mark.parametrize("case", sorted(TRAJECTORIES))
def test_trajectory_samplers_match_jax(case):
    name = TRAJECTORY_FN[case]
    for seed in range(4):
        got_jax, got_port = _both(getattr(jsam, name), getattr(psam, name),
                                  TRAJECTORIES[case], seed=seed)
        assert got_jax == got_port


def _negatives_args(dataset, traj_judge, style):
    """A positive path of either dataset and the arguments of
    ``generate_negatives``."""
    if dataset == "ytb":
        frames = _videos(7, n_frames=16)
        key = _ytb_key_trajectory(frames, "vid0", 5)
        path, states = jsam.ytb_trajectory("vid0", frames, key, rng=random.Random(1))
        rooms, by_room, captions = sorted(frames), frames, {}
    else:
        by_room, captions = _listings(8)
        path, states = jsam.bnb_trajectory_in_listing(1001, by_room, captions,
                                                      rng=random.Random(1))
        rooms = sorted(by_room)

    def make():
        return ((copy.deepcopy(path), list(states), rooms, copy.deepcopy(by_room),
                 captions, 3, jsam.shuffle_two, dataset, traj_judge, style), {})
    return make, states


NEGATIVE_CASES = ([("ytb", judge, style) for judge in (False, True)
                   for style in ("normal", "shuffle_instruction", "another_path",
                                 "another_destination")]
                  + [("bnb", judge, style) for judge in (False, True)
                     for style in ("normal", "shuffle_instruction")])


@pytest.mark.parametrize("dataset,traj_judge,style", NEGATIVE_CASES)
def test_generate_negatives_match_jax(dataset, traj_judge, style):
    """Every negative style of both datasets, with and without the
    trajectory-judge variant; the port's shuffler is its own copy."""
    make, states = _negatives_args(dataset, traj_judge, style)
    assert not all(states), "the judge variant needs a captionless frame"

    def port_make():
        args, kwargs = make()
        return (args[:6] + (psam.shuffle_two,) + args[7:]), kwargs
    for seed in range(3):
        outs = []
        for fn, mk in ((jsam.generate_negatives, make),
                       (psam.generate_negatives, port_make)):
            rng = random.Random(seed)
            args, kwargs = mk()
            outs.append((fn(*args, rng=rng, **kwargs), rng.random()))
        assert outs[0] == outs[1]


def test_judge_negatives_refuse_a_fully_captioned_path():
    path = [("vid0", (0,)), ("vid0", (3,)), ("vid0", (6,))]
    for sam in (jsam, psam):
        with pytest.raises(ValueError, match="CAPTIONLESS"):
            sam.generate_negatives(path, [True] * 3, ["vid0"], _videos(0), {}, 2,
                                   sam.shuffle_two, "ytb", True, "normal",
                                   rng=random.Random(0))


# --------------------------------------------------------------------------- #
# data/tokenizer.py, data/instructions.py
# --------------------------------------------------------------------------- #
TEXTS = ["Walk into the Living-room, with a sofa!", "turn LEFT at the kitchen.",
         "go past the bathroom with sink then wait", "unknownword [MASK] bedroom",
         "Café  naïve\tpiano中文 , ok?", ""]
WORDS = ["[PAD]", "[CLS]", "[SEP]", "[MASK]", "[UNK]", "walk", "into", "the",
         "living", "-", "room", "with", "a", "so", "##fa", "!", "turn", "left",
         "at", "kitchen", ".", "go", "past", "bath", "##room", "sink", "then",
         "wait", "bed", "cafe", "naive", "piano", "中", ",", "ok", "?"]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """Both packages' tokenizers over one vocabulary that each package's
    ``write_vocab`` wrote (the files must be equal)."""
    root = tmp_path_factory.mktemp("vocab")
    jtok.write_vocab(WORDS, root / "jax.txt")
    ptok.write_vocab(WORDS, root / "port.txt")
    assert (root / "jax.txt").read_bytes() == (root / "port.txt").read_bytes()
    return {case: (jtok.WordPieceTokenizer.from_vocab_file(root / "jax.txt", do_lower_case=lower),
                   ptok.WordPieceTokenizer.from_vocab_file(root / "port.txt", do_lower_case=lower))
            for case, lower in (("lower", True), ("cased", False))}


@pytest.mark.parametrize("case", ["lower", "cased"])
def test_wordpiece_tokenizer_matches_jax(tokenizers, case):
    """Punctuation splits, accents stripped, CJK characters, unknown words,
    the special tokens kept whole; with and without lower-casing."""
    jt, pt = tokenizers[case]
    assert len(jt) == len(pt)
    for text in TEXTS:
        assert jt.tokenize(text) == pt.tokenize(text), text
        assert jt.encode(text) == pt.encode(text), text
    assert jt.convert_tokens_to_ids("[MASK]") == pt.convert_tokens_to_ids("[MASK]")


def test_framing_highlights_and_token_caches_match_jax(tokenizers, tmp_path):
    """``frame_tokens`` (truncated and padded), ``highlight_mask`` (a word
    that is absent is skipped), ``tokenize_dataset`` with every optional
    field, ``load_tokens`` / ``ytb_load_tokens`` writing their caches and
    reading them back, ``save_json`` / ``load_json``."""
    jt, pt = tokenizers["lower"]
    for text in TEXTS:
        for max_len in (4, 16):
            assert jins.frame_tokens(jt, text, max_len) == pins.frame_tokens(pt, text, max_len)
    row = jins.frame_tokens(jt, TEXTS[0], 16)
    words = ["living", "absent", "sofa", "!"]
    assert jins.highlight_mask(jt, words, row, 16) == pins.highlight_mask(pt, words, row, 16)
    items = [{"instructions": TEXTS[:2], "highlights": [["walk"], ["kitchen", "x"]],
              "perturbations": [[TEXTS[2]], [TEXTS[3], TEXTS[0]]],
              "perturbation_highlights": [[["past"]], [["bed"], ["sofa"]]]},
             {"instructions": [TEXTS[4]]}]
    got = {}
    for name, ins, tok in (("jax", jins, jt), ("port", pins, pt)):
        data = copy.deepcopy(items)
        ins.tokenize_dataset(data, tok, 12)
        d = tmp_path / name
        d.mkdir()
        ins.save_json(items, d / "r2r.json")
        loaded = ins.load_tokens(d / "r2r.json", tok, 12)
        again = ins.load_tokens(d / "r2r.json", tok, 12)   # from the cache
        ytb = ins.ytb_load_tokens(d / "r2r.json", tok)
        got[name] = (data, loaded, again, ytb, ins.load_json(d / "r2r_tokenized_12.json"),
                     sorted(p.name for p in d.iterdir()))
    assert got["jax"] == got["port"]
    assert got["port"][0] == got["port"][1] == got["port"][2]


TEMPLATES = [{"instructions": [t]} for t in (
    "walk into the [MASK] .", "go past [MASK] and turn [OMASK] at [MASK] .",
    "turn [OMASK] , walk to [MASK] then [OMASK] to [MASK] .",
    "Turn [OMASK] then wait .", "go [OMASK] and [OMASK] .",
    "walk past [MASK] , [MASK] and [MASK] , turn [OMASK] .")]
FILL_CASES = {
    "mask_only": (["kitchen with sink"], []),
    "mask_and_omask": (["kitchen with sink", "bedroom with bed"], [["left"]]),
    "more_captions": (["hall with lamp", "kitchen with sink", "bathroom with sink"],
                      [["forward"]]),
    "omask_only": ([], [["forward"], ["right"]]),
    "around": (["kitchen with sink", "bedroom with bed"], [["around"]]),
    "no_template": (["a with b"] * 4, [["left"]]),
}


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_fill_template_matches_jax(case):
    """``index_templates`` and every branch of ``fill_template``: [MASK]
    alone, [MASK] and [OMASK], more captions than directions, [OMASK]
    alone, the 'around' direction, and no template of that signature."""
    captions, directions = FILL_CASES[case]
    assert jins.index_templates(TEMPLATES) == pins.index_templates(TEMPLATES)
    for seed in range(4):
        got_jax, got_port = _both(
            jins.fill_template, pins.fill_template,
            lambda: ((list(captions), [list(d) for d in directions], TEMPLATES)
                     + jins.index_templates(TEMPLATES), {}), seed=seed)
        assert got_jax == got_port
        assert (got_port is None) == (case == "no_template")


@pytest.fixture(scope="module")
def caption_data(tmp_path_factory):
    """Each package's YTb and BnB fixtures (byte-equal files,
    ``tests/test_torch_data.py``)."""
    out = {}
    for name, fix in (("jax", jfix), ("port", pfix)):
        root = tmp_path_factory.mktemp(f"captions_{name}")
        out[name] = dict(ytb=fix.build_ytb_fixture(root / "ytb", seed=4),
                         bnb=fix.build_bnb_fixture(root / "bnb", seed=4))
    return out


def _generator_runs(pkg, ins, tok_mod, sam, paths, kind):
    """Ten instructions of one generator kind over the fixture's captions."""
    rng = random.Random(11)
    if kind == "ytb_rephrase":
        p = paths["ytb"]
        tok = tok_mod.WordPieceTokenizer.from_vocab_file(p["vocab_path"])
        frames = ins.load_json(p["caption_path"])
        captions = {sam.ytb_key(f["video_id"], f["frame_id"]): f for f in frames}
        by_video = {}
        for f in frames:
            by_video.setdefault(f["video_id"], []).append(f)
        gen = ins.YTBRephraseInstructionGenerator(
            p["skeleton_path"], False, tok, [], captions, 60, rng=rng)
        out = []
        for vid in sorted(by_video)[:5]:
            caped = sorted(f["frame_id"] for f in by_video[vid] if f["caption"])
            traj = [(vid, (fid,)) for fid in caped[:3]]
            out.append(gen(traj))
        gen.random_action = True
        out.append(gen([(vid, (fid,)) for fid in caped[:2]]))
        return out
    p = paths["bnb"]
    tok = tok_mod.WordPieceTokenizer.from_vocab_file(p["vocab_path"])
    items = ins.load_tokens(p["caption_path"], tok, 60)
    captions = {it["photo_id"]: it for it in items}
    photos = {}
    for it in items:
        photos.setdefault(it["listing_id"], []).append(it["photo_id"])
    # a merged photo: weights over its members, one of them captionless
    captions[0] = dict(captions[0], merging=[0, 1, 2], weights=[0.2, 0.5, 0.3])
    if kind == "concatenate":
        gen = ins.ConcatenateInstructionGenerator(tok, [",", "."], captions, 12, rng=rng)
    else:
        skeletons = [{"instructions": ["walk past the room then the room ."],
                      "np": [[0, 0, 0, 1, 0, 0, 1, 0]]},
                     {"instructions": ["go to the room ."], "np": [[0, 0, 0, 1, 0]]},
                     {"instructions": ["the room , the room and the room"],
                      "np": [[0, 1, 0, 0, 1, 0, 0, 1]]}]
        skel = p["caption_path"].replace("bnb_train", "skeletons")
        ins.save_json(skeletons, skel)
        gen = ins.RephraseInstructionGenerator(skel, tok, [], captions, 24, rng=rng)
    out = []
    for lid in sorted(photos):
        ids = photos[lid]
        out.append(gen([(lid, (0, 1)) if kind == "concatenate" and lid == min(photos)
                        else (lid, ids[0])] + [(lid, i) for i in ids[1:6]]))
    return out


@pytest.mark.parametrize("kind", ["concatenate", "rephrase", "ytb_rephrase"])
def test_instruction_generators_match_jax(caption_data, kind):
    """The three generators (and their base class's caption choice for a
    merged photo) with seeded generators: the same token rows."""
    got = {name: _generator_runs(name, ins, tok, sam, caption_data[name], kind)
           for name, ins, tok, sam in (("jax", jins, jtok, jsam),
                                       ("port", pins, ptok, psam))}
    assert got["jax"] == got["port"] and got["port"]
    assert issubclass(pins.ConcatenateInstructionGenerator, pins.InstructionGenerator)


# --------------------------------------------------------------------------- #
# data/store.py, data/features_reader.py, data/fixtures.py
# --------------------------------------------------------------------------- #
def _records(mod, seed):
    """Region records of 2-4 boxes and one panorama record."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        k = 2 + i
        pano = {} if i < 3 else dict(
            view_heading=rng.random(36).astype(np.float32),
            view_elevation=rng.random(36).astype(np.float32),
            feat_heading=rng.random(k).astype(np.float32),
            feat_elevation=rng.random(k).astype(np.float32),
            feat_view_index=rng.integers(0, 36, k).astype(np.float32))
        out.append((f"key{i}", mod.StoreRecord(
            num_boxes=k, image_w=640, image_h=480,
            features=rng.normal(size=(k, 2048)).astype(np.float32),
            boxes=rng.random((k, 4)).astype(np.float32),
            cls_prob=rng.random((k, 1601)).astype(np.float32), **pano)))
    return out


def test_store_writer_writes_the_jax_bytes(tmp_path):
    """``StoreWriter`` over region and panorama ``StoreRecord``s: the same
    file, read back equal; a duplicate key refused by both."""
    for name, mod in (("jax", jstore), ("port", pstore)):
        with mod.StoreWriter(tmp_path / f"{name}.vlnstore") as w:
            for key, rec in _records(mod, 0):
                w.add(key, rec)
            with pytest.raises(ValueError, match="duplicate store key"):
                w.add("key0", rec)
    assert (tmp_path / "jax.vlnstore").read_bytes() == (tmp_path / "port.vlnstore").read_bytes()
    store = pstore.Store(tmp_path / "port.vlnstore")
    for key, rec in _records(pstore, 0):
        got = store.get(key)
        np.testing.assert_array_equal(got.features, rec.features)
        assert got.is_pano == rec.is_pano
    store.close()


def test_fixture_vocab_and_reader_bases_match_jax(caption_data):
    """``fixture_vocab``, and the readers' base classes over the BnB store:
    ``FeaturesReader`` keys and ``RegionFeaturesReader`` rows of merged
    keys (``BnBFeaturesReader``)."""
    assert jfix.fixture_vocab() == pfix.fixture_vocab()
    readers = [mod.BnBFeaturesReader(caption_data[name]["bnb"]["store_path"])
               for name, mod in (("jax", jfr), ("port", pfr))]
    assert isinstance(readers[1], pfr.RegionFeaturesReader)
    assert isinstance(readers[1], pfr.FeaturesReader)
    keys = sorted(readers[0].keys)
    assert keys == sorted(readers[1].keys) and len(readers[0]) == len(readers[1])
    for query in [(keys[0],), (keys[1], keys[2]), (keys[3], keys[4], keys[5])]:
        for a, b in zip(readers[0][query], readers[1][query]):
            np.testing.assert_array_equal(a, b)
    for r in readers:
        r.close()


# --------------------------------------------------------------------------- #
# training/optimization.py, utils/misc.py, utils/cli.py, the rest
# --------------------------------------------------------------------------- #
COSINE = ("warmup_cosine_schedule", "warmup_cosine_hard_restarts_schedule")


@pytest.mark.parametrize("name", COSINE)
@pytest.mark.parametrize("cycles", [0.25, 3.0])
def test_cosine_schedules_over_other_cycle_counts_match_jax(name, cycles):
    """The cosine schedules at cycle counts other than their defaults (a
    quarter cycle, and three: the hard restarts' wrap), at the warmup's
    edges, inside and past the last step; the defaults are
    ``tests/test_torch_optimization.py``'s."""
    jfn = getattr(jopt, name)(3e-4, 10, 100, cycles=cycles)
    pfn = getattr(popt, name)(3e-4, 10, 100, cycles=cycles)
    # the JAX schedules compute in f32: 1e-6 of the base rate
    for step in [0, 1, 9, 10, 11, 37, 43, 50, 76, 99, 100, 101, 150]:
        np.testing.assert_allclose(float(pfn(step)), float(jfn(step)), rtol=0,
                                   atol=1e-6 * 3e-4, err_msg=f"{name} at {step}")


def test_misc_helpers_match_jax(tmp_path, monkeypatch):
    """``set_seed`` leaves both generators in the same state, ``get_logger``
    writes the same lines to its file and adds one handler however often it
    is called, ``get_output_dir`` numbers a dotted run name the same and
    ``git_revision`` gives the same answer."""
    for process in (0, 3):
        jmisc.set_seed(5, process)
        want = (random.random(), np.random.random())
        pmisc.set_seed(5, process)
        assert (random.random(), np.random.random()) == want
    for name, mod in (("jax", jmisc), ("port", pmisc)):
        path = str(tmp_path / f"{name}.log")
        # a second call with the same file adds no second handler
        log = mod.get_logger(f"parity_{name}", path)
        assert mod.get_logger(f"parity_{name}", path) is log
        log.warning("one line")
        for h in log.handlers:
            h.flush()
        assert len(log.handlers) == 1
        log.removeHandler(log.handlers[0])
    assert (tmp_path / "jax.log").read_text() == (tmp_path / "port.log").read_text() == "one line\n"
    # the run directory's number, apart from its time stamp
    stamp = re.compile(r"_\d{4}-\d\d-\d\d_\d\d:\d\d:\d\d_")
    for sep in ("/train", "/test"):
        args = types.SimpleNamespace(output_dir=str(tmp_path / "out"), save_name="run.v2",
                                     note="n")
        (tmp_path / "out" / f"run.v2{sep.strip('/')}").mkdir(parents=True, exist_ok=True)
        got = [stamp.sub("_", str(m.get_output_dir(args, sep))) for m in (jmisc, pmisc)]
        assert got[0] == got[1]
    monkeypatch.chdir(tmp_path)
    assert jmisc.git_revision() == pmisc.git_revision()


CLI_FLAGS = [["--ranking"], ["--pretrain", "False", "--ranking", "--traj_judge",
                             "--shuffle_visual_features", "--batch_size", "8"],
             ["--masked_vision", "--masked_language", "--mesh_shape", "2", "4",
              "--gradient_accumulation_steps", "2", "--learning_rate", "2e-5"]]


@pytest.mark.parametrize("flags", range(len(CLI_FLAGS)))
def test_args_to_run_config_matches_jax(flags):
    """The fields that both ``RunConfig``s share, from the same flags."""
    argv = CLI_FLAGS[flags]
    jns = jcli.get_parser().parse_args(argv)
    pns = pcli.get_parser().parse_args(argv)
    jargs, pargs = jcli.args_to_run_config(jns), pcli.args_to_run_config(pns)
    shared = set(vars(jargs)) & set(vars(pargs))
    assert len(shared) > 50
    assert {k: getattr(jargs, k) for k in shared} == {k: getattr(pargs, k) for k in shared}


def test_is_orbax_checkpoint_matches_jax(tmp_path):
    """A file, a plain directory, an orbax-style directory (a
    ``_CHECKPOINT_METADATA`` or ``checkpoint`` entry) and a missing path."""
    (tmp_path / "a.bin").write_bytes(b"x")
    (tmp_path / "plain").mkdir()
    for marker in ("_CHECKPOINT_METADATA", "checkpoint", "_METADATA"):
        d = tmp_path / f"orbax_{marker}"
        d.mkdir()
        (d / marker).write_text("{}")
    paths = [tmp_path / "a.bin", tmp_path / "plain", tmp_path / "missing",
             *sorted(tmp_path.glob("orbax_*"))]
    got = [pckpt.is_orbax_checkpoint(p) for p in paths]
    assert got == [jckpt.is_orbax_checkpoint(p) for p in paths]
    assert any(got)


@pytest.mark.parametrize("size", [0, 1, 2])
def test_host_prefetch_yields_the_jax_batches(size):
    """``device_prefetch`` of the JAX loader and the port's
    ``prefetch_to_device`` on the CPU: the same batches in the same order,
    an empty iterator included."""
    batches = [{"x": np.arange(6, dtype=np.float32).reshape(2, 3) + i,
                "ids": np.array([i, i + 1], np.int32)} for i in range(4)]
    n = 0 if size == 0 else len(batches)
    want = list(jloader.device_prefetch(iter(batches[:n]), depth=max(size, 1)))
    got = list(pdevice.prefetch_to_device(iter(batches[:n]), torch.device("cpu"),
                                          max(size, 1)))
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


LAUNCHER_VARIABLES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS",
                      "NODE_RANK", "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS",
                      "TPU_WORKER_HOSTNAMES")


def test_single_process_collectives_match_jax(monkeypatch):
    """Without launcher variables both ``initialize`` calls leave one
    process: the main one of a world of 1, whose host mean and broadcast
    return their input."""
    for key in LAUNCHER_VARIABLES:
        monkeypatch.delenv(key, raising=False)
    jax.devices()
    jdist.initialize()
    pdist.initialize("cpu")
    assert not torch.distributed.is_initialized()
    assert ((jdist.is_main_process(), jdist.world_size())
            == (pdist.is_main_process(), pdist.world_size()) == (True, 1))
    assert jdist.all_reduce_mean_host(2.5) == pdist.all_reduce_mean_host(2.5) == 2.5
    value = {"best": [0.5, 3], "name": "run"}
    assert jdist.broadcast_host(value) == pdist.broadcast_host(value) == value
