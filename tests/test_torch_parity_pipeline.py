"""Direct parity of the offline pipeline's host steps with the JAX
package's, for the branches the chain's tests never reach: the frame
filters and their smoothing at the edges (``pipeline/filters.py``), the
photo-path caches, box orientation and the redundancy filter
(``pipeline/extraction.py``), the Mask R-CNN box ops and NMS at ties and on
empty input (``pipeline/maskrcnn.py``), CLIP's prompt tokenization,
checkpoint loading and frame encoding (``pipeline/clip_model.py``), the
zero-shot captions, ``build_dataset``'s readers and split, the detector's
store writer, the frame lists, the inverse head's image pairs and every
merge method of ``merge_photos``.

The same inputs, built from a seed, go through both packages: host code
must agree exactly (files byte for byte), features of the f32 models within
1e-4 of the largest value.  The index from a JAX name to its test is
``tests/test_torch_counterparts.py``."""
import json

import jax
import numpy as np
import pytest
import torch

from youtube_vln_tpu.pipeline import build_dataset as JB
from youtube_vln_tpu.pipeline import clip_captions as JCC
from youtube_vln_tpu.pipeline import clip_model as JC
from youtube_vln_tpu.pipeline import detector as JD
from youtube_vln_tpu.pipeline import extraction as JE
from youtube_vln_tpu.pipeline import filters as JF
from youtube_vln_tpu.pipeline import frames as JFR
from youtube_vln_tpu.pipeline import inverse_action as JI
from youtube_vln_tpu.pipeline import maskrcnn as JM
from youtube_vln_tpu.pipeline import merge_photos as JMP
from youtube_vln_tpu.pipeline import places365 as JP
from youtube_vln_tpu_torch.pipeline import build_dataset as PB
from youtube_vln_tpu_torch.pipeline import clip_captions as PCC
from youtube_vln_tpu_torch.pipeline import clip_model as PC
from youtube_vln_tpu_torch.pipeline import detector as PD
from youtube_vln_tpu_torch.pipeline import extraction as PE
from youtube_vln_tpu_torch.pipeline import filters as PF
from youtube_vln_tpu_torch.pipeline import frames as PFR
from youtube_vln_tpu_torch.pipeline import inverse_action as PI
from youtube_vln_tpu_torch.pipeline import maskrcnn as PM
from youtube_vln_tpu_torch.pipeline import merge_photos as PMP
from youtube_vln_tpu_torch.pipeline import places365 as PP

CPU = "cpu"


def close(got, want, tol):
    """Max error within ``tol`` of the largest value (floored at 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


# --------------------------------------------------------------------------- #
# pipeline/filters.py
# --------------------------------------------------------------------------- #
def test_frame_filters_match_jax(tmp_path):
    """``indoor_filter`` at its strict 0.5 boundary, ``person_filter``,
    ``indoor_probability`` over top-k, the Mask R-CNN artifact written as
    JSON and read from JSON and ``.npy``, and every reason of
    ``frame_passes`` to drop a frame."""
    rng = np.random.default_rng(0)
    frames = list(range(12))
    scores = [0.5, 0.49, 0.51, 1.0, 0.0] + rng.random(7).tolist()
    for fn in ("indoor_filter", "person_filter"):
        assert getattr(JF, fn)(frames, scores) == getattr(PF, fn)(frames, scores)
    assert 0 not in PF.indoor_filter(frames, scores) and 0 in PF.person_filter(frames, scores)
    for top_k in (1, 10, 400):
        probs = rng.dirichlet(np.ones(365))
        io = rng.integers(0, 2, 365)
        assert JF.indoor_probability(probs, io, top_k) == PF.indoor_probability(probs, io, top_k)
    paths = [m.write_maskrcnn_filters(tmp_path / name, "vid", [1, 2, 3, 5], [3])
             for name, m in (("jax", JF), ("port", PF))]
    assert paths[0].read_bytes() == paths[1].read_bytes()
    npy = tmp_path / "filters.npy"
    np.save(npy, np.array(json.loads(paths[0].read_text()), dtype=object))
    for path in (paths[0], npy):
        assert JF.load_maskrcnn_filters(path) == PF.load_maskrcnn_filters(path)
    mask = PF.load_maskrcnn_filters(paths[1])
    cases = [dict(indoor_resnet=[1, 2, 3], maskrcnn=mask, caption="kitchen with sink"),
             dict(indoor_resnet=None, maskrcnn=None, caption=""),
             dict(indoor_resnet=None, maskrcnn=mask, caption="hall with person"),
             dict(indoor_resnet=[5], maskrcnn=None, caption="hall with lamp")]
    decisions = []
    for kw in cases:
        for fid in (1, 3, 4, 5):
            want = JF.frame_passes(fid, **kw)
            assert PF.frame_passes(fid, **kw) == want
            decisions.append(want)
    assert any(decisions) and not all(decisions)


@pytest.mark.parametrize("n", [0, 3, 7, 40])
def test_smoothing_matches_jax(n):
    """``gaussian_smooth_round`` and ``smooth_window_round`` on sequences
    shorter than, equal to and longer than the window, at round-half ties
    (0.5 means) too."""
    rng = np.random.default_rng(n)
    values = rng.random(n)
    flags = (rng.random(n) < 0.5).astype(np.float64)
    for sigma in (1.0, 6.0):
        if n:
            np.testing.assert_array_equal(PF.gaussian_smooth_round(values, sigma),
                                          JF.gaussian_smooth_round(values, sigma))
    for window in (2, 6):
        np.testing.assert_array_equal(PF.smooth_window_round(flags, window),
                                      JF.smooth_window_round(flags, window))


# --------------------------------------------------------------------------- #
# pipeline/extraction.py, pipeline/detector.py
# --------------------------------------------------------------------------- #
def _frames_tree(root, n_videos=2, n_frames=3, seed=0):
    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        d = root / f"vid{v}"
        d.mkdir(parents=True)
        for f in range(n_frames):
            with open(d / ("%04d.jpg" % f), "wb") as fh:
                np.save(fh, rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))


def _load(path):
    """The test's image loader: frames are ``np.save`` files named .jpg; a
    file named 0002 of vid1 stands for an unreadable frame."""
    if path.parent.name == "vid1" and path.stem == "0002":
        raise OSError("unreadable")
    with open(path, "rb") as f:
        return np.load(f)


def test_photo_path_caches_match_jax(tmp_path):
    """All photos, the ones a TSV shard already holds, and the pending rest,
    each written to its cache file and read back from it."""
    frames = tmp_path / "frames"
    _frames_tree(frames)
    tsv = tmp_path / "done.tsv"
    tsv.write_text("vid0\t0001\t\n" + "vid1\t0000\t\n")
    got = {}
    for name, mod in (("jax", JE), ("port", PE)):
        cache = tmp_path / f"cache_{name}"
        runs = [mod.load_all_photo_paths(frames, cache),
                mod.load_finished_photo_paths([tsv], frames, cache),
                mod.load_pending_photo_paths([tsv], frames, cache),
                mod.load_pending_photo_paths([], frames, cache)]   # from the cache
        got[name] = (runs, sorted((p.name, p.read_text()) for p in cache.iterdir()))
    assert got["jax"] == got["port"]
    assert len(got["port"][0][2]) == 4


def test_box_orientation_and_redundancy_filter_match_jax():
    """Headings on both sides of the image centre (the wrap past pi),
    elevations, and the redundancy filter with 0 boxes, at most
    ``max_boxes`` and above it, with equal class scores (the tie keeps the
    first of a pair)."""
    rng = np.random.default_rng(1)
    boxes = np.concatenate([rng.uniform(0, 600, (30, 2)), rng.uniform(0, 600, (30, 2))], 1)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
    for foc in (300.0, 1e-3):
        for a, b in zip(JE.compute_box_orientation(boxes, 600, 600, foc),
                        PE.compute_box_orientation(boxes, 600, 600, foc)):
            np.testing.assert_array_equal(a, b)
    for k, max_boxes in ((0, 5), (4, 5), (30, 10), (30, 29)):
        heading, elevation = JE.compute_box_orientation(boxes[:k], 600, 600)
        probs = rng.random((k, 6)).astype(np.float32)
        probs[1::2, 1:] = probs[0::2, 1:][: len(probs[1::2])]
        record = dict(features=rng.normal(size=(k, 16)).astype(np.float32),
                      boxes=boxes[:k].astype(np.float32), cls_prob=probs,
                      featureHeading=heading, featureElevation=elevation,
                      featureViewIndex=np.zeros((k, 1), np.float32), note="kept")
        got = [dict(record), dict(record)]
        JE.redundancy_filter(got[0], max_boxes)
        PE.redundancy_filter(got[1], max_boxes)
        assert got[0].keys() == got[1].keys()
        for key in got[0]:
            np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
        assert len(got[1]["features"]) == min(k, max_boxes)


def test_records_shards_and_stores_match_jax(tmp_path):
    """``make_record`` on a 720p-shaped frame, ``build_shard``'s TSV over an
    interleaved slice with an unreadable frame skipped, and
    ``extract_to_store``'s store (``frame_key`` naming the records), each
    through the seeded stand-in detector."""
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (72, 128, 3), dtype=np.uint8)
    det = JD.RandomProposalExtractor(num_boxes=40, seed=3)
    pdet = PD.RandomProposalExtractor(num_boxes=40, seed=3)
    rec = [JE.make_record("v", "0001", image, *det(image), max_boxes=12),
           PE.make_record("v", "0001", image, *pdet(image), max_boxes=12)]
    for key in rec[0]:
        np.testing.assert_array_equal(rec[0][key], rec[1][key], err_msg=key)
    frames = tmp_path / "frames"
    _frames_tree(frames, n_frames=4)
    photos = sorted(str(p) for p in frames.rglob("*.jpg"))
    for name, mod, d in (("jax", JE, det), ("port", PE, pdet)):
        counts = [mod.build_shard(photos, s, 3, tmp_path / name, d, image_loader=_load)
                  for s in range(3)]
        assert sum(counts) == len(photos) - 1
    for s in range(3):
        shard = JE.SHARD_TEMPLATE.format(s)
        assert (tmp_path / "jax" / shard).read_bytes() == (tmp_path / "port" / shard).read_bytes()
    assert JD.frame_key("vid", 7) == PD.frame_key("vid", 7) == "vid/0007"
    for name, mod, d in (("jax", JD, det), ("port", PD, pdet)):
        assert mod.extract_to_store(frames, tmp_path / f"{name}.vlnstore", d,
                                    image_loader=lambda p: np.load(open(p, "rb"))) == 8
    assert (tmp_path / "jax.vlnstore").read_bytes() == (tmp_path / "port.vlnstore").read_bytes()


# --------------------------------------------------------------------------- #
# pipeline/maskrcnn.py: anchors, box coding, NMS
# --------------------------------------------------------------------------- #
def test_anchors_and_box_coding_match_jax():
    """The FPN anchors at a padded size, decoding with a clamped log-size
    delta and class-specific weights, and clipping to the image."""
    for a, b in zip(JM.cell_anchors(), PM.cell_anchors()):
        np.testing.assert_array_equal(a, b)
    feat_hw = [(25, 42), (13, 21), (7, 11), (4, 6), (2, 3)]
    for a, b in zip(JM.grid_anchors(feat_hw, (800, 1344)), PM.grid_anchors(feat_hw, (800, 1344))):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(4)
    boxes = np.sort(rng.uniform(0, 500, (50, 4)).astype(np.float32).reshape(50, 2, 2), 1).reshape(50, 4)
    boxes = boxes[:, [0, 2, 1, 3]]
    deltas = rng.normal(size=(50, 8)).astype(np.float32)
    deltas[0, 2] = deltas[1, 3] = 20.0          # past the log-size clamp
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        np.testing.assert_array_equal(JM.decode_boxes(deltas, boxes, weights),
                                      PM.decode_boxes(deltas, boxes, weights))
    decoded = JM.decode_boxes(deltas, boxes)
    np.testing.assert_array_equal(JM.clip_boxes(decoded, (300, 400)),
                                  PM.clip_boxes(decoded, (300, 400)))


def _nms_inputs(case):
    rng = np.random.default_rng(5)
    if case == "empty":
        return np.zeros((0, 4), np.float32), np.zeros(0, np.float32), np.zeros(0, np.int64)
    boxes = rng.uniform(0, 100, (60, 2)).astype(np.float32)
    boxes = np.concatenate([boxes, boxes + rng.uniform(5, 40, (60, 2)).astype(np.float32)], 1)
    scores = rng.random(60).astype(np.float32)
    if case in ("tied_scores", "duplicates"):
        scores = np.round(scores * 4) / 4          # four score levels
    if case == "duplicates":
        boxes[1::3] = boxes[0::3][: len(boxes[1::3])]
    classes = rng.integers(0, 3, 60)
    return boxes, scores, classes


@pytest.mark.parametrize("case", ["distinct", "tied_scores", "duplicates", "empty"])
def test_nms_keeps_the_jax_order(case):
    """Greedy NMS and its per-class form keep the same boxes in the same
    order, where scores tie (the stable sort keeps the earlier box first),
    where boxes repeat, and on no box at all."""
    boxes, scores, classes = _nms_inputs(case)
    for thresh in (0.3, 0.7):
        if len(boxes):
            np.testing.assert_array_equal(JM.nms(boxes, scores, thresh),
                                          PM.nms(boxes, scores, thresh))
        want = JM.batched_nms(boxes, scores, classes, thresh)
        got = PM.batched_nms(boxes, scores, classes, thresh)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# pipeline/clip_model.py, pipeline/clip_captions.py
# --------------------------------------------------------------------------- #
CLIP_KW = dict(image_size=32, patch_size=8, v_hidden=32, v_layers=2, v_heads=2,
               t_hidden=24, t_layers=2, t_heads=2, vocab_size=50, context_length=16,
               proj_dim=20)


def _bpe_dir(root):
    """A CLIP BPE tokenizer directory of the byte alphabet and a few
    merges (``vocab.json`` + ``merges.txt``)."""
    from transformers.models.clip.tokenization_clip import bytes_to_unicode
    chars = list(bytes_to_unicode().values())
    merges = ["k i", "ki t", "kit c", "kitc h", "kitch e", "kitche n</w>", "r o",
              "ro o", "roo m</w>", "w i", "wi t", "wit h</w>"]
    vocab = {t: i for i, t in enumerate(chars + [c + "</w>" for c in chars]
                                        + ["".join(m.split()) for m in merges]
                                        + ["<|startoftext|>", "<|endoftext|>"])}
    root.mkdir()
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    return root


def test_prompt_tokenization_matches_jax(tmp_path, monkeypatch):
    """``tokenize_prompts`` through a local BPE directory, padded and cut at
    the context length, and the error of both when the assets are absent."""
    pytest.importorskip("transformers")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    d = str(_bpe_dir(tmp_path / "bpe"))
    prompts = ["a kitchen with a room", "Kitchen!!", "", "with " * 20]
    for length in (8, 77):
        want = JC.tokenize_prompts(prompts, d, length)
        np.testing.assert_array_equal(PC.tokenize_prompts(prompts, d, length), want)
        assert want.shape == (4, length) and want.dtype == np.int32
    for mod in (JC, PC):
        with pytest.raises(RuntimeError, match="CLIP tokenizer assets not available"):
            mod.tokenize_prompts(prompts, str(tmp_path / "missing"))


@pytest.mark.parametrize("suffix", [".bin", ".safetensors"])
def test_clip_checkpoint_and_frame_encoding_match_jax(tmp_path, suffix):
    """``load_clip_params`` from a HuggingFace-layout ``.bin`` and
    ``.safetensors`` and ``encode_video_frames`` over batches that do not
    divide the frames: features 1e-4."""
    model = PC.ClipModel(PC.ClipConfig(**CLIP_KW), device=CPU).init_weights(3)
    path = tmp_path / f"clip{suffix}"
    if suffix == ".bin":
        torch.save(model.state_dict(), path)
    else:
        from safetensors.torch import save_file
        save_file({k: v.contiguous() for k, v in model.state_dict().items()}, str(path))
    params = jax.tree_util.tree_map(np.asarray, JC.load_clip_params(str(path)))
    loaded = PC.load_clip_params(path, PC.ClipConfig(**CLIP_KW), device=CPU)
    frames = np.random.default_rng(6).integers(0, 256, (5, 40, 56, 3), dtype=np.uint8)
    want = JC.encode_video_frames(params, JC.ClipConfig(**CLIP_KW), frames, batch_size=2)
    got = PC.encode_video_frames(loaded, frames, batch_size=2, device=CPU)
    close(got, want, 1e-4)


def test_zero_shot_captions_match_jax(tmp_path):
    """Captions by the nearest area and object prompt, the captions_SE
    payload (entropy and similarity) and its file."""
    rng = np.random.default_rng(7)
    frames = rng.normal(size=(9, 16)).astype(np.float32)
    areas = rng.normal(size=(len(JCC.AREAS), 16)).astype(np.float32)
    objects = rng.normal(size=(len(JCC.OBJECTS), 16)).astype(np.float32)
    want = JCC.zero_shot_captions(frames, areas, objects)
    assert PCC.zero_shot_captions(frames, areas, objects) == want
    ids = list(range(3, 12))
    payload = JCC.caption_video_frames(ids, frames, areas, objects)
    got = PCC.caption_video_frames(ids, frames, areas, objects)
    assert got.keys() == payload.keys()
    for k in payload:
        assert got[k][0] == payload[k][0]
        np.testing.assert_allclose(got[k][1]["ShannonEntropy"],
                                   payload[k][1]["ShannonEntropy"], rtol=1e-6)
        np.testing.assert_allclose(got[k][2]["similarity"], payload[k][2]["similarity"],
                                   rtol=1e-6)
    paths = [m.write_captions(tmp_path / n, "vid", payload)
             for n, m in (("jax", JCC), ("port", PCC))]
    assert paths[0].read_bytes() == paths[1].read_bytes()


# --------------------------------------------------------------------------- #
# build_dataset, frames, inverse_action, merge_photos
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_videos", [1, 2, 30])
def test_dataset_files_and_split_match_jax(tmp_path, n_videos):
    """``load_frames_tsv`` with captionless rows, ``split_train_test`` with
    one video (no test split), two and thirty, and ``write_dataset``'s
    file."""
    rows = []
    for v in range(n_videos):
        for f in range(3):
            rows.append(f"vid{v:02d}\t{f}\t{'' if f == 1 else 'hall with lamp'}\tleft")
    tsv = tmp_path / "frames.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    records = JB.load_frames_tsv(tsv)
    assert PB.load_frames_tsv(tsv) == records
    for seed in (0, 1):
        split = JB.split_train_test(records, 0.1, seed)
        assert PB.split_train_test(records, 0.1, seed) == split
        assert (len(split[1]) == 0) == (n_videos == 1)
    paths = [m.write_dataset(records, tmp_path / n / "ytb.json")
             for n, m in (("jax", JB), ("port", PB))]
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_video_lists_match_jax(tmp_path):
    """Video ids from a text file and a JSON list, and the ones left to
    fetch beside files already downloaded under any extension."""
    (tmp_path / "ids.txt").write_text("b\n\n a \nc\n")
    (tmp_path / "ids.json").write_text(json.dumps(["c", "a", "d"]))
    for name in ("ids.txt", "ids.json"):
        assert JFR.load_video_ids(tmp_path / name) == PFR.load_video_ids(tmp_path / name)
    videos = tmp_path / "videos"
    videos.mkdir()
    for f in ("a.mp4", "c.webm", "notes"):
        (videos / f).write_text("x")
    ids = ["d", "a", "b", "c", "d"]
    assert JFR.remaining_video_ids(ids, videos) == PFR.remaining_video_ids(ids, videos) == ["b", "d"]


def test_image_pairs_and_their_training_feed_match_jax(monkeypatch):
    """``image_pair_batches`` (features 1e-4, the sampled pairs and actions
    equal) and the batches ``train_inverse_model_from_images`` hands to
    ``train_inverse_model`` in both packages."""
    backbone = PP.WideResNet18(3, device=CPU).init_weights(5)
    params = jax.tree_util.tree_map(np.asarray,
                                    JP.params_from_torch_state_dict(backbone.state_dict()))
    frames = np.random.default_rng(8).integers(0, 256, (5, 48, 64, 3), dtype=np.uint8)
    actions = np.array([0, 1, 2, 1])
    want = JI.image_pair_batches(frames, actions, params, batch_size=3, seed=4)
    got = PI.image_pair_batches(frames, actions, backbone, batch_size=3, seed=4, device=CPU)
    for _ in range(2):
        (wk, wk1, wy), (gk, gk1, gy) = next(want), next(got)
        close(gk.transpose(0, 2, 3, 1), wk, 1e-4)
        close(gk1.transpose(0, 2, 3, 1), wk1, 1e-4)
        np.testing.assert_array_equal(gy, wy)
    fed = {}

    def record(name):
        def train(pairs, **kw):
            fed[name] = (next(pairs), kw.get("steps"))
            return None, []
        return train
    monkeypatch.setattr(JI, "train_inverse_model", record("jax"))
    monkeypatch.setattr(PI, "train_inverse_model", record("port"))
    JI.train_inverse_model_from_images(frames, actions, params, steps=2, seed=4)
    PI.train_inverse_model_from_images(frames, actions, backbone, device=CPU, steps=2, seed=4)
    (wk, _, wy), w_steps = fed["jax"]
    (gk, _, gy), g_steps = fed["port"]
    close(gk.transpose(0, 2, 3, 1), wk, 1e-4)
    np.testing.assert_array_equal(gy, wy)
    assert w_steps == g_steps == 2


@pytest.mark.parametrize("method", ["max", "least", "all", "adjacent", "continue"])
def test_merge_methods_match_jax(method):
    """Every merge method over rooms of 1-14 frames (``max``'s window at
    both ends), and the refusal of an unknown one."""
    rng = np.random.default_rng(9)
    rooms = ["kitchen", "hall", "bedroom"]
    frames = [{"frame_id": int(i), "caption": f"{rooms[r]} with lamp", "room": rooms[r]}
              for i, r in zip(rng.permutation(40)[:29],
                              [0] * 14 + [1] * 1 + [2] * 5 + [0] * 4 + [2] * 5)]
    got = [json.loads(json.dumps(frames)) for _ in range(2)]
    JMP.merge_video_frames(got[0], method, max_photo_per_merging=6)
    PMP.merge_video_frames(got[1], method, max_photo_per_merging=6)
    assert got[0] == got[1]
    for mod in (JMP, PMP):
        with pytest.raises(ValueError, match="merge_method"):
            mod.merge_video_frames(json.loads(json.dumps(frames)), method + "x")


def _shapes(tree):
    """{path: shape} of a JAX parameter tree (arrays or shape structs)."""
    return {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


INITIALISERS = {
    "clip": (lambda k: JC.init_clip_params(k, JC.ClipConfig(**CLIP_KW)),
             lambda: JC.params_from_hf_state_dict(
                 PC.ClipModel(PC.ClipConfig(**CLIP_KW), device=CPU).state_dict())),
    "places": (lambda k: JP.init_places_params(k, num_classes=5),
               lambda: JP.params_from_torch_state_dict(
                   PP.WideResNet18(5, device=CPU).state_dict())),
    "alexnet": (lambda k: JP.init_alexnet_params(k, num_classes=5),
                lambda: JP.alexnet_params_from_torch_state_dict(
                    PP.AlexNet(5, device=CPU).state_dict())),
    "maskrcnn": (JM.init_maskrcnn_params,
                 lambda: JM.params_from_torch_state_dict(PM.MaskRCNN(device=CPU).state_dict())),
    "inverse": (lambda k: JI.init_inverse_params(k, 8),
                lambda: JI.init_inverse_params(jax.random.PRNGKey(1), 8)),
}


@pytest.mark.parametrize("name", sorted(INITIALISERS))
def test_initialisers_give_the_port_layout(name):
    """Each JAX initialiser (shapes only, ``jax.eval_shape``) builds the tree
    that the JAX importer makes of the port's freshly built model: the same
    parameters with the same shapes, so the port's ``init_weights`` fills
    every tensor the JAX one does (the draws match only statistically)."""
    init, imported = INITIALISERS[name]
    want = _shapes(jax.eval_shape(init, jax.random.PRNGKey(0)))
    if name == "inverse":
        from youtube_vln_tpu_torch.models.weights import inverse_state_dict_from_jax_params
        model = PI.InverseActionHead(8, device=CPU)
        sd = inverse_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, imported()))
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = _shapes(imported())
    assert got == want and len(want) > 2
