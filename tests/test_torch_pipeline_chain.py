"""The offline-pipeline chain of ``tests/test_pipeline_chain.py`` (raw
frames -> sharded region-feature TSVs -> store -> zero-shot captions ->
filter artifacts -> records -> photo merging -> frozen testset -> training
batches) through the port's modules and through the JAX package's, on the
same frame tree: every artifact byte-equal (TSV shards and the photo-path
caches, the store, the captions, the filter JSONs, the dataset JSON and
the frozen testset), and the first Loader batch equal."""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np

import youtube_vln_tpu.config as JCFG
import youtube_vln_tpu.data.datasets as JDS
import youtube_vln_tpu.data.features_reader as JFR
import youtube_vln_tpu.data.fixtures as JFX
import youtube_vln_tpu.data.loader as JLD
import youtube_vln_tpu.pipeline.build_dataset as JB
import youtube_vln_tpu.pipeline.clip_captions as JC
import youtube_vln_tpu.pipeline.detector as JD
import youtube_vln_tpu.pipeline.extraction as JE
import youtube_vln_tpu.pipeline.filters as JF
import youtube_vln_tpu.pipeline.merge_photos as JM
import youtube_vln_tpu_torch.config as PCFG
import youtube_vln_tpu_torch.data.datasets as PDS
import youtube_vln_tpu_torch.data.features_reader as PFR
import youtube_vln_tpu_torch.data.fixtures as PFX
import youtube_vln_tpu_torch.data.loader as PLD
import youtube_vln_tpu_torch.pipeline.build_dataset as PB
import youtube_vln_tpu_torch.pipeline.clip_model as PORT_CLIP
import youtube_vln_tpu_torch.pipeline.clip_captions as PC
import youtube_vln_tpu_torch.pipeline.detector as PD
import youtube_vln_tpu_torch.pipeline.extraction as PE
import youtube_vln_tpu_torch.pipeline.filters as PF
import youtube_vln_tpu_torch.pipeline.merge_photos as PM

N_FRAMES = 12
VIDS = ("vidA", "vidB")
JAX = SimpleNamespace(cfg=JCFG, ds=JDS, fr=JFR, fx=JFX, ld=JLD, b=JB, c=JC, d=JD,
                      e=JE, f=JF, m=JM)
PORT = SimpleNamespace(cfg=PCFG, ds=PDS, fr=PFR, fx=PFX, ld=PLD, b=PB, c=PC, d=PD,
                       e=PE, f=PF, m=PM)


def _write_frames(root: Path) -> None:
    from PIL import Image
    rng = np.random.default_rng(0)
    for vid in VIDS:
        d = root / vid
        d.mkdir(parents=True)
        for i in range(1, N_FRAMES + 1):
            Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
                d / ("%04d.jpg" % i))


def _chain(pkg, frames_dir: Path, out: Path):
    """Steps 3-10 and a training batch through ``pkg``'s modules; returns
    the first batch."""
    feat_dir = out / "img_features"
    n = pkg.e.run_extraction(frames_dir, feat_dir,
                             lambda sid: pkg.d.RandomProposalExtractor(num_boxes=6, seed=sid),
                             num_splits=2, num_workers=0)
    assert n == len(VIDS) * N_FRAMES
    store_path = out / "ytb_features.vlnstore"
    assert pkg.d.convert_tsv_to_store(sorted(feat_dir.glob("*.tsv")), store_path) == n

    rng = np.random.default_rng(1)

    def text_encoder(prompts):
        return np.stack([np.random.default_rng(sum(map(ord, p)) * 7919 % 2 ** 31)
                         .normal(size=16) for p in prompts])

    emb = {vid: {i: rng.normal(size=16) for i in range(1, N_FRAMES + 1)} for vid in VIDS}
    cap_dir = out / "CLIP_captioned_images"
    pkg.c.run(emb, text_encoder, cap_dir)
    captions = {vid: json.loads((cap_dir / vid / "captions_SE.json").read_text())
                for vid in VIDS}

    maskrcnn = {}
    for k, vid in enumerate(VIDS):
        # one frame outdoor-ish and a person blip, so the smoothing runs
        indoor = [1.0] * N_FRAMES
        indoor[3 + k] = 0.2
        person = [False] * N_FRAMES
        person[7] = True
        maskrcnn[vid] = pkg.f.filter_frames(indoor, person, ["%04d.jpg" % i
                                                             for i in range(1, N_FRAMES + 1)])
        pkg.f.write_maskrcnn_filters(out / "filters", vid,
                                     [int(f[:4]) for f in maskrcnn[vid]["indoor_locs"]],
                                     [int(f[:4]) for f in maskrcnn[vid]["person_locs"]])
        pkg.f.write_indoor_tsv(out / "indoor", vid, list(range(1, N_FRAMES + 1, 3)))
        pkg.f.write_indoor_order_tsv(out / "indoor", vid, list(range(1, N_FRAMES + 1, 3)))

    keyframes = list(range(1, N_FRAMES + 1, 2))
    acts = ["left", "forward", "right"]
    records = pkg.b.assemble_records(
        list(VIDS), captions,
        {vid: {f: acts[i % 3] for i, f in enumerate(keyframes[:-1])} for vid in VIDS},
        maskrcnn_by_video=maskrcnn, trajectory_by_video={vid: keyframes for vid in VIDS})
    by_video = pkg.b.preprocess_records(records, min_caption=2, min_length=4)
    assert set(by_video) == set(VIDS)
    pkg.b.write_preprocessed(by_video, out / "pre", "ytb_train")
    flat = [r for items in by_video.values() for r in items]
    for r in flat:
        r["room"] = captions[r["video_id"]]["%04d.jpg" % r["frame_id"]][0].split(" with ")[0]
    caption_path = out / "merge+ytb_train.json"
    caption_path.write_text(json.dumps(pkg.m.merge_dataset(flat, "max", 4)))

    templates = []
    for k in range(1, 8):
        parts = []
        for i in range(k):
            parts.append("walk into the [MASK]")
            if i < k - 1:
                parts.append("and turn [OMASK]")
        templates.append({"instructions": [" ".join(parts) + " ."]})
    skeleton_path = out / "R2R_train_templates.json"
    skeleton_path.write_text(json.dumps(templates))
    tok = pkg.fx.write_fixture_vocab(out / "vocab.txt")
    args = pkg.cfg.RunConfig(
        pretrain=True, pre_dataset="ytb", ranking=True, masked_vision=True,
        masked_language=True, max_instruction_length=32, max_path_length=4,
        max_num_boxes=5, min_path_length=3, min_captioned=2, max_captioned=4,
        num_negatives=2, shuffler="different", negative_style="normal",
        skeleton_path=str(skeleton_path))
    reader = pkg.fr.YTbFeaturesReader(store_path)
    try:
        ds = pkg.ds.YTbDataset(args=args, caption_path=caption_path, tokenizer=tok,
                               features_reader=reader, masked_vision=True,
                               masked_language=True, training=True, seed=0)
        assert len(ds) == len(VIDS)
        pkg.b.freeze_testset(ds, out / "merge+testset.json")
        return next(iter(pkg.ld.Loader(ds, batch_size=2, shuffle=True, seed=1)))
    finally:
        reader.close()


def test_port_chain_artifacts_byte_equal_to_jax(tmp_path):
    frames_dir = tmp_path / "raw_frames"
    _write_frames(frames_dir)
    jax_batch = _chain(JAX, frames_dir, tmp_path / "jax")
    port_batch = _chain(PORT, frames_dir, tmp_path / "port")

    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    port_files = sorted(p.relative_to(tmp_path / "port")
                        for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert files == port_files
    kinds = {f.suffix for f in files}
    assert {".tsv", ".txt", ".vlnstore", ".json"} <= kinds
    assert Path("merge+testset.json") in files and Path("filters/vidA/vidA.json") in files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f

    assert set(port_batch) == set(jax_batch)
    for k in jax_batch:
        np.testing.assert_array_equal(np.asarray(port_batch[k]), np.asarray(jax_batch[k]),
                                      err_msg=k)


def _script(name):
    import importlib.util
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(f"script_{name}", root / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entries_write_what_the_scripts_write(tmp_path):
    """``python -m youtube_vln_tpu_torch.entries.extract_features |
    convert_tsv | merge_photos`` against ``scripts/*.py`` on the same
    flags: byte-equal outputs; ``entries.clip_features --device cpu`` (a
    random ViT-B/32) writes one row per frame and resumes."""
    from youtube_vln_tpu_torch.entries import (clip_features, convert_tsv,
                                               extract_features, merge_photos)
    frames_dir = tmp_path / "raw_frames"
    _write_frames(frames_dir)
    for tag, main in (("jax", _script("extract_features").main), ("port", extract_features.main)):
        main([str(frames_dir), str(tmp_path / tag / "feats"), "--num_splits", "3",
              "--num_workers", "0"])
        shards = sorted(str(p) for p in (tmp_path / tag / "feats").glob("*.tsv"))
        conv = _script("convert_tsv").main if tag == "jax" else convert_tsv.main
        conv([str(tmp_path / tag / "store.vlnstore"), *shards])
    for f in ("feats/ResNet-101-faster-rcnn-genome-0.tsv",
              "feats/ResNet-101-faster-rcnn-genome-2.tsv", "store.vlnstore"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f

    items = [dict(video_id=v, frame_id=i, caption="", room=r)
             for v in VIDS for i, r in zip(range(9), "aabbbacca")]
    (tmp_path / "src.json").write_text(json.dumps(items))
    for tag, main in (("jax", _script("merge_photos").main), ("port", merge_photos.main)):
        main(["--source", str(tmp_path / "src.json"), "--output",
              str(tmp_path / f"{tag}.json"), "--merge_method", "least",
              "--max_photo_per_merging", "2"])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()

    out = tmp_path / "clip.tsv"
    assert clip_features.main([str(frames_dir), str(out), "--device", "cpu",
                               "--batch_size", "16"]) == 2 * N_FRAMES
    assert clip_features.main([str(frames_dir), str(out), "--device", "cpu"]) == 0
    assert len(PORT_CLIP.read_clip_tsv(out)[1]) == 2 * N_FRAMES
