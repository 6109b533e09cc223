"""The port's host tooling against the JAX package's, on the same seeded
inputs: ``data/store.py`` ``merge_stores`` / ``convert_lmdb`` (through
``tests/fake_lmdb.py``), ``utils/file_cache.py`` and the offline
``--from_pretrained`` URL, ``pipeline/frames.py`` with stubbed ``yt_dlp``
and ``ffmpeg``, ``pipeline/assets.py`` (the manifest and the distance
tables), and the three script entries through their ``main(argv)``.
Nothing is fetched."""
import json
import os
import shutil
import stat
import sys
import tarfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import fake_lmdb
from youtube_vln_tpu.data import fixtures as jfix
from youtube_vln_tpu.data import store as jstore
from youtube_vln_tpu.pipeline import assets as jassets
from youtube_vln_tpu.pipeline import frames as jframes
from youtube_vln_tpu.utils import file_cache as jfc
from youtube_vln_tpu_torch.data import fixtures as pfix
from youtube_vln_tpu_torch.data import store as pstore
from youtube_vln_tpu_torch.data.features_reader import YTbFeaturesReader
from youtube_vln_tpu_torch.entries import convert_lmdb as convert_entry
from youtube_vln_tpu_torch.entries import extract_frames as frames_entry
from youtube_vln_tpu_torch.entries import merge_stores as merge_entry
from youtube_vln_tpu_torch.pipeline import assets as passets
from youtube_vln_tpu_torch.pipeline import frames as pframes
from youtube_vln_tpu_torch.training import checkpoint as pckpt
from youtube_vln_tpu_torch.utils import file_cache as pfc


def _shards(root):
    a, b = root / "a.vlnstore", root / "b.vlnstore"
    pfix.write_store(a, ["k0", "k1", "dup"], k_boxes=3, seed=10)
    pfix.write_store(b, ["k2", "dup"], k_boxes=2, seed=11)
    return a, b


def test_merge_stores_matches_jax_and_restores_native_path(tmp_path):
    """Last shard wins on a duplicate key, the record counts and the merged
    files equal the JAX package's byte for byte, and the merged store
    packs a path that spanned two shards through one native call; the
    entry writes the same file."""
    a, b = _shards(tmp_path)
    out_j, out_p, out_e = (tmp_path / f"{n}.vlnstore" for n in "jpe")
    assert jstore.merge_stores([a, b], out_j) == pstore.merge_stores([a, b], out_p) == 4
    assert out_p.read_bytes() == out_j.read_bytes()
    assert merge_entry.main([str(out_e), str(a), str(b)]) == 4
    assert out_e.read_bytes() == out_p.read_bytes()

    sharded, merged = YTbFeaturesReader([a, b]), YTbFeaturesReader(out_p)
    try:
        assert set(sharded.keys) == set(merged.keys)
        for key in ("k0", "k2", "dup"):
            for x, y in zip(sharded[(key,)], merged[(key,)]):
                np.testing.assert_array_equal(x, y)
        assert merged[("dup",)][0].shape == sharded[("dup",)][0].shape
        assert sharded.pack_path([("k0",), ("k2",)], 2, 4) is None
        packed = merged.pack_path([("k0",), ("k2",)], 2, 4)
        if pstore.get_native() is not None:
            assert packed is not None
    finally:
        sharded.close()
        merged.close()

    # pano records keep their orientation tail through the merge
    pa, pm_j, pm_p = (tmp_path / f"{n}.vlnstore" for n in ("pa", "pmj", "pmp"))
    pfix.write_store(pa, ["s-v0", "s-v1"], k_boxes=3, pano=True, seed=12)
    assert jstore.merge_stores([pa], pm_j) == pstore.merge_stores([pa], pm_p) == 2
    assert pm_p.read_bytes() == pm_j.read_bytes()


def _region_lmdb(store_path, out_path):
    """A region database in the reference's older record layout (raw
    float32 buffers under ``feature`` / ``bbox`` / ``cls_prob``,
    ``image_width`` / ``image_height``), as ``fake_lmdb._open`` loads it."""
    import pickle
    src = pstore.Store(store_path)
    try:
        data = {k.encode(): pickle.dumps({
            "image_width": r.image_w, "image_height": r.image_h,
            "feature": r.features.tobytes(), "bbox": r.boxes.tobytes(),
            "cls_prob": r.cls_prob.tobytes()})
            for k, r in ((k, src.get(k)) for k in src.keys)}
        data[b"keys"] = pickle.dumps([k.encode() for k in src.keys])
    finally:
        src.close()
    with open(out_path, "wb") as f:
        pickle.dump(data, f)


@pytest.mark.parametrize("pano", [False, True], ids=["region", "pano"])
def test_convert_lmdb_matches_jax(tmp_path, monkeypatch, pano):
    """A reference-layout LMDB (the fake of ``tests/fake_lmdb.py``) converts
    to the same bytes in both packages, and through the entry; without
    ``lmdb`` the converter says so."""
    src = tmp_path / "src.vlnstore"
    keys = ["s-v0", "s-v1", "s-v2"] if pano else ["v/0001", "v/0002"]
    pfix.write_store(src, keys, k_boxes=4, pano=pano, seed=3)
    db = tmp_path / "db.lmdb"
    if pano:
        fake_lmdb.store_to_lmdb_pickle(src, db, pano=True)
    else:
        _region_lmdb(src, db)
    lmdb = types.ModuleType("lmdb")
    lmdb.open = fake_lmdb._open
    monkeypatch.setitem(sys.modules, "lmdb", lmdb)
    out_j, out_p, out_e = (tmp_path / f"{n}.vlnstore" for n in "jpe")
    assert jstore.convert_lmdb(db, out_j, pano=pano) == len(keys)
    assert pstore.convert_lmdb(db, out_p, pano=pano) == len(keys)
    assert out_p.read_bytes() == out_j.read_bytes() == src.read_bytes()
    argv = [str(db), str(out_e)] + (["--pano"] if pano else [])
    assert convert_entry.main(argv) == len(keys)
    assert out_e.read_bytes() == out_p.read_bytes()
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(RuntimeError, match="lmdb is not installed"):
        pstore.convert_lmdb(db, tmp_path / "x.vlnstore")


def test_file_cache_lookup_matches_jax(tmp_path):
    """Names, sidecars and S3 paths as the JAX module computes them; an
    etag-named entry found offline; a miss raises; a download request
    raises with the URL and the path to place the file at."""
    for url, etag in (("https://example.com/f.bin", None),
                      ("s3://bucket/a/b.bin", '"abc"'),
                      ("https://example.com/f.bin", "etag-123")):
        assert pfc.url_to_filename(url, etag) == jfc.url_to_filename(url, etag)
    assert pfc.split_s3_path("s3://bucket/a/b.bin") == ("bucket", "a/b.bin")
    with pytest.raises(ValueError):
        pfc.split_s3_path("s3://bucketonly")

    url = "https://example.com/f.bin"
    name = pfc.url_to_filename(url, "etag-123")
    (tmp_path / name).write_bytes(b"payload")
    (tmp_path / (name + ".json")).write_text(json.dumps({"url": url, "etag": "etag-123"}))
    assert pfc.filename_to_url(name, tmp_path) == jfc.filename_to_url(name, tmp_path)
    got = pfc.get_from_cache(url, cache_dir=tmp_path)
    assert got == jfc.get_from_cache(url, cache_dir=tmp_path) == tmp_path / name
    assert pfc.cached_path(url, cache_dir=tmp_path) == got
    # the etag-less name wins over an etag-suffixed one, as in the JAX module
    (tmp_path / pfc.url_to_filename(url)).write_bytes(b"bare")
    assert pfc.get_from_cache(url, tmp_path) == jfc.get_from_cache(url, tmp_path)
    assert pfc.cached_path(tmp_path / name) == tmp_path / name

    other = "https://example.com/other.bin"
    with pytest.raises(FileNotFoundError):
        pfc.get_from_cache(other, cache_dir=tmp_path)
    with pytest.raises(FileNotFoundError):
        pfc.cached_path(str(tmp_path / "absent.bin"))
    with pytest.raises(RuntimeError, match=pfc.url_to_filename(other)) as e:
        pfc.cached_path(other, cache_dir=tmp_path, allow_download=True)
    assert other in str(e.value)


def test_url_from_pretrained_resolves_through_the_cache(tmp_path, monkeypatch):
    """``--from_pretrained <url>`` of a ``.tar.gz`` in the offline cache is
    extracted and loaded (JAX ``tests/test_checkpoint.py:251``)."""
    from youtube_vln_tpu_torch import tiny_config
    from youtube_vln_tpu_torch.models import Lily

    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setattr(pfc, "CACHE_DIR", cache)
    model = Lily(tiny_config(), device="cpu").init_weights(3)
    bin_path = tmp_path / "pytorch_model.bin"
    torch.save({"model_state_dict": model.state_dict()}, bin_path)
    tgz = tmp_path / "m.tar.gz"
    with tarfile.open(tgz, "w:gz") as t:
        t.add(bin_path, arcname="pytorch_model.bin")
    url = "https://example.com/release/model.tar.gz"
    shutil.copy(tgz, cache / pfc.url_to_filename(url))

    weights, tempdir = pckpt.resolve_pretrained(url)
    try:
        assert tempdir is not None and weights.endswith("pytorch_model.bin")
        assert Path(weights).exists()
    finally:
        shutil.rmtree(tempdir, ignore_errors=True)
    fresh = Lily(tiny_config(), device="cpu").init_weights(4)
    missing, unexpected, _, _ = pckpt.load_checkpoint(url, fresh)
    assert not missing and not unexpected
    for (k, x), y in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(x, y), k
    with pytest.raises(FileNotFoundError):
        pckpt.resolve_pretrained("https://example.com/absent.tar.gz")


def _download(mod, vids, out, **kw):
    calls, sleeps = [], []

    def fake_downloader(url):
        vid = url.split("=")[-1]
        calls.append(vid)
        if vid == "bbb" and calls.count("bbb") < 3:
            raise mod.RetryableDownloadError()   # 429-style, then succeeds
        if vid == "ccc":
            raise RuntimeError("blocked")        # permanent failure
        (out / f"{vid}.mp4").write_bytes(b"x")

    got = mod.download_videos(vids, out, downloader=fake_downloader,
                              sleep_fn=sleeps.append, **kw)
    return got, calls, sleeps


def test_download_recipe_matches_jax(tmp_path, monkeypatch):
    """Resume, exponential backoff and per-video failures as in the JAX
    recipe; the default downloader drives a stubbed ``yt_dlp`` with the
    reference's options."""
    vids = ["aaa", "bbb", "ccc", "ddd"]
    results = []
    for mod in (jframes, pframes):
        out = tmp_path / mod.__name__.split(".")[0] / "videos"
        out.mkdir(parents=True)
        (out / "aaa.mp4").write_bytes(b"x")
        assert mod.download_videos(vids, out) == ["aaa"]        # gated
        results.append((_download(mod, vids, out), mod.build_ydl_opts(out, "1.2.3.4")))
    (got, calls, sleeps), opts = results[1]
    assert got == ["aaa", "bbb", "ddd"] and sleeps == [10.0, 20.0]
    assert "aaa" not in calls
    assert results[0][0] == results[1][0]
    assert {k: v for k, v in results[0][1].items() if k != "outtmpl"} == \
        {k: v for k, v in opts.items() if k != "outtmpl"}
    assert opts["proxy"] == "socks5://1.2.3.4:1080"

    seen = []

    class YoutubeDL:
        def __init__(self, opts):
            self.opts = opts

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def extract_info(self, url, download=False):
            seen.append(("info", url, download))

        def download(self, urls):
            for url in urls:
                vid = url.split("=")[-1]
                Path(self.opts["outtmpl"].replace("%(id)s", vid)
                     .replace("%(ext)s", "mp4")).write_bytes(b"v")

    monkeypatch.setitem(sys.modules, "yt_dlp", types.SimpleNamespace(YoutubeDL=YoutubeDL))
    out = tmp_path / "stubbed"
    assert pframes.download_videos(["v1", "v2"], out, allow_download=True) == ["v1", "v2"]
    assert sorted(p.name for p in out.iterdir()) == ["v1.mp4", "v2.mp4"]
    assert seen[0] == ("info", pframes.URL_PREFIX + "v1", False)
    monkeypatch.setitem(sys.modules, "yt_dlp", None)
    with pytest.raises(RuntimeError, match="yt_dlp"):
        pframes.download_videos(["v3"], out, allow_download=True)


def _fake_ffmpeg(path, n_frames):
    """An ``ffmpeg`` that writes ``n_frames`` files to the output pattern
    it is given (the argument after ``-q:v 2``)."""
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "pattern = args[args.index('-q:v') + 2]\n"
        f"for i in range(1, {n_frames} + 1):\n"
        "    open(pattern % i, 'wb').write(b'jpg')\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_frame_extraction_matches_jax(tmp_path, monkeypatch):
    """``extract_frames`` / ``extract_all`` and the entry with a stubbed
    ``ffmpeg``: the same frame counts and files as the JAX package's;
    without ffmpeg the call says so."""
    ffmpeg = _fake_ffmpeg(tmp_path / "ffmpeg", 3)
    videos = tmp_path / "videos"
    videos.mkdir()
    for name in ("a.mp4", "b.webm", "notes.txt"):
        (videos / name).write_bytes(b"")
    assert pframes.extract_frames(videos / "a.mp4", tmp_path / "one", ffmpeg=ffmpeg) == 3
    assert sorted(p.name for p in (tmp_path / "one").iterdir()) == [
        "0001.jpg", "0002.jpg", "0003.jpg"]
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    shutil.copy(ffmpeg, bin_dir / "ffmpeg")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    listings = []
    for name, run in (("jax", lambda out: jframes.extract_all(videos, out)),
                      ("port", lambda out: pframes.extract_all(videos, out)),
                      ("entry", lambda out: frames_entry.main(
                          ["--videos", str(videos), "--out", str(out)]))):
        out = tmp_path / name
        assert run(out) == 6
        listings.append(sorted(str(p.relative_to(out)) for p in out.rglob("*.jpg")))
    assert listings[0] == listings[1] == listings[2]
    assert listings[1][0] == os.path.join("a", "0001.jpg")
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="ffmpeg not found"):
        pframes.extract_frames(videos / "a.mp4", tmp_path / "two")


def test_asset_manifest_and_offline_fetch_match_jax(tmp_path, monkeypatch):
    """Every category of the reference's download recipe, the 92
    connectivity files, offline resolution (local files, then the cache)
    equal to the JAX module's."""
    for name in ("BEAMSEARCH_ASSETS", "CONFIG_ASSETS", "SPEAKER_ASSETS",
                 "TASK_ASSETS", "MODEL_WEIGHT_ASSETS", "ASSETS",
                 "MATTERPORT_SCANS", "CONNECTIVITY_FILES"):
        assert getattr(passets, name) == getattr(jassets, name), name
    assert passets.connectivity_manifest() == jassets.connectivity_manifest()
    assert len(passets.connectivity_manifest()) == 92
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setattr(pfc, "CACHE_DIR", cache)
    monkeypatch.setattr(jfc, "CACHE_DIR", cache)
    data = tmp_path / "data"
    missing = passets.fetch_all(data_dir=data, include_connectivity=True)
    assert missing == jassets.fetch_all(data_dir=data, include_connectivity=True)
    assert set(missing) == set(passets.ASSETS) | set(passets.connectivity_manifest())
    (data / "task").mkdir(parents=True)
    (data / "task" / "R2R_test.json").write_text("[]")
    target = "data/beamsearch/beams_test.json"
    (cache / pfc.url_to_filename(passets.ASSETS[target])).write_text("[]")
    for t in ("data/task/R2R_test.json", target, "data/unknown.json", "elsewhere/x"):
        assert passets.fetch(t, data_dir=data) == jassets.fetch(t, data_dir=data), t
    assert passets.fetch(target, data_dir=data) is not None
    assert len(passets.fetch_all(data_dir=data)) == len(passets.ASSETS) - 2


def test_generate_distances_byte_equal_to_jax(tmp_path):
    """Distance tables regenerated from the connectivity graphs of one
    fixture, written byte-equal by both packages (the port on its own
    ``NavGraph``, without networkx), from ``scans.txt`` or the glob."""
    jfix.build_r2r_fixture(tmp_path / "j", n_viewpoints=12)
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    for root in (tmp_path / "j", tmp_path / "p"):
        for f in (root / "distances").glob("*.json"):
            f.unlink()
    written_j = jassets.generate_distances(tmp_path / "j")
    written_p = passets.generate_distances(tmp_path / "p")
    assert [p.name for p in written_p] == [p.name for p in written_j] == [
        "scan0_distances.json", "scan1_distances.json"]
    for a, b in zip(written_j, written_p):
        assert a.read_bytes() == b.read_bytes()
    (tmp_path / "p" / "connectivity" / "scans.txt").write_text("scan1")
    again = passets.generate_distances(tmp_path / "p")
    assert [p.name for p in again] == ["scan1_distances.json"]
    assert again[0].read_bytes() == written_j[1].read_bytes()
    d = json.loads(written_p[0].read_text())
    vp = next(iter(d))
    assert d[vp][vp] == 0.0
