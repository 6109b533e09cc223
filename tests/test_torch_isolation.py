"""The port stands alone: it never imports JAX, the JAX package or
networkx (absent on the card machine), its entry points and tools refuse
to run on a machine without CUDA unless the caller asks for the CPU, and
its host code and host tools import no torch."""
import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "youtube_vln_tpu_torch"

# every module of the package, packages aside: ``_CHECK`` imports each, and
# ``test_module_list_covers_the_package`` holds the list to the package
MODULES = (
    "config", "device", "utils.cli", "utils.entry", "utils.misc", "utils.file_cache",
    "utils.measure", "utils.spans",
    "ops._build", "ops._rowwise", "ops.attention", "ops.epilogue", "ops.layer_norm",
    "ops.philox", "ops.masking",
    "models.layers", "models.vilbert", "models.weights", "models.legacy",
    "training.losses", "training.optimization", "training.engine",
    "training.checkpoint",
    "parallel.train_step", "parallel.distributed", "parallel.mesh", "parallel.tensor",
    "data.store", "data.features_reader", "data.tokenizer", "data.sampling",
    "data.instructions", "data.datasets", "data.loader", "data.fixtures",
    "data.nav_graph",
    "evaluation.beam_eval", "evaluation.metrics",
    "pipeline.resize", "pipeline.places365", "pipeline.maskrcnn", "pipeline.clip_model",
    "pipeline.inverse_action", "pipeline.filters", "pipeline.clip_captions",
    "pipeline.detector", "pipeline.extraction", "pipeline.build_dataset",
    "pipeline.merge_photos", "pipeline.frames", "pipeline.assets",
    "entries.test", "entries.calculate_metrics", "entries.train", "entries.pretrain",
    "entries.clip_features", "entries.extract_features", "entries.convert_tsv",
    "entries.merge_photos", "entries.build_testset", "entries.merge_stores",
    "entries.convert_lmdb", "entries.extract_frames", "entries.check_kernels",
    "entries.profile_step", "entries.bench_e2e", "entries.bench_loader",
    "entries.northstar")

_CHECK = r"""
import importlib, pkgutil, sys
import youtube_vln_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "youtube_vln_tpu", "networkx"))
assert not leaked, leaked
for module in sys.argv[1:]:
    assert pkg.__name__ + "." + module in names, module

import os, tempfile
import numpy as np
from youtube_vln_tpu_torch import tiny_config
from youtube_vln_tpu_torch.config import RunConfig
from youtube_vln_tpu_torch.evaluation import beam_eval
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.entries import pretrain as pretrain_entry
from youtube_vln_tpu_torch.entries import test as test_entry
from youtube_vln_tpu_torch.entries import train as train_entry
from youtube_vln_tpu_torch.training.engine import Engine
from youtube_vln_tpu_torch.parallel import train_step
cfg = tiny_config()
args = RunConfig(ranking=True)
out = tempfile.mkdtemp()
model = Lily(cfg, device="cpu").init_weights(0)
optimizer, _ = train_step.create_train_state(model, args, 1)
for call in (lambda: beam_eval.eval_epoch(model, cfg, []),
             lambda: beam_eval.build_score_step(model, cfg),
             lambda: train_step.build_train_step(model, cfg, args, optimizer),
             lambda: train_step.build_eval_step(model, cfg, args),
             # the device is resolved before any data is read: no data here
             lambda: test_entry.main(["--split", "val_unseen", "--data_dir",
                                      "absent", "--output_dir", out]),
             lambda: train_entry.main(["--ranking", "--data_dir", "absent",
                                       "--output_dir", out]),
             lambda: pretrain_entry.main(["--final", "--ranking", "--pre_dataset",
                                          "ytb", "--data_dir", "absent",
                                          "--output_dir", out]),
             lambda: Engine(RunConfig(ranking=True, data_dir="absent"), cfg)):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit("an entry point ran without CUDA and without device='cpu'")
# the tools: the device is resolved before a model, a fixture or a folder
from youtube_vln_tpu_torch.entries import (bench_e2e, check_kernels, northstar,
                                           profile_step)
for call in (lambda: check_kernels.main([]), lambda: profile_step.main(["full"]),
             lambda: bench_e2e.main(["--n_videos", "2"]),
             lambda: northstar.main(["--data_dir", "absent", "--img_feature",
                                     "absent.vlnstore", "--from_pretrained", "x.bin",
                                     "--config_file", "absent.json",
                                     "--output_dir", out])):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit("a tool ran without CUDA and without --device cpu")
# the legacy heads and the pipeline's models and drivers
from youtube_vln_tpu_torch.entries import clip_features
from youtube_vln_tpu_torch.models import legacy
from youtube_vln_tpu_torch.pipeline import (clip_model, filters, inverse_action,
                                            maskrcnn, places365)
frames = os.path.join(out, "raw_frames", "vid0")
os.makedirs(frames)
frames = os.path.dirname(frames)
wrn = places365.WideResNet18(7, device="cpu")
alex = places365.AlexNet(7, device="cpu")
clip = clip_model.ClipModel(clip_model.ClipConfig(v_layers=1, t_layers=1), device="cpu")
head = inverse_action.InverseActionHead(8, device="cpu")
det = maskrcnn.MaskRCNNDetector(maskrcnn.MaskRCNN(device="cpu"), device="cpu")
img = np.zeros((1, 32, 32, 3), np.uint8)
sink = os.path.join(out, "sink")
for call in (lambda: legacy.BertForMultiModalPreTraining(cfg),
             lambda: legacy.VILBertForVLTasks(cfg, 3),
             lambda: places365.WideResNet18(), lambda: places365.AlexNet(),
             lambda: maskrcnn.MaskRCNN(), lambda: clip_model.ClipModel(),
             lambda: inverse_action.InverseActionHead(),
             lambda: maskrcnn.MaskRCNNDetector(det.model),
             lambda: places365.preprocess_images(img),
             lambda: places365.score_batch(wrn, None, labels_io=np.zeros(7)),
             lambda: places365.alexnet_indoor_probs(alex, img, np.zeros(7)),
             lambda: filters.places365_indoor_probs(wrn, img, np.zeros(7)),
             lambda: filters.run_indoor_filter(frames, sink, wrn, np.zeros(7)),
             lambda: filters.run_maskrcnn_filter(frames, sink, alex, np.zeros(7), det),
             lambda: clip_model.encode_video_frames(clip, img),
             lambda: clip_model.build_clip_tsv(clip, frames, os.path.join(sink, "c.tsv")),
             lambda: clip_model.text_features(clip, np.zeros((1, 4), np.int64)),
             lambda: inverse_action.train_inverse_model(iter([]), steps=1),
             lambda: inverse_action.encode_frames(wrn, img),
             lambda: inverse_action.predict_actions(head, [np.zeros((8, 7, 7))] * 2),
             lambda: clip_features.main([frames, os.path.join(sink, "c.tsv")])):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit("a pipeline call ran without CUDA and without device='cpu'")
assert not os.path.exists(sink), "a pipeline driver wrote output before it refused"
assert beam_eval.eval_epoch(model, cfg, [], device="cpu") == []
train_step.build_train_step(model, cfg, args, optimizer, device="cpu")
assert os.listdir(out) == ["raw_frames"], "an entry wrote output before it refused"
print("isolated")
"""


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    r = _run(["-c", _CHECK, *MODULES], REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("isolated")


def test_module_list_covers_the_package():
    """``MODULES`` names every module that ``pkgutil.walk_packages`` finds
    in the package: a module added without its entry fails here, one
    deleted with its entry left fails the import check."""
    import youtube_vln_tpu_torch as pkg
    prefix = pkg.__name__ + "."
    found = {m.name[len(prefix):] for m in pkgutil.walk_packages(pkg.__path__, prefix)
             if not m.ispkg}
    assert found <= set(MODULES), sorted(found - set(MODULES))


_HOST_ONLY = r"""
import sys
import youtube_vln_tpu_torch.data.datasets, youtube_vln_tpu_torch.data.fixtures
import youtube_vln_tpu_torch.data.loader, youtube_vln_tpu_torch.data.nav_graph
import youtube_vln_tpu_torch.evaluation.metrics
from youtube_vln_tpu_torch.data.datasets import BeamDataset
assert "torch" not in sys.modules, "the host pipeline imports torch"
print("host only")
"""


_HOST_COPIES = r"""
import sys
from youtube_vln_tpu_torch.pipeline import (build_dataset, clip_captions, detector,
                                            extraction, merge_photos)
from youtube_vln_tpu_torch.entries import (convert_tsv, extract_features,
                                           merge_photos as merge_entry)
assert "torch" not in sys.modules, "a host copy of the pipeline imports torch"
print("host only")
"""


_HOST_TOOLS = r"""
import sys
from youtube_vln_tpu_torch.data.store import convert_lmdb, merge_stores
from youtube_vln_tpu_torch.pipeline import assets, frames
from youtube_vln_tpu_torch.utils import file_cache, measure, spans
from youtube_vln_tpu_torch.entries import (bench_loader, convert_lmdb as convert_entry,
                                           extract_frames, merge_stores as merge_entry)
assert "torch" not in sys.modules, "a host tool imports torch"
print("host only")
"""


def test_host_tools_import_no_torch():
    """The store converters, the frame and asset steps, the file cache, the
    shared measurement helpers, the host spans, ``bench_loader`` and the
    host entries run without torch."""
    r = _run(["-c", _HOST_TOOLS], REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("host only")


def test_pipeline_host_copies_import_no_torch():
    """``extraction.run_extraction`` forks a ``multiprocessing.Pool``, and a
    fork after CUDA is up is unsafe: the pipeline's host copies and the
    entries built on them import no torch."""
    r = _run(["-c", _HOST_COPIES], REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("host only")


def test_host_pipeline_imports_no_torch():
    """The Loader's forked workers run only the datasets, the store reader
    and numpy: none of them imports torch, so a worker forked from a
    process with CUDA up never touches it."""
    r = _run(["-c", _HOST_ONLY], REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("host only")


def test_sources_hold_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|youtube_vln_tpu|networkx)\b(?!_torch)",
                         re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "kernel_timing.py"]
    assert {"philox.py", "optimization.py", "device.py"} <= {f.name for f in files}
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA, and in a directory holding chip_smoke.py alone, the
    script exits non-zero and prints no result line."""
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        r = _run(["chip_smoke.py"], cwd)
        assert r.returncode != 0, r.stdout
        assert '"ok": true' not in r.stdout


def test_kernel_timing_fails_without_a_card():
    r = _run(["kernel_timing.py"], REPO)
    assert r.returncode != 0, r.stdout
    assert "no CUDA device" in r.stderr
