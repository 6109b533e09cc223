"""The port stands alone: it never imports JAX, the JAX package or
networkx (absent on the card machine), and its entry points refuse to run
on a machine without CUDA unless the caller asks for the CPU."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "youtube_vln_tpu_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import youtube_vln_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "youtube_vln_tpu", "networkx"))
assert not leaked, leaked
for module in ("device", "ops.philox", "ops.epilogue", "ops.masking",
               "training.losses", "training.optimization", "parallel.train_step",
               "parallel.distributed", "parallel.mesh", "parallel.tensor",
               "data.store", "data.features_reader", "data.tokenizer",
               "data.sampling", "data.instructions", "data.datasets",
               "data.loader", "data.fixtures", "data.nav_graph",
               "evaluation.metrics", "training.engine", "training.checkpoint",
               "utils.cli", "utils.entry", "utils.misc", "entries.test",
               "entries.calculate_metrics", "entries.train", "entries.pretrain"):
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
assert beam_eval.eval_epoch(model, cfg, [], device="cpu") == []
train_step.build_train_step(model, cfg, args, optimizer, device="cpu")
assert not os.listdir(out), "an entry wrote output before it refused"
print("isolated")
"""


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    r = _run(["-c", _CHECK], REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("isolated")


_HOST_ONLY = r"""
import sys
import youtube_vln_tpu_torch.data.datasets, youtube_vln_tpu_torch.data.fixtures
import youtube_vln_tpu_torch.data.loader, youtube_vln_tpu_torch.data.nav_graph
import youtube_vln_tpu_torch.evaluation.metrics
from youtube_vln_tpu_torch.data.datasets import BeamDataset
assert "torch" not in sys.modules, "the host pipeline imports torch"
print("host only")
"""


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
                                          REPO / "eval_timing.py",
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


def test_eval_timing_fails_without_a_card():
    r = _run(["eval_timing.py"], REPO)
    assert r.returncode != 0, r.stdout
    assert "no CUDA device" in r.stderr


def test_kernel_timing_fails_without_a_card():
    r = _run(["kernel_timing.py"], REPO)
    assert r.returncode != 0, r.stdout
    assert "no CUDA device" in r.stderr
