"""The port's training entries (``youtube_vln_tpu_torch/entries/train.py``
and ``pretrain.py``, ``--device cpu``) against the repo's ``train.py`` and
``pretrain.py`` on ``build_full_fixture``, from the same JAX-written
``.bin`` in f32 with dropout off (the model and flags of
``tests/test_torch_engine.py``), two epochs with a save after each: the
returned bests are equal, the checkpoints have the same names, and the
per-step losses agree within 1e-4.  Resume: in the port, epoch 1 resumed
from the epoch-0 checkpoint (``--resume``) repeats the straight run's
epoch 1 within 1e-6; the JAX epoch-0 checkpoint, whose optimizer state is
the pickled ``jax_optimizer_state``, resumed by the port continues the JAX
run's epoch 1 within 1e-4."""
import shutil
from pathlib import Path

import pytest
import torch

from youtube_vln_tpu.training import checkpoint as jckpt
from youtube_vln_tpu.training import engine as jengine
from youtube_vln_tpu_torch.entries import pretrain as ppretrain
from youtube_vln_tpu_torch.entries import train as ptrain
from youtube_vln_tpu_torch.training import checkpoint as pckpt
from youtube_vln_tpu_torch.training import engine as pengine

from conftest import load_entry
from test_torch_engine import (assert_losses_close, build_env, flags,
                               record_steps, to_floats)

EPOCHS = ["--num_epochs", "2", "--save_epochs", "1"]
ENTRIES = {"train": "finetune", "pretrain": "pretrain"}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    out = build_env(tmp_path_factory.mktemp("train_entry"))
    out["runs"] = {}
    return out


def run_entry(env, pkg, entry, name, extra=()):
    """One entry run, cached: (returned bests, per-step metrics and target
    twins, checkpoint names, the engine, the folder where every checkpoint
    the run pruned was kept)."""
    key = (pkg, entry, name)
    if key in env["runs"]:
        return env["runs"][key]
    engine_cls = jengine.Engine if pkg == "jax" else pengine.Engine
    ckpt = jckpt if pkg == "jax" else pckpt
    kept = env["root"] / pkg / "kept" / name
    engines, steps = [], []
    init, delete = engine_cls.__init__, ckpt.delete_checkpoint

    def recording_init(self, *a, **k):
        init(self, *a, **k)
        engines.append(self)
        steps.append(record_steps(pkg, self))

    def keeping_delete(save_dir, save_name):
        path = Path(ckpt.checkpoint_path(save_dir, save_name))
        if path.exists():
            kept.mkdir(parents=True, exist_ok=True)
            shutil.copy(path, kept / path.name)
        delete(save_dir, save_name)

    argv = flags(env, pkg, ENTRIES[entry], EPOCHS + ["--save_name", name]
                 + list(extra))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_cls, "__init__", recording_init)
        mp.setattr(ckpt, "delete_checkpoint", keeping_delete)
        if pkg == "jax":
            best = load_entry(entry).main(argv)
        else:
            main = ptrain.main if entry == "train" else ppretrain.main
            best = main(argv + ["--device", "cpu"])
    data = env["root"] / pkg / "result" / name / "data"
    names = sorted(p.name for p in data.glob("*"))
    env["runs"][key] = (best, to_floats(steps[0]), names, engines[0], kept)
    return env["runs"][key]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_matches_the_jax_entry(env, entry):
    want_best, want_steps, want_names, jax_engine, _ = run_entry(
        env, "jax", entry, entry)
    got_best, got_steps, got_names, engine, _ = run_entry(
        env, "port", entry, entry)
    assert got_best == pytest.approx(want_best, rel=1e-6, abs=0)
    if entry == "train":
        assert isinstance(got_best, tuple) and len(got_best) == 2
        assert got_names == ["1.bin", "best_seen.bin", "best_unseen.bin"]
    else:
        assert sorted(got_best) == ["ranking", "traj"]
        assert got_names == ["1.bin", "best_ranking.bin", "best_traj.bin"]
    assert all(0.0 <= v <= 1.0 for v in (
        got_best.values() if isinstance(got_best, dict) else got_best))
    assert got_names == want_names
    assert len(got_steps) == 2 * len(engine.train_loader)
    assert_losses_close(got_steps, want_steps)
    # the last checkpoint carries the schedule's position and the moments
    payload = torch.load(Path(engine.save_folder) / "1.bin",
                         map_location="cpu", weights_only=True)
    assert payload["epoch"] == 1
    opt = payload["optimizer_state_dict"]
    assert opt["step_count"] == payload["jax_step"] == len(got_steps)
    assert set(opt["exp_avg"]) == set(opt["exp_avg_sq"]) == {
        n for n, _ in engine.model.named_parameters()}


def _resumed(env, pkg_of_checkpoint):
    """The port's epoch 1, resumed from the epoch-0 checkpoint that the
    straight run of ``pkg_of_checkpoint`` pruned (and the test kept)."""
    straight = run_entry(env, pkg_of_checkpoint, "train", "train")
    start = straight[4] / "0.bin"
    assert start.exists()
    return straight, run_entry(env, "port", "train",
                               f"resume_{pkg_of_checkpoint}",
                               ["--from_pretrained", str(start), "--resume"])


def test_port_resume_continues_the_straight_run(env):
    (_, straight, _, engine, _), (_, resumed, names, resumed_engine, _) = \
        _resumed(env, "port")
    per_epoch = len(engine.train_loader)
    assert resumed_engine.start_epoch == 1
    assert len(resumed) == per_epoch           # only epoch 1 ran
    assert_losses_close(resumed, straight[per_epoch:], tol=1e-6)
    assert resumed_engine.optimizer.step_count == 2 * per_epoch
    assert names == ["1.bin", "best_seen.bin", "best_unseen.bin"]


def test_jax_checkpoint_resumes_on_the_jax_trajectory(env):
    (_, straight, _, jax_engine, _), (_, resumed, _, resumed_engine, _) = \
        _resumed(env, "jax")
    per_epoch = len(jax_engine.train_loader)
    assert resumed_engine.start_epoch == 1
    assert len(resumed) == per_epoch
    assert_losses_close(resumed, straight[per_epoch:])
    assert resumed_engine.optimizer.step_count == int(jax_engine.state.step)
