"""Tensor parallelism of the port through its training entries, on 2 gloo
CPU processes under ``--mesh_shape 1 2`` (the launcher of
``tests/test_torch_distributed.py``), on the environment of
``tests/test_torch_train_entry.py`` (``build_env``: f32, dropout off, the
same JAX-written ``.bin``, a save after each epoch):

  * ``entries.pretrain.main`` (MRT, one epoch) against the JAX ``pretrain.py
    --mesh_shape 4 2`` on the 8-device CPU mesh: the bests within 1e-6
    relative, the same checkpoint names, the per-step losses within 1e-4;
    a ``.bin`` that the two ranks saved loads with the JAX
    ``load_checkpoint`` and with the port's one-process loader, to the same
    tensors;
  * checkpoints across meshes (two epochs, no validation):
    ``entries.train.main`` under ``1 2`` with
    ``--orbax_checkpoints``, whose epoch-0 ``.dcp`` resumed in one process
    runs epoch 1 on the two ranks' trajectory, and a one-process epoch-0
    ``.bin`` resumed under ``1 2`` runs epoch 1 on the one process's
    trajectory, both within 1e-5."""
from pathlib import Path

import pytest
import torch

from test_torch_distributed import run_ranks, worker_main

MRT_EPOCHS = ["--num_epochs", "1", "--save_epochs", "1"]
EPOCHS = ["--num_epochs", "2", "--save_epochs", "1", "--skip_val", "--no_test",
          "--batch_size", "4"]
RESUME_TOL = 1e-5
MESH = ["--mesh_shape", "1", "2"]


def _entries_task(spec):
    """The entry runs of ``spec["runs"]`` on this rank, each with its steps
    recorded; a run with ``keep`` keeps every checkpoint the entry would
    prune."""
    import test_torch_engine as T
    from youtube_vln_tpu_torch.entries import pretrain as ppretrain
    from youtube_vln_tpu_torch.entries import train as ptrain
    from youtube_vln_tpu_torch.training import checkpoint as pckpt
    from youtube_vln_tpu_torch.training.engine import Engine

    out = {}
    for run in spec["runs"]:
        engines, steps = [], []
        init = Engine.__init__

        def recording_init(self, *a, **k):
            init(self, *a, **k)
            engines.append(self)
            steps.append(T.record_steps("port", self))

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Engine, "__init__", recording_init)
            if run.get("keep"):
                mp.setattr(pckpt, "delete_checkpoint", lambda *a: None)
            main = ptrain.main if run["entry"] == "train" else ppretrain.main
            best = main(run["argv"])
        names = sorted(p.name for p in Path(run["data"]).glob("*"))
        out[run["name"]] = {"best": best, "steps": T.to_floats(steps[0]),
                            "names": names, "start_epoch": engines[0].start_epoch,
                            "per_epoch": len(engines[0].train_loader)}
        for e in engines:
            e.close()
    return out


TASKS = {"entries": _entries_task}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    import test_torch_engine as T
    out = T.build_env(tmp_path_factory.mktemp("tp_entry"))
    out["runs"] = {}
    return out


def _port_argv(env, recipe, name, extra=()):
    import test_torch_engine as T
    epochs = MRT_EPOCHS if recipe == "pretrain" else EPOCHS
    return T.flags(env, "port", recipe, epochs + ["--save_name", name, "--device",
                                                  "cpu", *extra])


def _run_entry(env, pkg, recipe, name, extra=()):
    """``test_torch_train_entry.run_entry`` with this file's epochs."""
    import test_torch_train_entry as E
    epochs = MRT_EPOCHS if recipe == "pretrain" else EPOCHS
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(E, "EPOCHS", epochs)
        return E.run_entry(env, pkg, "pretrain" if recipe == "pretrain" else "train",
                           name, extra)


def _data(env, name):
    return env["root"] / "port" / "result" / name / "data"


@pytest.fixture(scope="module")
def one_process(env):
    """The port's one-process fine-tuning, two epochs, every checkpoint kept."""
    env["one_process"] = _run_entry(env, "port", "finetune", "one")
    return env["one_process"]


@pytest.fixture(scope="module")
def tp_ranks(env):
    """The runs of the two ranks, each spawn cached: ``mrt``, the MRT entry;
    ``train``, the fine-tuning with ``.dcp`` saves, then the fine-tuning
    resumed from the one process's epoch-0 ``.bin``."""
    cache = {}

    def run(group):
        if group not in cache:
            if group == "mrt":
                runs = [{"name": "mrt", "entry": "pretrain",
                         "data": str(_data(env, "tp_mrt")),
                         "argv": _port_argv(env, "pretrain", "tp_mrt", MESH)}]
            else:
                start = env["one_process"][4] / "0.bin"
                assert start.exists()
                runs = [
                    {"name": "straight", "entry": "train", "keep": True,
                     "data": str(_data(env, "tp_train")),
                     "argv": _port_argv(env, "finetune", "tp_train",
                                        MESH + ["--orbax_checkpoints"])},
                    {"name": "resumed", "entry": "train",
                     "data": str(_data(env, "tp_resume")),
                     "argv": _port_argv(env, "finetune", "tp_resume",
                                        MESH + ["--from_pretrained", str(start),
                                                "--resume"])}]
            cache[group] = run_ranks(Path(__file__), "entries", {"runs": runs},
                                     env["root"] / f"tp_{group}")
        return cache[group]

    return run


def test_tp_mrt_entry_matches_the_jax_mesh_entry(env, tp_ranks):
    """``pretrain.main --mesh_shape 1 2`` against the JAX ``pretrain.py
    --mesh_shape 4 2``, and its saves read by both loaders."""
    import test_torch_engine as T
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.models.weights import state_dict_from_jax_params
    from youtube_vln_tpu_torch.training import checkpoint as pckpt
    from youtube_vln_tpu_torch.utils import cli, entry

    want_best, want_steps, want_names, _, _ = _run_entry(
        env, "jax", "pretrain", "jax_mesh", ["--mesh_shape", "4", "2"])
    ranks = [r["mrt"] for r in tp_ranks("mrt")]
    assert ranks[0]["best"] == ranks[1]["best"]
    assert ranks[0]["steps"] == ranks[1]["steps"]
    got = ranks[0]
    assert sorted(got["best"]) == ["ranking", "traj"]
    assert got["best"] == pytest.approx(want_best, rel=1e-6, abs=0)
    assert got["names"] == want_names == ["0.bin", "best_ranking.bin", "best_traj.bin"]
    assert len(got["steps"]) == got["per_epoch"]
    T.assert_losses_close(got["steps"], want_steps)

    # the gathered .bin: the JAX loader and the port's one process agree
    path = _data(env, "tp_mrt") / "0.bin"
    _, args = cli.parse_run_config(_port_argv(env, "pretrain", "x"))
    cfg = entry.build_model_config(args)
    params, step, epoch = _jax_load(env, path)
    assert (step, epoch) == (len(got["steps"]), 0)
    model = Lily(cfg, device="cpu").init_weights(99)
    missing, unexpected, step, epoch = pckpt.load_checkpoint(path, model)
    assert not missing and (step, epoch) == (len(got["steps"]), 0)
    from_jax = state_dict_from_jax_params(params, cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(v, from_jax[k]), k
    payload = torch.load(path, map_location="cpu", weights_only=True)
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(v.shape) for n, v in
            payload["optimizer_state_dict"]["exp_avg"].items()} == full


def _jax_load(env, path):
    """(params, step, epoch) of the JAX ``load_checkpoint`` of ``path``
    into a fresh parameter tree of the test config."""
    import jax
    import numpy as np
    from youtube_vln_tpu.config import LilyConfig as JaxLilyConfig
    from youtube_vln_tpu.models import init_lily_params
    from youtube_vln_tpu.training import checkpoint as jckpt

    cfg = JaxLilyConfig.from_json_file(env["config_file"])
    cfg.ranking = cfg.traj_judge = cfg.masked_vision = cfg.masked_language = True
    fresh = jax.tree_util.tree_map(np.asarray,
                                   init_lily_params(jax.random.PRNGKey(1), cfg))
    params, _, step, epoch = jckpt.load_checkpoint(str(path), cfg, fresh)
    return jax.tree_util.tree_map(np.asarray, params), step, epoch


def test_checkpoints_cross_meshes(env, tp_ranks, one_process):
    """A ``1 2`` ``.dcp`` resumed in one process, and a one-process ``.bin``
    resumed under ``1 2``: epoch 1 on the trajectory of the run that saved
    the checkpoint, within 1e-5."""
    import test_torch_engine as T

    _, one_steps, _, one_engine, _ = one_process
    per_epoch = len(one_engine.train_loader)
    ranks = tp_ranks("train")
    straight = [r["straight"] for r in ranks]
    assert straight[0]["steps"] == straight[1]["steps"]
    assert straight[0]["names"] == ["0.dcp", "1.dcp"]
    # the straight runs agree: the mesh changes nothing but rounding
    T.assert_losses_close(straight[0]["steps"], one_steps, tol=RESUME_TOL)

    # a one-process .bin resumed under 1 2
    resumed = [r["resumed"] for r in ranks]
    assert [r["start_epoch"] for r in resumed] == [1, 1]
    assert len(resumed[0]["steps"]) == per_epoch
    T.assert_losses_close(resumed[0]["steps"], one_steps[per_epoch:], tol=RESUME_TOL)

    # the 1 2 .dcp resumed in one process
    dcp = _data(env, "tp_train") / "0.dcp"
    assert dcp.is_dir()
    _, steps, _, engine, _ = _run_entry(
        env, "port", "finetune", "dcp_resume", ["--from_pretrained", str(dcp), "--resume"])
    assert engine.start_epoch == 1 and len(steps) == per_epoch
    T.assert_losses_close(steps, straight[0]["steps"][per_epoch:], tol=RESUME_TOL)


if __name__ == "__main__":
    worker_main(TASKS)
