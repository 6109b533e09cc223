"""Data-parallel training of the port (``youtube_vln_tpu_torch/parallel/
distributed.py``, ``parallel/train_step.py``, ``training/engine.py``) on 2
CPU processes over gloo, against the JAX package's single-process ``Engine``
and the port's own single process, at the model config of
``tests/test_torch_engine.py`` (2/1/1 layers, head dim 64 at the vision and
co-attention sites, 32 boxes: those sites take the B1-B4 autograd
Functions, their plain versions here), f32, dropout off:

  * 30RS at accumulation 1 and 2: the 2-rank ``Engine``'s per-step global
    losses equal the JAX ``Engine``'s on the same global batches within
    1e-4 (``shard_indices`` deals ``order[r::2]`` to rank r, so step k's
    global batch is the same set of items), and the ranks' parameters are
    bitwise equal after the epoch;
  * ``evaluate`` on 2 ranks equals the one-process dict on the same global
    batches (accuracy exactly, losses 1e-5); the splits hold 15 items, so
    ``shard_indices`` wrap-pads one;
  * a ``--orbax_checkpoints`` save of the 2 ranks, loaded in one process,
    gives the parameters and optimizer state of rank 0's ``.bin``.

``tests/test_torch_distributed_entry.py`` holds the rest: the global loss
normalizers, the Philox offsets, the entries' save decision and
``initialize``.

Each test that starts processes runs this file as a script, one process per
rank, on a free port with a timeout of at most 120 s."""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
TIMEOUT_S = 110


# --------------------------------------------------------------------------- #
# launching ranks
# --------------------------------------------------------------------------- #
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return env


def run_ranks(script: Path, task: str, spec: dict, out: Path,
              world: int = WORLD, timeout: float = TIMEOUT_S) -> list:
    """Runs ``script task spec.json`` as ranks 0 .. world-1 of a gloo group;
    returns what each rank saved to ``out/<task>.rank<r>.pt``.  A rank that
    fails or outlives ``timeout`` fails the test, and none is left
    running."""
    out.mkdir(parents=True, exist_ok=True)
    spec_path = out / f"{task}.json"
    spec_path.write_text(json.dumps(dict(spec, out=str(out))))
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(script), task, str(spec_path)],
                              cwd=REPO, env=rank_env(r, world, port),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(0.1, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{task}: a rank outlived its {timeout} s timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{task}, rank {r}:\n{log[-6000:]}"
    return [torch.load(out / f"{task}.rank{r}.pt", weights_only=False)
            for r in range(world)]


def worker_main(tasks: dict) -> None:
    """The entry of a rank: join the group, run ``tasks[argv[1]]`` on the
    spec, save its result."""
    task, spec_path = sys.argv[1], sys.argv[2]
    spec = json.loads(Path(spec_path).read_text())
    sys.path.insert(0, str(REPO / "tests"))
    torch.set_num_threads(1)
    from youtube_vln_tpu_torch.parallel import distributed
    distributed.initialize("cpu", timeout_s=60)
    result = tasks[task](spec)
    torch.save(result, Path(spec["out"]) / f"{task}.rank{distributed.rank()}.pt")
    torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------- #
# rank tasks
# --------------------------------------------------------------------------- #
def _engine_task(spec):
    """An ``Engine`` on its rank: ``evaluate`` of the named splits, one
    training epoch with every step's global metrics and the target twins
    of the rank's rows recorded, then the parameters and, with ``save``,
    a collective ``.dcp`` save and rank 0's ``.bin``."""
    import test_torch_engine as T
    from youtube_vln_tpu_torch.parallel import distributed
    from youtube_vln_tpu_torch.training import checkpoint as ckpt
    from youtube_vln_tpu_torch.training import engine as pengine
    from youtube_vln_tpu_torch.utils import cli, entry

    _, args = cli.parse_run_config(spec["argv"])
    folder = Path(spec["out"]) / "checkpoints"
    engine = pengine.Engine(args, entry.build_model_config(args),
                            save_folder=folder, device="cpu")
    evals = {name: engine.evaluate(name) for name in spec.get("evaluate", [])}
    steps = []
    train_step = engine._train_step

    def recording(batch, seed):
        metrics = train_step(batch, seed)
        steps.append(({k: float(v) for k, v in metrics.items()},
                      T.target_twins({k: v.numpy() for k, v in batch.items()})))
        return metrics

    engine._train_step = recording
    engine.train_epoch(0)
    out = {"steps": steps, "evals": evals,
           "step_batch": engine.step_batch,
           "params": {n: p.detach().clone()
                      for n, p in engine.model.named_parameters()}}
    if spec.get("save"):
        out["dcp"] = engine.save("ddp", 0)
        if distributed.is_main_process():
            out["bin"] = ckpt.save_checkpoint(
                folder, "ddp_bin", engine.model, engine.cfg,
                optimizer=engine.optimizer,
                step=engine.optimizer.step_count, epoch=0)
    engine.close()
    return out


TASKS = {"engine": _engine_task}


# --------------------------------------------------------------------------- #
# the tests
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def env(tmp_path_factory):
    import test_torch_engine as T
    env = T.build_env(tmp_path_factory.mktemp("ddp"))
    fast = env["root"] / "d64_fast_mode.json"
    fast.write_text(json.dumps({**json.loads(Path(env["config_file"]).read_text()),
                                "fast_mode": True}))
    env["fast_mode_config_file"] = str(fast)
    return env


def _finetune_argv(env, pkg, accum, extra=()):
    """Accumulation 2 runs with ``fast_mode`` on, in both packages: a no-op
    on the flattened step batch, which the port's step accepts under a data
    axis as the JAX step does."""
    import test_torch_engine as T
    model = (["--config_file", env["fast_mode_config_file"]] if accum == 2
             else [])
    return T.flags(env, pkg, "finetune", ["--batch_size", "4",
                                          "--gradient_accumulation_steps",
                                          str(accum), *model, *extra])


@pytest.fixture(scope="module")
def ddp_runs(env):
    """The 2-rank engine runs, cached: accumulation 1 with the evaluations
    and the saves, accumulation 2 with neither."""
    cache = {}

    def run(accum):
        if accum not in cache:
            spec = {"argv": _finetune_argv(env, "port", accum,
                                           ["--orbax_checkpoints"] if accum == 1
                                           else [])}
            if accum == 1:
                spec.update(evaluate=["val_seen", "val_unseen"], save=True)
            cache[accum] = run_ranks(Path(__file__), "engine", spec,
                                     env["root"] / f"ddp_accum{accum}")
        return cache[accum]

    return run


@pytest.mark.parametrize("accum", [1, 2])
def test_ddp_finetune_losses_match_jax(env, ddp_runs, accum):
    import test_torch_engine as T
    ranks = ddp_runs(accum)
    assert [r["step_batch"] for r in ranks] == [4 // accum // WORLD] * WORLD
    # the metrics are the global batch's: the same on both ranks
    assert [m for m, _ in ranks[0]["steps"]] == [m for m, _ in ranks[1]["steps"]]
    got = [(m, t0 + t1) for (m, t0), (_, t1) in zip(ranks[0]["steps"],
                                                     ranks[1]["steps"])]
    engine = T.make_engine("jax", _finetune_argv(env, "jax", accum))
    steps = T.record_steps("jax", engine)
    engine.train_epoch(0)
    engine.close()
    want = T.to_floats(steps)
    assert len(got) == len(want) == 3
    T.assert_losses_close(got, want)
    assert len({m["loss/train"] for m, _ in got}) > 1
    # one update on every rank: the replicas stay bitwise equal
    p0, p1 = ranks[0]["params"], ranks[1]["params"]
    assert p0.keys() == p1.keys()
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_ddp_evaluate_matches_one_process(env, ddp_runs):
    """Both ranks return the dict of one process that evaluates the same
    global batches: the split of 15 padded to 16 by wrapping item 0."""
    from youtube_vln_tpu_torch.data.loader import Loader
    from youtube_vln_tpu_torch.training import engine as pengine
    import test_torch_engine as T

    ranks = ddp_runs(1)
    assert ranks[0]["evals"] == ranks[1]["evals"]
    one = T.make_engine("port", _finetune_argv(env, "port", 1))
    want = {}
    for name in ("val_seen", "val_unseen"):
        ds = one.eval_loaders[name].dataset
        assert len(ds) % WORLD == 1
        padded = np.concatenate([np.arange(len(ds)), [0]])
        one.eval_loaders[name] = Loader(pengine.Subset(ds, padded), 4,
                                        shuffle=False, seed=one.args.seed,
                                        drop_last=False, num_workers=0)
        want[name] = one.evaluate(name)
    one.close()
    got = ranks[0]["evals"]
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k, v in want[name].items():
            if k.startswith("accuracy/"):
                assert got[name][k] == v, (name, k)
            else:
                np.testing.assert_allclose(got[name][k], v, rtol=1e-5,
                                           err_msg=(name, k))


def test_dcp_save_loads_as_the_bin_in_one_process(env, ddp_runs):
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.parallel import train_step as ts
    from youtube_vln_tpu_torch.training import checkpoint as ckpt
    from youtube_vln_tpu_torch.utils import cli, entry

    ranks = ddp_runs(1)
    dcp_dir = Path(ranks[0]["dcp"])
    assert ranks[1]["dcp"] == str(dcp_dir) and ckpt.is_dcp_checkpoint(dcp_dir)
    assert dcp_dir.name == "ddp.dcp"
    # both ranks wrote a share of the tensors
    assert len(list(dcp_dir.glob("*.distcp"))) == WORLD
    _, args = cli.parse_run_config(_finetune_argv(env, "port", 1))
    cfg = entry.build_model_config(args)
    loaded = {}
    for kind in ("dcp", "bin"):
        model = Lily(cfg, device="cpu").init_weights(99)
        optimizer, _ = ts.create_train_state(model, args, 3)
        missing, unexpected, step, epoch = ckpt.load_checkpoint(
            ranks[0][kind], model, optimizer)
        assert (step, epoch, optimizer.step_count) == (3, 0, 3), kind
        assert kind == "bin" or not (missing or unexpected)
        loaded[kind] = (model, ckpt.optimizer_state_by_name(model, optimizer))
    (m_dcp, o_dcp), (m_bin, o_bin) = loaded["dcp"], loaded["bin"]
    for (n, a), (_, b) in zip(m_dcp.state_dict().items(),
                              m_bin.state_dict().items()):
        assert torch.equal(a, b), n
    for n, p in m_dcp.named_parameters():
        assert torch.equal(p, ranks[0]["params"][n]), n
    assert o_dcp["step_count"] == o_bin["step_count"] == 3
    for k in ("exp_avg", "exp_avg_sq"):
        assert o_dcp[k].keys() == o_bin[k].keys() and len(o_dcp[k]) > 100
        for n in o_dcp[k]:
            assert torch.equal(o_dcp[k][n], o_bin[k][n]), (k, n)
    # the prune of delete_checkpoint takes the directory
    ckpt.delete_checkpoint(dcp_dir.parent, "ddp")
    assert not dcp_dir.exists()


if __name__ == "__main__":
    worker_main(TASKS)
