"""Data parallelism of the port, second part (the first is
``tests/test_torch_distributed.py``, whose launcher this file uses): on 2
CPU processes over gloo at the model config of ``tests/test_torch_engine.py``
and in one process,

  * the global loss normalizers: a four-task MRT batch whose masked counts
    differ between the ranks gives the 2-rank step the one-process
    gradient of the whole batch within 1e-5, where per-rank normalizers
    averaged over the ranks (the reference's pmean) miss it by more than
    1e-3;
  * the Philox offsets: ``dropout_keep`` / ``epilogue_keep`` at offset 0 are
    today's masks, and rank r's mask is slice r of the global one; so are
    the outputs and gradients of the B1-B6 wrappers (their plain versions
    on the CPU) and the sites' offsets of ``DropoutRng``;
  * the entries' save decision: with rank 1 made to see another
    validation accuracy, both ranks take rank 0's decision, save the
    ``.dcp`` directories together and end;
  * ``initialize``: a no-op without launcher variables; it raises on a
    failed rendezvous, on a rank without a world size, and on a
    ``LOCAL_RANK`` beyond the device count; and a JAX ``.orbax`` directory
    is refused with the ``.bin`` to write instead."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import (REPO, WORLD, free_port, rank_env,
                                    run_ranks, worker_main)
from youtube_vln_tpu_torch.models.layers import DropoutRng
from youtube_vln_tpu_torch.ops import attention as A
from youtube_vln_tpu_torch.ops import epilogue as E
from youtube_vln_tpu_torch.ops import philox
from youtube_vln_tpu_torch.parallel import distributed

GRAD_TOL, NAIVE_MISS = 1e-5, 1e-3
RATE = 0.1


# --------------------------------------------------------------------------- #
# rank tasks
# --------------------------------------------------------------------------- #
class GradientCapture:
    """Stands in for the optimizer of ``build_train_step``: keeps the
    gradients it would apply, and moves nothing."""

    def __init__(self, model):
        self.model = model
        self.step_count = 0
        self.grads = None

    def step(self):
        self.grads = {n: p.grad.detach().clone()
                      for n, p in self.model.named_parameters()
                      if p.grad is not None}

    def zero_grad(self, set_to_none=True):
        self.model.zero_grad(set_to_none=set_to_none)


def step_gradients(argv, weights, batch):
    """(gradients, metrics) of one ``build_train_step`` step of the model
    loaded from ``weights`` on ``batch``: DDP-wrapped under a group."""
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.parallel import train_step as ts
    from youtube_vln_tpu_torch.training import checkpoint as ckpt
    from youtube_vln_tpu_torch.utils import cli, entry

    _, args = cli.parse_run_config(argv)
    cfg = entry.build_model_config(args)
    model = Lily(cfg, device="cpu").init_weights(args.seed)
    ckpt.load_checkpoint(weights, model)
    capture = GradientCapture(model)
    metrics = ts.build_train_step(model, cfg, args, capture, device="cpu")(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}, 7)
    return capture.grads, {k: float(v) for k, v in metrics.items()}


def _grad_task(spec):
    with np.load(spec["batch"]) as f:
        batch = {k: f[k] for k in f.files}
    rows = len(batch["opt_mask"]) // distributed.world_size()
    r = distributed.rank()
    half = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
    grads, metrics = step_gradients(spec["argv"], spec["weights"], half)
    return {"grads": grads, "metrics": metrics}


def _entry_task(spec):
    """``entries.train.main`` on its rank; rank 1's validation accuracies
    are replaced by -1, below every best, so that a decision of its own
    would skip the saves that rank 0 makes."""
    from youtube_vln_tpu_torch.entries import train as train_entry
    from youtube_vln_tpu_torch.training.engine import Engine

    evaluate = Engine.evaluate

    def seen_by_rank1(self, name, epoch=0):
        out = evaluate(self, name, epoch)
        return dict(out, **{"accuracy/ranking": -1.0})

    if distributed.rank() == 1:
        Engine.evaluate = seen_by_rank1
    best = train_entry.main(spec["argv"])
    return {"best": best}


TASKS = {"grad": _grad_task, "entry": _entry_task}


# --------------------------------------------------------------------------- #
# the global normalizers
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def env(tmp_path_factory):
    import test_torch_engine as T
    return T.build_env(tmp_path_factory.mktemp("ddp_entry"))


def _mrt_counts(batch, rows):
    """Per rank: masked-language targets and masked-vision regions of the
    real candidates."""
    out = []
    for r in range(WORLD):
        part = slice(r * rows, (r + 1) * rows)
        real = batch["opt_mask"][part][..., None]
        lang = int(((batch["instr_targets"][part] >= 0) & real).sum())
        s_v = batch["image_mask"].shape[-1] if "image_mask" in batch else \
            batch["uniq_image_mask"].shape[-1]
        vis = int(((batch["image_targets_idx"][part] < s_v) & real).sum())
        out.append((lang, vis))
    return out


def test_mrt_gradient_takes_the_global_normalizers(env, tmp_path):
    """A four-task batch of 4 whose halves hold different masked counts: the
    2-rank gradient is the one-process gradient of the whole batch."""
    import test_torch_engine as T
    argv = T.flags(env, "port", "pretrain", ["--batch_size", "4"])
    engine = T.make_engine("port", argv)
    engine.train_loader.set_epoch(0)
    batch = next(iter(engine.train_loader))
    engine.close()
    rows = len(batch["opt_mask"]) // WORLD
    counts = _mrt_counts(batch, rows)
    assert counts[0][0] != counts[1][0] or counts[0][1] != counts[1][1], counts
    np.savez(tmp_path / "batch.npz", **batch)

    ranks = run_ranks(Path(__file__), "grad",
                      {"argv": argv, "weights": env["weights"],
                       "batch": str(tmp_path / "batch.npz")}, tmp_path)
    want, want_metrics = step_gradients(argv, env["weights"], batch)
    halves = [step_gradients(argv, env["weights"],
                             {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()})
              for r in range(WORLD)]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for k, v in want_metrics.items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)

    def miss(grads):
        assert grads.keys() == want.keys()
        scale = max(float(g.abs().max()) for g in want.values())
        return max(float((grads[k] - want[k]).abs().max()) for k in want) / scale

    assert ranks[0]["grads"].keys() == want.keys() and len(want) > 100
    for k in want:
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
    assert miss(ranks[0]["grads"]) <= GRAD_TOL
    # per-rank normalizers averaged over the ranks (the reference's pmean)
    naive = {k: (halves[0][0][k] + halves[1][0][k]) / WORLD for k in want}
    assert miss(naive) > NAIVE_MISS


# --------------------------------------------------------------------------- #
# the Philox offsets
# --------------------------------------------------------------------------- #
def _philox_words(seed, streams, rows, cols, direction):
    """The four words of the attention counters, straight from
    ``philox4x32``: today's definition of the mask."""
    return torch.stack(philox.philox4x32(
        rows[None, :, None], cols[None, None, :], streams[:, None, None],
        direction, philox.seed_key(seed)), dim=-1)


@pytest.mark.parametrize("direction", [0, 1])
def test_dropout_keep_offsets(direction):
    b, h, s_q, s_kv, seed = 4, 3, 37, 21, 0x1234_5678_9ABC
    full = philox.dropout_keep(seed, RATE, b, h, s_q, s_kv, direction)
    assert torch.equal(philox.dropout_keep(seed, RATE, b, h, s_q, s_kv,
                                           direction, stream0=0), full)
    # offset 0 is today's mask: the 2 x 2 groups of philox.cuh
    i, j = torch.arange(s_q), torch.arange(s_kv)
    words = _philox_words(seed, torch.arange(b * h), ((i >> 4) << 3) | (i & 7),
                          j >> 1, direction) >= philox.keep_threshold(RATE)
    word = ((i >> 3) & 1)[:, None] * 2 + (j & 1)[None, :]
    want = torch.gather(words, -1, word[None, :, :, None].expand(b * h, -1, -1, 1))
    assert torch.equal(full.view(b * h, s_q, s_kv), want[..., 0])
    # rank r's rows of the global mask
    rows = b // WORLD
    for r in range(WORLD):
        part = philox.dropout_keep(seed, RATE, rows, h, s_q, s_kv, direction,
                                   stream0=r * rows * h)
        assert torch.equal(part, full[r * rows:(r + 1) * rows])
    assert not torch.equal(full[:rows], full[rows:])


def test_epilogue_keep_offsets():
    n, d, seed = 10, 256, 99
    full = philox.epilogue_keep(seed, RATE, n, d)
    assert torch.equal(philox.epilogue_keep(seed, RATE, n, d, row0=0), full)
    words = torch.stack(philox.philox4x32(
        torch.arange(n)[:, None], torch.arange(d // 4)[None, :], 0,
        philox.EPILOGUE_DIRECTION, philox.seed_key(seed)), dim=-1)
    assert torch.equal(full, (words >= philox.keep_threshold(RATE)).view(n, d))
    for r0, r1 in ((0, 3), (3, 10), (7, 8)):
        assert torch.equal(philox.epilogue_keep(seed, RATE, r1 - r0, d, row0=r0),
                           full[r0:r1])


def _halves(*tensors):
    rows = tensors[0].shape[0] // WORLD
    return [[t[r * rows:(r + 1) * rows] for t in tensors] for r in range(WORLD)]


def _leaves(gen, *shapes):
    return [torch.randn(*s, generator=gen, dtype=torch.float64).float()
            .requires_grad_() for s in shapes]


def _check_halves(fn, inputs, rows_per_rank, offset_name):
    """``fn(*inputs)`` on the whole batch against ``fn`` on each half with
    its offset: outputs bitwise, gradients too."""
    full = fn(*inputs, **{offset_name: 0})
    full = full if isinstance(full, tuple) else (full,)
    cot = [torch.randn_like(o) for o in full]
    grads = torch.autograd.grad(full, inputs, cot, allow_unused=True)
    rows = inputs[0].shape[0] // WORLD
    for r in range(WORLD):
        part = [x.detach()[r * rows:(r + 1) * rows].requires_grad_() for x in inputs]
        out = fn(*part, **{offset_name: r * rows_per_rank})
        out = out if isinstance(out, tuple) else (out,)
        for o, f in zip(out, full):
            assert torch.equal(o, f[r * rows:(r + 1) * rows])
        g = torch.autograd.grad(out, part, [c[r * rows:(r + 1) * rows] for c in cot],
                                allow_unused=True)
        for gi, fi in zip(g, grads):
            if fi is not None and fi.shape[0] == inputs[0].shape[0]:
                assert torch.equal(gi, fi[r * rows:(r + 1) * rows])


def test_attention_wrappers_draw_the_global_rows():
    """B1/B3 and B2/B4 through their autograd Functions (plain versions on
    the CPU) at dropout 0.1: each half with stream0 = r * B/2 * H is that
    half of the whole batch, forward and backward."""
    gen = torch.Generator().manual_seed(3)
    b, h, s, d = 4, 2, 40, 64
    q, k, v = _leaves(gen, (b, h, s, d), (b, h, s, d), (b, h, s, d))
    bias = torch.zeros(b, s)

    def self_attention(q, k, v, stream0):
        return A.fused_attention(q, k, v, bias[:q.shape[0]], dropout_rate=RATE,
                                 seed=11, stream0=stream0)

    _check_halves(self_attention, [q, k, v], b // WORLD * h, "stream0")
    q1, k1, v1, q2, k2, v2 = _leaves(gen, *[(b, h, s, d)] * 3, *[(b, h, 12, d)] * 3)

    def co_attention(q1, k1, v1, q2, k2, v2, stream0):
        return A.fused_bi_attention(q1, k1, v1, q2, k2, v2, rate1=RATE,
                                    rate2=RATE, seed=12, stream0=stream0)

    _check_halves(co_attention, [q1, k1, v1, q2, k2, v2], b // WORLD * h, "stream0")


def test_epilogue_wrapper_draws_the_global_rows():
    """B5/B6 (plain versions on the CPU) at dropout 0.1: each half of the
    rows with row0 = its first row gives that half's out, dh and dres."""
    gen = torch.Generator().manual_seed(4)
    h, res = _leaves(gen, (6, 5, 128), (6, 5, 128))
    w, bias = torch.rand(128, generator=gen), torch.rand(128, generator=gen)

    def epilogue(h, res, row0):
        return E.fused_dropout_add_ln(h, res, w, bias, dropout_rate=RATE,
                                      seed=13, row0=row0)

    _check_halves(epilogue, [h, res], 3 * 5, "row0")


def test_dropout_rng_offsets_and_generators():
    """Rank 0 keeps today's generator; another rank folds its rank into the
    generator's seed; both take the same kernel seeds, at rank * rows."""
    r0, r1 = DropoutRng(5, "cpu"), DropoutRng(5, "cpu", rank=1)
    today = torch.Generator().manual_seed(philox.site_seed(5, 0))
    assert torch.equal(r0.generator.get_state(), today.get_state())
    assert not torch.equal(r0.generator.get_state(), r1.generator.get_state())
    assert [r0.kernel_seed() for _ in range(3)] == [r1.kernel_seed() for _ in range(3)]
    assert (r0.offset(96 * 8), r1.offset(96 * 8)) == (0, 96 * 8)
    assert DropoutRng(5, "cpu", rank=3).offset(10) == 30


# --------------------------------------------------------------------------- #
# the entries' save decision
# --------------------------------------------------------------------------- #
def test_save_decision_is_rank0s(env, tmp_path):
    """Rank 1 sees an accuracy of -1 on both splits; rank 0's saves of
    best_seen and best_unseen still happen on both ranks, collectively, and
    the run ends (a decision of rank 1's own would leave rank 0 waiting in
    the save until the timeout)."""
    import test_torch_engine as T
    out = tmp_path / "result"
    argv = T.flags(env, "port", "finetune", [
        "--batch_size", "4", "--device", "cpu", "--orbax_checkpoints",
        "--num_epochs", "1", "--save_epochs", "1", "--save_name", "ddp",
        "--output_dir", str(out)])
    ranks = run_ranks(Path(__file__), "entry", {"argv": argv}, tmp_path)
    assert ranks[0]["best"] == ranks[1]["best"]
    assert all(0.0 <= v <= 1.0 for v in ranks[0]["best"])
    data = out / "ddp" / "data"
    assert sorted(p.name for p in data.iterdir()) == [
        "0.dcp", "best_seen.dcp", "best_unseen.dcp"]
    # rank 0 alone wrote the run folder
    assert len(list((out / "ddp").glob("train*"))) == 1


# --------------------------------------------------------------------------- #
# initialize
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("env_vars", [
    {}, {"WORLD_SIZE": "1"}, {"SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
    {"RANK": "0", "LOCAL_RANK": "0"}], ids=range(4))
def test_initialize_without_launcher_is_a_noop(env_vars):
    """No launcher, or a launcher's single task without an address: one
    process, no group."""
    assert distributed.initialize("cpu", env=env_vars) == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (distributed.world_size(), distributed.rank()) == (1, 0)
    assert distributed.is_main_process()
    assert distributed.broadcast_host({"a": 1}) == {"a": 1}
    assert distributed.all_reduce_mean_host(2.5) == 2.5
    x = torch.ones(3)
    assert distributed.sum_across_ranks(x) is x


@pytest.mark.parametrize("env_vars,match", [
    ({"RANK": "1"}, "no world size"),
    ({"SLURM_PROCID": "2"}, "no world size"),
    ({"WORLD_SIZE": "1", "RANK": "1"}, "no world size"),
    ({"SLURM_NTASKS": "4"}, "cannot join"),
    ({"WORLD_SIZE": "2", "RANK": "0"}, "cannot join"),
    ({"WORLD_SIZE": "2", "RANK": "2", "MASTER_ADDR": "127.0.0.1",
      "MASTER_PORT": "1"}, "cannot join"),
], ids=range(6))
def test_initialize_refuses_a_job_it_cannot_join(env_vars, match):
    with pytest.raises(RuntimeError, match=match):
        distributed.initialize("cpu", env=env_vars)
    assert not torch.distributed.is_initialized()


def test_initialize_raises_on_a_local_rank_beyond_the_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    assert distributed.local_device(torch.device("cuda"), {"LOCAL_RANK": "1"}) \
        == torch.device("cuda", 1)
    for local in ("2", "7"):
        with pytest.raises(RuntimeError, match=f"LOCAL_RANK={local} names no device"):
            distributed.initialize("cuda", env={"LOCAL_RANK": local, "WORLD_SIZE": "8",
                                                "RANK": local})
    assert not torch.distributed.is_initialized()


def test_initialize_raises_on_a_failed_rendezvous():
    """Rank 0 of 2 with no rank 1: the rendezvous times out and the
    process fails, rather than training alone."""
    code = ("from youtube_vln_tpu_torch.parallel import distributed\n"
            "distributed.initialize('cpu', timeout_s=3)\n"
            "print('trained alone')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=rank_env(0, WORLD, free_port()), capture_output=True,
                       text=True, timeout=100)
    assert r.returncode != 0
    assert "trained alone" not in r.stdout
    assert "rendezvous of rank 0 of 2" in r.stderr, r.stderr[-3000:]


def test_orbax_directory_refused(tmp_path):
    from youtube_vln_tpu_torch import tiny_config
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.training import checkpoint as ckpt
    orbax_dir = tmp_path / "best_seen.orbax"
    orbax_dir.mkdir()
    (orbax_dir / "_CHECKPOINT_METADATA").write_text("{}")
    assert ckpt.is_orbax_checkpoint(orbax_dir) and not ckpt.is_dcp_checkpoint(orbax_dir)
    model = Lily(tiny_config(), device="cpu")
    with pytest.raises(ValueError, match=r"needs orbax.*best_seen\.bin"):
        ckpt.load_checkpoint(orbax_dir, model)


if __name__ == "__main__":
    worker_main(TASKS)
