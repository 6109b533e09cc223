"""Each cell's run, with the timed path broken underneath, comes out not
correct: a fault the cell can have is planted in the program (the harness's
look for a card skipped, the cell cut to CPU size); unbroken, it comes out
correct.  The limits are the cell's own (``benchmark/limits``)."""
import pytest

from benchmark.tests import small

CASES = [("rerank.r2r_val_bs1", ()), ("rerank.r2r_val_bs1", ("altered_answer",)),
         ("rerank.r2r_val_bs1", ("half_batch",)),
         ("rerank.r2r_val_bs1", ("permuted_beams",)),
         ("finetune.30rs", ()), ("finetune.30rs", ("frozen_state",)),
         ("finetune.30rs", ("half_batch",)),
         ("pretrain.mrt_ytb", ()), ("pretrain.mrt_ytb", ("frozen_state",)),
         ("pretrain.mrt_ytb", ("half_batch",))]


@pytest.mark.parametrize("name,faults", CASES)
def test_faults_fail_and_sound_runs_pass(name, faults, monkeypatch):
    small.fuse_everywhere(monkeypatch)
    run = small.run(small.cell(name), faults=faults)
    from benchmark import harness
    out = harness.report(run, "cpu")
    assert out["correct"] is (not faults), out["compared"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("name", ["rerank.r2r_val_bs1", "finetune.30rs",
                                  "pretrain.mrt_ytb"])
def test_control_reads_far_above_the_program(name, monkeypatch):
    """The float8 control in the program's place, at this size: one of the
    cell's numbers reads a hundred times the program's own (float32 here).
    At the cell's own size the cuda test below holds it to the limits."""
    import torch
    from benchmark import calibrate
    small.fuse_everywhere(monkeypatch)
    run = small.run(small.cell(name))
    program = {k: v for k, v, _ in run.checks}
    control = calibrate.control(run, torch.device("cpu"))
    assert any(v > 100 * max(program[k], 1e-9) for k, v in control.items()
               if k in program), (program, control)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rerank.r2r_val_bs1", "finetune.30rs",
                                  "pretrain.mrt_ytb"])
def test_control_fails_on_the_card(name, card):
    """At the cell's own size on the card: the program passes, its float8
    control fails (three seeds and more are read by ``calibrate.py``)."""
    import time
    from benchmark import calibrate, harness
    cell = harness.load_cell(name)
    run = harness.Run(cell=cell, model=harness.model_dict(cell.config),
                      seed=2 ** 31 + 99, trace=False)
    harness.load_module("drivers", cell.traffic["driver"]).run(
        run, seconds=3.0, device=card, started=time.time(),
        build_dir=harness.use_cache_dirs())
    assert harness.verdict(run)
    readings = calibrate.control(run, card)
    assert any(v > cell.limits[k] for k, v in readings.items()
               if k in cell.limits), readings
