"""Loader-fed training steps, as ``Engine.train_epoch`` feeds them in
``python -m youtube_vln_tpu_torch.entries.train`` (R2R fine-tuning) and
``entries.pretrain`` (YouTube pretraining).

Traffic parameters (``benchmark/traffic/<name>.json``): ``fixture`` (an
R2R or YouTube data set, ``benchmark/datasets.py``), ``split`` (R2R),
``batch_size`` (instructions per step), ``run`` (``RunConfig`` fields:
tasks, optimizer, schedule, transport, workers), ``geometry`` (more
``RunConfig`` fields, the data set's shapes), ``repeat`` (the epoch visits
each item this many times, each visit sampled anew from the seed, so that
no epoch ends inside the window), ``steps_per_epoch`` (the schedule's),
``checked_steps`` compared with the reference, ``warm_steps`` after them,
``trace_steps`` profiled right after the window in a traced run,
``instr_per_block`` (the reference's rows per block, in instructions).

Set-up builds one train step (model, ``AdamWRef`` state), drives it from
the seed through ``checked_steps`` steps of the window's own feed and
call, reads the first step's gradients from the optimizer's first moments
and the parameters' change after the last, and hands the same step to the
window.  The window: the ``Loader`` (its worker processes) over the data
set, ``device.prefetch_to_device`` and ``build_train_step``'s step, one
per batch, the device drained at the end.

Compared, each against ``benchmark/limits/<workload>.json``, with the
reference following the same steps from the same weights, batches and
dropout seeds (``reference/train.py``):
  loss_gap      the largest |loss - reference| / |reference| of the steps;
  grad_gap      the worst leaf's gap between the norms of the first
                step's gradients, over the larger of that leaf's reference
                norm and the median leaf's;
  change_gap    the same for the parameters' change after the last checked
                step, over the leaves whose reference gradient is at least
                a thousandth of the median leaf's;
  grad_diff     the median leaf's norm of the difference of the first
                step's gradients, over the same denominator: the norms above
                are second-order in an error of random direction and do not
                separate bfloat16 from float8, this does, and the median
                leaf is steady from seed to seed where the worst is not;
  bad_losses    non-finite losses among the window's steps (limit 0).
"""
from __future__ import annotations

import statistics
import tempfile
import time

import numpy as np
import torch

from benchmark import counts, datasets, harness, program, trace
from benchmark.reference import lily as ref_lily
from benchmark.reference import train as ref_train

NOUGHT = 1e-3      # a gradient under this share of the median leaf's is nought


def leaf_gap(prog, ref, names=None) -> float:
    names = list(ref) if names is None else names
    median = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in names)


def moved_leaves(ref_grads) -> list:
    median = statistics.median(ref_grads.values())
    return [k for k, g in ref_grads.items() if g >= NOUGHT * median]


def _dataset(traffic, args, paths, seed):
    from youtube_vln_tpu_torch.data.datasets import YTbDataset
    from youtube_vln_tpu_torch.data.features_reader import (PanoFeaturesReader,
                                                            YTbFeaturesReader)
    from youtube_vln_tpu_torch.data.tokenizer import load_tokenizer
    from youtube_vln_tpu_torch.training.engine import Subset, load_beam_dataset
    if traffic["fixture"]["kind"] == "r2r":
        ds = load_beam_dataset(traffic["split"], args,
                               load_tokenizer(paths["vocab_path"]),
                               PanoFeaturesReader(args.img_feature), training=True)
    else:
        ds = YTbDataset(args=args, caption_path=paths["caption_path"],
                        tokenizer=load_tokenizer(paths["vocab_path"]),
                        features_reader=YTbFeaturesReader(paths["store_path"]),
                        masked_vision=args.masked_vision,
                        masked_language=args.masked_language, training=True,
                        seed=seed)
    return Subset(ds, np.tile(np.arange(len(ds)), traffic["repeat"]))


def run(run: harness.Run, seconds: float, device, started: float, build_dir,
        faults=()):
    from youtube_vln_tpu_torch.config import RunConfig
    from youtube_vln_tpu_torch.data.loader import Loader
    from youtube_vln_tpu_torch.parallel.train_step import (build_train_step,
                                                           create_train_state)

    traffic, model = run.cell.traffic, run.model
    program.prepare(build_dir, device)
    tmp = tempfile.TemporaryDirectory(prefix="bench_train_")
    paths = datasets.build(tmp.name, traffic["fixture"], run.seed,
                           traffic.get("split", "train"))
    fields = dict(traffic["run"], **traffic.get("geometry", {}))
    if "data_dir" in paths:
        fields.update(data_dir=paths["data_dir"], img_feature=paths["store_path"],
                      bert_tokenizer=paths["vocab_path"])
    else:
        fields.update(skeleton_path=paths["skeleton_path"])
    args = RunConfig(batch_size=traffic["batch_size"], seed=run.seed, **fields)
    args.validate()
    ds = _dataset(traffic, args, paths, run.seed)
    loader = Loader(ds, traffic["batch_size"], shuffle=True, seed=run.seed,
                    drop_last=True, prefetch=args.host_prefetch,
                    num_workers=args.num_workers)
    cfg, net = program.model(run, device)
    optimizer, _ = create_train_state(net, args, traffic["steps_per_epoch"])
    step = build_train_step(net, cfg, args, optimizer, device)
    if "frozen_state" in faults:
        optimizer.step = lambda *a, **k: None
    if "half_batch" in faults:
        inner = step

        def step(batch, seed, inner=inner):
            return inner({k: v[: v.shape[0] // 2] for k, v in batch.items()}, seed)

    bs, nc = traffic["batch_size"], loader.nc
    s_t, s_v = args.max_instruction_length, args.max_path_length * args.max_num_boxes
    run.bounds_s = counts.kernel_bounds_s(model, bs * nc, s_t, s_v, train=True)
    run.expected_launches = counts.expected_launches(model, bs * nc, s_t, s_v, True)
    seeds = np.random.default_rng(run.seed)
    feed = program.Feed(loader, device, args.host_prefetch)
    take = feed.take

    def next_seed() -> int:
        return int(seeds.integers(0, 2 ** 64, dtype=np.uint64))

    # the checked steps, through the window's own feed and step
    checked, prog = [], {"losses": []}
    names = dict(net.named_parameters())
    for i in range(traffic["checked_steps"]):
        host, dev = take()
        seed = next_seed()
        metrics = step(dev, seed)
        checked.append((host, seed))
        prog["losses"].append(float(metrics["loss/train"]))
        if i == 0:
            first = {k: (optimizer.state[p]["exp_avg"] / (1.0 - optimizer.B1)).cpu()
                     if p in optimizer.state else torch.zeros(p.shape)
                     for k, p in names.items()}
            prog["grads"] = {k: float(g.norm()) for k, g in first.items()}
    start = ref_lily.make_weights(model, run.seed, device)
    with torch.no_grad():
        prog["change"] = {k: float((p - start[k]).norm()) for k, p in names.items()}
    del start
    for _ in range(traffic["warm_steps"]):
        step(take()[1], next_seed())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.setup_s = time.time() - started

    host_wait = harness.Spans("host_wait")
    losses, totals = [], dict(traj=0, n=0, flops=0.0)
    per_traj = counts.train_flops(model, s_t, s_v)

    def one():
        host, dev = host_wait(take)
        with trace.span("step"):
            losses.append(step(dev, next_seed())["loss/train"])
        opt = host["opt_mask"].astype(bool)
        lang = min(s_t, 32) if model["masked_language"] else 0
        vis = host["image_targets_idx"].shape[-1] if model["masked_vision"] else 0
        totals["traj"] += int(opt.sum())
        totals["flops"] += int(opt.sum()) * (per_traj + 3 * counts.head_flops(model, lang, vis))
        totals["n"] += 1

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.window_s = time.perf_counter() - t0
    run.units = run.attempted = totals["n"]
    run.work, run.flops = totals["traj"], totals["flops"]
    run.host_wait_ms = list(host_wait.ms)
    run.end_to_end = {"train_traj_per_s": totals["traj"] / run.window_s}
    if run.trace:
        # a traced segment after the window, in the same steady state
        n = traffic["trace_steps"]
        harness.traced_segment(run, device, lambda: [one() for _ in range(n)], n)
    run.memory_peak_bytes = program.peak_and_free(device)
    bad = int(sum(not np.isfinite(float(x)) for x in losses))
    run.failed = bad
    feed.close()
    del step, net, optimizer, names, losses
    if device.type == "cuda":
        torch.cuda.empty_cache()

    run.samples = checked
    t_check = time.perf_counter()
    run.reference = follow(run, checked, device, traffic["instr_per_block"],
                           against=first)
    prog["diff"] = run.reference.pop("diff")
    run.readings = prog
    run.check_s = time.perf_counter() - t_check
    run.checks = harness.compared(gaps(prog, run.reference), run.cell.limits)
    run.checks.append(("bad_losses", bad, 0))
    tmp.cleanup()


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers compared, of ``prog``'s readings against ``ref``'s."""
    median = statistics.median(ref["grads"].values())
    return {"loss_gap": max(abs(p - r) / abs(r)
                            for p, r in zip(prog["losses"], ref["losses"])),
            "grad_gap": leaf_gap(prog["grads"], ref["grads"]),
            "change_gap": leaf_gap(prog["change"], ref["change"],
                                   moved_leaves(ref["grads"])),
            "grad_diff": statistics.median(d / max(ref["grads"][k], median)
                                           for k, d in prog["diff"].items())}


def follow(run: harness.Run, checked, device, instr_per_block: int,
           num=ref_lily.F32, against=None, keep_first: bool = False) -> dict:
    """The reference's losses, first-step gradient norms and change norms
    over the checked steps, from the seed's weights; with ``against`` (the
    first step's gradients by name, on the host) the norm of each leaf's
    difference from them ("diff"); with ``keep_first`` its own first-step
    gradients on the host ("first")."""
    out = {}

    def on_first(grads):
        if against is not None:
            out["diff"] = {k: float((g - against[k].to(g.device)).norm())
                           for k, g in grads.items()}
        if keep_first:
            out["first"] = {k: g.cpu() for k, g in grads.items()}

    with program.NoTF32():
        weights = ref_lily.make_weights(run.model, run.seed, device)
        losses, grads = ref_train.follow_steps(
            weights, run.model, _reference_run(run), [h for h, _ in checked],
            [s for _, s in checked], num, instr_per_block, on_first)
        start = ref_lily.make_weights(run.model, run.seed, device)
        change = {k: float((weights[k] - start[k]).norm()) for k in grads}
        del weights, start
    return dict(out, losses=losses, grads=grads, change=change)


def _reference_run(run: harness.Run) -> dict:
    """The traffic's run settings that the reference's losses and update
    read."""
    r = run.cell.traffic["run"]
    out = {k: r[k] for k in ("ranking", "traj_judge", "masked_vision",
                             "masked_language", "pretrain", "num_negatives",
                             "traj_loss_scale", "learning_rate", "weight_decay",
                             "warmup_proportion", "lr_schedule", "num_epochs",
                             "cooldown_factor")}
    out["steps_per_epoch"] = run.cell.traffic["steps_per_epoch"]
    return out
