"""Closed-loop beam re-ranking, as ``python -m youtube_vln_tpu_torch.entries.test``
scores a split: one client, one request at a time.

Traffic parameters (``benchmark/traffic/<name>.json``): ``fixture`` (an
R2R data set, ``benchmark/datasets.py``), ``split``, ``batch_size``
(instructions per request), ``run`` (``RunConfig`` fields: the transport
and the host pipeline), ``warm_requests`` scored before the window,
``trace_requests`` profiled right after the window in a traced run,
``check_requests`` compared with the reference afterwards.

The window drives the program's ``Loader`` over ``BeamDataset`` (eval
items, in an order drawn from the seed), ``device.prefetch_to_device`` and
``build_score_step``; each request's scores are read back to the host
before the next request is taken.  A request is due when the previous
request's scores reach the host; its latency runs from then until its own
scores are on the host.  The requests compared are a uniform sample of
the window's, drawn from the seed (a reservoir holding each sampled
request's host batch and served scores).

Compared, each against ``benchmark/limits/<workload>.json``:
  score_gap    the widest gap between a served score and the reference's
               over the real beams of the sampled requests, each side less
               its mean over the request's real beams, divided by the
               median over the sampled requests of the spread (largest less
               smallest) of the reference's scores of a request's real
               beams.  Re-ranking reads how the beams of one request stand
               to each other, so a shift common to them is no error and a
               gap is measured against the typical difference between
               them; a swap of two beams reads about 1.  (Divided by each
               request's own spread instead, the rounding of requests whose
               beams lie close together reads as error.)
  bad_scores   real beams scored non-finite or padded beams scored other
               than -inf, over every request of the window (limit 0).
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


def _bad(scores: np.ndarray, opt: np.ndarray) -> int:
    return int((~np.isfinite(scores[opt])).sum()
               + (scores[~opt] != -np.inf).sum())


def run(run: harness.Run, seconds: float, device, started: float, build_dir,
        faults=()):
    from youtube_vln_tpu_torch.config import RunConfig
    from youtube_vln_tpu_torch.data.features_reader import PanoFeaturesReader
    from youtube_vln_tpu_torch.data.loader import Loader
    from youtube_vln_tpu_torch.evaluation.beam_eval import build_score_step
    from youtube_vln_tpu_torch.training.engine import (load_beam_dataset,
                                                       resolve_tokenizer)

    traffic, model = run.cell.traffic, run.model
    program.prepare(build_dir, device)
    tmp = tempfile.TemporaryDirectory(prefix="bench_r2r_")
    paths = datasets.build(tmp.name, traffic["fixture"], run.seed, traffic["split"])
    args = RunConfig(data_dir=paths["data_dir"], img_feature=paths["store_path"],
                     bert_tokenizer=paths["vocab_path"], num_beams=1,
                     batch_size=traffic["batch_size"], ranking=True,
                     seed=run.seed, **traffic["run"])
    args.validate()
    reader = PanoFeaturesReader(args.img_feature)
    ds = load_beam_dataset(traffic["split"], args, resolve_tokenizer(args),
                           reader, training=False)
    loader = Loader(ds, traffic["batch_size"], shuffle=True, seed=run.seed,
                    drop_last=False, num_candidates=ds.max_beam_count(),
                    with_instr_id=True, prefetch=args.host_prefetch,
                    num_workers=args.num_workers)
    cfg, net = program.model(run, device)
    score = build_score_step(net, cfg, device)
    score = _faulty(score, faults)

    s_t, s_v = args.max_instruction_length, args.max_path_length * args.max_num_boxes
    nc = loader.nc
    rows = traffic["batch_size"] * nc
    run.bounds_s = counts.kernel_bounds_s(model, rows, s_t, s_v, train=False)
    run.expected_launches = counts.expected_launches(model, rows, s_t, s_v, False)
    beam_flops = 2 * counts.encoder_macs(model, s_t, s_v) + counts.head_flops(model)
    block_flops = 2 * counts.visual_embedding_macs(model, args.max_num_boxes)

    feed = program.Feed(loader, device, args.host_prefetch, drop=("instr_id",))
    take = feed.take

    for _ in range(traffic["warm_requests"]):
        score(take()[1]).cpu()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.setup_s = time.time() - started

    host_wait = harness.Spans("host_wait")
    rng = np.random.default_rng(run.seed)
    reservoir, lat = [], []
    totals = dict(beams=0, flops=0.0, bad=0, n=0)

    def one(t_prev):
        host, dev = host_wait(take)
        with trace.span("score"):
            out = score(dev)
        with trace.span("readback"):
            scores = out.cpu().numpy()
        t = time.perf_counter()
        lat.append((t - t_prev) * 1e3)
        opt = host["opt_mask"].astype(bool)
        totals["beams"] += int(opt.sum())
        totals["bad"] += _bad(scores, opt)
        for b in range(opt.shape[0]):
            blocks = (len(np.unique(host["step_index"][b][opt[b]]))
                      if "step_index" in host
                      else int(opt[b].sum()) * args.max_path_length)
            totals["flops"] += beam_flops * int(opt[b].sum()) + block_flops * blocks
        j = totals["n"]
        totals["n"] += 1
        if not sampling:
            return t
        if j < traffic["check_requests"]:
            reservoir.append((host, scores))
        else:
            r = int(rng.integers(0, j + 1))
            if r < traffic["check_requests"]:
                reservoir[r] = (host, scores)
        return t

    sampling = True
    t0 = t = time.perf_counter()
    while t - t0 < seconds:
        t = one(t)
    sampling = False
    run.window_s = t - t0
    run.units = run.attempted = totals["n"]
    run.work, run.flops = totals["beams"], totals["flops"]
    run.host_wait_ms = list(host_wait.ms)
    run.end_to_end = {
        "rerank_beams_per_s": totals["beams"] / run.window_s,
        "rerank_p95_ms": statistics.quantiles(lat, n=100, method="inclusive")[94]}
    if run.trace:
        # a traced segment after the window, in the same steady state
        def requests(n=traffic["trace_requests"]):
            t = time.perf_counter()
            for _ in range(n):
                t = one(t)

        harness.traced_segment(run, device, requests, traffic["trace_requests"])
    run.memory_peak_bytes = program.peak_and_free(device)
    feed.close()
    del score, net
    if device.type == "cuda":
        torch.cuda.empty_cache()

    run.samples = reservoir
    t_check = time.perf_counter()
    gap = compare(run, reservoir, device)
    run.check_s = time.perf_counter() - t_check
    limit = run.cell.limits.get("score_gap")
    run.failed = sum(1 for g in gap if limit is None or g > limit)
    run.checks = harness.compared({"score_gap": max(gap) if gap else None},
                                  run.cell.limits)
    run.checks.append(("bad_scores", totals["bad"], 0))
    tmp.cleanup()


def compare(run: harness.Run, reservoir, device) -> list:
    """Per sampled request: the largest gap between its served and
    reference scores over its real beams, each side less its mean over
    those beams, divided by the median over the sampled requests of the
    spread of the reference's scores of a request's real beams."""
    gaps, spreads = [], []
    with program.NoTF32():
        weights = ref_lily.make_weights(run.model, run.seed, device)
        for host, served in reservoir:
            ref = ref_train.scores(weights, run.model, host).cpu().numpy()
            opt = host["opt_mask"].astype(bool)
            for b in range(opt.shape[0]):
                r = ref[b][opt[b]].astype(np.float64)
                s = served[b][opt[b]].astype(np.float64)
                gaps.append(float(np.abs((s - s.mean()) - (r - r.mean())).max()))
                spreads.append(float(r.max() - r.min()))
        del weights
    scale = max(statistics.median(spreads), 1e-30) if spreads else 1.0
    return [g / scale for g in gaps]


def _real(batch):
    """The number of real beams of each request (they come first)."""
    return [int(n) for n in batch["opt_mask"].sum(1).tolist()]


def _faulty(score, faults):
    """The scorer with the faults a test plants: ``altered_answer`` moves
    one beam's score where it is produced; ``half_batch`` leaves the second
    half of each request's beams out, giving them the mean score of the
    rest; ``permuted_beams`` gathers each beam's steps from the next beam's
    (a wrong step-dedup expansion)."""
    if "permuted_beams" in faults:
        inner0 = score

        def score(batch, inner=inner0):
            idx = batch["step_index"].clone()
            for b, n in enumerate(_real(batch)):
                idx[b, :n] = batch["step_index"][b, :n].roll(1, 0)
            return inner(dict(batch, step_index=idx))
    if "altered_answer" in faults:
        inner1 = score

        def score(batch, inner=inner1):
            out = inner(batch).clone()
            out[:, 0] += 0.5 * out[:, 0].abs() + 1e-3
            return out
    if "half_batch" in faults:
        inner2 = score

        def score(batch, inner=inner2):
            out = inner(batch).clone()
            for b, n in enumerate(_real(batch)):
                out[b, n // 2:n] = out[b, :n // 2].mean()
            return out
    return score
