"""Headline benchmark: pretraining trajectories per second through the
full train step on one card (the counterpart of the root ``bench.py``).

    python -m youtube_vln_tpu_torch.entries.bench [--batch_size 8]
        [--steps 10] [--windows 3] [--eval_dispatches 12]
        [--config_file F] [--device cpu]

Metric: trajectories per second through the full MRT step (the forward
over every task head, the backward and the ``AdamWRef`` update) of
``lily_base_config`` from seed 0 in bf16 with the kernels, at the
reference pretraining geometry: 8 instructions x 7 candidates, 60
instruction tokens, 808 visual regions, sparse MVM targets, one batch
staged on the device.  One trajectory is one (instruction, path)
candidate row.

Before timing, after two warm-up steps, it holds the kernel path against
the plain path on one sample (7 candidates, eval mode): the forward's
largest output difference within 2e-2 of the largest output, and the
gradients at the vision layer-0 query weight and the co-attention layer-0
query2 weight within 0.12 relative L2 (both bf16 programs; the split of
that tolerance is ``check_kernels``' attribution).  Then ``--windows``
windows of ``--steps`` steps, each between two CUDA events (the host clock
on the CPU); the headline is the median window.  The eval row is
``bench_eval_path``: beams per second through ``build_score_step`` at 30
beams x (60 + 808) on the dense and the step-dedup transports, with the
host bytes of each.

vs_baseline: the reference publishes no numbers, so the baseline is an
estimate of its per-GPU rate on its 4 x V100 DDP recipe: ~0.47 TF per
trajectory (``FLOPS_PER_TRAJ``) at 40% of a V100's 15.7 TF/s in f32, ~13
trajectories/s per GPU.  MFU is against the H100 SXM dense bf16 peak of
989 TFLOP/s; it is None on the CPU.  Prints one JSON line, the JAX
script's keys with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np

from ..device import resolve_device, to_device
from ..evaluation.beam_eval import build_score_step
from ..parallel import train_step as ts
from ..utils.measure import (FLOPS_PER_TRAJ, PEAK_BF16_FLOPS, S_T, S_V, card,
                             elapsed_ms)
from . import bench_serving as serving
from .check_kernels import probe_run, rel_l2
from .profile_step import Profiler

BASELINE_TRAJ_S = 13.0      # the V100 estimate of the docstring
FWD_REL_TOL, BWD_REL_L2_TOL = 2e-2, 0.12


def kernel_vs_plain(model, flat) -> Dict[str, float]:
    """The kernel path against the plain path on one sample in eval mode,
    in the model's dtype: the forward's outputs and the two probe
    gradients."""
    dtype = model.cfg.compute_dtype
    (out_k, g_k), (out_p, g_p) = (probe_run(model, flat, kernels, dtype)
                                  for kernels in (True, False))
    max_err = max(float((out_k[k] - out_p[k]).abs().max()) for k in out_k)
    scale = max(float(v.abs().max()) for v in out_p.values())
    return {
        "pallas_max_err": max_err,
        "pallas_rel_err": max_err / max(scale, 1e-6),
        "pallas_logit_scale": scale,
        "pallas_bwd_max_err": max(float((a.float() - b.float()).abs().max())
                                  for a, b in zip(g_k, g_p)),
        "pallas_bwd_rel_l2": rel_l2(g_k, g_p),
    }


def bench_eval_path(state_dict, config_file: str, device, dispatches: int = 12,
                    windows: int = 3) -> dict:
    """Beams per second through ``build_score_step`` at the R2R eval
    geometry (30 beams x 60 tokens x 808 regions, batch_size 1 as
    ``test.py``), dense and step-dedup (120 unique blocks, the eval set's
    median), on the train model's weights."""
    model, cfg = serving.eval_model(config_file, device, state_dict)
    step = build_score_step(model, cfg, device)
    nc, steps, n_unique = serving.NC, serving.L, 120
    dense = serving.build_eval_batch(cfg, 1, nc, S_T, S_V, seed=5)
    dedup = serving.build_dedup_eval_batch(cfg, 1, nc, S_T, n_unique, steps,
                                           S_V // steps, seed=5)
    out: dict = {}
    for name, batch in (("dense", dense), ("dedup", dedup)):
        dts = serving.time_dispatch_windows(step, to_device(batch, device), device,
                                            dispatches, windows)
        dt = float(np.median(dts))
        out[name] = {"ms_per_dispatch": dt * 1e3, "ms_min": min(dts) * 1e3,
                     "ms_max": max(dts) * 1e3, "instructions_per_s": 1.0 / dt,
                     "beams_per_s": nc / dt}
    dense_b = serving._visual_bytes({**dense, "image_features":
                                     dense["image_features"].astype(np.float16)})
    dd_b = serving._visual_bytes(dedup)
    out.update(geometry=[nc, S_T, S_V], n_unique=n_unique,
               visual_bytes_per_instruction_dense=dense_b,
               visual_bytes_per_instruction_dedup=dd_b,
               transport_saving=1.0 - dd_b / dense_b)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10, help="steps per window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--eval_dispatches", type=int, default=12,
                    help="dispatches per window of the eval row")
    ap.add_argument("--config_file", default="",
                    help="model topology (default lily_base_config)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)

    prof = Profiler("mrt", device, ns.config_file, ns.batch_size)
    model, step = prof.build_train_step(prof.cfg)
    bs, nc, batch = prof.bs, prof.nc, prof.batch
    seeds = iter(range(1 << 30))
    for _ in range(2):
        float(step(batch, next(seeds))["loss/train"])

    flat = ts.flatten_candidates({k: v[:1] for k, v in batch.items()})
    parity = kernel_vs_plain(model, flat)
    if not parity["pallas_rel_err"] < FWD_REL_TOL:
        raise SystemExit(f"bench: kernel forward off the plain path: {parity}")
    if not parity["pallas_bwd_rel_l2"] < BWD_REL_L2_TOL:
        raise SystemExit(f"bench: kernel backward off the plain path: {parity}")

    windows, losses = [], []
    for _ in range(ns.windows):
        pending = []
        windows.append(elapsed_ms(lambda: pending.append(step(batch, next(seeds))),
                                  ns.steps, device))
        losses = [float(m["loss/train"]) for m in pending]
    dt = float(np.median(windows)) / 1e3
    traj_per_s = bs * nc / dt
    eval_detail = bench_eval_path(model.state_dict(), ns.config_file, device,
                                  ns.eval_dispatches, ns.windows)
    dev = card(device)
    on_card = device.type == "cuda"
    out = {
        "metric": "pretrain_traj_per_s_per_chip",
        "value": traj_per_s,
        "unit": "traj/s/chip",
        "vs_baseline": traj_per_s / BASELINE_TRAJ_S,
        "detail": {
            "step_ms": dt * 1e3,
            "step_ms_min": min(windows),
            "step_ms_max": max(windows),
            "step_ms_windows": windows,
            "noise_band": (max(windows) - min(windows)) / (dt * 1e3),
            "batch": [bs, nc, S_T, S_V],
            "device": dev["name"],
            "devices": 1,
            "timing": "cuda events" if on_card else "host clock",
            "loss": losses[-1],
            "mfu": traj_per_s * FLOPS_PER_TRAJ / PEAK_BF16_FLOPS if on_card else None,
            "mfu_xla": None,
            "flops_per_traj_model": FLOPS_PER_TRAJ,
            "flops_per_traj_xla": None,
            **parity,
            "sparse_vision_targets": True,
            "eval": eval_detail,
        },
        "device": dev,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
