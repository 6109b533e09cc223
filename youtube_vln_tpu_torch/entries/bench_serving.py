"""Serving throughput: the beam re-ranking path of the ``test`` entry on the
card (the counterpart of ``scripts/bench_serving.py``).

    python -m youtube_vln_tpu_torch.entries.bench_serving [--dedup]
        [--batch_sizes 1 8] [--dispatches 12] [--windows 1]
        [--config_file F] [--device cpu]

Beams scored per second through ``build_score_step`` (the encoder forward,
the ranking head and ``pad_packed``) at the R2R eval geometry: 30 beams
per instruction, 60 instruction tokens, 808 visual tokens, on
``lily_base_config`` from seed 0 in bf16 with the kernels.  The reference
protocol is batch_size 1 (one instruction per dispatch, ``test.py:46-49``);
the batched rows exist because the scores of instructions are independent.
``--dedup`` adds the step-dedup transport: host bytes per instruction,
ms per dispatch, and the scores against the same batch expanded on the
host.

Each row is a warm-up dispatch, then ``--windows`` windows of
``--dispatches`` dispatches of one batch staged on the device, each window
between two CUDA events (the host clock on the CPU).  Prints one JSON
line, the JAX script's keys with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List

import numpy as np

from ..device import resolve_device, to_device
from ..evaluation.beam_eval import build_score_step
from ..models import Lily
from ..utils.measure import card, elapsed_ms, model_config

NC, S_T, S_V, L = 30, 60, 808, 8


def build_eval_batch(cfg, bs, nc, s_t, s_v, seed=0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "instr_tokens": rng.integers(1, cfg.vocab_size,
                                     (bs, nc, s_t)).astype(np.int32),
        "instr_mask": np.ones((bs, nc, s_t), np.int32),
        "segment_ids": np.zeros((bs, nc, s_t), np.int32),
        "image_features": rng.normal(
            size=(bs, nc, s_v, cfg.v_feature_size)).astype(np.float32),
        "image_locations": rng.random((bs, nc, s_v, 12)).astype(np.float32),
        "image_mask": np.ones((bs, nc, s_v), np.int32),
        "opt_mask": np.ones((bs, nc), bool),
    }


def build_dedup_eval_batch(cfg, bs, nc, s_t, n_u, steps, boxes, seed=0
                           ) -> Dict[str, np.ndarray]:
    """The step-dedup transport at the eval geometry: ``n_u`` unique
    (viewpoint, heading, step) pano blocks and a [nc, steps] gather index
    per instruction, f16 features as the loader ships them."""
    rng = np.random.default_rng(seed)
    dense = build_eval_batch(cfg, bs, nc, s_t, steps * boxes, seed=seed)
    return {
        "instr_tokens": dense["instr_tokens"],
        "instr_mask": dense["instr_mask"],
        "segment_ids": dense["segment_ids"],
        "uniq_step_features": rng.normal(
            size=(bs, n_u, boxes, cfg.v_feature_size)).astype(np.float16),
        "uniq_step_locations": rng.random(
            (bs, n_u, boxes, 12)).astype(np.float32),
        "uniq_step_mask": np.ones((bs, n_u, boxes), np.int32),
        "step_index": rng.integers(0, n_u, (bs, nc, steps)).astype(np.int32),
        "opt_mask": np.ones((bs, nc), bool),
    }


def _visual_bytes(batch) -> int:
    return sum(v.nbytes for k, v in batch.items()
               if k.startswith(("image_", "uniq_step_", "step_index")))


def expand_on_host(dd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A step-dedup batch of one instruction as the dense batch it stands
    for."""
    idx = dd["step_index"][0].reshape(-1)
    nc, steps = dd["step_index"].shape[1:]
    boxes = dd["uniq_step_features"].shape[2]
    out = {k: v for k, v in dd.items()
           if not k.startswith("uniq_step_") and k != "step_index"}
    for src, dst in (("uniq_step_features", "image_features"),
                     ("uniq_step_locations", "image_locations"),
                     ("uniq_step_mask", "image_mask")):
        x = dd[src][:, idx]
        out[dst] = x.reshape((1, nc, steps * boxes) + x.shape[3:])
    return out


def time_dispatch_windows(step: Callable, batch, device, n_disp: int = 12,
                          n_windows: int = 1) -> List[float]:
    """A warm-up dispatch, then ``n_windows`` windows of ``n_disp``
    dispatches; returns the seconds per dispatch of each window."""
    step(batch)
    return [elapsed_ms(lambda: step(batch), n_disp, device) / 1e3
            for _ in range(n_windows)]


def eval_model(config_file: str, device, state_dict=None):
    """(model, cfg) of the scorer: the ranking head alone, bf16, kernels;
    the weights from ``state_dict`` or seed 0."""
    cfg = model_config(config_file, ranking=True, traj_judge=False,
                       masked_vision=False, masked_language=False,
                       compute_dtype="bfloat16", use_attention_kernels=True)
    model = Lily(cfg, device=device)
    if state_dict is None:
        model.init_weights(0)
    else:
        model.load_state_dict(state_dict)
    return model, cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dedup", action="store_true",
                    help="also measure the step-dedup transport (bytes per "
                         "instruction, ms per dispatch, scores against the "
                         "dense batch)")
    ap.add_argument("--n_unique", type=int, default=120,
                    help="unique step blocks per instruction for --dedup "
                         "(dense slot count is 30 x 8 = 240)")
    ap.add_argument("--batch_sizes", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--dispatches", type=int, default=12)
    ap.add_argument("--windows", type=int, default=1)
    ap.add_argument("--config_file", default="",
                    help="model topology (default lily_base_config)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)

    model, cfg = eval_model(ns.config_file, device)
    step = build_score_step(model, cfg, device)
    results: dict = {}
    for bs in ns.batch_sizes:
        batch = to_device(build_eval_batch(cfg, bs, NC, S_T, S_V), device)
        dts = time_dispatch_windows(step, batch, device, ns.dispatches, ns.windows)
        dt = float(np.median(dts))
        results[f"bs{bs}"] = {
            "ms_per_dispatch": dt * 1e3,
            "ms_windows": [x * 1e3 for x in dts],
            "beams_per_s": bs * NC / dt,
            "instructions_per_s": bs / dt,
        }
        del batch

    if ns.dedup:
        boxes = S_V // L
        dense = build_eval_batch(cfg, 1, NC, S_T, S_V, seed=5)
        dd = build_dedup_eval_batch(cfg, 1, NC, S_T, ns.n_unique, L, boxes, seed=5)
        ddev = to_device(dd, device)
        s_dense = step(to_device(expand_on_host(dd), device)).float().cpu()
        s_dedup = step(ddev).float().cpu()
        max_err = float((s_dense - s_dedup).abs().max())
        if not max_err < 1e-2:
            raise SystemExit(f"bench_serving: step-dedup scores {max_err} off "
                             "the dense batch's")
        dts = time_dispatch_windows(step, ddev, device, ns.dispatches, ns.windows)
        dt = float(np.median(dts))
        # bytes on equal footing: the loader ships f16 features either way
        dense_b = _visual_bytes({**dense, "image_features":
                                 dense["image_features"].astype(np.float16)})
        dd_b = _visual_bytes(dd)
        results["dedup_bs1"] = {
            "ms_per_dispatch": dt * 1e3,
            "ms_windows": [x * 1e3 for x in dts],
            "beams_per_s": NC / dt,
            "n_unique": ns.n_unique,
            "visual_bytes_per_instruction_dense": dense_b,
            "visual_bytes_per_instruction_dedup": dd_b,
            "transport_saving": 1.0 - dd_b / dense_b,
            "score_parity_max_err": max_err,
        }

    first = results[f"bs{ns.batch_sizes[0]}"]
    dev = card(device)
    out = {
        "metric": "serving_beams_per_s_per_chip",
        "value": first["beams_per_s"],
        "unit": "beams/s/chip",
        "detail": {"geometry": [NC, S_T, S_V], "device": dev["name"],
                   "timing": "cuda events" if device.type == "cuda" else "host clock",
                   **results},
        "device": dev,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
