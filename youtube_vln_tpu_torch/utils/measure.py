"""What the port's tools share: the card they ran on, device timing, and
the synthetic batches of the flagship recipes.

Every tool prints the card beside its numbers (``card``); a time comes
from CUDA events on the card and from the host clock on the CPU, and a
result says which (``device``).  Nothing here is a device number when the
tool ran on the CPU.  The module imports torch only inside the functions
that need it, so the host-only tools use it too.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np


def nvidia_smi(index: int = 0) -> Optional[Dict[str, str]]:
    """{"name", "power_limit"} of card ``index`` as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them; None without the tool."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        name, limit = (x.strip() for x in out.split(",", 1))
    except (OSError, subprocess.SubprocessError, ValueError):
        return None
    return {"name": name, "power_limit": limit}


def card(device) -> Dict[str, object]:
    """The card ``device`` (a ``torch.device``) lies on, by ``nvidia_smi``;
    the CPU has none."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    import torch
    index = device.index if device.index is not None else torch.cuda.current_device()
    return nvidia_smi(index) or {"name": torch.cuda.get_device_name(index),
                                 "power_limit": None}


def synchronize(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def elapsed_ms(fn: Callable[[], object], n: int, device) -> float:
    """Mean ms per call of ``n`` back-to-back calls of ``fn``: between two
    CUDA events on the card (the queue drained first), on the host clock
    on the CPU.  The caller warms up."""
    synchronize(device)
    if device.type == "cuda":
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def pretrain_batch(cfg, bs: int, nc: int, s_t: int, s_v: int,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """A pretraining batch of the MRT recipe (every task, sparse MVM
    targets) from ``seed``, as root ``bench.py`` and
    ``scripts/profile_step.py`` build it."""
    from ..ops.masking import max_masked_regions
    m_cap = max_masked_regions(s_v)
    rng = np.random.default_rng(seed)
    tmask = (rng.random((bs, nc, s_v)) < 0.15).astype(np.int32)
    idx = np.full((bs, nc, m_cap), s_v, np.int32)
    rows = np.zeros((bs, nc, m_cap, cfg.v_target_size), np.float32)
    for i in range(bs):
        for j in range(nc):
            on = np.nonzero(tmask[i, j])[0][:m_cap]
            idx[i, j, :len(on)] = on
            r = rng.random((len(on), cfg.v_target_size)).astype(np.float32)
            rows[i, j, :len(on)] = r / r.sum(-1, keepdims=True)
    batch = {
        "instr_tokens": rng.integers(1, cfg.vocab_size, size=(bs, nc, s_t)),
        "instr_mask": np.ones((bs, nc, s_t), np.int32),
        "segment_ids": np.zeros((bs, nc, s_t), np.int32),
        "instr_targets": np.where(rng.random((bs, nc, s_t)) < 0.15,
                                  rng.integers(0, cfg.vocab_size,
                                               (bs, nc, s_t)), -1),
        "image_features": rng.normal(size=(bs, nc, s_v, cfg.v_feature_size)
                                     ).astype(np.float32),
        "image_locations": rng.random((bs, nc, s_v, 12)).astype(np.float32),
        "image_mask": np.ones((bs, nc, s_v), np.int32),
        "image_targets": rows,
        "image_targets_idx": idx,
        "image_targets_mask": tmask,
        "opt_mask": np.ones((bs, nc), bool),
        "ranking_target": np.zeros((bs,), np.int32),
    }
    batch["image_locations"][..., 11] = np.repeat(
        np.arange(s_v // 101 + 1), 101)[None, None, :s_v]
    return batch


def finetune_batch(cfg, bs: int, nc: int, s_t: int, s_v: int,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """A fine-tuning batch of recipe 30RS (ranking alone, the target at
    candidate 0) from ``seed``: ``bs`` instructions x ``nc`` candidates."""
    batch = pretrain_batch(cfg, bs, nc, s_t, s_v, seed)
    for k in ("image_targets", "image_targets_idx", "image_targets_mask"):
        del batch[k]
    batch["instr_targets"] = np.full_like(batch["instr_tokens"], -1)
    return batch


# the flagship recipes that the tools time, at 60 instruction tokens and
# 808 visual regions: ``mrt`` the pretraining step of every task at 8 x 7
# candidates with sparse MVM targets, ``30rs`` the fine-tuning step of
# recipe 30RS (ranking) at 16 x 6
S_T, S_V = 60, 808
RECIPES = {
    "mrt": dict(tasks=dict(ranking=True, traj_judge=True, masked_vision=True,
                           masked_language=True),
                run=dict(pretrain=True, learning_rate=2e-5,
                         sparse_vision_targets=True),
                batch=(8, 7), make=pretrain_batch),
    "30rs": dict(tasks=dict(ranking=True),
                 run=dict(pretrain=False, shuffle_visual_features=True,
                          learning_rate=4e-5),
                 batch=(16, 6), make=finetune_batch),
}


def recipe(name: str, config_file: str = ""):
    """(model config, run settings) of recipe ``name``: ``lily_base_config``
    (the flagship), or the topology of ``config_file``, in bf16 with the
    attention kernels, remat off; the settings are ``RunConfig`` keywords
    (the tasks, the optimizer, one epoch, no accumulation)."""
    import dataclasses

    from ..config import LilyConfig, lily_base_config
    spec = RECIPES[name]
    knobs = dict(compute_dtype="bfloat16", use_attention_kernels=True,
                 remat=False, **spec["tasks"])
    cfg = (dataclasses.replace(LilyConfig.from_json_file(config_file), **knobs)
           if config_file else lily_base_config(**knobs))
    return cfg, dict(**spec["tasks"], **spec["run"], num_epochs=1,
                     gradient_accumulation_steps=1)
