"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same code paths (kernel sites, epilogue sites, every head, transports,
worker processes) at small widths and depths, in float32."""
from __future__ import annotations

import time

import torch

from benchmark import harness
from benchmark.reference import lily as ref_lily

TOPOLOGY = dict(vocab_size=300, hidden_size=64, num_hidden_layers=3,
                num_attention_heads=1, intermediate_size=96,
                max_position_embeddings=64, v_hidden_size=128,
                v_num_hidden_layers=2, v_num_attention_heads=2,
                v_intermediate_size=128, bi_hidden_size=128,
                bi_num_attention_heads=2, v_biattention_id=[0, 1],
                t_biattention_id=[1, 2])


def cell(name: str, limits=None) -> harness.Cell:
    c = harness.load_cell(name)
    c.config.update(TOPOLOGY)
    c.config["dtype"] = "float32"
    t = c.traffic
    if t["fixture"]["kind"] == "r2r":
        t["fixture"].update(k_boxes=32, n_scans=2, n_viewpoints=20,
                            n_records=8, n_paths=30, beams=[6, 8])
    else:
        t["fixture"].update(n_videos=6, frames_per_video=12, k_boxes=33)
    geometry = t.get("geometry", t["run"])
    geometry.update(max_path_length=4, max_num_boxes=33)
    if "min_path_length" in geometry:
        geometry.update(min_path_length=2, max_captioned=3)
    if t["driver"] == "rerank":
        t.update(warm_requests=1, check_requests=3, trace_requests=2)
    else:
        t.update(batch_size=2, repeat=4, warm_steps=1, instr_per_block=1)
    c.limits = dict(c.limits if limits is None else limits)
    return c


def fuse_everywhere(monkeypatch) -> None:
    """Epilogue sites at any size, so the small cells reach them."""
    from youtube_vln_tpu_torch.ops import epilogue
    for mod in (epilogue, ref_lily):
        monkeypatch.setattr(mod, "MIN_FUSED_ELEMENTS", 0)


def run(c: harness.Cell, seed: int = 2 ** 31 + 12345, faults=(),
        seconds: float = 1.0) -> harness.Run:
    r = harness.Run(cell=c, model=harness.model_dict(c.config), seed=seed,
                    trace=False)
    driver = harness.load_module("drivers", c.traffic["driver"])
    driver.run(r, seconds=seconds, device=torch.device("cpu"),
               started=time.time(), build_dir=harness.CACHE / "kernels",
               faults=faults)
    return r
