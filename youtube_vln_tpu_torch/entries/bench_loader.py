"""Host data-pipeline throughput at the flagship geometry (the counterpart
of ``scripts/bench_loader.py``; host code, no torch).

    python -m youtube_vln_tpu_torch.entries.bench_loader [--num_workers N]
        [--items 24] [--no-sparse] [--no-dedup] [--eval]

Measures per-item assembly (``YTbDataset.__getitem__``: trajectory and
negative sampling, template instruction synthesis, feature gather/pad via
the native path packer when built, MLM/MVM masking) and the end-to-end
Loader rate (collate + f16 transport), on a synthetic fixture store with
the real shapes: 101 boxes x 2048 features, paths up to 8 steps, 7
candidates per item.

``--eval`` switches to the beam-eval path (``BeamDataset`` at the R2R
``test.py`` geometry: 30 beams x 8 steps x 101 boxes per instruction) and
reports the dense against the step-dedup assembly cost and host bytes side
by side.

Prints one JSON line, the JAX script's keys with the card's name and power
limit where ``nvidia-smi`` finds one (``device``; the numbers are host
numbers either way).
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..data import fixtures as F
from ..data.datasets import BeamDataset, YTbDataset
from ..data.features_reader import PanoFeaturesReader, YTbFeaturesReader
from ..data.loader import Loader
from ..data.store import get_native
from ..data.tokenizer import load_tokenizer
from ..utils.measure import nvidia_smi


def _item_bytes(item):
    return sum(v.nbytes for v in item.values()
               if isinstance(v, np.ndarray))


def bench_eval(ns) -> dict:
    """Beam-eval item assembly at the flagship test.py geometry: one
    instruction = 30 beams over one graph neighborhood, 8 steps x 101
    boxes.  Compares the dense path (BeamDataset._packed_path_features
    per beam) against --dedup_beam_steps (unique step blocks + gather
    index, datasets.py:_dedup_step_features)."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = F.build_r2r_fixture(root, n_scans=1, n_viewpoints=25,
                                    n_paths=4, n_beams=30, path_len=8,
                                    k_boxes=101, seed=0)
        build_s = time.perf_counter() - t0

        tok = load_tokenizer(paths["vocab_path"])
        reader = PanoFeaturesReader(paths["store_path"])

        def mk(**kw):
            from ..config import RunConfig
            args = RunConfig(
                pretrain=False, ranking=True, batch_size=1,
                max_instruction_length=60, max_path_length=8,
                max_num_boxes=101, num_beams=1, **kw)
            return BeamDataset(
                args, f"{paths['data_dir']}/task/R2R_val_unseen.json",
                f"{paths['data_dir']}/beamsearch/beams_val_unseen.json",
                tok, reader, num_beams=1, num_beams_strict=False,
                training=False, masked_vision=False, masked_language=False,
                shuffle_visual_features=False,
                data_dir=paths["data_dir"], seed=0)

        out = {}
        # the dense row names its transport: dedup_beam_steps defaults on
        # (the JAX script's dense row runs the default, the step-dedup one)
        for name, ds in (("dense", mk(dedup_beam_steps=False)),
                         ("dedup", mk(dedup_beam_steps=True))):
            item = ds[0]                      # warm caches + native lib
            n = ns.items
            t0 = time.perf_counter()
            for i in range(n):
                item = ds[i % len(ds)]
            dt = (time.perf_counter() - t0) / n
            out[name] = {
                "assembly_ms_per_instruction": round(dt * 1000, 1),
                "instructions_per_s": round(1.0 / dt, 1),
                "host_mb_per_instruction": round(_item_bytes(item) / 2**20,
                                                 1),
                "host_bytes_per_instruction": _item_bytes(item),
            }
            if name == "dedup":
                out[name]["n_unique_padded"] = int(
                    item["uniq_step_features"].shape[0])
                out[name]["dense_slots"] = int(
                    item["step_index"].size)
        reader.close()

    d, u = out["dense"], out["dedup"]
    return {
        "metric": "eval_loader_instructions_per_s_per_worker",
        "value": u["instructions_per_s"],
        "unit": "instr/s/worker",
        "detail": {
            **{f"{k}_{kk}": vv for k, v in out.items()
               for kk, vv in v.items()},
            "assembly_speedup": round(
                d["assembly_ms_per_instruction"]
                / u["assembly_ms_per_instruction"], 2),
            "transport_saving": round(
                1.0 - u["host_mb_per_instruction"]
                / d["host_mb_per_instruction"], 3),
            "native_packer": get_native() is not None,
            "fixture_build_s": round(build_s, 1),
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num_workers", type=int, default=0)
    ap.add_argument("--items", type=int, default=24)
    ap.add_argument("--sparse", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--no-sparse benches dense [S_v,1601] targets")
    ap.add_argument("--dedup", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--no-dedup benches the per-candidate transport")
    ap.add_argument("--eval", action="store_true",
                    help="bench the beam-eval (test.py) assembly path "
                         "instead of pretraining: dense vs "
                         "--dedup_beam_steps at 30 beams x 8 steps x "
                         "101 boxes")
    ns = ap.parse_args(argv)
    out = bench_eval(ns) if ns.eval else bench_ytb(ns)
    out["device"] = nvidia_smi() or {"name": "no card", "power_limit": None}
    out["host"] = {"cpus": os.cpu_count()}
    print(json.dumps(out))
    return out


def bench_ytb(ns) -> dict:
    """YTb item assembly and the Loader's rate at the flagship geometry."""
    flagship = dict(max_instruction_length=60, max_path_length=8,
                    max_num_boxes=101, min_path_length=4, min_captioned=2,
                    max_captioned=7,
                    sparse_vision_targets=ns.sparse,
                    dedup_candidates=ns.dedup and ns.sparse)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = F.build_ytb_fixture(root, n_videos=32, frames_per_video=24,
                                    k_boxes=101, args_overrides=flagship)
        build_s = time.perf_counter() - t0

        args = F._default_args(skeleton_path=paths["skeleton_path"],
                               **flagship)
        tok = load_tokenizer(paths["vocab_path"])
        reader = YTbFeaturesReader(paths["store_path"])
        ds = YTbDataset(args=args, caption_path=paths["caption_path"],
                        tokenizer=tok, features_reader=reader,
                        masked_vision=True, masked_language=True,
                        training=True, seed=0)

        # per-item assembly (the loader-worker inner loop; items discarded
        # so allocator pressure stays realistic)
        _ = ds[0]  # warm caches (tokenizer, graph, native lib)
        n = ns.items
        t0 = time.perf_counter()
        nc = 0
        for i in range(n):
            item = ds[i % len(ds)]
            nc += int(item["opt_mask"].sum())
        dt_item = (time.perf_counter() - t0) / n

        # end-to-end Loader (assembly + collate + transport), bs=8 like
        # training.  Epoch 1 warms everything; epoch 2 is the headline —
        # this is the rate ONE worker-equivalent sustains feeding a chip.
        loader = Loader(ds, batch_size=8, shuffle=True, seed=0,
                        num_workers=ns.num_workers, drop_last=True)
        for _ in range(2):   # warm item caches AND the malloc arena
            for _ in loader:
                pass
        t0 = time.perf_counter()
        batches = rows = 0
        for batch in loader:
            batches += 1
            rows += int(batch["opt_mask"].sum())
        dt_loader = time.perf_counter() - t0

        native = get_native() is not None
        reader.close()

    cand_per_item = nc / n
    e2e = rows / dt_loader
    workers = max(1, ns.num_workers)   # 0 = in-process, one worker-equiv
    return {
        "metric": "loader_traj_per_s_per_worker",
        "value": round(e2e / workers, 1),
        "unit": "traj/s/worker",
        "detail": {
            "aggregate_traj_per_s": round(e2e, 1),
            "assembly_item_ms": round(dt_item * 1000, 1),
            "assembly_traj_per_s": round(cand_per_item / dt_item, 1),
            "candidates_per_item": round(cand_per_item, 2),
            "loader_batches": batches,
            "num_workers": ns.num_workers,
            "native_packer": native,
            "sparse_vision_targets": ns.sparse,
            "dedup_candidates": ns.dedup and ns.sparse,
            "fixture_build_s": round(build_s, 1),
        },
    }


if __name__ == "__main__":
    main()
