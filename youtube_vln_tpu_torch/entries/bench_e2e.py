"""End-to-end training throughput: item assembly -> collate -> host-to-device
copy -> step (the counterpart of ``scripts/bench_e2e.py``).

    python -m youtube_vln_tpu_torch.entries.bench_e2e [--num_workers N]
        [--batch_size 8] [--steps N] [--n_videos 96]
        [--no-dedup] [--config_file F] [--device cpu]

``bench`` times a batch staged on the device, so it bounds the step; the
reference's loop also pays the host assembly and the copy of every batch
(reference ``utils/utils_init.py:192-268``).  This drives the pretraining
pipeline as ``Engine.train_epoch`` runs it: ``YTbDataset`` items
(trajectory and negative sampling, template instructions, the native path
packer, MLM/MVM masking) over a synthetic fixture store at the flagship
geometry (101 boxes x 8 steps x 7 candidates, 60 tokens; one item per
video), ``Loader`` collation with ``--num_workers`` workers,
``prefetch_to_device`` copies and the MRT train step (``utils/measure.py``
recipe ``mrt``).  The Loader, the host-byte count of ``measured`` and the
copies run on the feed thread of ``prefetch_to_device``, so the steady
state's time holds the feed only where it outlasts the step.

After 2 warm-up steps of a first epoch it opens a second one and times
two things on the host clock.  The epoch's start-up: from opening the
epoch to its first batch on the device (the Loader's worker pool, its
shared-memory slabs and the filling of the pipeline), reported as
``epoch_start_ms``.  And the steady state: after the epoch's first 2
batches have been stepped, ``--steps`` Loader-fed steps
(every remaining batch of the epoch when 0), synchronised at both ends,
reported as ``e2e_step_ms``; they must fit in the epoch, so ``--n_videos``
sets the window.  (The JAX script times whole epochs, start-up included.)
Then as many steps on one batch staged on the device, between two CUDA
events (the host clock on the CPU), for the gap.  It reports the host
bytes and the host-to-device bytes per batch, so the
``--dedup_candidates`` saving is measured, the Loader's pickle
fallbacks by cause (``slab_overflow``: a batch outgrew its shared-memory
slab) and its batches by how they were assembled (``batch_assembly``:
written in place by the workers, or collated).  Prints one JSON line,
the JAX script's keys with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

from ..data import fixtures as F
from ..data.datasets import YTbDataset
from ..data.features_reader import YTbFeaturesReader
from ..data.loader import Loader
from ..data.tokenizer import load_tokenizer
from ..device import prefetch_to_device, resolve_device, to_device
from ..models import Lily
from ..parallel import train_step as ts
from ..utils.measure import S_T, S_V, card, elapsed_ms, recipe, synchronize


# batches of the timed epoch stepped before its window: the first carries
# the epoch's start-up, the second the refill of the prefetch queue behind it
WARM_BATCHES = 2


def batch_nbytes(batch) -> int:
    return int(sum(np.asarray(v).nbytes for v in batch.values()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num_workers", type=int, default=0)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=0,
                    help="timed Loader-fed steps (0: the rest of the epoch)")
    ap.add_argument("--n_videos", type=int, default=96,
                    help="fixture videos: one item each")
    ap.add_argument("--dedup", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--no-dedup ships per-candidate visual rows")
    ap.add_argument("--config_file", default="",
                    help="model topology (default lily_base_config)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)
    per_epoch = ns.n_videos // ns.batch_size
    if per_epoch < WARM_BATCHES + max(ns.steps, 1):
        raise SystemExit(f"bench_e2e: an epoch holds {per_epoch} batches, fewer "
                         f"than {WARM_BATCHES} before the window and --steps "
                         f"{ns.steps}: raise --n_videos")

    cfg, run = recipe("mrt", ns.config_file)
    flagship = dict(max_instruction_length=S_T, max_path_length=8,
                    max_num_boxes=101, min_path_length=4, min_captioned=2,
                    max_captioned=7, dedup_candidates=ns.dedup, **run)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = F.build_ytb_fixture(root, n_videos=ns.n_videos,
                                    frames_per_video=24, k_boxes=101,
                                    args_overrides=flagship)
        build_s = time.perf_counter() - t0

        args = F._default_args(skeleton_path=paths["skeleton_path"], **flagship)
        reader = YTbFeaturesReader(paths["store_path"])
        ds = YTbDataset(args=args, caption_path=paths["caption_path"],
                        tokenizer=load_tokenizer(paths["vocab_path"]),
                        features_reader=reader, masked_vision=True,
                        masked_language=True, training=True, seed=0)
        model = Lily(cfg, device=device).init_weights(0)
        optimizer, _ = ts.create_train_state(model, args, steps_per_epoch=1000)
        step = ts.build_train_step(model, cfg, args, optimizer, device)
        loader = Loader(ds, ns.batch_size, shuffle=True, seed=0,
                        num_workers=ns.num_workers, drop_last=True)
        nc = ds.num_candidates()
        sizes = {}

        def measured(batches):
            for b in batches:
                sizes.setdefault("host", batch_nbytes(b))
                yield b

        def feed(epoch):
            loader.set_epoch(epoch)
            for b in prefetch_to_device(measured(iter(loader)), device,
                                        args.host_prefetch):
                sizes.setdefault("h2d", sum(t.nbytes for t in b.values()))
                yield b

        seeds = iter(range(1 << 30))
        warm = feed(0)
        for _, batch in zip(range(2), warm):
            metrics = step(batch, next(seeds))
        float(metrics["loss/train"])
        warm.close()

        # the second epoch: its start-up, then a steady-state window
        synchronize(device)
        t_open = time.perf_counter()
        epoch = feed(1)
        batch = next(epoch)
        start_s = time.perf_counter() - t_open
        step(batch, next(seeds))
        for _, batch in zip(range(WARM_BATCHES - 1), epoch):
            step(batch, next(seeds))
        pending = []
        synchronize(device)
        t0 = time.perf_counter()
        for batch in epoch:
            pending.append(step(batch, next(seeds))["loss/train"])
            if len(pending) == ns.steps:
                break
        synchronize(device)
        n_steps = len(pending)
        if not n_steps:
            raise SystemExit("bench_e2e: the epoch ended before the window: "
                             "raise --n_videos")
        dt_e2e = (time.perf_counter() - t0) / n_steps
        epoch.close()
        losses = [float(x) for x in pending]

        # device only: the same step on one staged batch
        loader.set_epoch(0)
        it = iter(loader)
        dbatch = to_device(next(it), device)
        it.close()
        for _ in range(2):
            step(dbatch, next(seeds))
        dt_dev = elapsed_ms(lambda: step(dbatch, next(seeds)), n_steps, device) / 1e3
        fallbacks = dict(loader.shm_fallbacks_by_reason)
        assembly = dict(loader.batch_assembly)
        reader.close()

    traj = ns.batch_size * nc
    e2e_rate, dev_rate = traj / dt_e2e, traj / dt_dev
    overhead_s = max(dt_e2e - dt_dev, 1e-9)
    dev = card(device)
    out = {
        "metric": "e2e_train_traj_per_s_per_chip",
        "value": e2e_rate,
        "unit": "traj/s/chip",
        "detail": {
            "device_only_traj_per_s": dev_rate,
            "host_bound_gap": 1.0 - e2e_rate / dev_rate,
            "effective_transport_mb_s": sizes["host"] / 1e6 / overhead_s,
            "e2e_step_ms": dt_e2e * 1e3,
            "device_step_ms": dt_dev * 1e3,
            "steps_timed": n_steps,
            "warm_batches": WARM_BATCHES,
            "epoch_start_ms": start_s * 1e3,
            "batch": [ns.batch_size, nc, S_T, S_V],
            "host_batch_bytes": sizes["host"],
            "h2d_batch_bytes": sizes["h2d"],
            "dedup_candidates": ns.dedup,
            "num_workers": ns.num_workers,
            "slab_overflow": fallbacks.get("slab_overflow", 0),
            "shm_fallbacks": fallbacks,
            "batch_assembly": assembly,
            "device": dev["name"],
            "timing": ("host clock end to end (steady state); cuda events "
                       "device only"
                       if device.type == "cuda" else "host clock"),
            "loss_last": losses[-1] if losses else None,
            "fixture_build_s": build_s,
        },
        "device": dev,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
