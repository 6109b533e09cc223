"""Sharded region-feature extraction (pipeline step 3; the counterpart of
``scripts/extract_features.py``).

    python -m youtube_vln_tpu_torch.entries.extract_features raw_frames/ \\
        img_features/ --num_splits 11 --num_workers 3

Multi-process TSV production with resume-from-partial over the pluggable
detector protocol (the seeded stand-in detector unless ``--detector
module:factory`` names a real one).  Host code only: it imports no torch,
so its worker pool may fork.
"""
import argparse
import importlib

from ..pipeline import extraction as E
from ..pipeline.detector import RandomProposalExtractor


def _stand_in_factory(shard_id: int):
    return RandomProposalExtractor(num_boxes=36, seed=shard_id)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("frames_dir")
    p.add_argument("out_dir")
    p.add_argument("--num_splits", type=int, default=11)
    p.add_argument("--num_workers", type=int, default=3)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--detector", default="",
                   help="module:factory producing a RegionFeatureExtractor "
                        "per shard id (default: seeded stand-in)")
    a = p.parse_args(argv)

    if a.detector:
        mod_name, fn_name = a.detector.split(":")
        factory = getattr(importlib.import_module(mod_name), fn_name)
    else:
        factory = _stand_in_factory
    n = E.run_extraction(a.frames_dir, a.out_dir, factory,
                         num_splits=a.num_splits, num_workers=a.num_workers,
                         start=a.start)
    print(f"extracted {n} frames -> {a.out_dir}")
    return n


if __name__ == "__main__":
    main()
