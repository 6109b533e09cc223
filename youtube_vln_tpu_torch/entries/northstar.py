"""North-star dress rehearsal: the R2R beam re-ranking eval of a released
checkpoint, as one command (the counterpart of ``scripts/northstar.py``).

  feature conversion (LMDB -> VLN store, skipped if already a store)
    -> ``entries.test`` beam re-ranking on the chosen split
    -> ``entries.calculate_metrics`` (SR / SPL / NE / OSR / TL)
    -> the comparison with the expected numbers (within --tolerance_pts)

    python -m youtube_vln_tpu_torch.entries.northstar --data_dir data \\
        --img_feature data/matterport-ResNet-101-faster-rcnn-genome.lmdb \\
        --from_pretrained best_unseen.bin \\
        --config_file data/config/bert_base_6_layer_6_connect.json \\
        --bert_tokenizer <path/to/vocab.txt> --split val_unseen \\
        --expected_sr <SR, 0-1> --expected_spl <SPL, 0-1> [--device cpu]

Prints one JSON line with the measured metrics, the expected values and a
verdict: PASS, FAIL (and a non-zero exit) or NO_EXPECTATION without
``--expected_*``.  The test split has no ground-truth paths: it reports
NO_GROUND_TRUTH with the results file.  Nothing is downloaded: the
checkpoint and the features must be on disk (a URL checkpoint resolves
through the offline file cache).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from ..data.store import convert_lmdb
from . import calculate_metrics
from . import test as test_entry


def ensure_store(img_feature: str) -> str:
    """An LMDB database -> its VLN store beside it, converted once and
    published atomically; a store passes through untouched."""
    p = Path(img_feature)
    looks_lmdb = p.suffix == ".lmdb" or (p.is_dir() and (p / "data.mdb").exists())
    if not looks_lmdb:
        return img_feature
    out = p.with_suffix(".vlnstore")
    if out.exists():
        print(f"# northstar: reusing converted store {out}", file=sys.stderr)
        return str(out)
    print(f"# northstar: converting {p} -> {out}", file=sys.stderr)
    # a converter killed mid-run must never leave ``out`` for the next run
    # to reuse as if complete
    tmp = out.with_name(out.name + ".tmp")
    n = convert_lmdb(str(p), str(tmp), pano=True)
    os.replace(tmp, out)
    print(f"# northstar: converted {n} records", file=sys.stderr)
    return str(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--img_feature", required=True,
                    help="pano features: a .vlnstore, or a reference .lmdb "
                         "(converted once)")
    ap.add_argument("--from_pretrained", required=True,
                    help="checkpoint (.bin / dir / .tar.gz / cached URL)")
    ap.add_argument("--config_file", required=True)
    ap.add_argument("--bert_tokenizer", default="bert-base-uncased")
    ap.add_argument("--split", default="val_unseen",
                    choices=["train", "val_seen", "val_unseen", "test"])
    ap.add_argument("--output_dir", default="result")
    ap.add_argument("--save_name", default="northstar")
    ap.add_argument("--beam_prefix", default="")
    ap.add_argument("--expected_sr", type=float, default=None,
                    help="expected success rate, 0-1 scale")
    ap.add_argument("--expected_spl", type=float, default=None,
                    help="expected SPL, 0-1 scale")
    ap.add_argument("--tolerance_pts", type=float, default=1.0,
                    help="allowed |measured - expected| in percentage points")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="everything after --extra goes to entries.test "
                         "verbatim (e.g. --compilation_cache_dir ...)")
    ns = ap.parse_args(argv)

    store = ensure_store(ns.img_feature)
    test_argv = ["--data_dir", ns.data_dir, "--img_feature", store,
                 "--from_pretrained", ns.from_pretrained,
                 "--config_file", ns.config_file,
                 "--bert_tokenizer", ns.bert_tokenizer,
                 "--output_dir", ns.output_dir, "--save_name", ns.save_name,
                 "--split", ns.split, "--device", ns.device]
    if ns.beam_prefix:
        test_argv += ["--beam_prefix", ns.beam_prefix]
    results_path = test_entry.main(test_argv + list(ns.extra))

    if ns.split == "test":
        out = {"northstar": "NO_GROUND_TRUTH", "split": ns.split,
               "results": str(results_path),
               "note": "the test split has no ground-truth paths; submit the "
                       "results file to the R2R leaderboard for SR/SPL"}
        print(json.dumps(out))
        return out

    summary = calculate_metrics.main([str(results_path), "--data_dir",
                                      ns.data_dir, "--split", ns.split])
    tol = ns.tolerance_pts / 100.0
    comparisons = {}
    verdict = "NO_EXPECTATION"
    if ns.expected_sr is not None or ns.expected_spl is not None:
        ok = True
        for key, expected in (("success_rate", ns.expected_sr),
                              ("spl", ns.expected_spl)):
            if expected is None:
                continue
            measured = summary[key]
            within = abs(measured - expected) <= tol
            ok = ok and within
            comparisons[key] = {"expected": expected, "measured": measured,
                                "delta_pts": (measured - expected) * 100.0,
                                "within_tolerance": within}
        verdict = "PASS" if ok else "FAIL"
    out = {"northstar": verdict, "split": ns.split,
           "results": str(results_path), "metrics": summary,
           "tolerance_pts": ns.tolerance_pts, "comparison": comparisons}
    print(json.dumps(out))
    if verdict == "FAIL":
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
