"""Score a results file with the Matterport3D R2R protocol (the counterpart
of ``scripts/calculate_metrics.py``, reference
``scripts/calculate-metrics.py``).

    python -m youtube_vln_tpu_torch.entries.calculate_metrics <results.json> \\
        [--data_dir data] [--split val_unseen]
"""
import argparse
import json

from ..evaluation.metrics import Evaluation


def main(argv=None):
    parser = argparse.ArgumentParser("Calculate standard VLN metrics")
    parser.add_argument("path", type=str, help="path to a results file")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--split", type=str, default="")
    args = parser.parse_args(argv)

    split = args.split or ("val_unseen" if "val_unseen" in args.path
                           else "val_seen")
    ev = Evaluation([split], data_dir=args.data_dir)
    summary, _ = ev.score_file(args.path)
    summary = {k: round(v, 4) for k, v in summary.items()}
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
