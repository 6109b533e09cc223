"""Room-type photo merging (pipeline step 10; the counterpart of
``scripts/merge_photos.py``, reference scripts/build_dataset/merge_photos.py).

    python -m youtube_vln_tpu_torch.entries.merge_photos --source ytb_test.json \\
        --output merge+ytb_test.json --merge_method max
"""
import argparse
import json

from ..pipeline.merge_photos import MERGE_METHODS, merge_dataset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--source", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--merge_method", default="max", choices=MERGE_METHODS)
    p.add_argument("--max_photo_per_merging", default=10, type=int)
    a = p.parse_args(argv)
    with open(a.source) as f:
        items = json.load(f)
    merged = merge_dataset(items, a.merge_method, a.max_photo_per_merging)
    with open(a.output, "w") as f:
        json.dump(merged, f)
    print(f"merged {len(merged)} records -> {a.output}")
    return merged


if __name__ == "__main__":
    main()
