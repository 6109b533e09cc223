"""Merge VLN store shards into one store file (the counterpart of
``scripts/merge_stores.py``).

    python -m youtube_vln_tpu_torch.entries.merge_stores out.vlnstore \\
        shard0.vlnstore shard1.vlnstore ...

Duplicate keys resolve last-shard-wins (the multi-shard FeaturesReader's
key-merge order).  Use after a per-shard migration (e.g. 11x
``convert_lmdb`` of the reference layout): the native path packers only
engage when every key of a path lives in one store.
"""
import argparse

from ..data.store import merge_stores


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("out_path")
    p.add_argument("shards", nargs="+")
    a = p.parse_args(argv)
    n = merge_stores(a.shards, a.out_path)
    print(f"merged {len(a.shards)} shards ({n} records) -> {a.out_path}")
    return n


if __name__ == "__main__":
    main()
