"""Convert BUTD TSV shards into a VLN store (pipeline step 4; the
counterpart of ``scripts/convert_tsv.py``).

    python -m youtube_vln_tpu_torch.entries.convert_tsv out.vlnstore \\
        shard0.tsv shard1.tsv ...
"""
import argparse

from ..pipeline.detector import convert_tsv_to_store


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("out_path")
    p.add_argument("tsv", nargs="+")
    p.add_argument("--pano", action="store_true", default=False)
    a = p.parse_args(argv)
    n = convert_tsv_to_store(a.tsv, a.out_path, pano=a.pano)
    print(f"converted {n} records -> {a.out_path}")
    return n


if __name__ == "__main__":
    main()
