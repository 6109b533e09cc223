"""Convert a reference LMDB feature database into a VLN store (the
counterpart of ``scripts/convert_lmdb.py``).

    python -m youtube_vln_tpu_torch.entries.convert_lmdb <lmdb_path> \\
        <out.vlnstore> [--pano]

Needs the optional ``lmdb`` package (reference databases:
``utils/dataset/features_reader.py:16-66``).
"""
import argparse

from ..data.store import convert_lmdb


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("lmdb_path")
    p.add_argument("out_path")
    p.add_argument("--pano", action="store_true", default=False)
    a = p.parse_args(argv)
    n = convert_lmdb(a.lmdb_path, a.out_path, pano=a.pano)
    print(f"converted {n} records -> {a.out_path}")
    return n


if __name__ == "__main__":
    main()
