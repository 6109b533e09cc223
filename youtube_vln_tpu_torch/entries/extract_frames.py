"""Extract frames at 1 fps from downloaded videos (pipeline step 2; the
counterpart of ``scripts/extract_frames.py``, reference
``scripts/video_process/extract_rawframes.py``).

    python -m youtube_vln_tpu_torch.entries.extract_frames \\
        --videos data/videos --out data/YouTube-VLN/raw_frames
"""
import argparse

from ..pipeline.frames import extract_all


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--videos", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--fps", default=1, type=int)
    a = p.parse_args(argv)
    n = extract_all(a.videos, a.out, fps=a.fps)
    print(f"extracted {n} frames -> {a.out}")
    return n


if __name__ == "__main__":
    main()
