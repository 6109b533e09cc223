"""CLIP frame features -> TSV (pipeline step 6a; the counterpart of
``scripts/clip_features.py``).

    python -m youtube_vln_tpu_torch.entries.clip_features raw_frames/ \\
        CLIP-ViT-B-32-views.tsv --weights /path/to/clip.safetensors [--device cpu]

Re-runs resume by appending only new frames, mirroring the reference
``precomute_CLIP_features.py``.  Without --weights a random-init encoder
(seed 0) is used for smoke runs; real features need the HF checkpoint
placed locally.  Runs on the CUDA device unless ``--device cpu``.
"""
import argparse

from ..device import resolve_device
from ..pipeline import clip_model as CM


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("frames_dir")
    p.add_argument("out_tsv")
    p.add_argument("--weights", default="",
                   help="local HF CLIP checkpoint (.bin or .safetensors)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    device = resolve_device(a.device)
    cfg = CM.ClipConfig()
    if a.weights:
        model = CM.load_clip_params(a.weights, cfg, device=device)
    else:
        print("WARNING: no --weights given; using a random-init encoder")
        model = CM.ClipModel(cfg, device=device).init_weights(0)
    n = CM.build_clip_tsv(model, a.frames_dir, a.out_tsv,
                          batch_size=a.batch_size, device=device)
    print(f"encoded {n} frames -> {a.out_tsv}")
    return n


if __name__ == "__main__":
    main()
