"""The offline dataset-construction pipeline in PyTorch (counterpart of
``youtube_vln_tpu/pipeline/``, the 10-step recipe of scripts/README.md).

Steps and their homes:
  1-2 video download (gated) and ffmpeg
       frame extraction                     -> frames.py
      the asset manifest and distance
       tables                               -> assets.py
  3  region features (detector protocol,
       multi-process sharded driver)        -> detector.py, extraction.py
  4  TSV -> feature-store conversion        -> detector.py
  5a indoor filter: WideResNet-18 Places365 -> places365.py + filters.py
  5b person filter: AlexNet Places365 and
       Mask R-CNN ResNet-50-FPN             -> places365.py, maskrcnn.py,
                                               filters.py
  6  CLIP ViT-B/32 encoders + zero-shot
       captions                             -> clip_model.py, clip_captions.py
  7-8 inverse action model and per-video
       action profiles                      -> inverse_action.py
  9  train/test JSON build + frozen testset -> build_dataset.py
  10 room-type photo merging                -> merge_photos.py

The models run on the device of their module (``device="cuda"`` unless the
caller asks for the CPU), in float32 as the JAX pipeline runs; every
preprocessor resizes as ``jax.image.resize`` does (``resize.py``).
``frames``, ``assets``, ``detector``, ``extraction``, ``build_dataset``,
``merge_photos`` and ``clip_captions`` are host code that imports no
torch.
"""
