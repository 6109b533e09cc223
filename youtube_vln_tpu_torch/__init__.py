"""PyTorch/CUDA port of the Lily (YouTube-VLN) stack for NVIDIA Hopper.

A second package beside ``youtube_vln_tpu`` (the JAX reference, which it
never imports).  This slice serves the beam re-ranking scorer of
``test.py``: ``evaluation.beam_eval.eval_epoch`` over loader-layout numpy
batches, with the vision self-attention and the co-attention layers on
hand-written CUDA kernels (``ops/csrc/attention_fwd.cu``).
"""
from .config import (BERT_BASE_6_LAYER_6_CONNECT, LilyConfig,
                     lily_base_config, tiny_config)

__all__ = ["BERT_BASE_6_LAYER_6_CONNECT", "LilyConfig", "lily_base_config",
           "tiny_config"]
