"""PyTorch/CUDA port of the Lily (YouTube-VLN) stack for NVIDIA Hopper.

A second package beside ``youtube_vln_tpu`` (the JAX reference, which it
never imports).  It serves the beam re-ranking scorer of ``test.py``
(``evaluation.beam_eval.eval_epoch``), the fine-tuning and pretraining
train steps (``parallel.train_step.build_train_step``) and the host
pipeline that feeds pretraining (``data``), with the attention and the
dropout + residual + LayerNorm epilogue on hand-written CUDA kernels
(``ops/csrc``).
"""
from .config import (BERT_BASE_6_LAYER_6_CONNECT, LilyConfig,
                     lily_base_config, tiny_config)

__all__ = ["BERT_BASE_6_LAYER_6_CONNECT", "LilyConfig", "lily_base_config",
           "tiny_config"]
