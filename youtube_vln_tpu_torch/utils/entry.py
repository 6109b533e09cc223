"""Shared setup for the entry points (a copy of
``youtube_vln_tpu/utils/entry.py``)."""
from __future__ import annotations

import logging
from pathlib import Path

from ..config import LilyConfig, RunConfig, lily_base_config

logger = logging.getLogger(__name__)

BUILTIN_CONFIG = (Path(__file__).resolve().parent.parent.parent / "configs"
                  / "bert_base_6_layer_6_connect.json")


def build_model_config(args: RunConfig) -> LilyConfig:
    """Load the topology JSON (reference pretrain.py:54) with a fallback to
    the repository's flagship config, then to ``lily_base_config()``, and
    fold in the task and kernel flags the way the reference stuffs
    config.args (test.py:88-98)."""
    path = Path(args.config_file)
    if path.exists():
        cfg = LilyConfig.from_json_file(path)
    elif BUILTIN_CONFIG.exists():
        logger.warning("config %s not found; using built-in %s", path,
                       BUILTIN_CONFIG)
        cfg = LilyConfig.from_json_file(BUILTIN_CONFIG)
    else:
        cfg = lily_base_config()
    cfg.ranking = args.ranking
    cfg.traj_judge = args.traj_judge
    cfg.masked_vision = args.masked_vision
    cfg.masked_language = args.masked_language
    cfg.compute_dtype = args.compute_dtype
    cfg.use_attention_kernels = args.use_attention_kernels
    cfg.remat = args.remat
    return cfg
