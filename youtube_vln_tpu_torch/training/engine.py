"""Data wiring of the entry points (the first functions of
``youtube_vln_tpu/training/engine.py``): the tokenizer and the R2R beam
dataset.  The ``Engine`` itself, its epoch loops and the pretraining
dataset wiring are not ported yet."""
from __future__ import annotations

import logging
from pathlib import Path

from ..config import RunConfig
from ..data.datasets import BeamDataset
from ..data.tokenizer import load_tokenizer

logger = logging.getLogger(__name__)


def resolve_tokenizer(args: RunConfig):
    try:
        return load_tokenizer(args.bert_tokenizer)
    except FileNotFoundError:
        fallback = Path(args.data_dir) / "vocab.txt"
        if fallback.exists():
            logger.warning("tokenizer '%s' unavailable; using %s",
                           args.bert_tokenizer, fallback)
            return load_tokenizer(fallback)
        raise


def load_beam_dataset(tag: str, args: RunConfig, tokenizer, reader,
                      training: bool) -> BeamDataset:
    """reference load_BeamDataset (dataset_init.py:66-93)."""
    return BeamDataset(
        args,
        f"{args.data_dir}/task/{args.r2r_prefix}R2R_{tag}.json",
        f"{args.data_dir}/beamsearch/{args.beam_prefix}beams_{tag}.json",
        tokenizer, reader,
        num_beams=args.num_beams_train if training else args.num_beams,
        num_beams_strict=False, training=training,
        masked_vision=args.masked_vision if training else False,
        masked_language=args.masked_language if training else False,
        shuffle_visual_features=(args.shuffle_visual_features
                                 if training else False),
        shuffler=args.shuffler,
        ground_truth_trajectory=args.ground_truth_trajectory,
        data_dir=args.data_dir, seed=args.seed)
