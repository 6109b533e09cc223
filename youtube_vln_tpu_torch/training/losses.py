"""Losses of the port (counterpart of ``youtube_vln_tpu/training/losses.py``).

The eval slice needs only ``pad_packed``; the task losses arrive with the
training slice.
"""
from __future__ import annotations

import torch


def pad_packed(logits: torch.Tensor, opt_mask: torch.Tensor) -> torch.Tensor:
    """Dense analogue of the reference ``pad_packed``: -inf at padded
    candidates.  ``logits`` and ``opt_mask`` are [bs, num_cand]."""
    return logits.float().masked_fill(~opt_mask.bool(), float("-inf"))
