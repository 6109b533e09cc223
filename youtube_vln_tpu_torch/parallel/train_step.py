"""Batch transports of the beam-eval step (counterpart of
``youtube_vln_tpu/parallel/train_step.py:84-120``).

Batch layout (the loader's numpy batches, moved to the device as they are):

  instr_tokens   [B, nc, S_t] i32     image_features     [B, nc, S_v, 2048]
  instr_mask     [B, nc, S_t] i32     image_locations    [B, nc, S_v, 12]
  segment_ids    [B, nc, S_t] i32     image_mask         [B, nc, S_v] i32
  opt_mask       [B, nc] bool

or, on the step-dedup transport, ``uniq_step_features`` [B, n_u, boxes,
2048] (float16, the loader's io dtype), ``uniq_step_locations``,
``uniq_step_mask`` and ``step_index`` [B, nc, L] in place of the
``image_*`` arrays.  Features stay in their transport dtype here; the
model upcasts them.
"""
from __future__ import annotations

from typing import Dict

import torch


def expand_beam_steps(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Step-dedup transport -> dense per-beam visual arrays, gathered on the
    device: each unique (viewpoint, heading, step) pano block crosses the
    host-device link once, and each beam picks its L blocks by
    ``step_index``."""
    if "uniq_step_features" not in batch:
        return batch
    idx = batch["step_index"].long()                  # [B, nc, L]
    bs, nc, L = idx.shape
    rows = torch.arange(bs, device=idx.device)[:, None]
    flat = idx.reshape(bs, nc * L)

    def gather(x):                                    # [B, n_u, boxes, ...]
        out = x[rows, flat]                           # [B, nc*L, boxes, ...]
        return out.reshape((bs, nc, L * x.shape[2]) + tuple(x.shape[3:]))

    out = dict(batch)
    out["image_features"] = gather(batch["uniq_step_features"])
    out["image_locations"] = gather(batch["uniq_step_locations"])
    out["image_mask"] = gather(batch["uniq_step_mask"])
    for k in ("uniq_step_features", "uniq_step_locations",
              "uniq_step_mask", "step_index"):
        del out[k]
    return out


def flatten_candidates(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """[B, nc, ...] -> [B*nc, ...] for the model inputs."""
    return {k: batch[k].reshape((-1,) + tuple(batch[k].shape[2:])) for k in
            ("instr_tokens", "instr_mask", "segment_ids", "image_features",
             "image_locations", "image_mask")}
