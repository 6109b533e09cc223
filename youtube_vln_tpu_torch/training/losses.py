"""Task losses of the port (counterpart of
``youtube_vln_tpu/training/losses.py``, reference ``utils/utils_init.py:
108-164``).

As in the JAX package the model runs on all ``bs * num_cand`` rows,
padding included, and ``opt_mask`` [bs, num_cand] weights them inside the
loss; padded candidates contribute nothing.  All reductions run in float32.
Every function returns device tensors and never reads a value back to the
host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def pad_packed(logits: torch.Tensor, opt_mask: torch.Tensor) -> torch.Tensor:
    """Dense analogue of the reference ``pad_packed``: -inf at padded
    candidates.  ``logits`` and ``opt_mask`` are [bs, num_cand]."""
    return logits.float().masked_fill(~opt_mask.bool(), float("-inf"))


def _xlogy(x, y):
    """x * log(y) with 0 * log(0) = 0 (torch F.kl_div convention)."""
    zero = x == 0.0
    return torch.where(zero, 0.0, x * torch.log(torch.where(zero, 1.0, y)))


def _take(x, idx):
    """x[..., idx] along the last dim; idx has one fewer dim than x."""
    return torch.gather(x, -1, idx.long()[..., None])[..., 0]


def masked_vision_loss(predictions, targets, target_mask, row_mask):
    """KLDiv(log_softmax(pred), target) masked and normalised by the count of
    masked regions (reference utils_init.py:117-128).

    predictions: [N, S_v, C] raw logits; targets: [N, S_v, C] distributions;
    target_mask: [N, S_v] 1 where the region was masked; row_mask: [N] 1 for
    real (non-padding) candidates."""
    logp = F.log_softmax(predictions.float(), dim=-1)
    t = targets.float()
    kl = _xlogy(t, t) - t * logp
    w = (target_mask.float() * row_mask.float()[:, None])[..., None]
    numel = torch.clamp(w[..., 0].sum(), min=1.0)
    return (kl * w).sum() / numel


def masked_vision_loss_sparse(predictions, target_idx, target_rows, row_mask,
                              *, pre_gathered: bool = False,
                              num_regions: int = None):
    """Sparse form of ``masked_vision_loss``: only masked regions carry
    targets.  predictions: [N, S_v, C], or with ``pre_gathered`` [N, M, C]
    aligned with ``target_idx``; target_idx: [N, M] (``num_regions`` / S_v
    is the padding sentinel); target_rows: [N, M, C]; row_mask: [N]."""
    if pre_gathered:
        assert num_regions is not None
        s_v = num_regions
        pred_rows = predictions.float()
        valid = (target_idx < s_v) & (row_mask[:, None] > 0)
    else:
        _, s_v, c = predictions.shape
        valid = (target_idx < s_v) & (row_mask[:, None] > 0)
        safe_idx = torch.where(valid, target_idx, 0).long()
        pred_rows = torch.gather(predictions.float(), 1,
                                 safe_idx[..., None].expand(-1, -1, c))
    logp = F.log_softmax(pred_rows, dim=-1)
    t = target_rows.float()
    kl = _xlogy(t, t) - t * logp
    w = valid.float()[..., None]
    numel = torch.clamp(w[..., 0].sum(), min=1.0)
    return (kl * w).sum() / numel


def masked_language_loss(predictions, targets, row_mask):
    """Cross entropy with ignore_index=-1 (reference utils_init.py:129-135);
    0 rather than torch's nan when every target is ignored.

    predictions: [N, S_t, V]; targets: [N, S_t] with -1 = ignore; row_mask:
    [N]."""
    logp = F.log_softmax(predictions.float(), dim=-1)
    valid = (targets >= 0) & (row_mask[:, None] > 0)
    nll = -_take(logp, torch.where(valid, targets, 0))
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / torch.clamp(valid.float().sum(), min=1.0)


def ranking_loss_train(logits, opt_mask, target):
    """CE over candidates with ignore_index=-1 and the argmax accuracy
    (reference utils_init.py:136-141).  logits: [bs, num_cand]; target:
    [bs] int (-1 = ignore).  Returns (loss, correct_count)."""
    pred = pad_packed(logits, opt_mask)
    logp = F.log_softmax(pred, dim=-1)
    valid = target >= 0
    nll = -_take(logp, torch.where(valid, target, 0))
    loss = torch.where(valid, nll, 0.0).sum() / torch.clamp(
        valid.float().sum(), min=1.0)
    correct = (pred.argmax(dim=1) == target).float().sum()
    return loss, correct


def _bce_with_logits(x, z, pos_weight=None):
    """torch's binary_cross_entropy_with_logits, elementwise, in the JAX
    package's stable form: (1 - z) x + (1 + (pw - 1) z) softplus(-x)."""
    x, z = x.float(), z.float()
    log_weight = 1.0 if pos_weight is None else 1.0 + (pos_weight - 1.0) * z
    softplus_neg = torch.clamp(-x, min=0.0) + torch.log1p(torch.exp(-x.abs()))
    return (1.0 - z) * x + log_weight * softplus_neg


def ranking_loss_eval(logits, opt_mask, target):
    """BCE-with-logits against multi-hot success and the top-1 success
    gather (reference utils_init.py:142-146); padded candidates are left out
    of the mean.  target: [bs, num_cand].  Returns (loss, correct_count)."""
    m = opt_mask.float()
    pred = torch.where(opt_mask.bool(), logits.float(), 0.0)
    bce = _bce_with_logits(pred, target.float()) * m
    loss = bce.sum() / torch.clamp(m.sum(), min=1.0)
    top = pad_packed(logits, opt_mask).argmax(dim=1)
    correct = _take(target.float(), top).sum()
    return loss, correct


def traj_judge_targets(num_cand: int, *, ranking_or_no_judge_data: bool,
                       pretrain: bool, num_negatives: int,
                       device=None) -> torch.Tensor:
    """Position-dependent target layout (reference utils_init.py:149-158),
    with the JAX package's num_negatives=0 rule: every candidate is a
    positive there (the reference's ``target[:, :-0] = 1`` is a no-op that
    makes its loss NaN; MIGRATION.md)."""
    idx = torch.arange(num_cand, device=device)
    if not ranking_or_no_judge_data:
        return idx == 0
    if pretrain:
        return idx < (1 + num_negatives)
    return idx < (num_cand - num_negatives)


def traj_judge_loss(logits, opt_mask, target_row):
    """BCE-with-logits with pos_weight = negatives / positives from the
    target row (reference utils_init.py:160-162), padded candidates left
    out of the mean and of the correct count (the JAX package's deliberate
    difference, equal on every batch the reference can feed).

    logits: [bs, num_cand]; target_row: [num_cand] bool.  Returns (loss,
    correct_count)."""
    bs, nc = logits.shape
    z = target_row.float()[None, :].expand(bs, nc)
    pos_weight = nc / target_row.float().sum() - 1.0
    m = opt_mask.float()
    pred = torch.where(opt_mask.bool(), logits.float(), 0.0)
    bce = _bce_with_logits(pred, z, pos_weight) * m
    loss = bce.sum() / torch.clamp(m.sum(), min=1.0)
    correct = (((torch.sigmoid(pred) > 0.5) == (z > 0.5)).float() * m).sum() / nc
    return loss, correct


def compute_task_losses(outputs: Dict[str, torch.Tensor], batch: Dict,
                        cfg_tasks: Dict) -> Tuple[torch.Tensor, Dict]:
    """Sum of the enabled task losses as the reference's train_epoch sums
    them (utils_init.py:192-239): vision + language + ranking +
    traj_loss_scale * traj.  ``outputs`` come from ``Lily`` on the flattened
    [bs * nc, ...] batch; ``batch`` holds opt_mask [bs, nc], ranking_target,
    image_targets, image_targets_mask, instr_targets (see
    ``parallel/train_step.py``); ``cfg_tasks`` is ``_task_config``'s dict.
    Returns (total_loss, metrics of per-task losses and correct counts)."""
    opt_mask = batch["opt_mask"]
    bs, nc = opt_mask.shape
    row_mask = opt_mask.reshape(-1)
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=opt_mask.device)

    if cfg_tasks["masked_vision"]:
        if "image_targets_idx" in batch:
            loss = masked_vision_loss_sparse(
                outputs["vision"], batch["image_targets_idx"],
                batch["image_targets"], row_mask,
                pre_gathered=batch.get("vision_pre_gathered", False),
                num_regions=batch.get("num_regions"))
        else:
            loss = masked_vision_loss(outputs["vision"], batch["image_targets"],
                                      batch["image_targets_mask"], row_mask)
        metrics["loss/vision"] = loss
        total = total + loss
    if cfg_tasks["masked_language"]:
        loss = masked_language_loss(outputs["language"],
                                    batch["instr_targets"], row_mask)
        metrics["loss/language"] = loss
        total = total + loss
    if cfg_tasks["ranking"]:
        logits = outputs["ranking"].reshape(bs, nc)
        loss_fn = (ranking_loss_train if cfg_tasks["training"]
                   else ranking_loss_eval)
        loss, correct = loss_fn(logits, opt_mask, batch["ranking_target"])
        metrics["loss/ranking"] = loss
        metrics["correct/ranking"] = correct
        total = total + loss
    if cfg_tasks["traj_judge"]:
        logits = outputs["traj"].reshape(bs, nc)
        target_row = traj_judge_targets(
            nc, ranking_or_no_judge_data=(cfg_tasks["ranking"]
                                          or cfg_tasks["not_traj_judge_data"]),
            pretrain=cfg_tasks["pretrain"],
            num_negatives=cfg_tasks["num_negatives"], device=logits.device)
        loss, correct = traj_judge_loss(logits, opt_mask, target_row)
        metrics["loss/traj"] = loss
        metrics["correct/traj"] = correct
        total = total + cfg_tasks["traj_loss_scale"] * loss

    # the reference logs loss/train as the UNSCALED sum of task losses
    # (utils_init.py:226-228) while backprop uses traj_loss_scale
    metrics["loss/train"] = sum(
        (v for k, v in metrics.items() if k.startswith("loss/")),
        torch.zeros((), dtype=torch.float32, device=opt_mask.device))
    return total, metrics
