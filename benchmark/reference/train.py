"""Plain reference of what the timed paths produce from a host batch: the
transports' expansion, the re-ranking scores, the task losses and the
AdamW update, in float32 on top of ``lily.py``.

Batches are the loader's numpy layout ([B, nc, ...] per instruction and
candidate).  The expansion is worked out here again: the step-dedup
transport's unique (viewpoint, heading, step) blocks gathered by
``step_index``; the candidate-dedup transport's unique trajectories
gathered by ``cand_index``, with ``feature_zero_mask`` zeroing the masked
regions.  A training step runs in blocks of whole instructions (each
task's sum over the block, divided by the whole batch's count) and
accumulates the gradients, so the losses and gradients are those of the
whole batch.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import lily

MAX_LANGUAGE_TARGETS = 32
NO_DECAY = ("bias", "LayerNorm.weight", "LayerNorm.bias")
B1, B2, EPS = 0.9, 0.999, 1e-6


def _t(a, device):
    return torch.as_tensor(np.asarray(a)).to(device)


def expand(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Per-candidate model inputs [B * nc, ...] and the loss fields of a
    host batch, on ``device`` (features in f32)."""
    b = {k: _t(v, device) for k, v in batch.items() if k != "instr_id"}
    bs, nc = b["opt_mask"].shape
    rows = torch.arange(bs, device=device)[:, None]
    if "uniq_step_features" in b:                       # step-dedup
        idx = b["step_index"].long()                    # [B, nc, L]
        steps = idx.shape[2]

        def gather(x):
            g = x[rows, idx.reshape(bs, -1)]            # [B, nc * L, boxes, ...]
            return g.reshape((bs, nc, steps * x.shape[2]) + tuple(x.shape[3:]))
        feats = gather(b["uniq_step_features"])
        locs = gather(b["uniq_step_locations"])
        mask = gather(b["uniq_step_mask"])
    elif "uniq_image_features" in b:                    # candidate-dedup
        idx = b["cand_index"].long()
        feats = b["uniq_image_features"][rows, idx]
        if "feature_zero_mask" in b:
            feats = feats * (b["feature_zero_mask"] == 0)[..., None].to(feats.dtype)
        locs = b["uniq_image_locations"][rows, idx]
        mask = b["uniq_image_mask"][rows, idx]
    else:
        feats, locs, mask = (b["image_features"], b["image_locations"],
                             b["image_mask"])

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))
    out = {"instr_tokens": flat(b["instr_tokens"]),
           "segment_ids": flat(b["segment_ids"]),
           "instr_mask": flat(b["instr_mask"]),
           "image_features": flat(feats).float(),
           "image_locations": flat(locs).float(),
           "image_mask": flat(mask),
           "opt_mask": b["opt_mask"].bool(),
           "ranking_target": b["ranking_target"],
           "instr_targets": flat(b["instr_targets"])}
    if "image_targets_idx" in b:
        out["image_targets_idx"] = flat(b["image_targets_idx"])
        out["image_targets"] = flat(b["image_targets"]).float()
    return out


MODEL_INPUTS = ("instr_tokens", "segment_ids", "instr_mask", "image_features",
                "image_locations", "image_mask")


@torch.no_grad()
def scores(P, cfg, batch, num=lily.F32, rows_per_block: int = 30):
    """[B, nc] ranking scores of an eval batch, -inf at padded candidates."""
    x = expand(batch, next(iter(P.values())).device)
    n = x["instr_tokens"].shape[0]
    logits = []
    for b0 in range(0, n, rows_per_block):
        b1 = min(n, b0 + rows_per_block)
        blk = lily.Block(b0, b1, n, None)
        out = lily.forward(P, cfg, {k: x[k][b0:b1] for k in MODEL_INPUTS},
                           blk, num)
        logits.append(out["ranking"][:, 0])
    logits = torch.cat(logits).reshape(x["opt_mask"].shape)
    return logits.masked_fill(~x["opt_mask"], float("-inf"))


# --------------------------------------------------------------------------- #
# losses, as sums over a block of whole instructions and counts over the batch
# --------------------------------------------------------------------------- #
def _xlogy(x, y):
    zero = x == 0.0
    return torch.where(zero, 0.0, x * torch.log(torch.where(zero, 1.0, y)))


def _bce(x, z, pos_weight=None):
    log_weight = 1.0 if pos_weight is None else 1.0 + (pos_weight - 1.0) * z
    return (1.0 - z) * x + log_weight * (torch.clamp(-x, min=0.0)
                                         + torch.log1p(torch.exp(-x.abs())))


def language_rows(instr_targets: torch.Tensor) -> torch.Tensor:
    """The first 32 target-carrying positions of each row (position order,
    padded with the others)."""
    m = min(instr_targets.shape[1], MAX_LANGUAGE_TARGETS)
    return torch.argsort((instr_targets < 0).to(torch.int8), dim=1,
                         stable=True)[:, :m]


def traj_targets(nc: int, run: Dict, device) -> torch.Tensor:
    idx = torch.arange(nc, device=device)
    if not (run["ranking"] or run.get("not_traj_judge_data", False)):
        return idx == 0
    if run["pretrain"]:
        return idx < 1 + run["num_negatives"]
    return idx < nc - run["num_negatives"]


def counts(x, run, lang_idx) -> Dict[str, torch.Tensor]:
    """The whole batch's count of each task's terms."""
    row_mask = x["opt_mask"].reshape(-1)
    out = {}
    if run["masked_vision"]:
        s_v = x["image_mask"].shape[1]
        out["vision"] = ((x["image_targets_idx"] < s_v)
                         & row_mask[:, None]).float().sum()
    if run["masked_language"]:
        tgt = torch.take_along_dim(x["instr_targets"], lang_idx, dim=1)
        out["language"] = ((tgt >= 0) & row_mask[:, None]).float().sum()
    if run["ranking"]:
        out["ranking"] = (x["ranking_target"] >= 0).float().sum()
    if run["traj_judge"]:
        out["traj"] = x["opt_mask"].float().sum()
    return {k: torch.clamp(v, min=1.0) for k, v in out.items()}


def block_sums(outputs, x, run, i0: int, i1: int, nc: int,
               lang_idx) -> Dict[str, torch.Tensor]:
    """Each task's sum over instructions [i0, i1) (rows i0*nc..i1*nc)."""
    r0, r1 = i0 * nc, i1 * nc
    opt = x["opt_mask"][i0:i1]
    row_mask = opt.reshape(-1)
    out = {}
    if run["masked_vision"]:
        s_v = x["image_mask"].shape[1]
        idx = x["image_targets_idx"][r0:r1]
        valid = (idx < s_v) & row_mask[:, None]
        logp = F.log_softmax(outputs["vision"], dim=-1)
        t = x["image_targets"][r0:r1]
        kl = _xlogy(t, t) - t * logp
        out["vision"] = (kl * valid[..., None].float()).sum()
    if run["masked_language"]:
        tgt = torch.take_along_dim(x["instr_targets"][r0:r1], lang_idx[r0:r1], dim=1)
        valid = (tgt >= 0) & row_mask[:, None]
        logp = F.log_softmax(outputs["language"], dim=-1)
        nll = -torch.gather(logp, -1, torch.where(valid, tgt, 0).long()[..., None])[..., 0]
        out["language"] = torch.where(valid, nll, 0.0).sum()
    if run["ranking"]:
        logits = outputs["ranking"].reshape(i1 - i0, nc)
        pred = logits.masked_fill(~opt, float("-inf"))
        target = x["ranking_target"][i0:i1].long()
        valid = target >= 0
        logp = F.log_softmax(pred, dim=-1)
        nll = -torch.gather(logp, 1, torch.where(valid, target, 0)[:, None])[:, 0]
        out["ranking"] = torch.where(valid, nll, 0.0).sum()
    if run["traj_judge"]:
        logits = outputs["traj"].reshape(i1 - i0, nc)
        target_row = traj_targets(nc, run, logits.device)
        z = target_row.float()[None, :].expand(i1 - i0, nc)
        pos_weight = nc / target_row.float().sum() - 1.0
        pred = torch.where(opt, logits, 0.0)
        out["traj"] = (_bce(pred, z, pos_weight) * opt.float()).sum()
    return out


def loss_and_grads(P, cfg, run, batch, seed: int, num=lily.F32,
                   instr_per_block: int = 4):
    """(loss/train, {name: gradient}) of one train-mode step on ``batch``
    with dropout seed ``seed``: the unscaled sum of the task losses, and the
    gradients of the scaled sum (trajectory judgement times
    ``traj_loss_scale``) with respect to every weight in ``P``."""
    device = next(iter(P.values())).device
    x = expand(batch, device)
    bs, nc = x["opt_mask"].shape
    n = bs * nc
    lang_idx = language_rows(x["instr_targets"]) if cfg["masked_language"] else None
    vis_rows = None
    if cfg["masked_vision"]:
        vis_rows = torch.clamp(x["image_targets_idx"],
                               max=x["image_mask"].shape[1] - 1)
    totals = counts(x, run, lang_idx)
    leaves = {k: v.detach().requires_grad_() for k, v in P.items()
              if k != lily.TIED[0]}
    leaves[lily.TIED[0]] = leaves[lily.TIED[1]]
    drop = lily.Dropout(seed, device)
    loss = torch.zeros((), device=device)
    for i0 in range(0, bs, instr_per_block):
        i1 = min(bs, i0 + instr_per_block)
        r0, r1 = i0 * nc, i1 * nc
        drop.replay()
        blk = lily.Block(r0, r1, n, drop)
        out = lily.forward(leaves, cfg, {k: x[k][r0:r1] for k in MODEL_INPUTS},
                           blk, num,
                           None if lang_idx is None else lang_idx[r0:r1],
                           None if vis_rows is None else vis_rows[r0:r1])
        sums = block_sums(out, x, run, i0, i1, nc, lang_idx)
        scaled = sum((run["traj_loss_scale"] if k == "traj" else 1.0)
                     * s / totals[k] for k, s in sums.items())
        scaled.backward()
        loss += sum(s.detach() / totals[k] for k, s in sums.items())
    del drop
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items() if k != lily.TIED[0]}
    return float(loss), grads


# --------------------------------------------------------------------------- #
# AdamW with the post-update weight decay, and the warm-up schedule
# --------------------------------------------------------------------------- #
def learning_rate(run: Dict, step: int) -> float:
    """The rate of the ``step``-th update (0-based): linear warm-up over
    ``warmup_proportion`` of the run's steps, then a linear decay that
    reaches 0 ``cooldown_factor`` times the remaining steps later."""
    base = run["learning_rate"]
    if run["lr_schedule"] == "constant":
        return base
    if run["lr_schedule"] != "warmup_linear":
        raise ValueError(run["lr_schedule"])
    total = run["steps_per_epoch"] * run["num_epochs"]
    warm = run["warmup_proportion"] * total
    end = warm + run["cooldown_factor"] * (total - warm)
    if step < warm:
        return base * step / max(1.0, warm)
    return base * max(0.0, (end - step) / max(1.0, end - warm))


class AdamW:
    """m <- b1 m + (1 - b1) g; v <- b2 v + (1 - b2) g^2;
    p <- p - lr sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) + eps);
    p <- p - lr wd p, decay off for biases and LayerNorm weights."""

    def __init__(self, P: Dict[str, torch.Tensor], run: Dict):
        self.P, self.run, self.t = P, run, 0
        self.m = {k: torch.zeros_like(v) for k, v in P.items() if k != lily.TIED[0]}
        self.v = {k: torch.zeros_like(v) for k, v in self.m.items()}

    @torch.no_grad()
    def step(self, grads):
        f32 = np.float32
        lr = f32(learning_rate(self.run, self.t))
        self.t += 1
        t = f32(self.t)
        step_size = float(lr * np.sqrt(f32(1.0) - f32(B2) ** t)
                          / (f32(1.0) - f32(B1) ** t))
        wd = self.run["weight_decay"]
        for k, g in grads.items():
            m, v, p = self.m[k], self.v[k], self.P[k]
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            p.addcdiv_(m, v.sqrt().add_(EPS), value=-step_size)
            if wd > 0.0 and not any(nd in k for nd in NO_DECAY):
                p.add_(p, alpha=-float(lr) * wd)


def follow_steps(P, cfg, run, batches: Sequence, seeds: Sequence[int],
                 num=lily.F32, instr_per_block: int = 4, on_first=None):
    """The first ``len(batches)`` steps from the weights ``P`` (updated in
    place): (losses, per-leaf gradient norms of step 1).  ``on_first`` is
    called with step 1's gradients before the update."""
    opt = AdamW(P, run)
    losses: List[float] = []
    grad_norms = None
    for batch, seed in zip(batches, seeds):
        loss, grads = loss_and_grads(P, cfg, run, batch, seed, num,
                                     instr_per_block)
        losses.append(loss)
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            if on_first is not None:
                on_first(grads)
        opt.step(grads)
        del grads
    return losses, grad_norms
