"""Batch transports, the train step and the eval step (counterpart of
``youtube_vln_tpu/parallel/train_step.py``).

Batch layout (the loader's numpy batches, moved to the device as they are):

  instr_tokens   [B, nc, S_t] i32     image_features     [B, nc, S_v, 2048]
  instr_mask     [B, nc, S_t] i32     image_locations    [B, nc, S_v, 12]
  segment_ids    [B, nc, S_t] i32     image_mask         [B, nc, S_v] i32
  instr_targets  [B, nc, S_t] i32     image_targets      [B, nc, S_v, C]
  opt_mask       [B, nc] bool         image_targets_mask [B, nc, S_v] i32
  ranking_target [B] i32 (train) / [B, nc] f32 multi-hot (eval)

or, on the candidate-dedup transport, ``uniq_image_features`` [B, n_u,
S_v, 2048], ``uniq_image_locations``, ``uniq_image_mask``, ``cand_index``
[B, nc] (and ``feature_zero_mask`` [B, nc, S_v] with masked vision) in
place of the ``image_*`` arrays; on the beam-eval step-dedup transport,
``uniq_step_features`` [B, n_u, boxes, 2048], ``uniq_step_locations``,
``uniq_step_mask`` and ``step_index`` [B, nc, L].  Features stay in their
transport dtype (float16) here; the model upcasts them.

``build_train_step`` returns one optimizer step: the forward in train mode
(dropout on, kernels B1/B2 forward and B3/B4 backward at the kernel
sites), the task losses, the backward, the ``AdamWRef`` update and zeroed
gradients.  Its metrics stay device tensors: nothing is read back.

Under a process group (``parallel/distributed.py``) the step wraps the
model in ``DistributedDataParallel`` and keeps the JAX package's
global-batch semantics: each rank's loss is its share of the global
batch's loss (``training/losses.py``, the counts summed over the ranks),
scaled by the world size because DDP averages the gradients; the metrics
are summed over the ranks, so ``loss/*`` are the global batch's losses
and ``correct/*`` its counts; dropout masks are those of the global
batch's rows (``models/layers.py:DropoutRng``).  Under a ``data`` x
``model`` mesh (``distributed.init_mesh``) each of those is over the data
axis alone: DDP runs over the ranks of this model coordinate, which hold
the same shard of the weights, the loss is scaled by the data extent, the
counts and metrics are summed over the data ranks (the model ranks of one
data coordinate hold the same rows and compute the same values), the masks
are those of the data coordinate's rows, and the gradients of the
replicated embedding tables are averaged over the model ranks
(``parallel/tensor.py:average_over_model``), so every replica stays equal.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import RunConfig
from ..device import resolve_device, to_device
from ..ops.philox import site_seed
from ..training import losses as losses_lib
from ..training.optimization import AdamWRef, make_schedule, param_groups
from . import distributed
from .tensor import average_over_model

# static cap on target-carrying text positions per row (JAX
# train_step.py:141-144): 32 of 60 is > 8 sigma above the 15% ladder
MAX_LANGUAGE_TARGETS = 32
# micro-step i of an accumulated step with seed s runs with seed
# site_seed(s, MICRO_STEP_SITE + i), apart from the model's own sites
MICRO_STEP_SITE = 1 << 32


def _gather_candidates(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, c]] for x [B, n_u, ...] and idx [B, nc] -> [B, nc, ...]."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return x[rows, idx.long()]


def _expand_dedup(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Candidate-dedup transport -> per-candidate visual arrays, gathered on
    the device; ``feature_zero_mask`` zeroes the masked regions of each
    candidate's copy, as the dense path corrupts its copies on the host."""
    if "uniq_image_features" not in batch:
        return batch
    idx = batch["cand_index"]
    feats = _gather_candidates(batch["uniq_image_features"], idx)
    if "feature_zero_mask" in batch:
        keep = (batch["feature_zero_mask"] == 0)[..., None]
        feats = feats * keep.to(feats.dtype)
    out = dict(batch)
    out["image_features"] = feats
    out["image_locations"] = _gather_candidates(batch["uniq_image_locations"], idx)
    out["image_mask"] = _gather_candidates(batch["uniq_image_mask"], idx)
    for k in ("uniq_image_features", "uniq_image_locations",
              "uniq_image_mask", "cand_index", "feature_zero_mask"):
        out.pop(k, None)
    return out


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


def _merge01(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def flatten_candidates(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """[B, nc, ...] -> [B*nc, ...] for the model inputs."""
    return {k: _merge01(batch[k]) for k in
            ("instr_tokens", "instr_mask", "segment_ids", "image_features",
             "image_locations", "image_mask")}


def _task_config(args: RunConfig, training: bool) -> Dict[str, Any]:
    # action-word masking can push the per-row masked count past the sparse
    # MLM cap: the dense MLM head runs there (the vision cap is unaffected)
    sparse_heads = args.sparse_task_heads and args.mask_action_rate == 0.0
    return dict(ranking=args.ranking, traj_judge=args.traj_judge,
                masked_vision=args.masked_vision,
                masked_language=args.masked_language,
                pretrain=args.pretrain, num_negatives=args.num_negatives,
                traj_loss_scale=args.traj_loss_scale,
                not_traj_judge_data=args.not_traj_judge_data,
                sparse_task_heads=sparse_heads,
                sparse_vision_head=args.sparse_task_heads,
                training=training)


def loss_fn(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
            tasks: Dict[str, Any], seed=None, rank: int = 0,
            total_counts: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics) of one batch on the device; train or eval as
    the model is set, ``seed`` the dropout seed of train mode, ``rank`` the
    process's data coordinate (its place on the data axis) and
    ``total_counts`` the sum of the loss counts over the data axis
    (``compute_task_losses``)."""
    batch = expand_beam_steps(_expand_dedup(batch))
    flat = flatten_candidates(batch)
    instr_targets = _merge01(batch["instr_targets"])
    sparse_heads = tasks.get("sparse_task_heads", False)

    lang_idx = vis_idx = None
    if sparse_heads and tasks["masked_language"]:
        m = min(instr_targets.shape[1], MAX_LANGUAGE_TARGETS)
        # target-carrying positions first (stable: ties keep position order)
        lang_idx = torch.argsort((instr_targets < 0).to(torch.int8), dim=1,
                                 stable=True)[:, :m]
        instr_targets = torch.take_along_dim(instr_targets, lang_idx, dim=1)
    if (tasks.get("sparse_vision_head", sparse_heads)
            and tasks["masked_vision"] and "image_targets_idx" in batch):
        # padding sentinel == s_v: clamped for the gather, the loss keeps
        # the raw indices for validity
        s_v = flat["image_mask"].shape[1]
        vis_idx = torch.clamp(_merge01(batch["image_targets_idx"]), max=s_v - 1)

    outputs = model(
        flat["instr_tokens"], flat["image_features"], flat["image_locations"],
        token_type_ids=flat["segment_ids"], attention_mask=flat["instr_mask"],
        image_attention_mask=flat["image_mask"],
        language_target_idx=lang_idx, vision_target_idx=vis_idx, seed=seed,
        rank=rank)
    loss_batch = dict(opt_mask=batch["opt_mask"],
                      ranking_target=batch["ranking_target"],
                      instr_targets=instr_targets,
                      num_regions=flat["image_mask"].shape[1])
    if "image_targets" in batch:
        loss_batch["image_targets"] = _merge01(batch["image_targets"])
        loss_batch["image_targets_mask"] = _merge01(batch["image_targets_mask"])
    if "image_targets_idx" in batch:
        loss_batch["image_targets_idx"] = _merge01(batch["image_targets_idx"])
        loss_batch["vision_pre_gathered"] = vis_idx is not None
    return losses_lib.compute_task_losses(outputs, loss_batch, tasks,
                                          total_counts)


def create_train_state(model: torch.nn.Module, args: RunConfig,
                       steps_per_epoch: int
                       ) -> Tuple[AdamWRef, Callable[[int], float]]:
    """(optimizer, schedule) for ``model``: ``AdamWRef`` over the
    decay / no-decay groups, with the schedule of ``make_schedule``
    (``steps_per_epoch`` counts optimizer steps)."""
    schedule = make_schedule(args, steps_per_epoch)
    optimizer = AdamWRef(param_groups(model, args.weight_decay), schedule,
                         weight_decay=args.weight_decay)
    return optimizer, schedule


def _check_model(model: torch.nn.Module, cfg, args: RunConfig,
                 device: torch.device) -> None:
    """The model lies on the step's device and has the head of every task
    the run trains."""
    param_device = next(model.parameters()).device
    if param_device.type != device.type:
        raise ValueError(f"model is on {param_device}, the step on {device}")
    for task in ("ranking", "traj_judge", "masked_vision", "masked_language"):
        if getattr(args, task) and not getattr(cfg, task):
            raise ValueError(f"the run trains {task} but the model has no "
                             f"{task} head")


def data_parallel(model: torch.nn.Module, device: torch.device
                  ) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` over the data group (the
    ranks of this model coordinate; on the default group DDP's first
    broadcast would copy model rank 0's shards over the others').
    ``find_unused_parameters``, as the reference wraps it
    (``SURVEY.md:120``): a run that trains some heads leaves the others
    and the frozen prefixes without a gradient, and DDP then leaves their
    gradient unset on every rank, so ``AdamWRef`` gives them the zero
    gradient of the JAX tree update."""
    from torch.nn.parallel import DistributedDataParallel
    ids = None
    if device.type == "cuda":
        ids = [device.index if device.index is not None
               else torch.cuda.current_device()]
    return DistributedDataParallel(model, device_ids=ids,
                                   process_group=distributed.data_group(),
                                   find_unused_parameters=True)


def _sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The metrics summed over the data ranks, in one collective."""
    keys = list(metrics)
    total = distributed.sum_across_data(
        torch.stack([metrics[k].float() for k in keys]))
    return dict(zip(keys, total))


def _refuse_batch_expansion(cfg) -> None:
    """``in_batch_pairs`` and ``fast_mode`` expand the batch inside the
    encoder (``models/vilbert.py:Encoder.forward``).  The JAX step expands
    the global batch (``parallel/train_step.py:289-308`` there); a rank here
    holds only its rows of it, so under a data axis above 1 either mode
    would pair other candidates: refused."""
    world = distributed.data_world()
    for mode in ("in_batch_pairs", "fast_mode"):
        if getattr(cfg, mode, False) and world > 1:
            raise ValueError(f"{mode} expands the global batch, which no rank "
                             f"holds under a data axis of {world}: run it in "
                             "one process")


def build_train_step(model: torch.nn.Module, cfg, args: RunConfig,
                     optimizer: torch.optim.Optimizer, device="cuda"
                     ) -> Callable[[Dict, int], Dict[str, torch.Tensor]]:
    """Returns ``step(batch, seed) -> metrics``.  ``batch`` is a numpy or
    tensor batch; with ``args.gradient_accumulation_steps`` A > 1 it carries
    a leading micro-batch axis [A, B/A, ...], the gradients are averaged
    over A before the one update, ``loss/*`` averaged and ``correct/*``
    summed (JAX train_step.py:232-256).  ``seed`` is the step's 64-bit
    dropout seed, drawn by the caller on the host and the same on every
    rank; ``cfg`` is the model's configuration, checked against the tasks
    of ``args``.  Under a process group the model is wrapped in DDP, which
    synchronises the gradients at the last micro-step alone."""
    device = resolve_device(device)
    _check_model(model, cfg, args, device)
    _refuse_batch_expansion(cfg)
    tasks = _task_config(args, training=True)
    accum = args.gradient_accumulation_steps
    params = [p for p in model.parameters() if p.requires_grad]
    synced = [p for p in params if getattr(p, "tp_sync", False)]
    shard = getattr(model, "shard", None)
    grouped = torch.distributed.is_initialized()
    world, rank = distributed.data_world(), distributed.data_rank()
    net = data_parallel(model, device) if grouped else model
    total_counts = distributed.sum_across_data if grouped else None

    def step(batch, seed: int) -> Dict[str, torch.Tensor]:
        net.train()
        batch = to_device(batch, device)
        micro = ([batch] if accum == 1 else
                 [{k: v[i] for k, v in batch.items()} for i in range(accum)])
        metrics: Dict[str, torch.Tensor] = {}
        for i, mb in enumerate(micro):
            mb_seed = seed if accum == 1 else site_seed(seed, MICRO_STEP_SITE + i)
            sync = (net.no_sync() if grouped and i < accum - 1
                    else contextlib.nullcontext())
            with sync:
                loss, m = loss_fn(net, mb, tasks, mb_seed, rank, total_counts)
                # DDP averages the gradients of the data ranks' shares
                (loss * world if world > 1 else loss).backward()
            for k, v in m.items():
                metrics[k] = metrics[k] + v.detach() if k in metrics else v.detach()
        if shard is not None:
            # the replicated embedding tables, equal on every model rank
            average_over_model([p.grad for p in synced if p.grad is not None],
                               shard)
        if accum > 1:
            torch._foreach_div_([p.grad for p in params if p.grad is not None],
                                float(accum))
            metrics = {k: v / accum if k.startswith("loss/") else v
                       for k, v in metrics.items()}
        if grouped:
            metrics = _sum_metrics(metrics)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return metrics

    return step


def build_eval_step(model: torch.nn.Module, cfg, args: RunConfig,
                    device="cuda"
                    ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Returns ``eval_step(batch) -> metrics`` (loss and correct count per
    task) in eval mode, with the eval losses of test_epoch and val_epoch
    (reference utils_init.py:306-312, 382-410).  Under a process group the
    losses are this rank's shares of the global batch's and the counts its
    own: the caller sums both over the data ranks (``Engine.evaluate``)."""
    device = resolve_device(device)
    _check_model(model, cfg, args, device)
    _refuse_batch_expansion(cfg)
    tasks = _task_config(args, training=False)
    total_counts = (distributed.sum_across_data
                    if torch.distributed.is_initialized() else None)

    def eval_step(batch) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            return loss_fn(model, to_device(batch, device), tasks,
                           total_counts=total_counts)[1]

    return eval_step
