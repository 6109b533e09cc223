"""Training engine: data wiring, epoch loops and checkpoint management
(counterpart of ``youtube_vln_tpu/training/engine.py``), on one device or
data-parallel over a process group (``parallel/distributed.py``).

Replaces the reference's ``utils/dataset/dataset_init.py`` (loader wiring),
``utils/utils_init.py`` (train/test/val epochs) and the orchestration in
``pretrain.py`` / ``train.py``:

  * one train step per optimizer step (``parallel/train_step.py``); its
    metrics stay on the device and are read back once per log window
  * host-to-device prefetch (``device.prefetch_to_device``: pinned memory,
    non-blocking copies) overlaps the input pipeline with the steps
  * checkpoints are reference-interop ``.bin`` files with the optimizer
    state for ``--resume``, written by rank 0, or with
    ``--orbax_checkpoints`` ``torch.distributed.checkpoint`` directories
    written by every rank together (``training/checkpoint.py``)
  * an optional ``torch.profiler`` trace of steps 2-8 of the first epoch,
    one per rank

Under a process group of W ranks ``--batch_size`` stays the global batch,
and ``--mesh_shape D M`` lays the ranks out as D data x M model
coordinates (D x M = W; the default is W x 1): each rank loads ``batch //
accum // D`` rows per micro-step from its data coordinate's shard of the
data (``Loader(num_shards=D, shard=data_rank)``; the M model ranks of a
coordinate load the same rows), the model holds this rank's shard of the
weights on the model axis (``Lily(..., shard=...)``), the step's losses and
metrics are those of the global batch (``parallel/train_step.py``), and
``evaluate`` sums its totals over the data ranks, so every rank returns
the same dict.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import LilyConfig, RunConfig
from ..data.datasets import BeamDataset, BnBDataset, YTbDataset
from ..data.features_reader import (BnBFeaturesReader, PanoFeaturesReader,
                                    YTbFeaturesReader)
from ..data.loader import Loader, microbatch_reshape
from ..data.tokenizer import load_tokenizer
from ..device import prefetch_to_device, resolve_device
from ..models import Lily
from ..parallel import distributed
from ..parallel import train_step as ts
from ..parallel.mesh import mesh_extents
from ..utils.misc import NoneLogger
from . import checkpoint as ckpt

logger = logging.getLogger(__name__)

# the profiled window of the first epoch: steps [2, 8)
PROFILE_STEPS = (2, 8)


class Subset:
    """Reference's torch Subset for --mini/--debug (dataset_init.py:122-137)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def __getattr__(self, name):
        # delegate the optional dataset hooks (reseed, num_candidates,
        # num_unique_candidates, ...): the Loader seeds each item only
        # when hasattr(ds, "reseed"), and a Subset that hid it would make
        # forked workers replay their fork-time RNG state
        if name.startswith("__") or name in ("dataset", "indices"):
            raise AttributeError(name)
        return getattr(self.dataset, name)


def _maybe_subset(dataset, size, seed=0):
    if size is None or len(dataset) <= size:
        return dataset
    idx = np.random.default_rng(seed).choice(len(dataset), size=size,
                                             replace=False)
    return Subset(dataset, idx)


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


def pretrain_caption_path(args: RunConfig, split: str) -> str:
    return (f"{args.data_dir}/YouTube-VLN/{args.pre_dataset}/"
            f"{args.prefix}{args.pre_dataset}_{split}{args.feather_note}.json")


def testset_paths(args: RunConfig) -> Dict[str, str]:
    """reference get_testset_path (dataset_init.py:23-35)."""
    base = (f"{args.data_dir}/YouTube-VLN/{args.pre_dataset}/{args.prefix}")
    out = {}
    if args.ranking or args.not_traj_judge_data:
        style = "" if args.negative_style == "normal" \
            else args.negative_style + "_"
        out["ranking"] = f"{base}{style}testset{args.feather_note}.json"
    if args.traj_judge and not args.ranking:
        out["traj"] = f"{base}traj_testset{args.feather_note}.json"
    return out


def load_pretrain_datasets(args: RunConfig, tokenizer):
    if args.pre_dataset == "ytb":
        reader = YTbFeaturesReader(list(args.ytb_feature))
        ds_cls = YTbDataset
    elif args.pre_dataset == "bnb":
        reader = BnBFeaturesReader(list(args.bnb_feature))
        ds_cls = BnBDataset
    else:
        raise ValueError(f"unknown pre_dataset {args.pre_dataset!r}")
    separators = ("then", "and", ",", ".") if args.separators else ("[SEP]",)
    tpaths = testset_paths(args)
    train = ds_cls(args=args, caption_path=pretrain_caption_path(args, "train"),
                   tokenizer=tokenizer, features_reader=reader,
                   masked_vision=args.masked_vision,
                   masked_language=args.masked_language, training=True,
                   separators=separators, seed=args.seed)
    test = ds_cls(args=args, caption_path=pretrain_caption_path(args, "test"),
                  tokenizer=tokenizer, features_reader=reader,
                  masked_vision=False, masked_language=False, training=False,
                  separators=separators, testset_path=tpaths, seed=args.seed)
    if args.mini:
        train = _maybe_subset(train, 950)
        test = _maybe_subset(test, 50)
    if args.debug:
        train = _maybe_subset(train, 8)
        test = _maybe_subset(test, 4)
    return train, test, reader


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


class Engine:
    """Owns the model, the optimizer, the data loaders and the epoch loops,
    on ``device`` (CUDA unless the caller asks for the CPU), as one rank of
    the process group when there is one."""

    def __init__(self, args: RunConfig, model_cfg: LilyConfig,
                 save_folder: Optional[Path] = None, run_logger=None,
                 device="cuda"):
        args.validate()
        self.device = resolve_device(device)
        self.args = args
        self.cfg = model_cfg
        self.save_folder = Path(save_folder) if save_folder else None
        self.world, self.rank = distributed.world_size(), distributed.rank()
        # the log and the writer (set by the entries) are rank 0's alone
        self.log = (run_logger or logger) if self.rank == 0 else NoneLogger()
        self.writer = None
        extents = mesh_extents(args.mesh_shape, args.mesh_axes, self.world)
        distributed.init_mesh(extents["data"], extents.get("model", 1))
        self.data_world, self.data_rank = (distributed.data_world(),
                                           distributed.data_rank())
        self.tokenizer = resolve_tokenizer(args)

        # datasets ------------------------------------------------------- #
        self.reader = None
        if args.pretrain:
            self.train_ds, self.test_ds, self.reader = \
                load_pretrain_datasets(args, self.tokenizer)
            self.val_seen_ds = self.val_unseen_ds = None
        else:
            self.reader = PanoFeaturesReader(args.img_feature)
            self.train_ds = load_beam_dataset("train", args, self.tokenizer,
                                              self.reader, training=True)
            self.test_ds = None
            if not args.no_test:
                self.val_seen_ds = load_beam_dataset(
                    "val_seen", args, self.tokenizer, self.reader, False)
                self.val_unseen_ds = load_beam_dataset(
                    "val_unseen", args, self.tokenizer, self.reader, False)
            else:
                self.val_seen_ds = self.val_unseen_ds = None
            if args.debug:
                self.train_ds = _maybe_subset(self.train_ds, 8)
                if self.val_seen_ds is not None:
                    self.val_seen_ds = _maybe_subset(self.val_seen_ds, 8)
                    self.val_unseen_ds = _maybe_subset(self.val_unseen_ds, 4)

        # args.batch_size is the global batch (dataset_init.py:204-208):
        # each data coordinate loads batch // accum // data_world rows per
        # micro-step from its shard, and their rows make the global batch
        accum = args.gradient_accumulation_steps
        self.step_batch = max(1, args.batch_size // accum // self.data_world)
        self.train_loader = Loader(self.train_ds, self.step_batch * accum,
                                   shuffle=True, seed=args.seed,
                                   num_shards=self.data_world,
                                   shard=self.data_rank,
                                   prefetch=args.host_prefetch,
                                   num_workers=args.num_workers)
        self.eval_loaders = {}
        for name, ds in (("test", self.test_ds),
                         ("val_seen", self.val_seen_ds),
                         ("val_unseen", self.val_unseen_ds)):
            if ds is not None:
                self.eval_loaders[name] = Loader(
                    ds, self.step_batch, shuffle=False, seed=args.seed,
                    num_shards=self.data_world, shard=self.data_rank,
                    drop_last=False, prefetch=args.host_prefetch,
                    num_workers=args.num_workers)

        # model / optimizer ---------------------------------------------- #
        self.model = Lily(model_cfg, device=self.device,
                          shard=distributed.model_shard()).init_weights(args.seed)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.log.info(f"number of parameters on this rank: {n_params:,}")
        self.optimizer, self.schedule = ts.create_train_state(
            self.model, args, steps_per_epoch=len(self.train_loader))
        self.start_epoch = 0
        is_sentinel = (args.from_pretrained == "bert-base-uncased"
                       and not Path(args.from_pretrained).exists())
        if args.from_pretrained and is_sentinel:
            # the CLI default is the reference's HF model name; nothing is
            # downloaded, so the model keeps its initialisation: loudly
            self.log.warning(
                "from_pretrained='bert-base-uncased' is the HF-name sentinel "
                "and no such local path exists: initializing from scratch "
                "(no egress to download HF weights)")
        if args.from_pretrained and not is_sentinel:
            _, _, _, epoch = ckpt.load_checkpoint(
                args.from_pretrained, self.model,
                optimizer=self.optimizer if args.resume else None)
            if args.resume:
                self.start_epoch = epoch + 1
                self.log.info(f"resuming from epoch {self.start_epoch}")

        self._train_step = ts.build_train_step(self.model, model_cfg, args,
                                               self.optimizer,
                                               device=self.device)
        self._eval_step = ts.build_eval_step(self.model, model_cfg, args,
                                             device=self.device)
        # the host draws each step's 64-bit dropout seed; a resumed run
        # restarts the sequence, as the JAX engine's PRNGKey(seed) does
        self.rng = np.random.default_rng(args.seed)

    # -------------------------------------------------------------------- #
    def _device_batches(self, loader, accum=1):
        batches = (microbatch_reshape(b, accum) if accum > 1 else b
                   for b in loader)
        return prefetch_to_device(batches, self.device,
                                  max(1, self.args.host_prefetch))

    def _next_seed(self) -> int:
        return int(self.rng.integers(0, 2 ** 64, dtype=np.uint64))

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_trace(self, prof, epoch: int, first: int, end: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = Path(self.args.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        rank = f".rank{self.rank}" if self.world > 1 else ""
        path = out / f"train_epoch{epoch}_steps{first}-{end - 1}{rank}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        self.log.info(f"profiler trace written to {path}")

    def train_epoch(self, epoch: int) -> None:
        args = self.args
        self.train_loader.set_epoch(epoch)
        accum = args.gradient_accumulation_steps
        profiling = bool(args.profile_dir) and epoch == self.start_epoch
        prof = None
        t0 = time.time()
        n = 0
        pending = []
        for batch in self._device_batches(self.train_loader, accum):
            if profiling and n == PROFILE_STEPS[0]:
                prof = self._start_trace()
            metrics = self._train_step(batch, self._next_seed())
            pending.append(metrics)
            n += 1
            if prof is not None and n == PROFILE_STEPS[1]:
                self._stop_trace(prof, epoch, PROFILE_STEPS[0], n)
                profiling, prof = False, None
            if len(pending) >= 20:
                self._log_metrics(epoch, n, pending)
                pending = []
        if prof is not None:  # a short epoch: close the trace
            self._stop_trace(prof, epoch, PROFILE_STEPS[0], n)
        if pending:
            self._log_metrics(epoch, n, pending)
        dt = time.time() - t0
        steps_s = n / max(dt, 1e-9)
        self.log.info(
            f"epoch {epoch}: {n} steps in {dt:.1f}s "
            f"({steps_s:.2f} steps/s, "
            f"{steps_s * args.batch_size:.1f} samples/s)")

    def _log_metrics(self, epoch, step, pending) -> None:
        # one readback for the window: the last step's metrics, stacked
        keys = sorted(pending[-1])
        vals = torch.stack([pending[-1][k].float() for k in keys]).tolist()
        last = dict(zip(keys, vals))
        lr = float(self.schedule(self.optimizer.step_count - 1))
        parts = " ".join(f"{k.split('/')[-1]}={v:.3f}"
                         for k, v in sorted(last.items())
                         if k.startswith("loss/"))
        self.log.info(f"epoch {epoch} step {step}: {parts} lr={lr:.2e}")
        if self.writer is not None:
            gstep = self.optimizer.step_count
            self.writer.add_scalar("learning_rate/train", lr, gstep)
            for k, v in last.items():
                self.writer.add_scalar(k, v, gstep)

    # -------------------------------------------------------------------- #
    def evaluate(self, name: str, epoch: int = 0) -> Dict[str, float]:
        """test_epoch / val_epoch equivalent: per-task loss averaged over
        batches and accuracy = correct / samples over a split (reference
        utils_init.py:315-446).  Under a process group the batches are the
        global batches of the data ranks' shards (a split that the data
        extent does not divide is wrap-padded, as ``shard_indices`` pads
        it): the sums and the sample count are summed over the data ranks
        once, and every rank returns the same dict."""
        loader = self.eval_loaders[name]
        n_batches = 0
        n_samples = 0
        acc: Dict[str, Any] = {}   # running sums on the device
        for batch in self._device_batches(loader):
            metrics = self._eval_step(batch)
            n_samples += batch["opt_mask"].shape[0]
            n_batches += 1
            for k, v in metrics.items():
                acc[k] = v if k not in acc else acc[k] + v
        # one stacked collective and readback for the split
        keys = sorted(acc)
        totals = torch.stack([acc[k].float() for k in keys]
                             + [torch.tensor(float(n_samples), device=self.device)])
        *vals, n_samples = distributed.sum_across_data(totals).tolist()
        out: Dict[str, float] = {}
        for k, v in zip(keys, vals):
            if k.startswith("loss/"):
                out[k] = v / max(n_batches, 1)
            elif k.startswith("correct/"):
                task = k.split("/")[1]
                out[f"accuracy/{task}"] = v / max(n_samples, 1)
        tips = " ".join(f"{k}={v:.3f}" for k, v in sorted(out.items()))
        self.log.info(f"[{name}] epoch {epoch}: {tips}")
        if self.writer is not None:
            for k, v in out.items():
                self.writer.add_scalar(f"{k}_{name}", v,
                                       self.optimizer.step_count)
        return out

    # -------------------------------------------------------------------- #
    def save(self, save_name, epoch: int) -> str:
        """Saves the model and the optimizer; returns the path.  Every rank
        calls it: the ``.bin`` is written by rank 0 alone, from the tensors
        that the model ranks of data coordinate 0 gather together, a
        ``--orbax_checkpoints`` directory by all of them together."""
        assert self.save_folder is not None
        self.save_folder.mkdir(parents=True, exist_ok=True)
        if self.args.orbax_checkpoints:
            return ckpt.save_dcp(self.save_folder, save_name, self.model,
                                 optimizer=self.optimizer,
                                 step=self.optimizer.step_count, epoch=epoch)
        if self.data_rank != 0:
            return ckpt.checkpoint_path(self.save_folder, save_name)
        return ckpt.save_checkpoint(
            self.save_folder, save_name, self.model, self.cfg,
            optimizer=self.optimizer, step=self.optimizer.step_count,
            epoch=epoch, write=self.rank == 0)

    def close(self):
        if self.reader is not None:
            self.reader.close()
