"""Step-time breakdown on the card: times variants of the train step to
locate the bottleneck (the counterpart of ``scripts/profile_step.py``).

    python -m youtube_vln_tpu_torch.entries.profile_step [VARIANT ...]
        [--recipe mrt|30rs] [--config_file F] [--batch_size B]
        [--steps N] [--device cpu]

Recipes: ``mrt`` (default, the JAX script's) is the pretraining step of
every task at 8 x 7 candidates, sparse MVM targets; ``30rs`` the
fine-tuning step of recipe 30RS (ranking) at 16 x 6.  Both at 60 + 808
tokens on ``lily_base_config`` from seed 0 in bf16 (``--config_file``:
another topology), on a batch staged on the device before timing.

Variants (default ``full fwd encoder``):
  full               the optimizer step (``build_train_step``), dropout on;
  full_xla           the same on the plain attention (``--no_pallas``);
  full_epi           with the epilogue kernels B5/B6 (``use_epilogue_kernels``);
  full_nodrop, full_noattndrop, full_nohiddendrop
                     every dropout, the attention dropouts, the hidden
                     dropouts at 0;
  noopt              forward and backward, no update;
  fwd_train          the forward in train mode;
  fwd, fwd_dense     the forward and losses in eval mode (dense: full
                     [S_v, 1601] vision targets; MRT only);
  encoder, encoder_xla
                     ``BertModel`` alone in eval mode, kernels or plain;
  enc_grad           ``BertModel`` in train mode, forward and backward of
                     sum(seq_t^2) + sum(seq_v^2);
  heads              fwd minus encoder.
``full_rbg`` (the JAX RBG generator) has no counterpart and is refused.

Each variant runs 2 warm-up calls, then ``--steps`` calls between two CUDA
events (the host clock on the CPU).  The last line is one JSON object of
ms per variant, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Dict

import numpy as np
import torch

from ..config import RunConfig
from ..device import resolve_device, to_device
from ..models import Lily
from ..models.layers import DropoutRng
from ..parallel import train_step as ts
from ..utils.measure import RECIPES, S_T, S_V, card, elapsed_ms, recipe

VARIANTS = ("full", "full_xla", "full_epi", "full_nodrop", "full_noattndrop",
            "full_nohiddendrop", "noopt", "fwd_train", "fwd", "fwd_dense",
            "encoder", "encoder_xla", "enc_grad", "heads")
NO_COUNTERPART = {"full_rbg": "the JAX RBG generator has no counterpart: every "
                              "dropout site here draws Philox or torch bits"}
DROPOUTS = {"full_nodrop": ("hidden_dropout_prob", "attention_probs_dropout_prob",
                            "v_hidden_dropout_prob", "v_attention_probs_dropout_prob"),
            "full_noattndrop": ("attention_probs_dropout_prob",
                                "v_attention_probs_dropout_prob"),
            "full_nohiddendrop": ("hidden_dropout_prob", "v_hidden_dropout_prob")}


class Profiler:
    """The recipe's model, batch and step on one device."""

    def __init__(self, name: str, device, config_file: str = "",
                 batch_size: int = 0, steps: int = 8):
        spec = RECIPES[name]
        self.recipe, self.device, self.steps = name, resolve_device(device), steps
        self.cfg, run = recipe(name, config_file)
        self.args = RunConfig(**run)
        self.args.validate()
        self.bs = batch_size or spec["batch"][0]
        self.nc = spec["batch"][1]
        self.host_batch = spec["make"](self.cfg, self.bs, self.nc, S_T, S_V)
        self.batch = to_device(self.host_batch, self.device)
        self.flat = ts.flatten_candidates(self.batch)
        self.tasks = ts._task_config(self.args, training=True)

    def model(self, cfg=None) -> Lily:
        return Lily(cfg or self.cfg, device=self.device).init_weights(0)

    def time(self, fn: Callable[[int], object]) -> float:
        for i in range(2):
            fn(1000 + i)
        calls = iter(range(self.steps))
        return elapsed_ms(lambda: fn(next(calls)), self.steps, self.device)

    def train_step(self, cfg) -> Callable[[int], object]:
        """The recipe's optimizer step on ``cfg``."""
        model = self.model(cfg)
        optimizer, _ = ts.create_train_state(model, self.args, steps_per_epoch=1000)
        step = ts.build_train_step(model, cfg, self.args, optimizer, self.device)
        return lambda i: step(self.batch, i)

    def variant(self, name: str) -> Callable[[int], object]:
        cfg = self.cfg
        if name.startswith("full"):
            if name == "full_xla":
                cfg = dataclasses.replace(cfg, use_attention_kernels=False)
            elif name == "full_epi":
                cfg = dataclasses.replace(cfg, use_epilogue_kernels=True)
            elif name in DROPOUTS:
                cfg = dataclasses.replace(cfg, **dict.fromkeys(DROPOUTS[name], 0.0))
            return self.train_step(cfg)
        if name == "encoder_xla":
            cfg = dataclasses.replace(cfg, use_attention_kernels=False)
        model, batch, flat = self.model(cfg), self.batch, self.flat
        if name == "noopt":
            def fn(i):
                model.train()
                loss, m = ts.loss_fn(model, batch, self.tasks, i)
                loss.backward()
                model.zero_grad(set_to_none=True)
                return m
            return fn
        if name == "fwd_train":
            def fn(i):
                model.train()
                with torch.no_grad():
                    return ts.loss_fn(model, batch, self.tasks, i)[0]
            return fn
        if name in ("fwd", "fwd_dense"):
            if name == "fwd_dense":
                if self.recipe != "mrt":
                    raise ValueError("fwd_dense needs vision targets: --recipe mrt")
                dense = dict(self.host_batch)
                dense.pop("image_targets_idx")
                dense["image_targets"] = np.full(
                    (self.bs, self.nc, S_V, cfg.v_target_size),
                    1.0 / cfg.v_target_size, np.float32)
                batch = to_device(dense, self.device)

            def fn(i):
                # the training losses without dropout, as the JAX script
                model.eval()
                with torch.no_grad():
                    return ts.loss_fn(model, batch, self.tasks)[0]
            return fn
        bert_inputs = (flat["instr_tokens"], flat["image_features"],
                       flat["image_locations"], flat["segment_ids"],
                       flat["instr_mask"], flat["image_mask"])
        if name in ("encoder", "encoder_xla"):
            def fn(i):
                model.eval()
                with torch.no_grad():
                    return model.bert(*bert_inputs)[2]
            return fn
        if name == "enc_grad":
            def fn(i):
                model.train()
                seq_t, seq_v, _, _ = model.bert(*bert_inputs,
                                                DropoutRng(i, self.device))
                (seq_t.float().square().sum() + seq_v.float().square().sum()).backward()
                model.zero_grad(set_to_none=True)
            return fn
        raise ValueError(f"unknown variant {name!r}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=["full", "fwd", "encoder"])
    ap.add_argument("--recipe", default="mrt", choices=sorted(RECIPES))
    ap.add_argument("--config_file", default="",
                    help="model topology (default lily_base_config)")
    ap.add_argument("--batch_size", type=int, default=0,
                    help="instructions per step (default the recipe's)")
    ap.add_argument("--steps", type=int, default=8, help="timed calls per variant")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ns = ap.parse_args(argv)
    for name in ns.variants:
        if name in NO_COUNTERPART:
            raise SystemExit(f"profile_step: {name}: {NO_COUNTERPART[name]}")
        if name not in VARIANTS:
            raise SystemExit(f"profile_step: unknown variant {name!r}; one of "
                             f"{', '.join(VARIANTS)}")

    prof = Profiler(ns.recipe, ns.device, ns.config_file, ns.batch_size, ns.steps)
    results: Dict[str, float] = {}
    for name in ns.variants:
        if name == "heads":
            for part in ("fwd", "encoder"):
                if part not in results:
                    results[part] = prof.time(prof.variant(part))
            results[name] = results["fwd"] - results["encoder"]
        else:
            results[name] = prof.time(prof.variant(name))
        print(f"{name}: {results[name]:.2f} ms", flush=True)
        if prof.device.type == "cuda":
            torch.cuda.empty_cache()
    out = {"profile_step": results, "recipe": ns.recipe,
           "batch": [prof.bs, prof.nc, S_T, S_V],
           "timing": "cuda events" if prof.device.type == "cuda" else "host clock",
           "device": card(prof.device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
