"""Beam re-ranking inference, the port's main path (counterpart of
``youtube_vln_tpu/evaluation/beam_eval.py``).

One request is one instruction scored against its <= 30 beam-search paths
with the ranking head; ``convert_scores`` turns the argmax into a
trajectory and falls back to the beam-0 start viewpoint when the argmax
lands on a padded row (reference ``test.py:144-192``).  Batches arrive in
the loader's numpy layout (``parallel/train_step.py``), dense or on the
step-dedup transport, with ``instr_id`` [B, 2].
"""
from __future__ import annotations

import collections
import json
from typing import Callable, Dict, Iterable, Iterator, List, Tuple

import numpy as np
import torch

from ..config import LilyConfig
from ..device import resolve_device, to_device
from ..parallel.train_step import expand_beam_steps, flatten_candidates
from ..training.losses import pad_packed


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]],
                       device: torch.device, depth: int = 2
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Starts the copies of up to ``depth`` batches ahead of their use, so
    the host-to-device transfer overlaps the scoring of earlier batches."""
    buf = collections.deque()
    it = iter(batches)
    for b in it:
        buf.append(to_device(b, device))
        if len(buf) >= depth:
            break
    while buf:
        out = buf.popleft()
        for b in it:
            buf.append(to_device(b, device))
            break
        yield out


def build_score_step(model: torch.nn.Module, cfg: LilyConfig,
                     device="cuda") -> Callable[[Dict[str, torch.Tensor]],
                                                torch.Tensor]:
    """step(batch on ``device``) -> [bs, nc] f32 ranking scores, -inf at
    padded candidates."""
    device = resolve_device(device)
    if not cfg.ranking:
        raise ValueError("the beam scorer needs the ranking head (cfg.ranking)")
    param_device = next(model.parameters()).device
    if param_device.type != device.type:
        raise ValueError(f"model is on {param_device}, scoring on {device}")
    model.eval()

    def step(batch):
        with torch.inference_mode():
            flat = flatten_candidates(expand_beam_steps(batch))
            outputs = model(
                flat["instr_tokens"], flat["image_features"],
                flat["image_locations"], token_type_ids=flat["segment_ids"],
                attention_mask=flat["instr_mask"],
                image_attention_mask=flat["image_mask"])
            bs, nc = batch["opt_mask"].shape
            return pad_packed(outputs["ranking"].reshape(bs, nc),
                              batch["opt_mask"])
    return step


def eval_epoch(model: torch.nn.Module, cfg: LilyConfig,
               batches: Iterable[Dict[str, np.ndarray]], device="cuda",
               random_testing: bool = False, seed: int = 0,
               prefetch: int = 2) -> List[Tuple[str, List[float]]]:
    """Returns [(instr_id, [beam scores])] (reference test.py:144-166)."""
    device = resolve_device(device)
    step = build_score_step(model, cfg, device)
    rng = np.random.default_rng(seed)
    pending = []
    # instr_id is loader metadata: captured on the host before the copy,
    # so reading it never waits for the device
    ids_fifo: List[List[str]] = []

    def strip_ids(it):
        for b in it:
            ids_fifo.append([f"{int(a)}_{int(x)}" for a, x in
                             np.asarray(b["instr_id"])])
            yield {k: v for k, v in b.items() if k != "instr_id"}

    for batch in prefetch_to_device(strip_ids(batches), device, prefetch):
        instr_ids = ids_fifo.pop(0)
        if random_testing:
            pending.append((instr_ids,
                            rng.random(tuple(batch["opt_mask"].shape))))
        else:
            pending.append((instr_ids, step(batch)))
    all_scores: List[Tuple[str, List[float]]] = []
    for instr_ids, logits in pending:
        if torch.is_tensor(logits):
            logits = logits.cpu().numpy()
        for iid, row in zip(instr_ids, logits):
            all_scores.append((iid, [float(x) for x in row]))
    return all_scores


def convert_scores(all_scores, beam_path, add_exploration_path=False):
    """argmax beam -> trajectory (reference test.py:169-192)."""
    with open(beam_path) as f:
        beam_data = json.load(f)
    beams_by_id = {item["instr_id"]: item["ranked_paths"]
                   for item in beam_data}
    exploration_by_id = {}
    if add_exploration_path:
        exploration_by_id = {
            item["instr_id"]: [[vp] for vp in item["exploration_path"]]
            for item in beam_data}

    output = []
    for instr_id, scores in all_scores:
        idx = int(np.argmax(scores))
        beams = beams_by_id[instr_id]
        trajectory = []
        if add_exploration_path:
            trajectory += exploration_by_id[instr_id]
        if idx >= len(beams):
            # perturbation rows: fake a wrong destination by stopping at the
            # start viewpoint (test.py:186-188)
            trajectory = [beams[0][0]]
        else:
            trajectory += beams[idx]
        output.append({"instr_id": instr_id, "trajectory": trajectory})
    return output
