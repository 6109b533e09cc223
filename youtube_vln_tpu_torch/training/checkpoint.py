"""Checkpoint loading (the read side of ``youtube_vln_tpu/training/
checkpoint.py``).

Reads a torch ``.bin`` in the reference layout (``utils/utils_init.py:
277-295``) with ``torch.load(weights_only=True)``: the JAX package's own
checkpoints (``model_state_dict`` plus ``epoch``, ``jax_step`` and the
pickled ``jax_optimizer_state``, which is left unread), reference
checkpoints, and ViLBERT dumps without the ``bert.`` prefix or with
gamma/beta names (vilbert/vilbert.py:1098-1160).  The load into a ``Lily``
follows the JAX per-tensor non-strict rule (``models/torch_io.py:
state_dict_to_params``): a tensor missing from the file keeps its
initialisation, and the tied MLM decoder weight is never read.

Saving, the optimizer state and resume come with the engine.
"""
from __future__ import annotations

import logging
import os
import shutil
import tarfile
import tempfile
from typing import List, Optional, Tuple

import torch

from ..models.weights import _key_map, normalize_state_dict

logger = logging.getLogger(__name__)

# top-level entries of a checkpoint that are not weights
_EXTRAS = ("epoch", "jax_step", "jax_optimizer_state",
           "optimizer_state_dict", "scheduler_state_dict")
_TIED = "cls.predictions.decoder.weight"


def checkpoint_path(save_dir, save_name) -> str:
    return os.path.join(save_dir, f"{save_name}.bin")


def resolve_pretrained(path) -> Tuple[str, Optional[str]]:
    """Reference ``from_pretrained`` path semantics (vilbert.py:1014-1093)
    without downloads: a directory means ``<dir>/pytorch_model.bin``; a
    ``.bin``/``.pth``/``.pt`` file is used as-is; anything else is a
    ``.tar.gz`` archive, extracted to a temporary directory whose
    ``pytorch_model.bin`` is loaded.  Returns (weights_path, tempdir); the
    caller removes tempdir (if not None) after loading."""
    path = str(path)
    if "://" in path:
        raise ValueError(f"--from_pretrained {path!r} is a URL; this package "
                         "reads local files only: download it and pass the "
                         "path")
    if os.path.isdir(path):
        return os.path.join(path, "pytorch_model.bin"), None
    if path.endswith((".bin", ".pth", ".pt")):
        return path, None
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path!r}")
    tempdir = tempfile.mkdtemp()
    logger.info("extracting archive file %s to temp dir %s", path, tempdir)
    try:
        with tarfile.open(path, "r:gz") as archive:
            archive.extractall(tempdir, filter="data")
    except (tarfile.ReadError, OSError) as e:
        shutil.rmtree(tempdir, ignore_errors=True)
        raise ValueError(
            f"{path}: not a recognized checkpoint — expected a weights file "
            "(.bin/.pth/.pt), a directory holding pytorch_model.bin, or a "
            f".tar.gz archive of one ({e})") from e
    return os.path.join(tempdir, "pytorch_model.bin"), tempdir


@torch.no_grad()
def load_checkpoint(path, model: torch.nn.Module
                    ) -> Tuple[List[str], List[str], int, int]:
    """Loads ``path`` into ``model`` in place; returns (missing, unexpected,
    step, epoch) as the JAX ``load_checkpoint`` reports them: ``missing``
    the tensors that kept their initialisation, in the order of the key
    map, ``unexpected`` the entries of the file that no tensor took (the
    dead ``q_dense`` parameters and the non-weight entries left out)."""
    weights_path, tempdir = resolve_pretrained(path)
    try:
        payload = torch.load(weights_path, map_location="cpu",
                             weights_only=True)
    finally:
        if tempdir:
            shutil.rmtree(tempdir, ignore_errors=True)
    if "model_state_dict" in payload:
        state = payload["model_state_dict"]
    else:
        state = {k: v for k, v in payload.items() if k not in _EXTRAS}
    sd = normalize_state_dict(state)

    own = model.state_dict()
    missing: List[str] = []
    for key, _, kind in _key_map(model.cfg):
        names = [f"{key}.weight"] if kind == "emb" else [f"{key}.weight",
                                                         f"{key}.bias"]
        missing.extend(n for n in names if n not in sd)
    if "cls.predictions.bias" not in sd:
        missing.append("cls.predictions.bias")
    consumed = {_TIED}
    for name, value in sd.items():
        if name in own and name != _TIED:
            own[name].copy_(value)
            consumed.add(name)
    unexpected = [k for k in sd if k not in consumed]
    if missing:
        logger.info("checkpoint %s: %d tensors kept initialization (e.g. %s)",
                    path, len(missing), missing[0])
    if unexpected:
        logger.info("checkpoint %s: %d unused entries (e.g. %s)", path,
                    len(unexpected), unexpected[0])
    return (missing, unexpected, int(payload.get("jax_step", 0)),
            int(payload.get("epoch", -1)))


def delete_checkpoint(save_dir, save_name) -> None:
    path = checkpoint_path(save_dir, save_name)
    if os.path.exists(path):
        os.unlink(path)
