"""Checkpoints (counterpart of ``youtube_vln_tpu/training/checkpoint.py``).

``save_checkpoint`` writes a torch ``.bin`` in the reference layout
(``utils/utils_init.py:277-295``), atomically (a ``.tmp`` sibling, then a
rename): ``model_state_dict`` with the key set of the JAX package's
``save_checkpoint`` (the tied MLM decoder weight sharing the word
embedding's storage, and the zero ``biOutput.q_dense1`` / ``q_dense2``
tensors that the reference's forward never reads), ``epoch``, ``jax_step``
(the name the JAX reader takes the step from) and, with an optimizer,
``optimizer_state_dict``: ``step_count`` and the moments ``exp_avg`` /
``exp_avg_sq`` keyed by reference parameter names.  The JAX package's
``load_checkpoint`` reads such a file and skips the optimizer entry.

``load_checkpoint`` reads with ``torch.load(weights_only=True)`` the port's
own files, the JAX package's (``model_state_dict`` plus ``epoch``,
``jax_step`` and the pickled ``jax_optimizer_state``), reference
checkpoints, and ViLBERT dumps without the ``bert.`` prefix or with
gamma/beta names (vilbert/vilbert.py:1098-1160).  The load into a ``Lily``
follows the JAX per-tensor non-strict rule (``models/torch_io.py:
state_dict_to_params``): a tensor missing from the file keeps its
initialisation, and the tied MLM decoder weight is never read.  Given an
optimizer, it also restores the moments and ``step_count``, from the
port's ``optimizer_state_dict`` or from a JAX ``jax_optimizer_state``
(unpickled with an allow-list; its ``mu`` / ``nu`` trees cross over as the
weights do), so that a run begun on a TPU resumes here.

``save_dcp`` is the counterpart of the JAX package's ``--orbax_checkpoints``
(``save_orbax``, ``checkpoint.py:211``): a ``torch.distributed.checkpoint``
directory ``<save_name>.dcp`` holding the weights, the ``AdamWRef`` moments,
``step_count``, the step and the epoch, written by every rank of a
data-parallel run together (each tensor once, the ranks sharing the
writes).  ``load_checkpoint`` reads such a directory with or without a
process group.  A JAX ``.orbax`` directory needs ``orbax``, which this
package does not use: it is refused with the ``.bin`` to write instead.

Under tensor parallelism (a ``Lily`` built with a ``ModelShard`` of M > 1)
a ``.bin`` holds the full tensors: ``save_checkpoint`` gathers the weights
and the moments over the model group (every model rank calls it, one of
them writes), so the file is the one process's, in the reference layout
and the JAX key set.  ``save_dcp`` keeps the shards: a tensor that the
model axis shards is stored under ``<name>.shard<m>of<M>``, one key per
model rank (plain tensors under one name on several ranks would be taken
for replicas and written once).  Every load reads full tensors, from a
``.bin`` or by joining a directory's shards, and cuts this model's shard
(``models/weights.py:shard_state_dict``), so a checkpoint of any mesh
loads onto any other.
"""
from __future__ import annotations

import io
import logging
import os
import pickle
import re
import shutil
import tarfile
import tempfile
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..config import LilyConfig
from ..models.weights import (_key_map, full_shapes, normalize_state_dict,
                              shard_state_dict, state_dict_from_jax_params)
from ..parallel.mesh import param_spec
from ..parallel.tensor import ModelShard, unshard_tensor
from ..utils.file_cache import cached_path

logger = logging.getLogger(__name__)

# top-level entries of a checkpoint that are not weights
_EXTRAS = ("epoch", "jax_step", "jax_optimizer_state",
           "optimizer_state_dict", "scheduler_state_dict")
_TIED = "cls.predictions.decoder.weight"


class AdamWRefState(NamedTuple):
    """The JAX package's optimizer state (``training/optimization.py:134``):
    the step count and the first and second moments, trees of the
    parameters' shape."""
    count: Any
    mu: Any
    nu: Any


# the globals a JAX ``jax_optimizer_state`` blob may reference (JAX
# ``checkpoint.py:44-78``): numpy array and scalar reconstruction, the dict
# containers and the optimizer state, which maps to the copy above
_JAX_OPT_STATE = ("youtube_vln_tpu.training.optimization", "AdamWRefState")
_OPT_STATE_ALLOWED = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.dtypes", "Float32DType"),
    ("numpy.dtypes", "Int32DType"),
    ("collections", "OrderedDict"),
}


class _OptStateUnpickler(pickle.Unpickler):
    """Allow-listed unpickler for the ``jax_optimizer_state`` blob: a plain
    ``pickle.loads`` would run whatever a crafted payload names."""

    def find_class(self, module, name):
        if (module, name) == _JAX_OPT_STATE:
            return AdamWRefState
        if (module, name) in _OPT_STATE_ALLOWED or (
                module.startswith("numpy.dtypes") and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"jax_optimizer_state references disallowed global "
            f"'{module}.{name}'")


def _loads_opt_state(data: bytes):
    return _OptStateUnpickler(io.BytesIO(data)).load()


def checkpoint_path(save_dir, save_name) -> str:
    return os.path.join(save_dir, f"{save_name}.bin")


def _shard(model: torch.nn.Module) -> ModelShard:
    return getattr(model, "shard", ModelShard())


def _gathered(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """``tensors`` (this rank's, keyed by state-dict name) made whole over
    the model group, in one order on every rank (collective)."""
    shard = _shard(model)
    if shard.world == 1:
        return tensors
    shapes, extents = full_shapes(model.cfg), {"model": shard.world}
    return {k: unshard_tensor(v, param_spec(k, shapes[k], extents), shard)
            for k, v in tensors.items()}


def _sharded(model: torch.nn.Module, full: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """This model's shard of the full tensors ``full``."""
    shard = _shard(model)
    if shard.world == 1:
        return full
    return shard_state_dict(full, {"model": shard.world}, shard.rank)


def model_state_dict(model: torch.nn.Module, cfg: LilyConfig
                     ) -> Dict[str, torch.Tensor]:
    """The weights as the JAX ``params_to_state_dict`` exports them
    (``models/torch_io.py:172-203``), f32 on the host: the tied decoder
    weight is the word embedding's tensor, and the dead ``q_dense``
    entries are zeros.  Under a model axis the tensors are gathered
    (collective over the model group)."""
    sd = {k: v.detach().to("cpu", torch.float32).contiguous()
          for k, v in _gathered(model, model.state_dict()).items()}
    sd[_TIED] = sd["bert.embeddings.word_embeddings.weight"]
    for i in range(len(cfg.v_biattention_id)):
        p = f"bert.encoder.c_layer.{i}.biOutput"
        sd[f"{p}.q_dense1.weight"] = torch.zeros(cfg.v_hidden_size,
                                                 cfg.bi_hidden_size)
        sd[f"{p}.q_dense1.bias"] = torch.zeros(cfg.v_hidden_size)
        sd[f"{p}.q_dense2.weight"] = torch.zeros(cfg.hidden_size,
                                                 cfg.bi_hidden_size)
        sd[f"{p}.q_dense2.bias"] = torch.zeros(cfg.hidden_size)
    return sd


def _flat_params(optimizer) -> List[torch.nn.Parameter]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def optimizer_state_by_name(model: torch.nn.Module, optimizer
                            ) -> Dict[str, Any]:
    """``step_count`` and the moments of ``optimizer`` (an ``AdamWRef``)
    keyed by reference parameter names, f32 on the host; under a model
    axis, gathered whole (collective over the model group)."""
    names = {id(p): n for n, p in model.named_parameters()}
    state = optimizer.state_dict()
    flat = _flat_params(optimizer)
    out: Dict[str, Any] = {"step_count": state["step_count"],
                           "exp_avg": {}, "exp_avg_sq": {}}
    for i, moments in state["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            out[k][names[id(flat[i])]] = moments[k].detach()
    for k in ("exp_avg", "exp_avg_sq"):
        out[k] = {n: v.to("cpu", torch.float32).contiguous()
                  for n, v in _gathered(model, out[k]).items()}
    return out


def load_optimizer_state_by_name(model: torch.nn.Module, optimizer,
                                 state: Dict[str, Any]) -> None:
    """The inverse of ``optimizer_state_by_name``: moments of the names in
    ``state`` (full tensors, cut to this model's shard); a parameter absent
    there starts with none."""
    index = {id(p): i for i, p in enumerate(_flat_params(optimizer))}
    shards = {k: _sharded(model, state[k]) for k in ("exp_avg", "exp_avg_sq")}
    moments = {}
    for name, p in model.named_parameters():
        if id(p) in index and name in shards["exp_avg"]:
            moments[index[id(p)]] = {k: shards[k][name]
                                     for k in ("exp_avg", "exp_avg_sq")}
    current = optimizer.state_dict()
    optimizer.load_state_dict({"state": moments,
                               "param_groups": current["param_groups"],
                               "step_count": int(state["step_count"])})


def _from_jax_opt_state(blob: bytes, cfg: LilyConfig) -> Dict[str, Any]:
    """A JAX ``jax_optimizer_state`` blob in the form of
    ``optimizer_state_by_name``."""
    opt = _loads_opt_state(blob)
    if not isinstance(opt, AdamWRefState):
        raise ValueError(f"jax_optimizer_state holds a {type(opt).__name__}, "
                         "not the AdamWRef state")
    return {"step_count": int(opt.count),
            "exp_avg": state_dict_from_jax_params(opt.mu, cfg),
            "exp_avg_sq": state_dict_from_jax_params(opt.nu, cfg)}


def save_checkpoint(save_dir, save_name, model: torch.nn.Module,
                    cfg: LilyConfig, optimizer=None, step: int = 0,
                    epoch: int = 0, write: bool = True) -> str:
    """Writes ``<save_dir>/<save_name>.bin`` and returns its path.  Under a
    model axis every model rank calls it (the gather is collective) and
    the one with ``write`` writes."""
    path = checkpoint_path(save_dir, save_name)
    payload: Dict[str, Any] = {"model_state_dict": model_state_dict(model, cfg),
                               "epoch": int(epoch), "jax_step": int(step)}
    if optimizer is not None:
        payload["optimizer_state_dict"] = optimizer_state_by_name(model,
                                                                  optimizer)
    if not write:
        return path
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def resolve_pretrained(path) -> Tuple[str, Optional[str]]:
    """Reference ``from_pretrained`` path semantics (vilbert.py:1014-1093)
    without downloads: a URL resolves to its entry in the offline file
    cache (``utils/file_cache.py:cached_path``); a directory means
    ``<dir>/pytorch_model.bin``; a ``.bin``/``.pth``/``.pt`` file is used
    as-is; anything else is a ``.tar.gz`` archive, extracted to a temporary
    directory whose ``pytorch_model.bin`` is loaded.  Returns
    (weights_path, tempdir); the caller removes tempdir (if not None) after
    loading."""
    path = str(path)
    if "://" in path:
        url, path = path, os.fspath(cached_path(path))
        logger.info("loading archive file %s from cache at %s", url, path)
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
def load_checkpoint(path, model: torch.nn.Module, optimizer=None
                    ) -> Tuple[List[str], List[str], int, int]:
    """Loads ``path`` into ``model`` in place; returns (missing, unexpected,
    step, epoch) as the JAX ``load_checkpoint`` reports them: ``missing``
    the tensors that kept their initialisation, in the order of the key
    map, ``unexpected`` the entries of the file that no tensor took (the
    dead ``q_dense`` parameters and the non-weight entries left out).
    With ``optimizer``, the file's optimizer state (the port's or the JAX
    package's) replaces its moments and ``step_count``; a file without one
    leaves the optimizer as it is.  ``path`` may also be a ``save_dcp``
    directory."""
    if is_dcp_checkpoint(path):
        return _load_dcp(path, model, optimizer)
    if is_orbax_checkpoint(path):
        stem = os.path.splitext(str(path).rstrip("/"))[0]
        raise ValueError(
            f"{path} is an Orbax checkpoint of the JAX package: reading it "
            f"needs orbax, which this package does not use. Load it with the "
            f"JAX package and write it with its save_checkpoint as "
            f"{stem}.bin, then pass that file")
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
    sd = _sharded(model, normalize_state_dict(state))

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
    if optimizer is not None:
        opt_state = None
        if "optimizer_state_dict" in payload:
            opt_state = payload["optimizer_state_dict"]
        elif "jax_optimizer_state" in payload:
            opt_state = _from_jax_opt_state(payload["jax_optimizer_state"],
                                            model.cfg)
        if opt_state is not None:
            load_optimizer_state_by_name(model, optimizer, opt_state)
    return (missing, unexpected, int(payload.get("jax_step", 0)),
            int(payload.get("epoch", -1)))


def delete_checkpoint(save_dir, save_name) -> None:
    """Removes ``<save_name>.bin`` and ``<save_name>.dcp``, where present."""
    path = checkpoint_path(save_dir, save_name)
    if os.path.exists(path):
        os.unlink(path)
    shutil.rmtree(dcp_path(save_dir, save_name), ignore_errors=True)


# --------------------------------------------------------------------------- #
# torch.distributed.checkpoint directories (--orbax_checkpoints)
# --------------------------------------------------------------------------- #
def dcp_path(save_dir, save_name) -> str:
    return os.path.join(save_dir, f"{save_name}.dcp")


def is_dcp_checkpoint(path) -> bool:
    """A directory written by ``save_dcp`` (its ``.metadata`` file)."""
    return os.path.isfile(os.path.join(str(path), ".metadata"))


def is_orbax_checkpoint(path) -> bool:
    """A directory written by the JAX package's ``save_orbax`` (JAX
    ``checkpoint.py:193-208``), not one holding ``pytorch_model.bin``."""
    if not os.path.isdir(path) or os.path.exists(
            os.path.join(path, "pytorch_model.bin")):
        return False
    markers = ("manifest.ocdbt", "_CHECKPOINT_METADATA", "_METADATA",
               "ocdbt.process_0", "zarr.json", ".zarray")
    return any(os.path.exists(os.path.join(path, m)) for m in markers)


def _weights(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's tensors by state-dict name (the tied decoder weight is
    the word embedding's and is left out), sharing the model's storage."""
    return {k: v for k, v in model.state_dict().items() if k != _TIED}


def _moments(model: torch.nn.Module, optimizer) -> Dict[str, Dict]:
    names = {id(p): n for n, p in model.named_parameters()}
    out: Dict[str, Dict] = {"exp_avg": {}, "exp_avg_sq": {}}
    for p in _flat_params(optimizer):
        for k, v in optimizer.state[p].items():
            out[k][names[id(p)]] = v
    return out


def _storage(model: torch.nn.Module, prefix: str,
             tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's ``tensors`` under their names in a ``.dcp`` directory:
    ``<prefix>.<name>``, or ``<prefix>.<name>.shard<m>of<M>`` for a tensor
    that the model axis shards."""
    shard = _shard(model)
    shapes = full_shapes(model.cfg) if shard.world > 1 else {}
    out = {}
    for k, v in tensors.items():
        key = f"{prefix}.{k}"
        if k in shapes and param_spec(k, shapes[k], {"model": shard.world}) is not None:
            key = f"{key}.shard{shard.rank}of{shard.world}"
        out[key] = v
    return out


def save_dcp(save_dir, save_name, model: torch.nn.Module, optimizer=None,
             step: int = 0, epoch: int = 0) -> str:
    """Writes ``<save_dir>/<save_name>.dcp`` with
    ``torch.distributed.checkpoint`` and returns its path.  Under a process
    group it is collective: every rank calls it with its replica or its
    shard."""
    import torch.distributed.checkpoint as dcp

    path = dcp_path(save_dir, save_name)
    state: Dict[str, Any] = {**_storage(model, "model", _weights(model)),
                             "step": torch.tensor(int(step)),
                             "epoch": torch.tensor(int(epoch))}
    if optimizer is not None:
        for k, moments in _moments(model, optimizer).items():
            state.update(_storage(model, f"optimizer.{k}", moments))
        state["step_count"] = torch.tensor(int(optimizer.step_count))
    dcp.save(state, checkpoint_id=path)
    return path


_SHARD_KEY = re.compile(r"^(.*)\.shard(\d+)of(\d+)$")


def _full_from_dcp(path, meta, prefix: str, names, shapes, required: bool
                   ) -> Dict[str, torch.Tensor]:
    """The full tensors ``<prefix>.<name>`` of a ``.dcp`` directory, read
    on the host, a sharded one joined from its shards; a name the
    directory lacks raises when ``required`` and is left out otherwise."""
    import torch.distributed.checkpoint as dcp

    shards = {}
    for key in meta:
        m = _SHARD_KEY.match(key)
        if m:
            shards[m.group(1)] = int(m.group(3))
    plan, buffers = {}, {}
    for n in names:
        key = f"{prefix}.{n}"
        if key in meta:
            plan[n] = [key]
        elif key in shards:
            plan[n] = [f"{key}.shard{i}of{shards[key]}"
                       for i in range(shards[key])]
        elif required:
            raise KeyError(f"{path} holds no {key}")
        for k in plan.get(n, ()):
            buffers[k] = torch.empty(meta[k].size, dtype=meta[k].properties.dtype)
    dcp.load(buffers, checkpoint_id=str(path))
    out = {}
    for n, keys in plan.items():
        parts = [buffers[k] for k in keys]
        dim = param_spec(n, shapes[n], {"model": len(parts)})
        out[n] = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return out


@torch.no_grad()
def _load_dcp(path, model: torch.nn.Module, optimizer=None
              ) -> Tuple[List[str], List[str], int, int]:
    """``load_checkpoint`` of a ``save_dcp`` directory of any mesh: every
    weight is read whole (none may be missing) and cut to this model's
    shard; with ``optimizer`` the moments and ``step_count`` too, where the
    directory has them."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
    shapes = full_shapes(model.cfg)
    own = _weights(model)
    full = _full_from_dcp(path, meta, "model", own, shapes, required=True)
    for k, v in _sharded(model, full).items():
        own[k].copy_(v)
    scalars = {k: torch.tensor(0) for k in ("step", "epoch", "step_count")
               if k in meta}
    dcp.load(scalars, checkpoint_id=str(path))
    if optimizer is not None and "step_count" in meta:
        names = [n for n, _ in model.named_parameters()]
        load_optimizer_state_by_name(model, optimizer, {
            "step_count": int(scalars["step_count"]),
            **{k: _full_from_dcp(path, meta, f"optimizer.{k}", names, shapes,
                                 required=False)
               for k in ("exp_avg", "exp_avg_sq")}})
    return [], [], int(scalars["step"]), int(scalars["epoch"])
