"""Process-group set-up, the data x model mesh and host-side helpers of
distributed training (counterpart of
``youtube_vln_tpu/parallel/distributed.py``).

One process per GPU, started by ``torchrun`` or any launcher that sets
``RANK`` (or ``SLURM_PROCID`` / ``NODE_RANK``), ``WORLD_SIZE`` (or
``SLURM_NTASKS``), ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT`` (or
``COORDINATOR_ADDRESS`` as ``host:port``), as the reference's
``utils/distributed.py:37-90`` resolves them.  ``initialize`` joins the
group before anything else touches the device; the train step then wraps
the model in ``DistributedDataParallel`` (``parallel/train_step.py``).

A process never carries on alone where the environment shows a
multi-process job: a failed rendezvous raises, and so does a
``LOCAL_RANK`` that names no device.  Without launcher variables
``initialize`` is a no-op and every helper answers for one process.

``init_mesh(data, model)`` lays the group out as the JAX ``make_mesh``
does, row-major: global rank r sits at data coordinate r // model and
model coordinate r % model.  It builds one subgroup per data coordinate
(its ``model`` ranks, which hold the same rows and shards of the weights)
and one per model coordinate (its ``data`` ranks, which hold the same
shard of the weights and different rows).  Without it, or at model 1, the
data group is the whole world and the model group a single process.
"""
from __future__ import annotations

import datetime
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from .tensor import ModelShard

# ranks and world sizes, in the order the reference resolves them
RANK_VARS = ("RANK", "SLURM_PROCID", "NODE_RANK")
WORLD_VARS = ("WORLD_SIZE", "SLURM_NTASKS")
DEFAULT_TIMEOUT_S = 600


def _first_int(env: Mapping[str, str], names) -> Optional[int]:
    for name in names:
        if env.get(name, "") != "":
            return int(env[name])
    return None


def multiprocess_markers(env: Mapping[str, str]) -> list:
    """Environment evidence of a job of several processes: a world size
    above 1 or a rank above 0 under any of the launchers' names."""
    out = []
    for name in WORLD_VARS:
        if env.get(name, "").isdigit() and int(env[name]) > 1:
            out.append(f"{name}={env[name]}")
    for name in RANK_VARS:
        if env.get(name, "").isdigit() and int(env[name]) > 0:
            out.append(f"{name}={env[name]}")
    return out


def _address(env: Mapping[str, str]) -> Optional[str]:
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        return f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if env.get("COORDINATOR_ADDRESS"):
        return f"tcp://{env['COORDINATOR_ADDRESS']}"
    return None


def local_device(device: torch.device, env: Mapping[str, str] = os.environ
                 ) -> torch.device:
    """``cuda:LOCAL_RANK`` for a CUDA device (``cuda:0`` without the
    variable), ``device`` itself otherwise; a local rank that names no
    device raises rather than sharing another rank's."""
    if device.type != "cuda":
        return device
    local = int(env.get("LOCAL_RANK", device.index or 0))
    count = torch.cuda.device_count()
    if not 0 <= local < count:
        raise RuntimeError(f"LOCAL_RANK={local} names no device: this machine "
                           f"has {count} CUDA device(s)")
    return torch.device("cuda", local)


def initialize(device="cuda", backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               env: Optional[Mapping[str, str]] = None) -> torch.device:
    """Joins the launcher's process group and returns this process's device
    (``cuda:LOCAL_RANK``, made current, for a CUDA ``device``).  The
    backend is NCCL for CUDA and gloo for the CPU unless ``backend`` names
    one.  A no-op, apart from the device, when a group already exists or
    the launcher variables describe one process without an address;
    raises when the environment shows a multi-process job that it cannot
    join."""
    env = os.environ if env is None else env
    dev = local_device(torch.device(device), env)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    world = _first_int(env, WORLD_VARS)
    rank = _first_int(env, RANK_VARS)
    address = _address(env)
    markers = multiprocess_markers(env)
    if world is None or (world == 1 and address is None):
        # one process, as a launcher of a single task describes it
        if markers:
            raise RuntimeError(f"the environment shows a multi-process job "
                               f"({markers}) but no world size and address "
                               f"to join it: set WORLD_SIZE, MASTER_ADDR and "
                               f"MASTER_PORT")
        return dev
    if rank is None or address is None or not 0 <= rank < world:
        raise RuntimeError(
            f"cannot join a process group of {world}: rank {rank} and "
            f"address {address} (set RANK, MASTER_ADDR and MASTER_PORT, or "
            f"launch with torchrun)")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    try:
        dist.init_process_group(
            backend, init_method=address, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        # never N independent trainings racing on one checkpoint path
        raise RuntimeError(f"rendezvous of rank {rank} of {world} at "
                           f"{address} ({backend}) failed: {e}") from e
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class _Mesh:
    """The mesh of this process: the extents, its coordinates and the two
    subgroups it belongs to (None: the whole world, or a single process)."""

    def __init__(self, data: int = 1, model: int = 1, data_group=None,
                 model_group=None):
        self.data, self.model = data, model
        self.data_group, self.model_group = data_group, model_group


_MESH = _Mesh()


def init_mesh(data: int, model: int = 1) -> None:
    """Lays the process group out as a ``data`` x ``model`` mesh (global
    rank d * model + m) and builds its subgroups; every rank calls it, in
    the same order.  A mesh of the same extents is kept as it is."""
    global _MESH
    if data * model != world_size():
        raise ValueError(f"{((data, model), world_size())}: a {data} x {model} "
                         f"mesh needs {data * model} processes, the group "
                         f"holds {world_size()}")
    if (_MESH.data, _MESH.model) == (data, model):
        return
    if model == 1:
        _MESH = _Mesh(data, 1)
        return
    backend = dist.get_backend()
    me = rank()
    data_group = model_group = None
    # every rank creates every group, in one order (new_group's rule)
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)], backend=backend)
        if me % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)], backend=backend)
        if me // model == d:
            model_group = g
    _MESH = _Mesh(data, model, data_group, model_group)


def data_world() -> int:
    """Processes on the ``data`` axis: the data-parallel degree."""
    return world_size() if _MESH.model == 1 else _MESH.data


def model_world() -> int:
    """Processes on the ``model`` axis: the tensor-parallel degree."""
    return _MESH.model


def data_rank() -> int:
    """This process's data coordinate: which rows of the global batch."""
    return rank() // _MESH.model


def model_rank() -> int:
    """This process's model coordinate: which shard of the weights."""
    return rank() % _MESH.model


def data_group():
    """The ranks of this process's model coordinate (None: the world)."""
    return _MESH.data_group


def model_group():
    """The ranks of this process's data coordinate (None at model 1)."""
    return _MESH.model_group


def model_shard() -> ModelShard:
    """This process's place on the model axis, as the model takes it."""
    return ModelShard(model_rank(), model_world(), model_group())


def is_main_process() -> bool:
    return rank() == 0


def _host_device() -> torch.device:
    """Where a host value crosses the group: NCCL moves device tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sum_across_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the world when None; a
    new tensor, no gradient); ``x`` itself in one process."""
    if not dist.is_initialized():
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def sum_across_data(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data coordinates: over the ranks that hold
    the other rows of the global batch."""
    return sum_across_ranks(x, data_group())


def all_reduce_mean_host(value: float, group=None) -> float:
    """The mean of a host float over the ranks of ``group`` (the world when
    None)."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=_host_device())
    dist.all_reduce(t, group=group)
    return float(t.item()) / n


def broadcast_host(value, root: int = 0):
    """``root``'s value of a picklable host object on every rank (the
    reference's ``any_broadcast``, ``utils/distributed.py:349-381``)."""
    if world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=root, device=_host_device())
    return box[0]
