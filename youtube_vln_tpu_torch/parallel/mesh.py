"""The device mesh of a run, data axis only (counterpart of
``youtube_vln_tpu/parallel/mesh.py``).

``--mesh_shape`` / ``--mesh_axes`` name the axes as the JAX package does,
and the default puts every process on ``data`` (``make_mesh``).  Here a
process is one GPU of a ``DistributedDataParallel`` group, so the ``data``
extent must equal the world size; a ``model`` axis above 1 is tensor
parallelism, which this package does not have yet (ROADMAP.md Queue A item
A10).  Replication, the rest of ``param_shardings`` on a data-only mesh, is
what DDP does.
"""
from __future__ import annotations

from typing import Dict, Sequence


def mesh_extents(shape: Sequence[int], axes: Sequence[str],
                 world: int = None) -> Dict[str, int]:
    """{axis: extent} of ``shape`` over ``axes`` (``make_mesh``'s rule: an
    empty shape is all of ``world`` on ``data`` and 1 on ``model``).
    Raises on a ``model`` extent above 1, an axis other than ``data`` and
    ``model``, and, given ``world``, a ``data`` extent other than it.
    Without ``world`` an empty shape gives no extents."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if not shape:
        if world is None:
            return {}
        shape = (world, 1) if len(axes) == 2 else (world,)
    if len(axes) < len(shape) or len(set(axes)) != len(axes):
        raise ValueError(f"--mesh_shape {list(shape)} needs as many distinct "
                         f"--mesh_axes names, got {list(axes)}")
    extents = dict(zip(axes, shape))
    if "data" not in extents:
        raise ValueError(f"--mesh_axes {list(axes)} has no 'data' axis")
    for axis, n in extents.items():
        if axis == "model" and n > 1:
            raise ValueError(
                f"--mesh_shape {list(shape)} gives the 'model' axis {n}: tensor "
                f"parallelism is not ported to this package yet; ROADMAP.md "
                f"Queue A item A10 ports it")
        if axis not in ("data", "model"):
            raise ValueError(f"--mesh_axes: unknown axis {axis!r} (data, model)")
    if world is not None and extents["data"] != world:
        raise ValueError(f"--mesh_shape {list(shape)} gives the 'data' axis "
                         f"{extents['data']}, but the process group holds "
                         f"{world} process(es), one per data shard")
    return extents
