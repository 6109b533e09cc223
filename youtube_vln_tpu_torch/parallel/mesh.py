"""The device mesh of a run and its sharding rules (counterpart of
``youtube_vln_tpu/parallel/mesh.py``).

``--mesh_shape`` / ``--mesh_axes`` name the axes as the JAX package does,
and the default puts every process on ``data`` (``make_mesh``).  Here a
process is one GPU: the ``data`` axis is data parallelism (DDP over the
processes of one model coordinate) and the ``model`` axis tensor
parallelism over heads and features (``parallel/tensor.py``); data x model
must equal the world size.  Global rank r is d * M + m, the row-major
order of ``make_mesh``'s device array, so the M model ranks of one data
coordinate are adjacent (``parallel/distributed.py:init_mesh``).

``param_spec`` is the port's copy of ``_param_spec`` / ``param_shardings``
(``mesh.py:43-91``) in the port's state-dict names and the torch layout:
a JAX kernel ``w`` is ``[in, out]`` and a torch ``weight`` ``[out, in]``,
so JAX's column-parallel ``P(None, "model")`` shards torch dim 0 and its
row-parallel ``P("model", None)`` torch dim 1.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

# the JAX rules' layer names (``_param_spec``), as the port names them: the
# attention projections (``attention.self.query`` ...), the FFN inputs
# (``intermediate.dense``, ``v_intermediate.dense``, ``t_intermediate.dense``)
# and the co-attention projections (``biattention.query1`` ...)
_COLUMN = re.compile(r"(\.attention\.self\.(query|key|value)"
                     r"|\.(|v_|t_)intermediate\.dense"
                     r"|\.biattention\.(query|key|value)[12])\.(weight|bias)$")
# JAX ``out``: the attention output (``attention.output.dense``) and the FFN
# output (``output.dense``, ``v_output.dense``, ``t_output.dense``); the
# co-attention's ``biOutput.dense1`` / ``dense2`` are JAX ``out/dense1`` and
# ``out/dense2``, whose keys[-2] is not ``out``: replicated
_ROW = re.compile(r"(\.attention\.output\.dense|\.(|v_|t_)output\.dense)\.weight$")
_VOCAB = ("bert.embeddings.word_embeddings.weight",
          "cls.predictions.decoder.weight")


def mesh_extents(shape: Sequence[int], axes: Sequence[str],
                 world: int = None) -> Dict[str, int]:
    """{axis: extent} of ``shape`` over ``axes`` (``make_mesh``'s rule: an
    empty shape is all of ``world`` on ``data`` and 1 on ``model``).
    Raises on an axis other than ``data`` and ``model``, a mesh without
    ``data``, and, given ``world``, a shape whose product is not ``world``.
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
        if axis not in ("data", "model"):
            raise ValueError(f"--mesh_axes: unknown axis {axis!r} (data, model)")
        if n < 1:
            raise ValueError(f"--mesh_shape {list(shape)}: axis {axis!r} of {n}")
    size = 1
    for n in shape:
        size *= n
    if world is not None and size != world:
        # make_mesh: assert int(np.prod(shape)) == n, (shape, n)
        raise ValueError(f"{(shape, world)}: --mesh_shape {list(shape)} holds "
                         f"{size} device(s), but the process group holds "
                         f"{world} process(es), one per device")
    return extents


def param_spec(name: str, shape: Tuple[int, ...], extents: Dict[str, int]
               ) -> Optional[int]:
    """The dim of the full tensor ``name`` (a state-dict key of ``Lily``)
    of shape ``shape`` that the ``model`` axis shards, or None when it is
    replicated: everything when the axis is 1, and any tensor whose dim
    the axis does not divide (``param_shardings``'s fallback)."""
    m = extents.get("model", 1)
    if m == 1:
        return None
    dim = None
    if name in _VOCAB:
        dim = 0                                # the vocabulary
    elif _COLUMN.search(name):
        dim = 0                                # out features (and bias)
    elif _ROW.search(name) and len(shape) == 2:
        dim = 1                                # in features
    if dim is None or shape[dim] % m:
        return None
    return dim
