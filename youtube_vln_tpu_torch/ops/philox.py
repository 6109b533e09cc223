"""Counter-based dropout bits shared by the attention kernels and their
plain versions: Philox4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC'11; the Random123 constants).

The TPU kernels draw their masks in program order from a per-(batch, head)
seed (``youtube_vln_tpu/ops/attention.py:40-45, 56-59``).  The CUDA kernels
tile the forward and the backward differently, so the mask is instead a
pure function of its coordinates, and one Philox call serves a 2 x 2 group
of entries, all four of its words used:

    keep(seed, stream, i, j, direction) =
        philox4x32_10(counter=((i >> 4) * 8 + (i & 7), j >> 1, stream,
                               direction),
                      key=(seed_lo, seed_hi))[2 * ((i >> 3) & 1) + (j & 1)]
        >= threshold(rate)

with ``stream`` the global row id b*H + h, ``i`` the query row, ``j`` the
key, and ``direction`` 0 for B1 and for B2's text->vision direction, 1 for
B2's vision->text direction.  Under data parallelism a process holds a
shard of the global batch and passes its first global stream ``stream0``
(rank * B_local * H; 0 in one process), so each shard draws its rows of
the mask the whole batch would draw, as the TPU kernels do with their
batch-sharded row-id operand (``youtube_vln_tpu/ops/attention.py:56-59``).  The group of (i, j) is rows {i0, i0 + 8} x
keys {j0, j0 + 1} (i0: i with bit 3 cleared, j0: j with bit 0 cleared):
what one thread holds of an m16n8 ``mma.sync`` accumulator, so the kernels
draw one call per fragment (``csrc/philox.cuh``).  A probability is kept
when its draw is at least rate * 2^32 (``attention.py:44-45``); kept values
scale by 1 / (1 - rate).  ``csrc/philox.cuh`` computes the same function
on the card, so a kernel and its plain version drop the same entries.

The epilogue kernels B5/B6 (``ops/epilogue.py``) drop elements of an
[N, D] input, and one Philox call serves four neighbouring columns:

    keep(seed, row, col) =
        philox4x32_10(counter=(row, col // 4, 0, EPILOGUE_DIRECTION),
                      key=(seed_lo, seed_hi))[col % 4] >= threshold(rate)

with ``row`` the global row of the flattened input (a shard's first row
``row0`` plus its own row) and direction 2, so these counters never meet
the attention ones.  The rate is exact, as at
the attention sites, not the uint8 rule of the XLA-path dropout.

Plain torch has no unsigned 32-bit product, and a 32 x 32 -> 64-bit
product overflows int64; ``_mulhilo`` splits one operand into 16-bit
halves so every intermediate stays below 2^49.
"""
from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
EPILOGUE_DIRECTION = 2
# elements per chunk of a mask (int64 temporaries of 128 MiB each)
_CHUNK = 1 << 24


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x, x an int64 tensor in [0, 2^32)."""
    a = (x & 0xFFFF) * m                    # < 2^48
    b = (x >> 16) * m                       # < 2^48
    s = a + ((b & 0xFFFF) << 16)            # < 2^48 + 2^32
    return ((s >> 32) + (b >> 16)) & MASK32, s & MASK32


def philox4x32(c0, c1, c2, c3, key: Tuple[int, int]):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) (int64 tensors or
    ints in [0, 2^32), broadcast together) under the 64-bit key
    (k0, k1).  Returns the four output words as int64 tensors."""
    k0, k1 = key
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def seed_key(seed: int) -> Tuple[int, int]:
    """(seed_lo, seed_hi): the Philox key of a 64-bit seed."""
    seed &= MASK64
    return seed & MASK32, seed >> 32


def keep_threshold(rate: float) -> int:
    """Draws at or above this uint32 value are kept (``_dropout_mask``)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def site_seed(base: int, site: int) -> int:
    """The 64-bit seed of dropout site ``site`` under a step's base seed
    (the JAX package draws one seed per kernel site, ``attention.py:153``)."""
    return _splitmix64(_splitmix64(base & MASK64) ^ site)


def dropout_keep(seed: int, rate: float, batch: int, heads: int, s_q: int,
                 s_kv: int, direction: int = 0, device=None, q0: int = 0,
                 k0: int = 0, stream0: int = 0) -> torch.Tensor:
    """The keep mask [batch, heads, s_q, s_kv] (bool) of query rows
    [q0, q0 + s_q) and keys [k0, k0 + s_kv) of one attention call whose
    first global stream is ``stream0``, bit for bit the mask its kernel
    draws.  One Philox call per 2 x 2 group, as on the card."""
    key = seed_key(seed)
    thresh = keep_threshold(rate)
    i = torch.arange(q0, q0 + s_q, dtype=torch.int64, device=device)
    j = torch.arange(k0, k0 + s_kv, dtype=torch.int64, device=device)
    # the groups' counters span whole ranges: rows of a 16-row block share
    # the 8 counters of that block, and key pairs share one counter
    grow = ((i >> 4) << 3) | (i & 7)
    g0, c0 = int(grow.min()), int(j[0]) >> 1
    rows = torch.arange(g0, int(grow.max()) + 1, dtype=torch.int64,
                        device=device)[:, None]
    cols = torch.arange(c0, (int(j[-1]) >> 1) + 1, dtype=torch.int64,
                        device=device)[None, :]
    gi, cj = (grow - g0)[:, None], ((j >> 1) - c0)[None, :]
    word = ((i >> 3) & 1)[:, None] * 2 + (j & 1)[None, :]
    out = torch.empty(batch * heads, s_q, s_kv, dtype=torch.bool,
                      device=device)
    step = max(1, _CHUNK // max(1, 4 * rows.shape[0] * cols.shape[1]))
    for r0 in range(0, batch * heads, step):
        stream = torch.arange(stream0 + r0,
                              stream0 + min(r0 + step, batch * heads),
                              dtype=torch.int64, device=device)[:, None, None]
        words = torch.stack(philox4x32(rows, cols, stream, direction, key),
                            dim=-1) >= thresh
        out[r0:r0 + step] = words[:, gi, cj, word]
    return out.view(batch, heads, s_q, s_kv)


def epilogue_keep(seed: int, rate: float, n_rows: int, d: int,
                  device=None, row0: int = 0) -> torch.Tensor:
    """The keep mask [n_rows, d] (bool) of one epilogue call (d a multiple
    of 4) whose first global row is ``row0``, bit for bit the mask kernels
    B5/B6 draw."""
    if d % 4:
        raise ValueError(f"epilogue mask needs d % 4 == 0, got {d}")
    key = seed_key(seed)
    thresh = keep_threshold(rate)
    group = torch.arange(d // 4, dtype=torch.int64, device=device)[None, :]
    out = torch.empty(n_rows, d // 4, 4, dtype=torch.bool, device=device)
    step = max(1, _CHUNK // d)
    for r0 in range(0, n_rows, step):
        rows = torch.arange(row0 + r0, row0 + min(r0 + step, n_rows),
                            dtype=torch.int64, device=device)[:, None]
        words = philox4x32(rows, group, 0, EPILOGUE_DIRECTION, key)
        out[r0:r0 + step] = torch.stack(words, dim=-1) >= thresh
    return out.view(n_rows, d)
