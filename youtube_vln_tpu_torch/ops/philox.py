"""Counter-based dropout bits shared by the attention kernels and their
plain versions: Philox4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC'11; the Random123 constants).

The TPU kernels draw their masks in program order from a per-(batch, head)
seed (``youtube_vln_tpu/ops/attention.py:40-45, 56-59``).  The CUDA kernels
tile the forward and the backward differently, so the mask is instead a
pure function of its coordinates:

    keep(seed, stream, i, j, direction) =
        philox4x32_10(counter=(i, j, stream, direction),
                      key=(seed_lo, seed_hi))[0] >= threshold(rate)

with ``stream`` the global row id b*H + h, ``i`` the query row, ``j`` the
key, and ``direction`` 0 for B1 and for B2's text->vision direction, 1 for
B2's vision->text direction.  A probability is kept when its draw is at
least rate * 2^32 (``attention.py:44-45``); kept values scale by
1 / (1 - rate).  ``csrc/philox.cuh`` computes the same function on the
card, so a kernel and its plain version drop the same entries.

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
                 s_kv: int, direction: int = 0, device=None) -> torch.Tensor:
    """The keep mask [batch, heads, s_q, s_kv] (bool) of one attention call,
    bit for bit the mask its kernel draws."""
    key = seed_key(seed)
    thresh = keep_threshold(rate)
    i = torch.arange(s_q, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(s_kv, dtype=torch.int64, device=device)[None, :]
    out = torch.empty(batch * heads, s_q, s_kv, dtype=torch.bool,
                      device=device)
    step = max(1, _CHUNK // max(1, s_q * s_kv))
    for r0 in range(0, batch * heads, step):
        stream = torch.arange(r0, min(r0 + step, batch * heads),
                              dtype=torch.int64, device=device)[:, None, None]
        word = philox4x32(i, j, stream, direction, key)[0]
        out[r0:r0 + step] = word >= thresh
    return out.view(batch, heads, s_q, s_kv)
