"""Counter-based dropout masks, a frozen copy of the rule the port's kernels
draw by (Philox4x32-10, Salmon et al., SC'11, with the Random123
constants).  The reference recomputes every mask from the step's seed; it
reads no mask, seed table or counter from the program.

  attention keep(seed, stream, i, j, direction) =
      philox(counter=((i >> 4) * 8 + (i & 7), j >> 1, stream, direction),
             key=(seed_lo, seed_hi))[2 * ((i >> 3) & 1) + (j & 1)] >= rate * 2^32

  epilogue keep(seed, row, col) =
      philox(counter=(row, col // 4, 0, 2), key)[col % 4] >= rate * 2^32

with ``stream`` = b * heads + h of the whole batch and ``row`` the row of
the flattened [N * S, D] input.  Site seeds come from splitmix64:
``site_seed(seed, n)`` is the n-th kernel site of a forward, n = 1, 2, ...,
and ``site_seed(seed, 0)`` seeds the generator of every other site.

Plain torch has no unsigned 32-bit product and a 32 x 32 -> 64-bit product
overflows int64, so ``_mulhilo`` splits one operand into 16-bit halves.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
EPILOGUE_DIRECTION = 2
CHUNK = 1 << 24          # counters per chunk of a mask


def _mulhilo(m: int, x: torch.Tensor):
    a = (x & 0xFFFF) * m
    b = (x >> 16) * m
    s = a + ((b & 0xFFFF) << 16)
    return ((s >> 32) + (b >> 16)) & MASK32, s & MASK32


def philox4x32(c0, c1, c2, c3, key):
    k0, k1 = key
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    for _ in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
    return c0, c1, c2, c3


def _key(seed: int):
    seed &= MASK64
    return seed & MASK32, seed >> 32


def _threshold(rate: float) -> int:
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def site_seed(base: int, site: int) -> int:
    return _splitmix64(_splitmix64(base & MASK64) ^ site)


def attention_keep(seed: int, rate: float, batch: int, heads: int, s_q: int,
                   s_kv: int, direction: int, device) -> torch.Tensor:
    """Keep mask [batch, heads, s_q, s_kv] of one attention site."""
    key, thresh = _key(seed), _threshold(rate)
    i = torch.arange(s_q, dtype=torch.int64, device=device)
    j = torch.arange(s_kv, dtype=torch.int64, device=device)
    grow = ((i >> 4) << 3) | (i & 7)
    rows = torch.arange(int(grow.max()) + 1, dtype=torch.int64,
                        device=device)[:, None]
    cols = torch.arange((s_kv - 1 >> 1) + 1, dtype=torch.int64,
                        device=device)[None, :]
    gi, cj = grow[:, None], (j >> 1)[None, :]
    word = ((i >> 3) & 1)[:, None] * 2 + (j & 1)[None, :]
    out = torch.empty(batch * heads, s_q, s_kv, dtype=torch.bool, device=device)
    step = max(1, CHUNK // (4 * rows.shape[0] * cols.shape[1]))
    streams = torch.arange(batch * heads, dtype=torch.int64, device=device)
    for r0 in range(0, batch * heads, step):
        stream = streams[r0:r0 + step, None, None]
        words = torch.stack(philox4x32(rows, cols, stream, direction, key),
                            dim=-1) >= thresh
        out[r0:r0 + step] = words[:, gi, cj, word]
    return out.view(batch, heads, s_q, s_kv)


def epilogue_keep(seed: int, rate: float, n_rows: int, d: int,
                  device) -> torch.Tensor:
    """Keep mask [n_rows, d] of one dropout + residual + LayerNorm site."""
    key, thresh = _key(seed), _threshold(rate)
    group = torch.arange(d // 4, dtype=torch.int64, device=device)[None, :]
    out = torch.empty(n_rows, d // 4, 4, dtype=torch.bool, device=device)
    step = max(1, CHUNK // d)
    for r0 in range(0, n_rows, step):
        rows = torch.arange(r0, min(r0 + step, n_rows), dtype=torch.int64,
                            device=device)[:, None]
        words = philox4x32(rows, group, 0, EPILOGUE_DIRECTION, key)
        out[r0:r0 + step] = torch.stack(words, dim=-1) >= thresh
    return out.view(n_rows, d)
