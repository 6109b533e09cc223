"""MLM / MVM masking as vectorized host-side ops (the numpy functions of
``youtube_vln_tpu/ops/masking.py``, copied: the port imports nothing of the
JAX package).

Bit-matched to the reference threshold-ladder scheme:
  * tokens:  ``randomize_tokens``  (utils/dataset/common.py:213-270)
      p = U(0,1)*mask; masked where p >= 0.85; of those, replaced by [MASK]
      (80%), by a random token (p >= 0.97), or kept (p >= 0.985); targets are
      the original token where masked, -1 elsewhere.  Optional action-word
      masking (left/forward/right) at ``mask_action_rate``.
  * regions: ``randomize_regions`` (utils/dataset/common.py:272-300)
      targets default to uniform 1/C; masked regions (p >= 0.85) get the
      detector class distribution as target and flag 1; 90% of masked
      regions' features are zeroed (p >= 0.865).

These run in the host data pipeline (numpy), keeping device steps fully
static.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

MASK_THRESH = 0.85
RANDOM_THRESH = 0.85 + 0.15 * 0.8    # 0.97
KEEP_THRESH = 0.85 + 0.15 * 0.9      # 0.985
ZERO_THRESH = 0.85 + 0.15 * 0.1      # 0.865

# bert-base-uncased ids for left/forward/right (common.py:215-222)
ACTION_TOKEN_IDS = (2187, 2830, 2157)


def randomize_tokens_np(
    tokens: np.ndarray,
    mask: np.ndarray,
    vocab_size: int,
    mask_token_id: int,
    rng: np.random.Generator,
    mask_action_rate: float = 0.0,
    action_token_ids: Sequence[int] = ACTION_TOKEN_IDS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (masked_tokens, targets); targets are -1 where unmasked."""
    tokens = tokens.copy()
    targets = np.full_like(tokens, -1)

    p = rng.random(tokens.shape) * (mask > 0)
    random_tokens = rng.integers(0, vocab_size, size=tokens.shape,
                                 dtype=tokens.dtype)

    if mask_action_rate > 0:
        xs, ys = np.nonzero(np.isin(tokens, np.asarray(action_token_ids)))
        if len(xs):
            # reference uses np.random.choice with replacement
            # (common.py:248)
            picks = rng.integers(0, len(xs),
                                 size=int(mask_action_rate * len(xs)))
            for mi in picks:
                targets[xs[mi], ys[mi]] = tokens[xs[mi], ys[mi]]
                tokens[xs[mi], ys[mi]] = mask_token_id
                p[xs[mi], ys[mi]] = MASK_THRESH * 0.9  # below ladder

    sel = p >= MASK_THRESH
    targets[sel] = tokens[sel]
    tokens[sel] = mask_token_id
    sel = p >= RANDOM_THRESH
    tokens[sel] = random_tokens[sel]
    sel = p >= KEEP_THRESH
    tokens[sel] = targets[sel]
    return tokens, targets


def randomize_regions_np(
    features: np.ndarray,
    probs: np.ndarray,
    mask: np.ndarray,
    rng: np.random.Generator,
    copy: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (features, targets, targets_mask).  With copy=False the
    features buffer is masked in place (safe for freshly-assembled
    sample-local arrays)."""
    if copy:
        features = features.copy()
    n_classes = probs.shape[-1]
    targets = np.full_like(probs, 1.0 / n_classes)
    targets_mask = np.zeros_like(mask)

    p = rng.random(mask.shape) * (mask > 0)
    sel = p >= MASK_THRESH
    targets[sel] = probs[sel]
    targets_mask[sel] = 1
    features[p >= ZERO_THRESH] = 0
    return features, targets, targets_mask


def unmasked_region_targets(probs: np.ndarray, mask: np.ndarray):
    """Targets when masked_vision is off (all_dataset.py:252-253)."""
    n_classes = probs.shape[-1]
    return (np.full_like(probs, 1.0 / n_classes), np.zeros_like(mask))


def max_masked_regions(num_regions: int) -> int:
    """Static upper bound for the sparse encoding: the ladder masks 15% in
    expectation; 25% (rounded up to a multiple of 8) is >8 sigma of
    headroom at S_v=808."""
    m = int(np.ceil(num_regions * 0.25))
    return (m + 7) // 8 * 8


def randomize_regions_sparse_dedup_np(
    probs_u: Sequence[np.ndarray],
    mask_u: np.ndarray,
    cand_map: Sequence[int],
    rng: np.random.Generator,
    dtype=None,
):
    """Per-candidate MVM masking over DEDUPLICATED visual rows.

    Candidates that share a trajectory (positive + caption-negatives,
    datasets.py:213-215) ship their 2048-d feature rows once; masking is
    still drawn independently per candidate (matching the reference, which
    masks after stacking).  Instead of corrupting per-candidate feature
    copies, this returns the zero-mask so the train step can apply the
    corruption in-graph after the gather-expand.

    ``probs_u`` is a SEQUENCE of per-trajectory [S, C] arrays (kept
    unstacked on purpose: materializing the [n_u, S, 1601] stack costs a
    ~26 MB copy per item at flagship geometry only to gather ~120 target
    rows); ``mask_u`` is [n_unique, S]; cand_map[j] is candidate j's row
    in the unique arrays.  Draw order matches
    randomize_regions_sparse_np exactly (one uniform per candidate-region,
    drawn as a single [nc, S] block), so with the same RNG state the
    dedup and dense paths select identical masks.  ``dtype`` sets the
    target-row output dtype (the transport dtype) so the cast happens in
    the gather assignment instead of a second full pass.

    Returns (feature_zero_mask [nc, S] u8, idx [nc, M] i32,
             rows [nc, M, C], targets_mask [nc, S])."""
    nc = len(cand_map)
    s = mask_u.shape[1]
    m_cap = max_masked_regions(s)
    targets_mask = np.zeros((nc, s), mask_u.dtype)
    zero_mask = np.zeros((nc, s), np.uint8)
    idx = np.full((nc, m_cap), s, np.int32)
    rows = np.zeros((nc, m_cap, probs_u[0].shape[-1]),
                    dtype or probs_u[0].dtype)

    p = rng.random((nc, s))
    for j, u in enumerate(cand_map):
        pj = p[j] * (mask_u[u] > 0)
        sel = pj >= MASK_THRESH
        extra = sel.sum() - m_cap
        if extra > 0:  # >8-sigma guard, same policy as the dense variant
            on = np.nonzero(sel)[0]
            sel[on[m_cap:]] = False
            pj[on[m_cap:]] = 0.0
        targets_mask[j, sel] = 1
        zero_mask[j] = pj >= ZERO_THRESH
        on = np.nonzero(sel)[0]
        idx[j, : len(on)] = on
        rows[j, : len(on)] = probs_u[u][on]
    return zero_mask, idx, rows, targets_mask


def randomize_regions_sparse_np(
    features: np.ndarray,
    probs: np.ndarray,
    mask: np.ndarray,
    rng: np.random.Generator,
    copy: bool = True,
):
    """MVM masking with a sparse target encoding.

    Same ladder as randomize_regions_np, but instead of a dense
    [N, S, C] target tensor returns:
      idx  [N, M] int32 — masked region indices, padded with S (sentinel)
      rows [N, M, C]    — the target distributions for those regions
      targets_mask [N, S] — dense flag mask (same as the dense variant)
    The KL loss only reads masked regions (unmasked contribute exactly 0 in
    the reference formula), so the dense uniform part is never needed.
    """
    if copy:
        features = features.copy()
    n, s = mask.shape
    m_cap = max_masked_regions(s)
    targets_mask = np.zeros_like(mask)

    p = rng.random(mask.shape) * (mask > 0)
    sel = p >= MASK_THRESH
    # extremely unlikely overflow guard: drop excess masked regions
    for i in range(n):
        extra = sel[i].sum() - m_cap
        if extra > 0:
            on = np.nonzero(sel[i])[0]
            sel[i, on[m_cap:]] = False
            p[i, on[m_cap:]] = 0.0
    targets_mask[sel] = 1
    features[p >= ZERO_THRESH] = 0

    idx = np.full((n, m_cap), s, np.int32)
    rows = np.zeros((n, m_cap, probs.shape[-1]), probs.dtype)
    for i in range(n):
        on = np.nonzero(sel[i])[0]
        idx[i, : len(on)] = on
        rows[i, : len(on)] = probs[i, on]
    return features, idx, rows, targets_mask
