"""The benchmark's yardstick: published peaks of one H100, the model's
operations from its configuration, and the operations and bytes of the
port's hand-written kernels B1-B6 at a cell's shapes.

Every count is of the work the inputs need: a matrix product of m x k by
k x n is 2 m k n operations; each input byte is read once and each output
byte written once, whatever a kernel reads again.  A kernel's bound is the
larger of its operations over the peak rate and its bytes over the memory
rate (``bound_s``).
"""
from __future__ import annotations

from typing import Dict

from benchmark.reference import lily as ref_lily

# NVIDIA H100 SXM data sheet, dense rates at 700 W: bf16 tensor cores,
# float32 outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> float:
    return max(flops / peak, nbytes / PEAK_BYTES)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def encoder_macs(cfg: Dict, s_t: int, s_v: int) -> int:
    """Multiply-adds of one trajectory's encoder forward: projections,
    feed-forward blocks and attention products of every text, vision and
    connection layer (the count of ``chip_smoke.py:model_flops_per_traj``
    without the visual embedding)."""
    h, hv, bi = cfg["hidden_size"], cfg["v_hidden_size"], cfg["bi_hidden_size"]
    text = s_t * (4 * h * h + 2 * h * cfg["intermediate_size"]) + 2 * s_t * s_t * h
    vis = (s_v * (4 * hv * hv + 2 * hv * cfg["v_intermediate_size"])
           + 2 * s_v * s_v * hv)
    conn = (s_v * 3 * hv * bi + s_t * 3 * h * bi + 4 * s_t * s_v * bi
            + s_v * bi * hv + s_t * bi * h
            + s_v * 2 * hv * cfg["v_intermediate_size"]
            + s_t * 2 * h * cfg["intermediate_size"])
    return (cfg["num_hidden_layers"] * text + cfg["v_num_hidden_layers"] * vis
            + len(cfg["v_biattention_id"]) * conn)


def visual_embedding_macs(cfg: Dict, regions: int) -> int:
    return regions * cfg["v_feature_size"] * cfg["v_hidden_size"]


def forward_flops(cfg: Dict, s_t: int, s_v: int) -> int:
    """Operations of one trajectory's forward, visual embedding included."""
    return 2 * (encoder_macs(cfg, s_t, s_v) + visual_embedding_macs(cfg, s_v))


def train_flops(cfg: Dict, s_t: int, s_v: int) -> int:
    """Forward and backward of one trajectory: 3 x the forward (recomputed
    work is not counted)."""
    return 3 * forward_flops(cfg, s_t, s_v)


def head_flops(cfg: Dict, language_rows: int = 0, vision_rows: int = 0) -> int:
    """Forward operations of one trajectory's poolers and enabled heads;
    ``language_rows`` / ``vision_rows`` are the positions the masked heads
    run on."""
    h, hv, bi = cfg["hidden_size"], cfg["v_hidden_size"], cfg["bi_hidden_size"]
    macs = bi * h + bi * hv
    macs += bi * (int(cfg["ranking"]) + int(cfg["traj_judge"]))
    if cfg["masked_language"]:
        macs += language_rows * (h * h + h * cfg["vocab_size"])
    if cfg["masked_vision"]:
        macs += vision_rows * (hv * hv + hv * cfg["v_target_size"])
    return 2 * macs


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #
def attention_fwd(b: int, h: int, s_q: int, s_kv: int, d: int, train: bool,
                  elt: int = BF16):
    """(operations, bytes) of one attention problem's forward (B1, or one
    direction of B2): q k^T and P v; q, k, v read, the output written, the
    key bias read and, in training, the row log-sum-exps written."""
    flops = 4 * b * h * s_q * s_kv * d
    nbytes = elt * b * h * d * (2 * s_q + 2 * s_kv) + F32 * b * s_kv
    if train:
        nbytes += F32 * b * h * s_q
    return flops, nbytes


def attention_bwd(b: int, h: int, s_q: int, s_kv: int, d: int, elt: int = BF16):
    """(operations, bytes) of one problem's backward (B3, or one direction
    of B4, with its pre-pass): the scores again, dP, dV, dK and dQ; q, k, v,
    o, dO, the bias and log-sum-exps read, dq, dk, dv written."""
    flops = 10 * b * h * s_q * s_kv * d
    nbytes = (elt * b * h * d * (4 * s_q + 4 * s_kv) + F32 * b * s_kv
              + F32 * b * h * s_q)
    return flops, nbytes


def epilogue_fwd(rows: int, d: int, elt: int = BF16):
    """(operations, bytes) of B5 on [rows, d]: h and res read, out written,
    the f32 scale and shift read."""
    return 10 * rows * d, 3 * elt * rows * d + 2 * F32 * d


def epilogue_bwd(rows: int, d: int, elt: int = BF16):
    """(operations, bytes) of B6 (row pass and column sums): h, res and dO
    read, dh and dres written, the scale read, dw and db written."""
    return 20 * rows * d, 5 * elt * rows * d + 3 * F32 * d


def kernel_bounds_s(cfg: Dict, rows: int, s_t: int, s_v: int,
                    train: bool) -> Dict[str, float]:
    """Least seconds of each kernel group for one step or request of
    ``rows`` trajectories: "attention" (B1 + B2, and B3 + B4 in training)
    and "epilogue" (B5 + B6, training with the epilogue rule on)."""
    hv, dv = cfg["v_num_attention_heads"], cfg["v_hidden_size"] // cfg["v_num_attention_heads"]
    hb, db = cfg["bi_num_attention_heads"], cfg["bi_hidden_size"] // cfg["bi_num_attention_heads"]
    n_v, n_c = cfg["v_num_hidden_layers"], len(cfg["v_biattention_id"])
    b1 = attention_fwd(rows, hv, s_v, s_v, dv, train)
    b2 = [a + b for a, b in zip(attention_fwd(rows, hb, s_t, s_v, db, train),
                                attention_fwd(rows, hb, s_v, s_t, db, train))]
    attn = n_v * bound_s(*b1) + n_c * bound_s(*b2)
    if train:
        b3 = attention_bwd(rows, hv, s_v, s_v, dv)
        b4 = [a + b for a, b in zip(attention_bwd(rows, hb, s_t, s_v, db),
                                    attention_bwd(rows, hb, s_v, s_t, db))]
        attn += n_v * bound_s(*b3) + n_c * bound_s(*b4)
    out = {"attention": attn}
    if train and epilogue_sites(cfg, rows, s_t, s_v):
        n = rows * s_v
        out["epilogue"] = epilogue_sites(cfg, rows, s_t, s_v) * (
            bound_s(*epilogue_fwd(n, dv * hv), PEAK_F32_FLOPS)
            + bound_s(*epilogue_bwd(n, dv * hv), PEAK_F32_FLOPS))
    return out


def epilogue_sites(cfg: Dict, rows: int, s_t: int, s_v: int) -> int:
    """Dropout + residual + LayerNorm sites that take B5/B6 in one training
    forward: the vision sites (two per vision layer, two per connection
    layer) when the configuration's epilogue rule is on and they hold at
    least 2^22 elements of a width divisible by 128; none on the text side
    at these sizes (checked)."""
    if not (cfg["use_epilogue_kernels"] and cfg["use_attention_kernels"]):
        return 0
    hv, h = cfg["v_hidden_size"], cfg["hidden_size"]
    if rows * s_t * h >= ref_lily.MIN_FUSED_ELEMENTS and h % 128 == 0:
        raise ValueError("text-side epilogue sites are not counted")
    if rows * s_v * hv < ref_lily.MIN_FUSED_ELEMENTS or hv % 128:
        return 0
    return 2 * cfg["v_num_hidden_layers"] + 2 * len(cfg["v_biattention_id"])


def expected_launches(cfg: Dict, rows: int, s_t: int, s_v: int,
                      train: bool) -> Dict[str, int]:
    """Kernel launches per step or request, by the kernel's name in the
    device trace."""
    n_v, n_c = cfg["v_num_hidden_layers"], len(cfg["v_biattention_id"])
    out = {"attention_fwd_kernel": n_v + n_c}
    if train:
        out["attention_bwd_kernel"] = n_v + n_c
        out["delta_kernel"] = n_v + n_c
        sites = epilogue_sites(cfg, rows, s_t, s_v)
        if sites:
            out.update(epilogue_fwd_kernel=sites, epilogue_bwd_kernel=sites,
                       column_sum_kernel=sites)
    return out
