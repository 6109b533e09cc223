"""Property checks of the kernels B1-B6 with dropout on (the counterpart of
``scripts/check_kernels_tpu.py``).

    python -m youtube_vln_tpu_torch.entries.check_kernels [--device cpu]
        [--checks drop replay determinism attribution multichip]

``chip_smoke.py`` holds each kernel against its plain twin, so a fault the
two share (in the Philox mask, say) passes there.  These checks hold each
autograd Function against itself, in f32 with TF32 off:

  drop         the drop fraction of B5: a constant input of 100 with res 0,
               w 1 and b 0 leaves two values per row, so the dropped
               elements are exactly the row minima; the fraction must lie
               in a binomial 5-sigma band around the rate 0.1;
  replay       each backward replays its forward's mask, by directional
               finite differences through a probe the output is linear in
               (B5/B6 through h at eps 3e-2; B1/B3 through V at [2, 2, 128,
               64]; B2/B4 through both V operands, 128 <-> 64): the
               analytic and the finite-difference derivative within 2e-2 of
               the bound sum |g| |u|, along the JAX script's random
               direction and along the gradient (where a replay break costs
               O(rate) of the bound);
  determinism  two launches of each of B1-B6 on the same inputs agree bit
               for bit, and two of B3 on its wgmma route (bf16, [2, 2, 256,
               128]), whose dQ is summed across blocks;
  attribution  the gradient of one flagship sample (7 candidates, 60 + 808
               tokens, ``lily_base_config`` from seed 0, eval mode) at the
               vision layer-0 query weight and the co-attention layer-0
               query2 weight: plain bf16 (the floor), kernels bf16 and
               kernels f32, each as a relative L2 against the plain f32
               path; kernels f32 within 1e-3, kernels bf16 within twice the
               floor.  Beside them, kernels bf16 with each of B1-B4 in turn
               on its plain twin (``kernel_bf16_with_plain``), which says
               which kernel carries the error above the floor; for the
               weights and samples of 3 seeds;
  multichip    with more than one CUDA device, a constant input split over
               the devices with each one's first global row (as the ranks
               of a data-parallel run pass it) draws a different mask on
               each; on one device it prints "skipped (1 device)".

On the card every check must launch the kernels it names (the launch
counts of ``ops/attention.py`` and ``ops/epilogue.py``); on the CPU the
autograd Functions run the plain twins.  It prints one JSON line with the
JAX script's keys, the card and the launches, and exits non-zero when a
check fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict, List

import numpy as np
import torch

from ..device import resolve_device
from ..ops import attention as A
from ..ops import epilogue as E
from ..utils.measure import card

CHECKS = ("drop", "replay", "determinism", "attribution", "multichip")
RATE = 0.1
SEED = 7
# counters of a route that f32 operands never take: the f32 checks do not
# expect them to move
BF16_ROUTES = ("attention_bwd_wgmma",)
FD_REL_TOL = 2e-2
ATTR_F32_TOL = 1e-3
ATTR_BF16_OVER_FLOOR = 2.0
# (d) on these weight seeds: one draw of bf16 rounding is no measure of a
# path's precision (the kernel path reads 1.61x the floor at seed 0 and
# 0.97x at seed 1)
ATTRIBUTION_SEEDS = (0, 1, 2)


@contextlib.contextmanager
def no_tf32():
    """f32 matrix products at full precision while the checks run."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _launches() -> Dict[str, int]:
    return {**A.LAUNCHES, **E.LAUNCHES}


def drop_fraction(device) -> float:
    """(a): the fraction B5 drops of a constant input."""
    shape = (2, 101, 256)
    d = shape[-1]
    with torch.no_grad():
        out = E.fused_dropout_add_ln(
            torch.full(shape, 100.0, device=device),
            torch.zeros(shape, device=device), torch.ones(d, device=device),
            torch.zeros(d, device=device), dropout_rate=RATE, seed=SEED)
    out = out.cpu().numpy()
    return float(np.mean(out <= out.min(axis=-1, keepdims=True) + 1e-3))


def _fd_rel(f, xs: List[torch.Tensor], us: List[torch.Tensor], eps: float) -> float:
    """|<grad f, u> - (f(x + eps u) - f(x - eps u)) / (2 eps)| over the
    bound sum |g| |u|, autograd through the Functions for the gradient and
    the no-grad launches for the two evaluations; the larger of two
    directions: ``us`` (the JAX script's) and the gradient itself, scaled
    to the norm of ``us``.  Along a random direction a backward that
    replays another mask errs by zero-mean terms, O(1/sqrt(n)) of the
    bound; along the gradient it errs by |g - g_true|^2, O(rate) of it."""
    xs = [x.detach().requires_grad_() for x in xs]
    grads = torch.autograd.grad(f(*xs), xs)
    with torch.no_grad():
        scale = (sum(float(u.square().sum()) for u in us)
                 / max(sum(float(g.square().sum()) for g in grads), 1e-30)) ** 0.5
        rels = []
        for direction in (us, [g * scale for g in grads]):
            analytic = sum(float((g * u).sum()) for g, u in zip(grads, direction))
            bound = sum(float((g.abs() * u.abs()).sum())
                        for g, u in zip(grads, direction))
            plus = f(*[x + eps * u for x, u in zip(xs, direction)])
            minus = f(*[x - eps * u for x, u in zip(xs, direction)])
            fd = float(plus - minus) / (2 * eps)
            rels.append(abs(analytic - fd) / max(bound, 1e-6))
    return max(rels)


def replay_checks(device) -> Dict[str, float]:
    """(b): mask replay of B5/B6, B1/B3 and B2/B4 by finite differences."""
    rng = np.random.default_rng(0)
    shape = (2, 101, 256)
    h, res = _t(rng.normal(size=shape), device), _t(rng.normal(size=shape), device)
    w, b = _t(rng.normal(size=shape[-1:]), device), _t(rng.normal(size=shape[-1:]), device)
    u = rng.normal(size=shape)
    u = _t(u / np.linalg.norm(u.ravel()), device)
    t = _t(rng.normal(size=shape), device)

    def f_epi(hh):
        return (E.fused_dropout_add_ln(hh, res, w, b, dropout_rate=RATE,
                                       seed=SEED) * t).sum()

    out = {"epilogue_fd_rel": _fd_rel(f_epi, [h], [u], 3e-2)}

    b_, h_, s_v, s_t, d = 2, 2, 128, 64, 64

    def mk(s):
        return _t(rng.normal(size=(b_, h_, s, d)), device)

    q, k, v = mk(s_v), mk(s_v), mk(s_v)
    v_bias = torch.zeros(b_, s_v, device=device)
    tprobe, uv = mk(s_v), mk(s_v)     # uv unnormalised: FD signal far above f32 noise

    def f_attn(vv):
        return (A.fused_attention(q, k, vv, v_bias, dropout_rate=RATE,
                                  seed=SEED) * tprobe).sum()

    out["attn_fd_rel"] = _fd_rel(f_attn, [v], [uv], 0.5)

    q2, k2, v2 = mk(s_t), mk(s_t), mk(s_t)
    t_bias = torch.zeros(b_, s_t, device=device)
    t1, u2 = mk(s_t), mk(s_t)

    def f_bi(vv1, vv2):
        c1, c2 = A.fused_bi_attention(q, k, vv1, q2, k2, vv2, v_bias, t_bias,
                                      rate1=RATE, rate2=RATE, seed=SEED)
        return (c1 * t1).sum() + (c2 * tprobe).sum()

    out["bi_attn_fd_rel"] = _fd_rel(f_bi, [v, v2], [uv, u2], 0.5)
    return out


def _twice(run) -> bool:
    """Whether two runs of ``run`` give bitwise equal tensors."""
    first, second = run(), run()
    return all(torch.equal(x, y) for x, y in zip(first, second))


def determinism(device) -> Dict[str, bool]:
    """(c): two launches of each kernel on the same inputs, bitwise."""
    gen = torch.Generator(device="cpu").manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    b_, h_, s_v, s_t, d = 2, 2, 128, 64, 64
    q, k, v, do = (rand(b_, h_, s_v, d) for _ in range(4))
    q2, k2, v2, do2 = (rand(b_, h_, s_t, d) for _ in range(4))
    v_bias, t_bias = torch.zeros(b_, s_v, device=device), torch.zeros(b_, s_t, device=device)

    def attention(backward):
        x = [t.detach().requires_grad_(backward) for t in (q, k, v)]
        o = A.fused_attention(*x, v_bias, dropout_rate=RATE, seed=SEED)
        return torch.autograd.grad(o, x, do) if backward else (o,)

    def bi_attention(backward):
        x = [t.detach().requires_grad_(backward) for t in (q, k, v, q2, k2, v2)]
        c1, c2 = A.fused_bi_attention(*x, v_bias, t_bias, rate1=RATE, rate2=RATE,
                                      seed=SEED)
        return torch.autograd.grad((c1, c2), x, (do2, do)) if backward else (c1, c2)

    h, res, dout = rand(202, 256), rand(202, 256), rand(202, 256)
    w, bias = rand(256), rand(256)

    def epilogue(backward):
        x = [t.detach().requires_grad_(backward) for t in (h, res, w, bias)]
        o = E.fused_dropout_add_ln(*x, dropout_rate=RATE, seed=SEED)
        return torch.autograd.grad(o, x, dout) if backward else (o,)

    # B3's wgmma route: bf16 at head dim 128, at least 128 queries and keys
    qb, kb, vb, dob = (rand(b_, h_, 256, 128).to(torch.bfloat16) for _ in range(4))

    def attention_wgmma():
        x = [t.detach().requires_grad_() for t in (qb, kb, vb)]
        o = A.fused_attention(*x, None, dropout_rate=RATE, seed=SEED)
        return torch.autograd.grad(o, x, dob)

    return {"attention_fwd": _twice(lambda: attention(False)),
            "attention_bwd": _twice(lambda: attention(True)),
            "attention_bwd_wgmma": _twice(attention_wgmma),
            "bi_attention_fwd": _twice(lambda: bi_attention(False)),
            "bi_attention_bwd": _twice(lambda: bi_attention(True)),
            "epilogue_fwd": _twice(lambda: epilogue(False)),
            "epilogue_bwd": _twice(lambda: epilogue(True))}


def attribution_sample(cfg, n: int = 7, s_t: int = 60, s_v: int = 808,
                       seed: int = 3):
    """The flagship sample of the JAX script's attribution, from ``seed``
    (the JAX script's is 3)."""
    rng = np.random.default_rng(seed)
    batch = {
        "instr_tokens": rng.integers(1, cfg.vocab_size, size=(n, s_t)),
        "instr_mask": np.ones((n, s_t), np.int32),
        "segment_ids": np.zeros((n, s_t), np.int32),
        "image_features": rng.normal(size=(n, s_v, cfg.v_feature_size)
                                     ).astype(np.float32),
        "image_locations": rng.random((n, s_v, 12)).astype(np.float32),
        "image_mask": np.ones((n, s_v), np.int32),
    }
    batch["image_locations"][..., 11] = np.repeat(np.arange(8), s_v // 8)[None, :]
    return batch


PROBES = ("bert.encoder.v_layer.0.attention.self.query.weight",
          "bert.encoder.c_layer.0.biattention.query2.weight")


def probe_run(model, inputs, kernels: bool, dtype: str):
    """(outputs, gradients of sum(ranking) + sum(traj) at ``PROBES``) of
    ``model`` on ``inputs`` (the flat model inputs) in eval mode, on the
    kernel or the plain path in ``dtype``; ``model.cfg``, which every layer
    shares, is restored after."""
    cfg = model.cfg
    saved = (cfg.use_attention_kernels, cfg.compute_dtype, model.training)
    params = dict(model.named_parameters())
    try:
        cfg.use_attention_kernels, cfg.compute_dtype = kernels, dtype
        model.eval()
        out = model(inputs["instr_tokens"], inputs["image_features"],
                    inputs["image_locations"], token_type_ids=inputs["segment_ids"],
                    attention_mask=inputs["instr_mask"],
                    image_attention_mask=inputs["image_mask"])
        grads = torch.autograd.grad(out["ranking"].sum() + out["traj"].sum(),
                                    [params[name] for name in PROBES])
    finally:
        cfg.use_attention_kernels, cfg.compute_dtype = saved[:2]
        model.train(saved[2])
    return {k: v.detach() for k, v in out.items()}, grads


def rel_l2(got, want) -> float:
    """The largest relative L2 distance of matching tensors."""
    return max(float((a.double() - b.double()).norm()
                     / max(float(b.double().norm()), 1e-12))
               for a, b in zip(got, want))


def _plain_attention_fwd(q, k, v, bias, rate, seed, want_lse, *streams,
                         seed_slot=None):
    q = A._operand(q, q)
    k, v = A._operand(k, q), A._operand(v, q)
    bias = A._key_bias(bias, q.shape[0], k.shape[2], q.device)
    lse = A.attention_lse_reference(q, k, bias) if want_lse else None
    return (A.attention_reference(q, k, v, bias, rate, seed, 0, *streams), lse,
            (q, k, v, bias))


def _plain_attention_bwd(q, k, v, bias, o, do, lse, rate, seed, *streams,
                         seed_slot=None):
    return A.attention_bwd_reference(q, k, v, bias, do, rate, seed, 0, *streams)


def _plain_bi_attention_fwd(q1, k1, v1, q2, k2, v2, v_bias, t_bias, rate1, rate2,
                            seed, want_lse, *streams, seed_slot=None):
    q1 = A._operand(q1, q1)
    k1, v1, q2, k2, v2 = (A._operand(x, q1) for x in (k1, v1, q2, k2, v2))
    vb = A._key_bias(v_bias, q1.shape[0], k1.shape[2], q1.device)
    tb = A._key_bias(t_bias, q1.shape[0], k2.shape[2], q1.device)
    ctx1, ctx2 = A.bi_attention_reference(q1, k1, v1, q2, k2, v2, vb, tb, rate1,
                                          rate2, seed, *streams)
    lse1, lse2 = ((A.attention_lse_reference(q2, k1, vb),
                   A.attention_lse_reference(q1, k2, tb)) if want_lse
                  else (None, None))
    return ctx1, ctx2, lse1, lse2, (q1, k1, v1, q2, k2, v2, vb, tb)


def _plain_bi_attention_bwd(q1, k1, v1, q2, k2, v2, vb, tb, ctx1, ctx2, lse1, lse2,
                            do1, do2, rate1, rate2, seed, *streams,
                            seed_slot=None):
    return A.bi_attention_bwd_reference(q1, k1, v1, q2, k2, v2, vb, tb, do1, do2,
                                        rate1, rate2, seed, *streams)


# B1-B4 by launcher: the plain version that stands in for it on CUDA tensors
PLAIN_TWINS = {"attention_fwd": _plain_attention_fwd,
               "attention_bwd": _plain_attention_bwd,
               "bi_attention_fwd": _plain_bi_attention_fwd,
               "bi_attention_bwd": _plain_bi_attention_bwd}


@contextlib.contextmanager
def plain_twin(name: str):
    """Kernel ``name`` (a key of ``PLAIN_TWINS``) replaced by its plain
    version while the others launch: the f32 plain backward, or the plain
    forward with the row statistic its backward kernel reads."""
    launcher = f"_{name}"
    saved = getattr(A, launcher)
    setattr(A, launcher, PLAIN_TWINS[name])
    try:
        yield
    finally:
        setattr(A, launcher, saved)


def bwd_probe_attribution(device, cfg=None, seed: int = 0) -> Dict[str, object]:
    """(d): rel-L2 of the two probe gradients of each (path, dtype) leg
    against the plain f32 path, the largest of the two probes, for the
    weights of ``seed`` on the sample of seed 3 + ``seed``; and the bf16
    kernel path with each of B1-B4 in turn on its plain twin, which locates
    the kernel path's error above the floor."""
    from .. import lily_base_config
    from ..models import Lily

    cfg = cfg or lily_base_config(ranking=True, traj_judge=True)
    model = Lily(cfg, device=device).init_weights(seed)
    inputs = {k: torch.as_tensor(v, device=device)
              for k, v in attribution_sample(cfg, seed=3 + seed).items()}

    def leg(kernels, dtype):
        return probe_run(model, inputs, kernels, dtype)[1]

    ref = leg(False, "float32")
    out = {"floor_bf16": rel_l2(leg(False, "bfloat16"), ref),
           "kernel_bf16": rel_l2(leg(True, "bfloat16"), ref),
           "kernel_f32": rel_l2(leg(True, "float32"), ref)}
    swapped = {}
    for name in PLAIN_TWINS:
        with plain_twin(name):
            swapped[name] = rel_l2(leg(True, "bfloat16"), ref)
    out["kernel_bf16_with_plain"] = swapped
    return out


def multichip_dropout_check(device) -> str:
    """(e): per-device masks of a constant input split over the devices."""
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_dev < 2:
        return "skipped (1 device)"
    rows, d = 16, 256
    masks = []
    for i in range(n_dev):
        dev = torch.device("cuda", i)
        with torch.no_grad():
            out = E.fused_dropout_add_ln(
                torch.full((rows, d), 100.0, device=dev),
                torch.zeros(rows, d, device=dev), torch.ones(d, device=dev),
                torch.zeros(d, device=dev), dropout_rate=RATE, seed=3,
                row0=i * rows).cpu()
        masks.append(out <= out.min(dim=-1, keepdim=True).values + 1e-3)
    same = [i for i in range(1, n_dev) if torch.equal(masks[i], masks[0])]
    if same:
        raise AssertionError(f"devices {same} replayed device 0's dropout mask stream")
    return f"ok ({n_dev} devices, distinct per-device masks)"


def run_checks(device, checks=CHECKS) -> dict:
    """Runs ``checks`` on ``device``; the result carries ``failures``."""
    device = resolve_device(device)
    out: dict = {"kernel_tpu_checks": "ok"}
    failures = []
    on_card = device.type == "cuda"
    with no_tf32():
        if "drop" in checks:
            before = _launches()
            out["drop_frac"] = frac = drop_fraction(device)
            n = 2 * 101 * 256
            if not abs(frac - RATE) < 5 * np.sqrt(RATE * (1 - RATE) / n):
                failures.append(f"drop fraction {frac} vs rate {RATE}")
            if on_card and _launches()["epilogue_fwd"] == before["epilogue_fwd"]:
                failures.append("drop: B5 did not launch")
        if "replay" in checks:
            before = _launches()
            out.update(replay_checks(device))
            for key in ("epilogue_fd_rel", "attn_fd_rel", "bi_attn_fd_rel"):
                if not out[key] < FD_REL_TOL:
                    failures.append(f"{key} {out[key]:.4g} above {FD_REL_TOL}: "
                                    "the backward does not replay the mask")
            after = _launches()
            idle = [k for k in after if after[k] == before[k] and k not in BF16_ROUTES]
            if on_card and idle:
                failures.append(f"replay: {idle} did not launch")
        if "determinism" in checks:
            before = _launches()
            out["determinism"] = same = determinism(device)
            idle = [k for k in before if _launches()[k] == before[k]]
            if on_card and idle:
                failures.append(f"determinism: {idle} did not launch")
            failures += [f"{k}: two launches differ" for k, ok in same.items() if not ok]
        if "attribution" in checks:
            before = _launches()
            by_seed = {}
            for seed in ATTRIBUTION_SEEDS:
                by_seed[seed] = attr = bwd_probe_attribution(device, seed=seed)
                if not attr["kernel_f32"] <= ATTR_F32_TOL:
                    failures.append(f"seed {seed}: kernel_f32 "
                                    f"{attr['kernel_f32']:.3g} above {ATTR_F32_TOL}")
                if not attr["kernel_bf16"] <= ATTR_BF16_OVER_FLOOR * attr["floor_bf16"]:
                    failures.append(f"seed {seed}: kernel_bf16 "
                                    f"{attr['kernel_bf16']:.3g} above "
                                    f"{ATTR_BF16_OVER_FLOOR} x floor "
                                    f"{attr['floor_bf16']:.3g}")
            out["bwd_probe_attribution"] = by_seed[0]
            out["bwd_probe_attribution_by_seed"] = by_seed
            after = _launches()
            idle = [k for k in A.LAUNCHES if after[k] == before[k]]
            if on_card and idle:
                failures.append(f"attribution: {idle} did not launch")
        if "multichip" in checks:
            try:
                out["multichip_dropout"] = multichip_dropout_check(device)
            except AssertionError as e:
                out["multichip_dropout"] = "failed"
                failures.append(str(e))
    if failures:
        out["kernel_tpu_checks"] = "failed"
    out["failures"] = failures
    out["launches"] = _launches()
    out["device"] = card(device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--checks", nargs="+", default=list(CHECKS), choices=CHECKS)
    ns = ap.parse_args(argv)
    out = run_checks(ns.device, tuple(ns.checks))
    print(json.dumps(out))
    if out["failures"]:
        print("check_kernels: FAILED: " + "; ".join(out["failures"]), file=sys.stderr)
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
