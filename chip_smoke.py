#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``youtube_vln_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel from ``youtube_vln_tpu_torch/ops/csrc``
     (one nvcc per source, all at once);
  3. the forward kernels B1/B2 against their plain PyTorch versions at the
     beam-eval shapes and at odd lengths, in bf16 and f32;
  4. the eval path: the beam re-ranking scorer (``eval_epoch``) at the full
     flagship width (``lily_base_config``, random weights from the seed,
     bf16), on a few requests of 30 beams x (60 text + 808 visual tokens),
     on the step-dedup transport and on the dense one; the launch counts
     must show both kernels on that path, the scores must be finite, and
     the kernel path must agree with the plain path on one request;
  5. B1-B4 in train mode at the fine-tuning shapes (96 x 8 heads, D = 128)
     and at odd lengths, bf16 and f32, dropout 0 and 0.1, with a padded
     candidate: outputs, row log-sum-exps and gradients against the plain
     versions (same Philox masks), and in f32 against autograd through the
     plain forward;
  6. the train path: the fine-tuning step of recipe 30RS (ranking, global
     batch 16 instructions x 6 candidates) at full flagship width and
     depth in bf16 with AdamWRef, 2 warm-up and 5 timed steps; finite
     losses, moved parameters, finite gradients and 6 launches of each of
     B1-B4 per micro-step; then 3 steps of the same global batch with
     gradient accumulation 2;
  7. the train step's gradients on the kernel path against the plain path
     at batch 1 x 6 (f32 with dropout off and on, and bf16 against f32);
  8. one traced train step: device time by kind of kernel, idle share;
  9. a ``kernels`` JSON line: per kernel its launches on the eval and the
     train path, error, time, bound, plain time and a library call's time
     at the train shapes (B1/B2 also at the eval shapes).
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside it, the script exits non-zero.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
NC, S_T, L, BOXES, FEAT, N_UNIQUE = 30, 60, 8, 101, 2048, 80
N_REQUESTS = 4                     # step-dedup requests on the eval path
# recipe 30RS (README: train.py --ranking --shuffle_visual_features
# --batch_size 16): 16 instructions x (4 beams + 2 shuffled negatives)
TRAIN_B, TRAIN_NC, HEADS = 16, 6, 8
WARMUP_STEPS, TIMED_STEPS = 2, 5
RATE = 0.1                         # attention dropout of lily_base_config
# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores
# (the main path's type) and device memory
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# kernel vs plain version: max abs error over max(1, max |plain|).  bf16:
# 1e-2, about two and a half bf16 ulps (8 significant bits) at the largest
# output.  f32: 1e-3, set by the rows of a padded candidate, where every key
# carries -10000 and a logit is rounded at the f32 ulp of 10000 (9.8e-4)
# whatever the order of summation.
TOL = {"bfloat16": 1e-2, "float32": 1e-3}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def heads_view(gen, b, h, s, d, dtype):
    """A [B, H, S, D] operand laid out as the model makes it: a split_heads
    view of a [B, S, H*D] projection."""
    import torch
    x = torch.randn(b, s, h * d, generator=gen, device="cuda")
    return x.to(dtype).view(b, s, h, d).transpose(1, 2)


def key_bias(gen, b, s, keep=0.9, masked_rows=(0,)):
    """(1 - m) * -10000 with ~10% masked keys; the rows in ``masked_rows``
    mask every key, as a padded beam candidate does."""
    import torch
    keep_mask = torch.rand(b, s, generator=gen, device="cuda") < keep
    bias = (~keep_mask).float() * -10000.0
    for r in masked_rows:
        bias[r] = -10000.0
    return bias


def check(name, got, want, rel_tol, floor=1.0) -> float:
    """max |got - want| <= rel_tol * max(floor, max |want|); gradients use
    floor 0, so their tolerance scales with the largest gradient."""
    import torch
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    scale = max(floor, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    tol = rel_tol * scale
    print(f"check {name}: max_abs_err {err:.3e} (tol {tol:.2e} = "
          f"{rel_tol:.0e} x {scale:.3g})")
    if not err <= tol:
        fail(f"{name}: max_abs_err {err} above {tol}")
    return err


def bound_ms(flops, nbytes):
    """The least time for the work in bf16: operations over the tensor-core
    peak or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_checks(seed):
    """Phase 3: every kernel against its plain version; returns the numbers
    of the kernels line at the main-path shapes."""
    import torch
    import torch.nn.functional as F
    from youtube_vln_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    bh = (NC, 8)                     # 30 beams x 8 heads at D = 128
    s_v = L * BOXES
    rows = {}

    # B1: vision self-attention, main shape in bf16 and f32, odd lengths
    for dtype, s_q, s_kv, d in ((bf16, s_v, s_v, 128), (f32, s_v, s_v, 128),
                                (bf16, 61, 807, 128), (f32, 807, 61, 64)):
        q = heads_view(gen, *bh, s_q, d, dtype)
        k, v = heads_view(gen, *bh, s_kv, d, dtype), heads_view(gen, *bh, s_kv, d, dtype)
        bias = key_bias(gen, NC, s_kv)
        err = check(f"B1 attention_fwd {dtype} {s_q}x{s_kv} D={d}",
                    A.fused_attention(q, k, v, bias),
                    A.attention_reference(q, k, v, bias), TOL[str(dtype)[6:]])
        if (dtype, s_q) == (bf16, s_v):
            main = (q, k, v, bias, err)

    # B1: half the keys masked; masked values must not reach the output
    q = heads_view(gen, 2, 8, s_v, 128, bf16)
    k, v = heads_view(gen, 2, 8, s_v, 128, bf16), heads_view(gen, 2, 8, s_v, 128, bf16)
    bias = torch.zeros(2, s_v, device="cuda")
    bias[:, s_v // 2:] = -10000.0
    v2 = v.clone()
    v2[:, :, s_v // 2:] += 100.0
    out = A.fused_attention(q, k, v, bias)
    check("B1 masked values do not leak", A.fused_attention(q, k, v2, bias),
          out, 1e-6)
    check("B1 half-masked vs plain", out, A.attention_reference(q, k, v, bias),
          TOL["bfloat16"])

    q, k, v, bias, err = main
    flops = 4 * q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2] * q.shape[3]
    bound, by = bound_ms(flops, 4 * nbytes(q) + nbytes(bias))
    mask4 = bias[:, None, None, :].to(q.dtype)
    rows["attention_fwd"] = dict(
        name="attention_fwd", route="cuda",
        source="youtube_vln_tpu_torch/ops/csrc/attention_fwd.cu",
        replaces="youtube_vln_tpu/ops/attention.py:48", max_abs_err=err,
        ms=cuda_ms(lambda: A.fused_attention(q, k, v, bias)),
        plain_ms=cuda_ms(lambda: A.attention_reference(q, k, v, bias)),
        bound_ms=bound, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4)))

    # B2: co-attention 60 <-> 808 in one launch, bf16 and f32
    for dtype in (bf16, f32):
        vis = [heads_view(gen, *bh, s_v, 128, dtype) for _ in range(3)]
        txt = [heads_view(gen, *bh, S_T, 128, dtype) for _ in range(3)]
        vb, tb = key_bias(gen, NC, s_v), key_bias(gen, NC, S_T)
        got = A.fused_bi_attention(*vis, *txt, vb, tb)
        want = A.bi_attention_reference(*vis, *txt, vb, tb)
        tol = TOL[str(dtype)[6:]]
        err = max(check(f"B2 bi_attention_fwd ctx1 {dtype} 60->808", got[0], want[0], tol),
                  check(f"B2 bi_attention_fwd ctx2 {dtype} 808->60", got[1], want[1], tol))
        if dtype == bf16:
            main = (vis, txt, vb, tb, err)

    vis, txt, vb, tb, err = main
    (q1, k1, v1), (q2, k2, v2) = vis, txt
    b, h, _, d = q1.shape
    flops = 8 * b * h * S_T * s_v * d
    bound, by = bound_ms(flops, 4 * nbytes(q1) + 4 * nbytes(q2) + nbytes(vb, tb))
    vm, tm = vb[:, None, None, :].to(bf16), tb[:, None, None, :].to(bf16)
    rows["bi_attention_fwd"] = dict(
        name="bi_attention_fwd", route="cuda",
        source="youtube_vln_tpu_torch/ops/csrc/attention_fwd.cu",
        replaces="youtube_vln_tpu/ops/attention.py:288", max_abs_err=err,
        ms=cuda_ms(lambda: A.fused_bi_attention(*vis, *txt, vb, tb)),
        plain_ms=cuda_ms(lambda: A.bi_attention_reference(*vis, *txt, vb, tb)),
        bound_ms=bound, bound_by=by,
        # no single library call runs both directions: two SDPA calls
        library_ms=cuda_ms(lambda: (
            F.scaled_dot_product_attention(q2, k1, v1, attn_mask=vm),
            F.scaled_dot_product_attention(q1, k2, v2, attn_mask=tm))))
    return rows


def dedup_request(rng, rid, n_real=NC):
    """One instruction x 30 beams on the step-dedup transport (loader
    layout): 80 unique 101-box pano blocks with f16 features, each beam an
    index of L = 8 blocks; candidates past ``n_real`` are padding."""
    import numpy as np
    tokens = np.zeros((1, NC, S_T), np.int32)
    mask = np.zeros((1, NC, S_T), np.int32)
    n_words = int(rng.integers(20, S_T))
    tokens[0, :n_real] = rng.integers(1, 30522, S_T)
    mask[0, :n_real, :n_words] = 1
    locs = rng.random((1, N_UNIQUE, BOXES, 12)).astype(np.float32)
    step_mask = np.zeros((1, N_UNIQUE, BOXES), np.int32)
    for j in range(N_UNIQUE):          # 36..101 detected boxes per block
        step_mask[0, j, :int(rng.integers(36, BOXES + 1))] = 1
    step_index = np.zeros((1, NC, L), np.int32)
    step_index[0, :n_real] = rng.integers(0, N_UNIQUE, (n_real, L))
    locs[..., 11] = rng.integers(0, L, (1, N_UNIQUE, BOXES))
    opt = np.zeros((1, NC), bool)
    opt[0, :n_real] = True
    return {"instr_tokens": tokens, "instr_mask": mask,
            "segment_ids": np.zeros_like(tokens),
            "uniq_step_features": rng.normal(
                size=(1, N_UNIQUE, BOXES, FEAT)).astype(np.float16),
            "uniq_step_locations": locs, "uniq_step_mask": step_mask,
            "step_index": step_index, "opt_mask": opt,
            "instr_id": np.array([[rid, 0]], np.int64)}


def dense_request(dd):
    """The same request on the dense transport (host-expanded)."""
    idx = dd["step_index"][0].reshape(-1)
    out = {k: v for k, v in dd.items() if not k.startswith(("uniq_", "step_"))}
    for uk, dk in (("uniq_step_features", "image_features"),
                   ("uniq_step_locations", "image_locations"),
                   ("uniq_step_mask", "image_mask")):
        x = dd[uk][0][idx]
        out[dk] = x.reshape((1, NC, L * BOXES) + x.shape[2:])
    return out


def main_path(seed):
    """Phase 4: the beam re-ranking scorer at flagship width."""
    import numpy as np
    import torch
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.evaluation.beam_eval import eval_epoch
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.ops import attention as A

    cfg = lily_base_config(ranking=True, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = Lily(cfg, device="cuda").init_weights(seed).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: lily_base_config, {n_params} parameters, bf16, "
          f"init {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(seed)
    # the last request carries 3 padded candidates (opt_mask false)
    requests = [dedup_request(rng, i) for i in range(N_REQUESTS - 1)]
    requests.append(dedup_request(rng, N_REQUESTS - 1, n_real=NC - 3))
    dense = dense_request(requests[0])
    dense["instr_id"] = np.array([[N_REQUESTS, 0]], np.int64)
    # warm-up: library handles, kernel load, allocator
    eval_epoch(model, cfg, [requests[0], dense], device="cuda")

    A.reset_launch_counts()
    t0 = time.perf_counter()
    scores = eval_epoch(model, cfg, requests, device="cuda")
    t_dedup = time.perf_counter() - t0
    scores += eval_epoch(model, cfg, [dense], device="cuda")
    launches = dict(A.LAUNCHES)
    n_run = N_REQUESTS + 1
    per_layer = {"attention_fwd": cfg.v_num_hidden_layers,
                 "bi_attention_fwd": len(cfg.v_biattention_id)}
    print(f"launches on the main path ({n_run} requests): {launches}")
    for name, n in per_layer.items():
        if launches[name] != n * n_run:
            fail(f"{name}: {launches[name]} launches, expected {n} x {n_run}")

    s = np.array([row for _, row in scores])
    opt = np.concatenate([r["opt_mask"] for r in requests + [dense]])
    if not (np.isfinite(s[opt]).all() and np.isneginf(s[~opt]).all()):
        fail("scores: non-finite at a real beam or finite at a padded one")
    if s.shape != (n_run, NC):
        fail(f"scores shape {s.shape}")
    transport_err = float(np.abs(s[0] - s[-1]).max())
    print(f"check dense vs step-dedup transport, same request: max_abs_err "
          f"{transport_err:.3e} (tol 1e-3)")
    if not transport_err <= 1e-3:
        fail("dense and dedup transports disagree")

    # the kernel path against the plain path on one request, in f32 (the
    # kernels' f32 route, tol 1e-4) and in bf16, where the kernel path's
    # error against the f32 plain path may be at most twice the plain bf16
    # path's own; the argmax beam must agree unless the plain top two lie
    # within twice the bf16 path difference of each other
    def score(kernels, dtype):
        cfg.use_attention_kernels, cfg.compute_dtype = kernels, dtype
        try:
            return np.array(eval_epoch(model, cfg, requests[:1],
                                       device="cuda")[0][1])
        finally:
            cfg.use_attention_kernels, cfg.compute_dtype = True, "bfloat16"

    kernel = s[0]
    t0 = time.perf_counter()
    plain = score(False, "bfloat16")
    plain_request_ms = (time.perf_counter() - t0) * 1e3
    exact = score(False, "float32")
    f32_err = float(np.abs(score(True, "float32") - exact).max())
    print(f"check kernel vs plain path, f32 scores: max_abs_err {f32_err:.3e} "
          f"(tol 1e-4)")
    if not f32_err <= 1e-4:
        fail("kernel and plain paths disagree in f32")
    path_err = float(np.abs(kernel - plain).max())
    kernel_err = float(np.abs(kernel - exact).max())
    plain_err = float(np.abs(plain - exact).max())
    print(f"scores (request 0): kernel {np.round(kernel[:6], 5).tolist()}..., "
          f"plain {np.round(plain[:6], 5).tolist()}...")
    print(f"check kernel vs plain path, bf16 scores: max_abs_err "
          f"{path_err:.3e}; against f32: kernel {kernel_err:.3e} (tol "
          f"{2 * plain_err:.3e} = 2 x plain {plain_err:.3e})")
    if not kernel_err <= 2 * plain_err:
        fail("the kernel path's bf16 error exceeds twice the plain path's")
    top = np.sort(plain)[::-1]
    if int(np.argmax(kernel)) != int(np.argmax(plain)):
        if top[0] - top[1] > 2 * path_err:
            fail(f"argmax differs: kernel {np.argmax(kernel)}, plain "
                 f"{np.argmax(plain)}, plain top-two gap {top[0] - top[1]}")
        print(f"argmax differs within a tie: plain top-two gap "
              f"{top[0] - top[1]:.2e} <= 2 x path difference")
    else:
        print(f"argmax beam {int(np.argmax(kernel))} on both paths "
              f"(plain top-two gap {top[0] - top[1]:.2e})")

    lat = []
    for r in requests:
        t0 = time.perf_counter()
        eval_epoch(model, cfg, [r], device="cuda")
        lat.append((time.perf_counter() - t0) * 1e3)
    n_beams = int(sum(r["opt_mask"].sum() for r in requests))
    print(json.dumps({
        "main_path": "eval_epoch, step-dedup transport, bf16, flagship width",
        "requests": len(requests), "beams": n_beams,
        "ms_per_request": t_dedup * 1e3 / len(requests),
        "beams_per_s": n_beams / t_dedup,
        "request_ms_median": statistics.median(lat),
        "request_ms_max": max(lat), "request_ms_samples": len(lat),
        "plain_path_request_ms": plain_request_ms,
        "h2d_bytes_per_request": {   # instr_id stays on the host
            name: sum(v.nbytes for k, v in r.items() if k != "instr_id")
            for name, r in (("step_dedup", requests[0]), ("dense", dense))},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}))
    print(json.dumps(device_breakdown(
        lambda: eval_epoch(model, cfg, requests[1:2], device="cuda"),
        "traced_request")))
    return launches


def device_breakdown(run, name):
    """One traced run of ``run`` (torch.profiler): device time by kind of
    kernel, the device's busy share of the run's wall time, and the top
    kernels.  A separate run from the timed ones."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    groups = {"attention kernels B1-B4": ("attention_fwd_kernel",
                                          "attention_bwd_kernel",
                                          "delta_kernel"),
              "gemm (cuBLAS)": ("gemm", "nvjet", "xmma", "cutlass", "sm90_"),
              "copies": ("memcpy", "memset")}
    by_kind = dict.fromkeys(list(groups) + ["elementwise and other"], 0.0)
    for e in kernels:
        key = e.key.lower()
        kind = next((g for g, keys in groups.items()
                     if any(k in key for k in keys)), "elementwise and other")
        by_kind[kind] += e.self_device_time_total / 1e3
    busy = sum(by_kind.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {name: {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": (1 - busy / wall_ms) if wall_ms else None,
        "device_ms_by_kind": by_kind,
        "top_kernels": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                        for e in top]}}


def leaf(x):
    """A leaf that requires grad and keeps x's strides."""
    return x.detach().requires_grad_()


def sdpa_backward(problems, rate):
    """(ms, busiest device kernel) of the backward of
    F.scaled_dot_product_attention through autograd, one call per
    (q, k, v, additive mask, dO) problem: the library yardstick of B3/B4."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    leaves, outs, douts = [], [], []
    for q, k, v, mask, do in problems:
        qkv = [leaf(x) for x in (q, k, v)]
        outs.append(F.scaled_dot_product_attention(*qkv, attn_mask=mask,
                                                   dropout_p=rate))
        leaves += qkv
        douts.append(do)

    def run():
        return torch.autograd.grad(outs, leaves, douts, retain_graph=True)
    ms = cuda_ms(run)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busiest = max(kernels, key=lambda e: e.self_device_time_total).key[:80]
    return ms, busiest


def train_kernel_checks(seed):
    """Phase 5: B1-B4 in train mode against their plain versions; returns
    the numbers of the kernels line at the train shapes."""
    import torch
    import torch.nn.functional as F
    from youtube_vln_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    bf16, f32 = torch.bfloat16, torch.float32
    s_v, bh = L * BOXES, TRAIN_B * TRAIN_NC
    drop_seed = 0x5EED0000 + seed
    rows = {}

    def tol(dtype):
        return TOL[str(dtype)[6:]]

    def check_grads(tag, got, twin, auto, names, dtype):
        err = 0.0
        for n, g, t in zip(names, got, twin):
            err = max(err, check(f"{tag} d{n} vs plain bwd", g, t, tol(dtype), floor=0))
        if auto is not None:    # f32: autograd through the plain forward
            for n, g, a in zip(names, got, auto):
                check(f"{tag} d{n} vs autograd of plain fwd", g, a, tol(dtype), floor=0)
        return err

    # B1 (train forward with LSE) and B3; row 0 of every bias is a padded
    # candidate (every key at -10000)
    for i, (dtype, b, s_q, s_kv, d, rate) in enumerate((
            (bf16, bh, s_v, s_v, 128, RATE), (bf16, 8, s_v, s_v, 128, 0.0),
            (f32, 8, s_v, s_v, 128, RATE), (bf16, 8, 61, 807, 128, RATE),
            (f32, 8, 807, 61, 64, RATE), (f32, 8, 61, 807, 64, 0.0))):
        tag = f"{dtype} {b}x{HEADS} {s_q}x{s_kv} D={d} rate {rate}"
        q = heads_view(gen, b, HEADS, s_q, d, dtype)
        k, v = (heads_view(gen, b, HEADS, s_kv, d, dtype) for _ in range(2))
        do = heads_view(gen, b, HEADS, s_q, d, dtype)
        bias = key_bias(gen, b, s_kv)
        out, lse, _ = A._attention_fwd(q, k, v, bias, rate, drop_seed, True)
        err_f = check(f"B1 train fwd {tag}", out,
                      A.attention_reference(q, k, v, bias, rate, drop_seed), tol(dtype))
        lse_ref = A.attention_lse_reference(q, k, bias)
        check(f"B1 lse {tag}", lse[1:], lse_ref[1:], 1e-5)
        check(f"B1 lse padded row {tag}", lse[:1], lse_ref[:1], 1e-6)
        qkv = [leaf(x) for x in (q, k, v)]
        got = torch.autograd.grad(
            A.fused_attention(*qkv, bias, dropout_rate=rate, seed=drop_seed), qkv, do)
        twin = A.attention_bwd_reference(q, k, v, bias, do, rate, drop_seed)
        auto = (torch.autograd.grad(A.attention_reference(*qkv, bias, rate, drop_seed),
                                    qkv, do) if dtype == f32 else None)
        err_b = check_grads(f"B3 {tag}", got, twin, auto, "qkv", dtype)
        if i > 0:
            continue
        del got, twin
        mask4 = bias[:, None, None, :].to(dtype)
        n = q.shape[0] * q.shape[1] * s_q * s_kv * d
        fwd_bound = bound_ms(4 * n, 4 * nbytes(q) + nbytes(bias, lse))
        bwd_bound = bound_ms(10 * n, 8 * nbytes(q) + nbytes(bias, lse))
        lib_ms, lib_kernel = sdpa_backward([(q, k, v, mask4, do)], rate)
        rows["attention_fwd"] = dict(
            name="attention_fwd", route="cuda",
            source="youtube_vln_tpu_torch/ops/csrc/attention_fwd.cu",
            replaces="youtube_vln_tpu/ops/attention.py:48", max_abs_err=err_f,
            ms=cuda_ms(lambda: A._attention_fwd(q, k, v, bias, rate, drop_seed, True)),
            plain_ms=cuda_ms(lambda: (A.attention_reference(q, k, v, bias, rate, drop_seed),
                                      A.attention_lse_reference(q, k, bias)), iters=5),
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask4, dropout_p=rate)),
            shape=f"[{bh}, {HEADS}, {s_q}, {d}] bf16, dropout {rate}, LSE out")
        rows["attention_bwd"] = dict(
            name="attention_bwd", route="cuda",
            source="youtube_vln_tpu_torch/ops/csrc/attention_bwd.cu",
            replaces="youtube_vln_tpu/ops/attention.py:67", max_abs_err=err_b,
            ms=cuda_ms(lambda: A._attention_bwd(q, k, v, bias, out, do, lse, rate,
                                                drop_seed)),
            plain_ms=cuda_ms(lambda: A.attention_bwd_reference(q, k, v, bias, do, rate,
                                                               drop_seed), iters=5),
            bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=lib_ms,
            library=f"backward of F.scaled_dot_product_attention, float mask, "
                    f"dropout {rate}: {lib_kernel}",
            shape=f"[{bh}, {HEADS}, {s_q}, {d}] bf16, dropout {rate}")
        del out, lse, q, k, v, do, mask4
        torch.cuda.empty_cache()

    # B2 (both directions, train forward with LSE) and B4
    names = ("q1", "k1", "v1", "q2", "k2", "v2")
    for i, (dtype, b, sv, st, d, rate) in enumerate((
            (bf16, bh, s_v, S_T, 128, RATE), (bf16, 8, s_v, S_T, 128, 0.0),
            (f32, 8, s_v, S_T, 128, RATE), (bf16, 8, 807, 61, 64, RATE),
            (f32, 8, 807, 61, 64, RATE))):
        tag = f"{dtype} {b}x{HEADS} {st}<->{sv} D={d} rate {rate}"
        vis = [heads_view(gen, b, HEADS, sv, d, dtype) for _ in range(3)]
        txt = [heads_view(gen, b, HEADS, st, d, dtype) for _ in range(3)]
        vb, tb = key_bias(gen, b, sv), key_bias(gen, b, st)
        do1 = heads_view(gen, b, HEADS, st, d, dtype)
        do2 = heads_view(gen, b, HEADS, sv, d, dtype)
        ctx1, ctx2, lse1, lse2, _ = A._bi_attention_fwd(
            *vis, *txt, vb, tb, rate, rate, drop_seed, True)
        want = A.bi_attention_reference(*vis, *txt, vb, tb, rate, rate, drop_seed)
        err_f = max(check(f"B2 train fwd ctx1 {tag}", ctx1, want[0], tol(dtype)),
                    check(f"B2 train fwd ctx2 {tag}", ctx2, want[1], tol(dtype)))
        for lse, ref, side in ((lse1, A.attention_lse_reference(txt[0], vis[1], vb), "1"),
                               (lse2, A.attention_lse_reference(vis[0], txt[1], tb), "2")):
            check(f"B2 lse{side} {tag}", lse[1:], ref[1:], 1e-5)
            check(f"B2 lse{side} padded row {tag}", lse[:1], ref[:1], 1e-6)
        ops = [leaf(x) for x in vis + txt]
        got = torch.autograd.grad(A.fused_bi_attention(
            *ops, vb, tb, rate1=rate, rate2=rate, seed=drop_seed), ops, (do1, do2))
        twin = A.bi_attention_bwd_reference(*vis, *txt, vb, tb, do1, do2, rate, rate,
                                            drop_seed)
        auto = (torch.autograd.grad(A.bi_attention_reference(
            *ops, vb, tb, rate, rate, drop_seed), ops, (do1, do2))
            if dtype == f32 else None)
        err_b = check_grads(f"B4 {tag}", got, twin, auto, names, dtype)
        if i > 0:
            continue
        del got, twin
        (q1, k1, v1), (q2, k2, v2) = vis, txt
        vm, tm = vb[:, None, None, :].to(dtype), tb[:, None, None, :].to(dtype)
        n = q1.shape[0] * q1.shape[1] * st * sv * d
        vis_bytes, txt_bytes = nbytes(q1), nbytes(q2)
        fwd_bound = bound_ms(8 * n, 4 * (vis_bytes + txt_bytes) + nbytes(vb, tb, lse1, lse2))
        bwd_bound = bound_ms(20 * n, 8 * (vis_bytes + txt_bytes) + nbytes(vb, tb, lse1, lse2))
        lib_ms, lib_kernel = sdpa_backward(
            [(q2, k1, v1, vm, do1), (q1, k2, v2, tm, do2)], rate)
        rows["bi_attention_fwd"] = dict(
            name="bi_attention_fwd", route="cuda",
            source="youtube_vln_tpu_torch/ops/csrc/attention_fwd.cu",
            replaces="youtube_vln_tpu/ops/attention.py:288", max_abs_err=err_f,
            ms=cuda_ms(lambda: A._bi_attention_fwd(*vis, *txt, vb, tb, rate, rate,
                                                   drop_seed, True)),
            plain_ms=cuda_ms(lambda: (
                A.bi_attention_reference(*vis, *txt, vb, tb, rate, rate, drop_seed),
                A.attention_lse_reference(q2, k1, vb),
                A.attention_lse_reference(q1, k2, tb)), iters=5),
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
            # no single library call runs both directions: two SDPA calls
            library_ms=cuda_ms(lambda: (
                F.scaled_dot_product_attention(q2, k1, v1, attn_mask=vm, dropout_p=rate),
                F.scaled_dot_product_attention(q1, k2, v2, attn_mask=tm, dropout_p=rate))),
            shape=f"[{bh}, {HEADS}] {st}<->{sv}, D {d}, bf16, dropout {rate}, LSE out")
        rows["bi_attention_bwd"] = dict(
            name="bi_attention_bwd", route="cuda",
            source="youtube_vln_tpu_torch/ops/csrc/attention_bwd.cu",
            replaces="youtube_vln_tpu/ops/attention.py:324", max_abs_err=err_b,
            ms=cuda_ms(lambda: A._bi_attention_bwd(
                *vis, *txt, vb, tb, ctx1, ctx2, lse1, lse2, do1, do2, rate, rate,
                drop_seed)),
            plain_ms=cuda_ms(lambda: A.bi_attention_bwd_reference(
                *vis, *txt, vb, tb, do1, do2, rate, rate, drop_seed), iters=5),
            bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=lib_ms,
            library=f"backward of two F.scaled_dot_product_attention calls, "
                    f"float masks, dropout {rate}: {lib_kernel}",
            shape=f"[{bh}, {HEADS}] {st}<->{sv}, D {d}, bf16, dropout {rate}")
        del ctx1, ctx2, lse1, lse2, vis, txt, do1, do2
        torch.cuda.empty_cache()
    return rows


def train_batch(rng, padded: bool):
    """One global batch of recipe 30RS on the candidate-dedup transport, in
    the loader's layout: 16 instructions x 6 candidates, each candidate its
    own unique trajectory (the negatives are shuffled copies), f16
    features.  With ``padded`` the last instruction's last candidate is
    padding (opt_mask false, every text and visual key masked)."""
    import numpy as np
    b, nc, s_v = TRAIN_B, TRAIN_NC, L * BOXES
    n_words = rng.integers(20, S_T, b)
    instr_mask = np.repeat((np.arange(S_T)[None] < n_words[:, None])[:, None],
                           nc, axis=1).astype(np.int32)
    tokens = rng.integers(1, 30522, (b, nc, S_T)).astype(np.int32) * instr_mask
    image_mask = np.zeros((b, nc, s_v), np.int32)
    for i in range(b):
        for j in range(nc):
            for step in range(L):        # 36..101 detected boxes per step
                n = int(rng.integers(36, BOXES + 1))
                image_mask[i, j, step * BOXES:step * BOXES + n] = 1
    locs = rng.random((b, nc, s_v, 12)).astype(np.float32)
    locs[..., 11] = np.repeat(np.arange(L), BOXES)
    feats = rng.normal(size=(b, nc, s_v, FEAT)).astype(np.float16)
    opt = np.ones((b, nc), bool)
    if padded:
        opt[-1, -1] = False
        instr_mask[-1, -1] = 0
        image_mask[-1, -1] = 0
        feats[-1, -1] = 0
    return {"instr_tokens": tokens, "instr_mask": instr_mask,
            "segment_ids": np.zeros_like(tokens),
            "instr_targets": np.full_like(tokens, -1),
            "uniq_image_features": feats, "uniq_image_locations": locs,
            "uniq_image_mask": image_mask,
            "cand_index": np.tile(np.arange(nc, dtype=np.int32), (b, 1)),
            "opt_mask": opt, "ranking_target": np.zeros(b, np.int32)}


def model_flops_per_traj(cfg, s_t, s_v):
    """Matmul operations of one trajectory's forward and backward (3x the
    forward's multiply-adds x 2), from the configuration: the projections,
    feed-forward blocks, attention products and the visual embedding."""
    h, hv, bi = cfg.hidden_size, cfg.v_hidden_size, cfg.bi_hidden_size
    text = s_t * (4 * h * h + 2 * h * cfg.intermediate_size) + 2 * s_t * s_t * h
    vis = (s_v * (4 * hv * hv + 2 * hv * cfg.v_intermediate_size)
           + 2 * s_v * s_v * hv)
    conn = (s_v * 3 * hv * bi + s_t * 3 * h * bi + 4 * s_t * s_v * bi
            + s_v * bi * hv + s_t * bi * h
            + s_v * 2 * hv * cfg.v_intermediate_size
            + s_t * 2 * h * cfg.intermediate_size)
    macs = (cfg.num_hidden_layers * text + cfg.v_num_hidden_layers * vis
            + len(cfg.v_biattention_id) * conn + s_v * cfg.v_feature_size * hv)
    return 3 * 2 * macs


def run_steps(step, batches, n, next_seed):
    """(ms per step, peak device memory, launch counts, metrics) of ``n``
    train steps, the counts and the peak reset just before them."""
    import torch
    from youtube_vln_tpu_torch.ops import attention as A
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(batches[i % len(batches)], next_seed()) for i in range(n)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    return ms, torch.cuda.max_memory_allocated(), dict(A.LAUNCHES), metrics


def check_launches(cfg, launches, micro, what):
    """6 launches of each of B1-B4 per micro-step (one per vision layer and
    one per connection layer)."""
    print(f"launches on the {what} ({micro} micro-steps): {launches}")
    for name, per in (("attention_fwd", cfg.v_num_hidden_layers),
                      ("attention_bwd", cfg.v_num_hidden_layers),
                      ("bi_attention_fwd", len(cfg.v_biattention_id)),
                      ("bi_attention_bwd", len(cfg.v_biattention_id))):
        if launches[name] != per * micro:
            fail(f"{what}: {name} launched {launches[name]} times, expected "
                 f"{per} x {micro}")


def train_path(seed):
    """Phase 6: the 30RS fine-tuning step at full flagship width, then the
    same global batch with gradient accumulation 2; returns the launch
    counts of the timed steps without accumulation."""
    import dataclasses

    import numpy as np
    import torch
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.config import RunConfig
    from youtube_vln_tpu_torch.device import to_device
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.parallel.train_step import (_task_config,
                                                           build_train_step,
                                                           create_train_state,
                                                           loss_fn)

    cfg = lily_base_config(ranking=True, compute_dtype="bfloat16")
    args = RunConfig(ranking=True, pretrain=False, shuffle_visual_features=True,
                     num_negatives=2, learning_rate=4e-5, weight_decay=1e-2,
                     lr_schedule="warmup_linear")
    args.validate()
    model = Lily(cfg, device="cuda").init_weights(seed)
    n_params = sum(p.numel() for p in model.parameters())
    # a 2000-step schedule (100 steps x 20 epochs, warm-up 0.2)
    optimizer, _ = create_train_state(model, args, steps_per_epoch=100)
    step = build_train_step(model, cfg, args, optimizer, device="cuda")
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    batches = [to_device(train_batch(rng, padded), dev) for padded in (True, False)]
    seeds = torch.Generator().manual_seed(seed)   # the host draws step seeds

    def next_seed():
        return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=seeds))

    print(f"train model: lily_base_config, {n_params} parameters, bf16, "
          f"AdamWRef, global batch {TRAIN_B} x {TRAIN_NC}")
    before = [p.detach().clone() for p in model.parameters()]
    metrics = [step(batches[i % 2], next_seed()) for i in range(WARMUP_STEPS)]
    ms, peak, launches, timed = run_steps(step, batches, TIMED_STEPS, next_seed)
    check_launches(cfg, launches, TIMED_STEPS, "train path")
    losses = [float(m["loss/train"]) for m in metrics + timed]
    print(f"train losses: {losses}")
    if not np.isfinite(losses).all():
        fail("train path: non-finite loss")
    moved = sum(int(not torch.equal(a, p.detach()))
                for a, p in zip(before, model.parameters()))
    print(f"parameters moved: {moved} of {len(before)} tensors")
    if moved == 0:
        fail("train path: no parameter moved")
    del before

    # one more micro-step, untimed, to read the gradients before the update
    model.train()
    loss_fn(model, batches[0], _task_config(args, True), next_seed())[0].backward()
    bad = [n for n, p in model.named_parameters()
           if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    if bad:
        fail(f"train path: non-finite gradients in {bad[:5]}")
    optimizer.zero_grad(set_to_none=True)

    flops = model_flops_per_traj(cfg, S_T, L * BOXES) * TRAIN_B * TRAIN_NC
    print(json.dumps({
        "train_path": "build_train_step, recipe 30RS, bf16, flagship width and "
                      "depth, batches resident on the device",
        "steps": TIMED_STEPS, "ms_per_step": ms,
        "trajectories_per_s": TRAIN_B * TRAIN_NC / ms * 1e3,
        "instructions_per_s": TRAIN_B / ms * 1e3,
        "peak_memory_gib": peak / 2 ** 30,
        "step_flops": flops, "step_bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
        "losses": losses}))
    print(json.dumps(device_breakdown(
        lambda: step(batches[0], next_seed()), "traced_train_step")))

    # the same global batch in two micro-steps of 8 x 6
    args2 = dataclasses.replace(args, gradient_accumulation_steps=2)
    step2 = build_train_step(model, cfg, args2, optimizer, device="cuda")
    split = [{k: v.reshape((2, -1) + tuple(v.shape[1:])) for k, v in b.items()}
             for b in batches]
    step2(split[0], next_seed())
    ms2, peak2, launches2, timed2 = run_steps(step2, split, 3, next_seed)
    check_launches(cfg, launches2, 3 * 2, "train path with accumulation 2")
    losses2 = [float(m["loss/train"]) for m in timed2]
    if not np.isfinite(losses2).all():
        fail("train path with accumulation 2: non-finite loss")
    print(json.dumps({
        "train_path_accumulation_2": "the same global batch as two micro-steps",
        "steps": 3, "ms_per_step": ms2, "peak_memory_gib": peak2 / 2 ** 30,
        "losses": losses2}))

    # the instruction that carries the padded candidate
    path_gradient_check(model, cfg, args, {k: v[-1:] for k, v in
                                           train_batch(rng, True).items()})
    return launches


def path_gradient_check(model, cfg, args, batch):
    """Phase 7: gradients of one step at batch 1 x 6 on the kernel path
    against the plain path (kernel sites on the kernels' plain versions)."""
    import torch
    from youtube_vln_tpu_torch.device import to_device
    from youtube_vln_tpu_torch.ops import attention as A
    from youtube_vln_tpu_torch.parallel.train_step import _task_config, loss_fn

    batch = to_device(batch, torch.device("cuda"))
    tasks = _task_config(args, True)
    params = [p for p in model.parameters() if p.requires_grad]
    drop_seed = 0xD50 + 1

    def grads(kernels, dtype, dropout):
        """The step's gradients; the kernel path must launch each of B1-B4
        once per layer, the plain path none of them."""
        cfg.use_attention_kernels, cfg.compute_dtype = kernels, dtype
        model.train(dropout)
        A.reset_launch_counts()
        try:
            loss = loss_fn(model, batch, tasks, drop_seed)[0]
            g = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            cfg.use_attention_kernels, cfg.compute_dtype = True, "bfloat16"
        what = (f"gradient check ({'kernel' if kernels else 'plain'} path, "
                f"{dtype}, dropout {'on' if dropout else 'off'})")
        if kernels:
            check_launches(cfg, dict(A.LAUNCHES), 1, what)
        elif any(A.LAUNCHES.values()):
            fail(f"{what}: kernels launched: {dict(A.LAUNCHES)}")
        return [torch.zeros_like(p) if x is None else x.float()
                for p, x in zip(params, g)]

    def rel_l2(a, b):
        num = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
        den = sum(float((y ** 2).sum()) for y in b)
        return (num / den) ** 0.5

    for dropout in (False, True):
        err = rel_l2(grads(True, "float32", dropout), grads(False, "float32", dropout))
        print(f"check train-step gradients, kernel vs plain path, f32, dropout "
              f"{'on' if dropout else 'off'}: relative L2 {err:.3e} (tol 1e-3)")
        if not err <= 1e-3:
            fail("train-step gradients: kernel and plain paths disagree")
    exact = grads(False, "float32", False)
    k_err = rel_l2(grads(True, "bfloat16", False), exact)
    p_err = rel_l2(grads(False, "bfloat16", False), exact)
    print(f"check train-step gradients in bf16 against f32: kernel path "
          f"{k_err:.3e}, plain path {p_err:.3e} (tol 2 x plain)")
    if not k_err <= 2 * p_err:
        fail("train-step gradients: the kernel path's bf16 error exceeds "
             "twice the plain path's")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (REPO / "youtube_vln_tpu_torch" / "ops" / "csrc").is_dir():
        fail(f"the youtube_vln_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from youtube_vln_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    print(f"build: {', '.join(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")

    eval_rows = kernel_checks(args.seed)
    launches_eval = main_path(args.seed)
    rows = train_kernel_checks(args.seed)
    launches_train = train_path(args.seed)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, row in rows.items():
        row["launches_eval"] = launches_eval[name]
        row["launches_train"] = launches_train[name]
        row["launches"] = launches_eval[name] + launches_train[name]
        if name in eval_rows:
            row["eval_shape"] = {k: eval_rows[name][k] for k in keys}
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
