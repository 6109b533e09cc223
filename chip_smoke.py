#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``youtube_vln_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel from ``youtube_vln_tpu_torch/ops/csrc``;
  3. each kernel against its plain PyTorch version on the card, at the beam-
     eval shapes and at odd lengths, in bf16 and f32;
  4. the main path: the beam re-ranking scorer (``eval_epoch``) at the full
     flagship width (``lily_base_config``, random weights from the seed,
     bf16), on a few requests of 30 beams x (60 text + 808 visual tokens),
     on the step-dedup transport and on the dense one; the launch counts
     must show both kernels on that path, the scores must be finite, and
     the kernel path must agree with the plain path on one request;
  5. a ``kernels`` JSON line: per kernel its launches on the main path,
     error, time, bound, plain time and a library call's time.
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
N_REQUESTS = 4                     # step-dedup requests on the main path
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


def check(name, got, want, rel_tol) -> float:
    import torch
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    scale = max(1.0, float(want.float().abs().max()))
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
        lambda: eval_epoch(model, cfg, requests[1:2], device="cuda"))))
    return launches


def device_breakdown(run):
    """One traced request (torch.profiler): device time by kind of kernel,
    the device's busy share of the request's wall time, and the top
    kernels.  A separate run from the timed ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    groups = {"attention kernels B1+B2": ("attention_fwd_kernel",),
              "gemm (cuBLAS)": ("gemm", "nvjet", "xmma", "cutlass", "sm90_"),
              "copies": ("memcpy", "memset")}
    by_kind = dict.fromkeys(list(groups) + ["elementwise and other"], 0.0)
    for e in kernels:
        name = e.key.lower()
        kind = next((g for g, keys in groups.items()
                     if any(k in name for k in keys)), "elementwise and other")
        by_kind[kind] += e.self_device_time_total / 1e3
    busy = sum(by_kind.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"traced_request": {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": (1 - busy / wall_ms) if wall_ms else None,
        "device_ms_by_kind": by_kind,
        "top_kernels": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                        for e in top]}}


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

    rows = kernel_checks(args.seed)
    launches = main_path(args.seed)
    for name, row in rows.items():
        row["launches"] = launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
