#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``youtube_vln_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

(``--ddp-child SPEC`` runs one rank of phase 14 or 15; the script starts
those itself.)

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel from ``youtube_vln_tpu_torch/ops/csrc``
     (one nvcc per source, all at once, ``-Xptxas -v``): registers, stack
     and spills of every kernel instance, fatal on a spill in a bf16
     D = 128 instance of B1-B4 or in B6's bf16 instance (D up to 1024);
     the blocks per SM of B1-B4 (at least 2 in bf16 at D = 128) and B6's
     layout (at least 2 resident blocks, 32 warps, per SM in bf16);
  3. the forward kernels B1/B2 against their plain PyTorch versions at the
     beam-eval shapes and at odd lengths, in bf16 and f32; then B1-B4 at
     the edges of the kernels' tiling: B*H = 1, S_q and S_kv of 1, 17 and
     65, D 64 and 128, bf16 and f32, dropout 0 and 0.1;
  4. the eval path: the beam re-ranking scorer (``eval_epoch``) at the full
     flagship width (``lily_base_config``, random weights from the seed,
     bf16), on a few requests of 30 beams x (60 text + 808 visual tokens),
     on the step-dedup transport and on the dense one; the launch counts
     must show both kernels on that path, the scores must be finite, and
     the kernel path must agree with the plain path on one request;
 4b. the user's entry: ``entries.test.main`` (``python -m
     youtube_vln_tpu_torch.entries.test``) at full width on an R2R fixture
     at the flagship eval geometry written by the port's
     ``build_r2r_fixture`` (val_unseen, 15 instructions x 30 beams x 8
     steps x 100 boxes + the global row), weights of ``lily_base_config``
     from the seed saved as a reference-layout ``.bin``: run A bf16 on the
     step-dedup transport, B on the dense one, C f32 with the kernels, D
     f32 with ``--no_pallas``; every results file covers all 15
     instructions, scores finite at real beams, dense against step-dedup
     within 1e-3 and f32 kernels against f32 plain within 1e-4 (the
     trajectories equal except at ties within those), 6 + 6 launches of
     B1/B2 per request in A-C and none in D, SPL <= SR by ``Evaluation``;
     prints SR and SPL, ms per request through the entry, beams/s, host
     ms per ``BeamDataset`` item and whether the native packer ran;
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
  9. B5/B6, the fused dropout + residual + LayerNorm epilogue, against
     their plain versions at the pretraining shape (45,248 x 1024), at
     5,760 x 768 and at an odd row count, bf16 and f32, dropout 0 and 0.1:
     out, dh, dres, dw and db (same Philox masks), dh 0 wherever B5
     dropped, and a second B6 launch on the same inputs bitwise equal;
 10. the pretraining path: a YTb fixture at flagship geometry (16 videos
     x 24 frames x 101 boxes) written by the port's ``build_ytb_fixture``,
     the port's ``YTbDataset`` (MLM + MVM masking, sparse targets,
     candidate dedup) and ``Loader`` (batch 8, one process) feeding
     ``build_train_step`` for the four MRT tasks at flagship width and
     depth in bf16 (AdamWRef, lr 2e-5): 2 warm-up steps, then 5 timed
     steps each with ``use_epilogue_kernels`` on, off, off, on, on
     device-resident batches; 24 launches each of B5/B6 and 6 of B1-B4 per
     micro-step with the knob on, none of B5/B6 with it off; finite
     losses, moved parameters; then 3 steps fed straight from the Loader;
 11. that step's gradients at batch 1 x 7 on the kernel path against the
     plain path (every kernel site on its plain version, same masks): f32
     with dropout off and on, and bf16 against f32;
 12. one traced pretraining step with the epilogue knob on and one with it
     off: device time by kind, B5/B6 a kind of their own, idle share;
 13. the training entries at full width and depth, as users run them:
     ``entries.train.main`` (``python -m youtube_vln_tpu_torch.entries.train``,
     recipe 30RS, one epoch, a save after it) on ``build_r2r_fixture(
     n_paths=16)`` (48 instructions per split, 3 steps of 16 x 6) from seed
     weights saved as a ``.bin``; then ``--resume`` from its epoch-0
     checkpoint; then ``--remat --profile_dir``; then
     ``entries.pretrain.main`` (the MRT recipe, 3 Loader workers) on the YTb
     fixture of phase 10 laid out under ``<data_dir>/YouTube-VLN/ytb``;
     fatal: finite losses, 6 launches of each of B1-B4 per micro-step (12 of
     B1/B2 with remat) plus 6 + 6 of B1/B2 per eval batch, none of B5/B6,
     ``0.bin``, ``best_seen.bin`` and ``best_unseen.bin`` loaded back with no
     missing or unexpected tensor and ``step_count`` 3, accuracies in [0, 1],
     the resumed run running epoch 1 alone from ``step_count`` 3 to 6 at lr
     ``schedule(3)``, remat's first-step loss equal to the run without it
     and its peak memory lower, a profiler trace written,
     ``best_ranking.bin`` and ``best_traj.bin`` written; prints a
     ``train_entry`` JSON line (ms per step, trajectories/s, peak memory,
     save seconds and bytes, load seconds, eval ms per split);
 14. data parallelism, on phase 13's fixtures: (a) B1-B6 at their train
     shapes with dropout 0.1, each half of the batch launched with the
     offset its rank of two would pass (first global stream or row): the
     rows of the full launch bit for bit (B6's dw/db, sums over the rows,
     within the tolerance), offset 0 bit for bit the launch without one,
     each against its plain twin; (b) the 30RS train entry in a child
     process of a world-1 NCCL group (``RANK=0 WORLD_SIZE=1``), so the model
     is DDP-wrapped on the card, with ``--orbax_checkpoints`` (a ``.dcp``
     save) and a ``--resume`` from it, 6 launches of each of B1-B4 per
     micro-step, ms per step against phase 13's unwrapped run; (c) two
     child ranks over gloo on the one card: 30RS ``--remat`` in f32 with
     dropout 0 against the same run in this process (per-step losses within
     1e-4 relative), in bf16 (losses equal across the ranks), and the MRT
     step with the epilogue kernels (24 launches each of B5/B6 per
     micro-step per rank) saved collectively as ``.dcp`` and loaded here in
     one process, equal to rank 0's weights; a child that fails or hangs
     (420 s) fails the run; prints a ``ddp`` JSON line (gloo's times are
     not a speed number);
 15. tensor parallelism over heads, after phase 14: (a) B1-B4 at the
     train shapes (bf16 and f32, dropout 0 and 0.1) on every shard of a
     1 x 2 and a 2 x 2 mesh with the head mapping of the Philox stream:
     bitwise the slice of the full launch, the identity mapping bitwise the
     launch without one; B5/B6 with the data coordinate's row0 once per
     model rank, bitwise the full launch's rows; (b) two gloo child ranks
     on the one card under ``--mesh_shape 1 2`` (global batch 8,
     ``--remat``, an R2R fixture of 18 instructions): the 30RS train entry
     in f32 with dropout 0 against one process (per-step losses within
     1e-4 relative), its gathered ``0.bin`` equal in keys and shapes to the
     one process's; in bf16 with dropout 0.1, the replicated parameters
     bitwise equal across the ranks, the ``.dcp`` loaded in one process
     equal to the ranks' gathered weights and moments; (c) the MRT pretrain
     entry under ``--mesh_shape 1 2`` with the epilogue kernels, 2 steps:
     6 launches of B1-B4 and 24 of B5/B6 per micro-step per rank, every B5
     output bitwise equal on the two ranks; (d) eight gloo child ranks on
     the card under ``--mesh_shape 1 8`` at full width and depth, where
     the 12 text heads split (each rank attends on the 2 heads that cover
     its 96 features): the 30RS entry of (b) in f32 against (b)'s one
     process (1e-4 relative), its gathered ``0.bin`` in keys and shapes,
     in bf16 at dropout 0.1 the replicated parameters bitwise equal across
     the eight ranks, 6 launches of B1-B4 per micro-step per rank; (e)
     B1-B4 on the heads that cover each coordinate of a model axis of 16
     (half a head each) at the train shapes, in one process: the kept
     contexts bitwise the full launch's, the gradients of the kept
     features summed over the coordinates within 1e-5 relative L2 (f32);
     prints a ``tp`` JSON line with the card (gloo times, not a speed
     number);
 16a. the legacy ViLBERT heads at full width: ``BertForMultiModalPreTraining``
     and ``VILBertForVLTasks`` with ``SimpleClassifier(1024, 2048, 3129)``
     (``lily_base_config``, random weights from the seed, bf16) on 32 rows x
     (60 + 808) tokens: an eval forward of each, 6 + 6 launches of B1/B2 per
     call, and a train-mode forward and backward of each at dropout 0.1, 6
     launches of each of B1-B4 per call; the eval outputs against
     ``plain_launchers()`` (the classifier's argmax equal outside ties, the
     bf16 error against the f32 plain path at most twice the plain path's,
     f32 within 1e-4) and the f32 train-mode gradients at 8 rows within
     1e-3 relative L2; prints a ``legacy`` JSON line;
 16. the offline dataset pipeline at full width on 2 synthetic videos x 48
     frames of 720 x 1280 (a 720p house tour at 1 fps, cut in frames only),
     f32, random weights from the seed: 5a ``run_indoor_filter``
     (WideResNet-18 Places365, batch 64), 5b ``run_maskrcnn_filter``
     (AlexNet Places365, batch 32; Mask R-CNN R50-FPN at min 800 / max
     1333, 749 x 1333 padded to 768 x 1344), 6 ``build_clip_tsv``
     (ViT-B/32, batch 64), text features of seeded token ids and
     ``clip_captions.run``, 7-8 ``encode_frames``, 20 Adam steps of the
     inverse head at batch 32, ``predict_actions`` and
     ``write_action_profiles``, 3-4 ``run_extraction`` (seeded stand-in
     detector) and ``convert_tsv_to_store``, 9-10 the records, photo merging,
     the frozen testset and a Loader batch of the port's ``YTbDataset``;
     fatal: a non-finite output, an artifact not read back, an inverse-head
     loss that does not fall, and for 2 frames per model a card output
     (Places365 logits, layer4 and pooled; AlexNet logits; the FPN levels,
     the RPN outputs and the box head on the same proposals; CLIP image and
     text features; the head's logits) off the same port code on the CPU by
     more than 1e-4 of the CPU output's largest value; prints a ``pipeline``
     JSON line (frames/s per stage, Mask R-CNN device and host ms per frame,
     the head's ms per step, peak memory, the phase's seconds);
 17. the tools (``python -m youtube_vln_tpu_torch.entries.<tool>``), in
     this process: ``check_kernels`` (a) B5's drop fraction, (b) the mask
     replay of B1-B6 by finite differences, (c) two launches bitwise equal,
     (d) the backward error of the kernels on a flagship sample against
     the plain f32 path, beside the bf16 floor and with each of B1-B4 on
     its plain twin, for 3 weight seeds, (e) "skipped (1 device)";
     then, counted, ``profile_step full full_epi --recipe 30rs --table``
     (ms per 30RS step, and a ``profile`` line: the top ops and kernels by
     self device time, busy and idle share), ``bench_serving --dedup``,
     ``bench`` (kernel against plain path, trajectories/s, MFU),
     ``bench_e2e`` (an epoch's start-up, then 8 steady-state Loader-fed
     steps, 3 workers, against the device-only step, candidate-dedup and
     dense; ``slab_overflow``), ``bench_loader``
     and ``bench_loader --eval``, and ``northstar`` on
     phase 4b's fixture and weights with run A's SR and SPL expected: it
     must report PASS, and every kernel must launch; prints each tool's line
     and a ``tools`` summary line;
 18. a ``kernels`` JSON line: per kernel its launches on the eval, the
     fine-tuning, the pretraining, the test entry (run A), the train entry,
     the pretrain entry, the data-parallel (phase 14 b and c, every rank),
     the tensor-parallel (phase 15 b, c and d, every rank), the legacy-head
     (phase 16a) and the tools (phase 17) paths, error,
     time, bound, plain time
     and a library call's time at the train shapes (B1/B2 also at the eval
     shapes, B5/B6 at the pretraining shape); B1-B4 also carry the bf16
     D = 128 registers and blocks per SM, B6 those of its bf16 instance.
Before the kernels line, a ``phase_s`` line gives the seconds of each
phase.  The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside it, the script exits non-zero.
"""
import argparse
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# the pretraining recipe (README: pretrain.py --pre_dataset ytb
# --masked_vision --masked_language --ranking --traj_judge --batch_size 8
# --learning_rate 2e-5): 8 instructions x (1 + 3 x 2 negatives) candidates
PRE_B, PRE_NC = 8, 7
PRE_VIDEOS, PRE_FRAMES = 16, 24    # fixture: ~0.57 GB of features
PRE_TIMED = 5
# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores
# (the main path's type), f32 outside the tensor cores (the epilogue's
# arithmetic) and device memory
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# B6's bf16 occupancy that the source note of csrc/epilogue.cu states
B6_BLOCKS_PER_SM, B6_WARPS_PER_SM = 2, 32
# kernel vs plain version: max abs error over max(1, max |plain|).  bf16:
# 1e-2, about two and a half bf16 ulps (8 significant bits) at the largest
# output.  f32: 1e-3, set by the rows of a padded candidate, where every key
# carries -10000 and a logit is rounded at the f32 ulp of 10000 (9.8e-4)
# whatever the order of summation.
TOL = {"bfloat16": 1e-2, "float32": 1e-3}


# seconds per phase of this run (``phase_timer``), printed before the kernels line
PHASE_S = {}
# the card's name and power limit (nvidia-smi), printed beside every time
CARD = ""


@contextlib.contextmanager
def phase_timer(phase: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_S[phase] = round(time.perf_counter() - t0, 1)


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


def check(name, got, want, rel_tol, floor=1.0, verbose=True) -> float:
    """max |got - want| <= rel_tol * max(floor, max |want|); gradients use
    floor 0, so their tolerance scales with the largest gradient."""
    import torch
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    scale = max(floor, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    tol = rel_tol * scale
    if verbose or not err <= tol:
        print(f"check {name}: max_abs_err {err:.3e} (tol {tol:.2e} = "
              f"{rel_tol:.0e} x {scale:.3g})")
    if not err <= tol:
        fail(f"{name}: max_abs_err {err} above {tol}")
    return err


def bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """The least time for the work: operations over the peak rate of their
    type (bf16 tensor cores unless given) or bytes over the memory rate,
    whichever is larger."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def reset_counts() -> None:
    """Zero the launch counts of every kernel (B1-B6)."""
    from youtube_vln_tpu_torch.ops import attention as A
    from youtube_vln_tpu_torch.ops import epilogue as E
    A.reset_launch_counts()
    E.reset_launch_counts()


def counts() -> dict:
    """The launch counts of every kernel since the last reset."""
    from youtube_vln_tpu_torch.ops import attention as A
    from youtube_vln_tpu_torch.ops import epilogue as E
    return {**A.LAUNCHES, **E.LAUNCHES}


def no_epilogue_launches(launches, what) -> None:
    if launches["epilogue_fwd"] or launches["epilogue_bwd"]:
        fail(f"{what}: B5/B6 launched with use_epilogue_kernels off: {launches}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ptxas_summary(log):
    """Per kernel instance in an ``nvcc -Xptxas -v`` log: registers, stack
    frame and spill bytes (a ``Function properties`` line, then its
    ``spill`` and ``Used N registers`` lines)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def kernel_instance(mangled):
    """(kernel name, element type, head dim) of a mangled kernel symbol."""
    m = re.search(r"((?:attention_fwd|attention_bwd|delta|epilogue_fwd|epilogue_bwd|"
                  r"column_sum)_kernel)I?(13__nv_bfloat16|f)?(?:Li(\d+)E)?", mangled)
    if not m:
        return mangled[:60], "", None
    dtype = {"13__nv_bfloat16": "bf16", "f": "f32"}.get(m.group(2) or "", "")
    return m.group(1), dtype, int(m.group(3)) if m.group(3) else None


def build_kernels():
    """Phase 2: every kernel built from ``ops/csrc`` with ``-Xptxas -v``
    (one nvcc per source, all at once): registers, stack and spills per
    instance, fatal on any spill in a bf16 D = 128 instance of B1-B4 or in
    B6's bf16 instance; then the blocks per SM of the B1-B4 instances and
    B6's layout (occupancy query).  Returns the bf16 numbers of B1-B4 (D =
    128) and B6 by kernels-line name."""
    import ctypes

    import torch
    from youtube_vln_tpu_torch.ops import _build
    from youtube_vln_tpu_torch.ops import epilogue as E
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    print(f"build: {', '.join(logs)} in {time.perf_counter() - t0:.1f} s")
    regs = {}
    for source, log in logs.items():
        for f in ptxas_summary(log):
            name, dtype, d = kernel_instance(f["function"])
            print(f"  ptxas {source}: {name} <{dtype}, {d}>: {f.get('registers')} "
                  f"registers, {f.get('stack')} B stack, {f.get('spill_stores')} B "
                  f"spill stores, {f.get('spill_loads')} B spill loads")
            if dtype == "bf16" and (d == 128 or name == "epilogue_bwd_kernel"):
                if f.get("spill_stores") or f.get("spill_loads"):
                    fail(f"{name} <bf16, {d or 1024}> spills: {f}")
                regs[name] = f.get("registers")
    occupancy = {}
    for source, kernel, names in (
            ("attention_fwd", "attention_fwd_kernel", ("attention_fwd", "bi_attention_fwd")),
            ("attention_bwd", "attention_bwd_kernel", ("attention_bwd", "bi_attention_bwd"))):
        lib = _build.load(source)
        blocks, smem = {}, {}
        for table, query in ((blocks, lib[f"vln_{source}_blocks_per_sm"]),
                             (smem, lib[f"vln_{source}_smem_bytes"])):
            query.argtypes, query.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
            table.update({f"{'bf16' if bf else 'f32'} D={d}": query(d, bf)
                          for bf in (1, 0) for d in (128, 64)})
        print(f"  blocks per SM, {kernel}: {blocks}")
        print(f"  shared memory per block (B), {kernel}: {smem}")
        if blocks["bf16 D=128"] < 2:
            fail(f"{kernel} <bf16, 128>: {blocks['bf16 D=128']} block per SM, expected 2")
        for n in names:
            occupancy[n] = {"registers": regs.get(kernel),
                            "smem_bytes": smem["bf16 D=128"],
                            "blocks_per_sm": blocks["bf16 D=128"]}
    # B6: one wave of the resident blocks; the source note of epilogue.cu
    # states 2 blocks of 512 threads (32 warps) per SM in bf16
    layouts = {dt: E._bwd_layout(dt == "bf16", torch.cuda.current_device())
               for dt in ("bf16", "f32")}
    print(f"  layout, epilogue_bwd_kernel: {layouts}")
    lay = layouts["bf16"]
    warps = lay["blocks_per_sm"] * lay["threads"] // 32
    if lay["blocks_per_sm"] < B6_BLOCKS_PER_SM or warps < B6_WARPS_PER_SM:
        fail(f"epilogue_bwd_kernel <bf16>: {lay['blocks_per_sm']} blocks ({warps} warps) "
             f"per SM, the design states {B6_BLOCKS_PER_SM} ({B6_WARPS_PER_SM} warps)")
    occupancy["epilogue_bwd"] = {"registers": regs.get("epilogue_bwd_kernel"),
                                 "smem_bytes": lay["smem_bytes"],
                                 "blocks_per_sm": lay["blocks_per_sm"], "warps_per_sm": warps}
    return occupancy


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


def edge_checks(seed):
    """Phase 3b: B1-B4 against their plain versions at the edges of the
    kernels' tiling (64-row tiles, 16-row warp strips, 8-key n-tiles):
    B*H = 1, S_q and S_kv of 1, 17 and 65 (keys not a multiple of 8), D 64
    and 128, bf16 and f32, dropout 0 and 0.1.  Outputs at the TOL rule,
    row log-sum-exps at 1e-5; a call's gradients at the TOL rule over the
    largest of its gradients, since with one key dQ and dK are 0 in exact
    arithmetic and the kernels' Delta = rowsum(dO o O) rounds to O's type."""
    import torch
    from youtube_vln_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    drop_seed = 0xED6E + seed
    lengths = (1, 17, 65)
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype)[6:]]
        for d in (64, 128):
            for rate in (0.0, RATE):
                for s_q in lengths:
                    for s_kv in lengths:
                        tag = f"{str(dtype)[6:]} 1x1 {s_q}x{s_kv} D={d} rate {rate}"
                        q, do = (heads_view(gen, 1, 1, s_q, d, dtype) for _ in range(2))
                        k, v = (heads_view(gen, 1, 1, s_kv, d, dtype) for _ in range(2))
                        bias = key_bias(gen, 1, s_kv, masked_rows=())
                        out, lse, _ = A._attention_fwd(q, k, v, bias, rate, drop_seed, True)
                        check(f"edge B1 {tag}", out,
                              A.attention_reference(q, k, v, bias, rate, drop_seed), tol, verbose=False)
                        check(f"edge B1 lse {tag}", lse,
                              A.attention_lse_reference(q, k, bias), 1e-5, verbose=False)
                        got = A._attention_bwd(q, k, v, bias, out, do, lse, rate, drop_seed)
                        want = A.attention_bwd_reference(q, k, v, bias, do, rate, drop_seed)
                        floor = max(float(w.float().abs().max()) for w in want)
                        for name, g, w in zip("qkv", got, want):
                            check(f"edge B3 d{name} {tag}", g, w, tol, floor, verbose=False)
                        n += 1
                for s_v, s_t in ((65, 17), (17, 1), (1, 65)):
                    tag = f"{str(dtype)[6:]} 1x1 {s_t}<->{s_v} D={d} rate {rate}"
                    vis = [heads_view(gen, 1, 1, s_v, d, dtype) for _ in range(3)]
                    txt = [heads_view(gen, 1, 1, s_t, d, dtype) for _ in range(3)]
                    vb = key_bias(gen, 1, s_v, masked_rows=())
                    tb = key_bias(gen, 1, s_t, masked_rows=())
                    do1 = heads_view(gen, 1, 1, s_t, d, dtype)
                    do2 = heads_view(gen, 1, 1, s_v, d, dtype)
                    c1, c2, l1, l2, _ = A._bi_attention_fwd(*vis, *txt, vb, tb, rate, rate,
                                                            drop_seed, True)
                    w1, w2 = A.bi_attention_reference(*vis, *txt, vb, tb, rate, rate, drop_seed)
                    check(f"edge B2 ctx1 {tag}", c1, w1, tol, verbose=False)
                    check(f"edge B2 ctx2 {tag}", c2, w2, tol, verbose=False)
                    got = A._bi_attention_bwd(*vis, *txt, vb, tb, c1, c2, l1, l2, do1, do2,
                                              rate, rate, drop_seed)
                    want = A.bi_attention_bwd_reference(*vis, *txt, vb, tb, do1, do2, rate,
                                                        rate, drop_seed)
                    # one floor per direction: (dq2, dk1, dv1) and (dq1, dk2, dv2)
                    for names, idx in ((("q2", "k1", "v1"), (3, 1, 2)),
                                       (("q1", "k2", "v2"), (0, 4, 5))):
                        floor = max(float(want[i].float().abs().max()) for i in idx)
                        for name, i in zip(names, idx):
                            check(f"edge B4 d{name} {tag}", got[i], want[i], tol, floor, verbose=False)
                    n += 1
    print(f"edge checks: {n} calls of B1/B3 and B2/B4 at B*H = 1 held (each "
          f"check prints only on failure)")


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

    reset_counts()
    t0 = time.perf_counter()
    scores = eval_epoch(model, cfg, requests, device="cuda")
    t_dedup = time.perf_counter() - t0
    scores += eval_epoch(model, cfg, [dense], device="cuda")
    launches = counts()
    no_epilogue_launches(launches, "eval path")
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
    return launches, t_dedup * 1e3 / len(requests)


@contextlib.contextmanager
def timed_eval_epoch(times):
    """Appends the wall ms of every ``eval_epoch`` call of the test entry to
    ``times``: from the Loader's first item to the last score on the host,
    so host assembly, copies and scoring all count."""
    from youtube_vln_tpu_torch.entries import test as entry
    real = entry.eval_epoch

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    entry.eval_epoch = timed
    try:
        yield
    finally:
        entry.eval_epoch = real


def check_trajectories(results, other, scores, tol, what):
    """The two runs' trajectories are equal except where the top two
    scores of ``scores`` lie within ``tol`` of each other."""
    import numpy as np
    traj = {r["instr_id"]: r["trajectory"] for r in other}
    ties = 0
    for r in results:
        if r["trajectory"] != traj[r["instr_id"]]:
            top = np.sort(np.array(scores[r["instr_id"]]))[::-1]
            if top[0] - top[1] > tol:
                fail(f"{what}: trajectories differ at {r['instr_id']}, top-two "
                     f"gap {top[0] - top[1]:.3e} above {tol:.0e}")
            ties += 1
    print(f"check trajectories, {what}: {len(results) - ties} equal, {ties} "
          f"differ within a tie (tol {tol:.0e})")


def entry_path(seed, synthetic_ms, root):
    """Phase 4b: the user's own entry, ``entries.test.main``, on an R2R
    fixture at the flagship eval geometry (``build_r2r_fixture``: 15
    instructions of val_unseen x 30 beams x 8 steps x 100 boxes + the global
    row), with weights of ``lily_base_config`` from the seed saved as a
    reference-layout ``.bin``. Run A: bf16, step-dedup transport; B: the
    dense transport; C: f32 with the kernels; D: f32 with ``--no_pallas``.
    The fixture and the weights are written under ``root``, where phase 17
    reads them again.  Returns run A's launch counts and run A itself (the
    root, the fixture's paths, the split, SR and SPL)."""
    import numpy as np
    import torch
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.data import store
    from youtube_vln_tpu_torch.data.features_reader import PanoFeaturesReader
    from youtube_vln_tpu_torch.data.fixtures import build_r2r_fixture
    from youtube_vln_tpu_torch.entries import test as entry
    from youtube_vln_tpu_torch.evaluation.metrics import Evaluation
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.training.checkpoint import load_checkpoint
    from youtube_vln_tpu_torch.training.engine import (load_beam_dataset,
                                                       resolve_tokenizer)
    from youtube_vln_tpu_torch.utils.cli import parse_run_config

    split, n_instr = "val_unseen", 15
    t0 = time.perf_counter()
    paths = build_r2r_fixture(root, k_boxes=BOXES - 1, n_beams=NC, path_len=L,
                              seed=seed)
    store_mb = Path(paths["store_path"]).stat().st_size / 1e6
    print(f"R2R fixture: {split} {n_instr} instructions x {NC} beams x {L} "
          f"steps x {BOXES} boxes, pano store {store_mb:.1f} MB, built in "
          f"{time.perf_counter() - t0:.1f} s")
    if store.get_native() is None:
        fail("the native store library (native/libvlnstore.so) did not build: "
             "the step-dedup path needs its packer")
    weights = Path(root) / "lily_base_seed.bin"
    model = Lily(lily_base_config(), device="cuda").init_weights(seed)
    torch.save({"model_state_dict": model.state_dict()}, weights)
    missing, unexpected, _, _ = load_checkpoint(weights, model)
    if missing or unexpected:
        fail(f"weights file: missing {missing[:3]}, unexpected {unexpected[:3]}")
    del model
    torch.cuda.empty_cache()

    flags = ["--device", "cuda",
             "--config_file", str(REPO / "configs" / "bert_base_6_layer_6_connect.json"),
             "--data_dir", paths["data_dir"], "--img_feature", paths["store_path"],
             "--bert_tokenizer", paths["vocab_path"], "--from_pretrained", str(weights),
             "--output_dir", str(Path(root) / "result"), "--seed", str(seed)]
    runs = {"A": [], "B": ["--no_dedup_beam_steps"],
            "C": ["--compute_dtype", "float32"],
            "D": ["--compute_dtype", "float32", "--no_pallas"]}
    out = {}
    for name, extra in runs.items():
        times = []
        reset_counts()
        with timed_eval_epoch(times):
            results_path = entry.main(["--split", split] + flags + extra
                                      + ["--save_name", f"run{name}"])
        launches = counts()
        folder = Path(results_path).parent
        scores = dict(json.loads((folder / f"_scores_{split}.json").read_text()))
        results = json.loads(Path(results_path).read_text())
        out[name] = dict(launches=launches, scores=scores, results=results,
                         path=results_path, ms=times[0])

    # the items the entry scored, rebuilt for their beam masks and timed
    # on the host, one __getitem__ at a time
    _, args = parse_run_config(flags + ["--num_beams", "1", "--batch_size", "1",
                                        "--ranking"])
    host_ms = {}
    for transport, dedup in (("step_dedup", True), ("dense", False)):
        args.dedup_beam_steps = dedup
        reader = PanoFeaturesReader(args.img_feature)
        ds = load_beam_dataset(split, args, resolve_tokenizer(args), reader,
                               training=False)
        t0 = time.perf_counter()
        items = [ds[i] for i in range(len(ds))]
        host_ms[transport] = (time.perf_counter() - t0) * 1e3 / len(items)
        reader.close()
    opt = {f"{int(it['instr_id'][0])}_{int(it['instr_id'][1])}": it["opt_mask"]
           for it in items}
    evaluation = Evaluation([split], data_dir=paths["data_dir"])

    if len(opt) != n_instr:
        fail(f"entry: {len(opt)} instructions in {split}, expected {n_instr}")
    per_request = {"attention_fwd": lily_base_config().v_num_hidden_layers,
                   "bi_attention_fwd": len(lily_base_config().v_biattention_id)}
    for name, run in out.items():
        what = f"entry run {name} ({' '.join(runs[name]) or 'bf16, step-dedup'})"
        if {r["instr_id"] for r in run["results"]} != set(opt) or \
                set(run["scores"]) != set(opt):
            fail(f"{what}: results cover {len(run['results'])} of {n_instr} instructions")
        for iid, mask in opt.items():
            row = np.array(run["scores"][iid])
            if row.shape != mask.shape or not (np.isfinite(row[mask]).all()
                                               and np.isneginf(row[~mask]).all()):
                fail(f"{what}: scores of {iid} not finite at real beams and -inf "
                     f"at padded ones")
        want = {k: (n * n_instr if name != "D" else 0) for k, n in per_request.items()}
        got = {k: run["launches"][k] for k in want}
        others = {k: v for k, v in run["launches"].items() if k not in want and v}
        print(f"launches, {what}: {run['launches']}")
        if got != want or others:
            fail(f"{what}: launches {run['launches']}, expected {want} and no other")
        summary, _ = evaluation.score_items(run["results"])
        run["summary"] = summary
        if not summary["spl"] <= summary["success_rate"]:
            fail(f"{what}: SPL {summary['spl']} above SR {summary['success_rate']}")

    for a, b, tol, what in (("B", "A", 1e-3, "dense vs step-dedup transport, bf16"),
                            ("C", "D", 1e-4, "kernels vs --no_pallas, f32")):
        err = max(float(np.abs(np.array(out[a]["scores"][k])[opt[k]]
                               - np.array(out[b]["scores"][k])[opt[k]]).max())
                  for k in opt)
        print(f"check entry scores, {what}: max_abs_err {err:.3e} (tol {tol:.0e})")
        if not err <= tol:
            fail(f"entry scores, {what}: {err} above {tol}")
        check_trajectories(out[a]["results"], out[b]["results"], out[b]["scores"],
                           tol, what)

    n_beams = int(sum(m.sum() for m in opt.values()))
    print(json.dumps({
        "entry_path": "python -m youtube_vln_tpu_torch.entries.test --split "
                      "val_unseen, lily_base_config, R2R fixture at flagship geometry",
        "requests": n_instr, "beams": n_beams,
        "sr": {k: r["summary"]["success_rate"] for k, r in out.items()},
        "spl": {k: r["summary"]["spl"] for k, r in out.items()},
        "ms_per_request": {k: r["ms"] / n_instr for k, r in out.items()},
        "beams_per_s": {k: n_beams / r["ms"] * 1e3 for k, r in out.items()},
        "host_ms_per_item": host_ms,
        "store_reader": "native" if store.get_native() is not None else "numpy",
        "synthetic_ms_per_request": synthetic_ms,
        "runs": {k: " ".join(v) or "bf16, step-dedup" for k, v in runs.items()}}))
    run_a = dict(root=root, paths=paths, split=split,
                 sr=out["A"]["summary"]["success_rate"], spl=out["A"]["summary"]["spl"])
    return out["A"]["launches"], run_a


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
    # user annotations (the optimizer's step range) carry the device time
    # of the kernels inside them: counting both would count those twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    groups = {"attention kernels B1-B4": ("attention_fwd_kernel",
                                          "attention_bwd_kernel",
                                          "delta_kernel"),
              "epilogue kernels B5/B6": ("epilogue_fwd_kernel",
                                         "epilogue_bwd_kernel",
                                         "column_sum_kernel"),
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    # the kernel's name only labels the row; its time comes from the events
    busiest = (max(kernels, key=lambda e: e.self_device_time_total).key[:80]
               if kernels else "kernel name not traced")
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = [step(batches[i % len(batches)], next_seed()) for i in range(n)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    return ms, torch.cuda.max_memory_allocated(), counts(), metrics


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
    no_epilogue_launches(launches, "train path")
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


def epilogue_kernel_checks(seed):
    """Phase 9: B5/B6 against their plain versions (same Philox masks), B6
    launched twice bitwise equal; returns the numbers of the kernels line at
    the pretraining shape."""
    import torch
    import torch.nn.functional as F
    from youtube_vln_tpu_torch.ops import epilogue as E

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    bf16, f32 = torch.bfloat16, torch.float32
    drop_seed = 0xE91 + seed
    n_main = PRE_B * PRE_NC * L * BOXES            # 45,248 vision rows
    rows = {}
    cases = [(dtype, n, d, rate) for n, d in ((n_main, 1024), (5760, 768), (1001, 1024))
             for dtype in (bf16, f32) for rate in (RATE, 0.0)]
    for dtype, n, d, rate in cases:
        tag = f"{dtype} {n}x{d} rate {rate}"
        h, res, do = (torch.randn(n, d, generator=gen, device="cuda").to(dtype)
                      for _ in range(3))
        w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = 0.1 * torch.randn(d, generator=gen, device="cuda")
        # bf16 by the TOL rule; f32 1e-4 x max |plain|
        tol = TOL["bfloat16"] if dtype == bf16 else 1e-4
        floor = 1.0 if dtype == bf16 else 0.0
        out, ops = E._epilogue_fwd(h, res, w, b, rate, drop_seed)
        err_f = check(f"B5 epilogue_fwd {tag}", out,
                      E.epilogue_reference(h, res, w, b, rate, drop_seed), tol, floor)
        got = E._epilogue_bwd(*ops, do, rate, drop_seed)
        want = E.epilogue_bwd_reference(h, res, w, do, rate, drop_seed)
        err_b = max(check(f"B6 epilogue_bwd d{name} {tag}", g, r, tol, 0.0)
                    for name, g, r in zip(("h", "res", "w", "b"), got, want))
        if rate > 0.0:
            keep = E._keep(h, rate, drop_seed, 0)
            if not bool((got[0][~keep] == 0).all()):
                fail(f"B6 {tag}: dh is not 0 where B5 dropped")
        again = E._epilogue_bwd(*ops, do, rate, drop_seed)
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            fail(f"B6 {tag}: a second launch on the same inputs differs")
        if (dtype, rate) != (bf16, RATE) or n != n_main:
            continue
        # the main path's shape: time B5/B6, the plain versions and the
        # library's LayerNorm (no dropout: F.layer_norm of the summed input,
        # and its backward as the one ATen call autograd makes, so that no
        # autograd host work stands between the launches)
        y = h + res
        wl, bl = w.to(dtype), b.to(dtype)
        fwd_bound = bound_ms(10 * n * d, nbytes(h, res, out, w, b), PEAK_F32_FLOPS)
        bwd_bound = bound_ms(20 * n * d, nbytes(h, res, do, w, *got), PEAK_F32_FLOPS)
        _, mean, rstd = torch.ops.aten.native_layer_norm(y, (d,), wl, bl, 1e-12)
        rows["epilogue_fwd"] = dict(
            name="epilogue_fwd", route="cuda",
            source="youtube_vln_tpu_torch/ops/csrc/epilogue.cu",
            replaces="youtube_vln_tpu/ops/epilogue.py:43", max_abs_err=err_f,
            ms=cuda_ms(lambda: E._epilogue_fwd(h, res, w, b, rate, drop_seed)),
            plain_ms=cuda_ms(lambda: E.epilogue_reference(h, res, w, b, rate,
                                                          drop_seed), iters=5),
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
            library_ms=cuda_ms(lambda: F.layer_norm(y, (d,), wl, bl, 1e-12)),
            library="F.layer_norm of h + res (LN only, no dropout), bf16 weights",
            shape=f"[{n}, {d}] bf16, dropout {rate}")
        rows["epilogue_bwd"] = dict(
            name="epilogue_bwd", route="cuda",
            source="youtube_vln_tpu_torch/ops/csrc/epilogue.cu",
            replaces="youtube_vln_tpu/ops/epilogue.py:61", max_abs_err=err_b,
            ms=cuda_ms(lambda: E._epilogue_bwd(*ops, do, rate, drop_seed)),
            plain_ms=cuda_ms(lambda: E.epilogue_bwd_reference(h, res, w, do, rate,
                                                              drop_seed), iters=5),
            bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
            library_ms=cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                do, y, (d,), mean, rstd, wl, bl, (True, True, True))),
            library="aten native_layer_norm_backward of that F.layer_norm (LN only, "
                    "no dropout): dx, dw, db",
            shape=f"[{n}, {d}] bf16, dropout {rate}")
        del y, mean, rstd
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def plain_launchers():
    """Every kernel site on its kernel's plain version: the launchers of
    B1-B6 in ops/attention.py and ops/epilogue.py replaced, for CUDA
    tensors, by the plain versions (same Philox masks).  Nothing launches,
    so the launch counts stay 0."""
    from youtube_vln_tpu_torch.entries.check_kernels import PLAIN_TWINS
    from youtube_vln_tpu_torch.ops import attention as A
    from youtube_vln_tpu_torch.ops import epilogue as E

    def epilogue_fwd(h, res, weight, bias, rate, seed, row0=0):
        d = h.shape[-1]
        h, res = h.reshape(-1, d), res.reshape(-1, d)
        return (E.epilogue_reference(h, res, weight, bias, rate, seed, row0),
                (h, res, weight))

    def epilogue_bwd(h, res, weight, do, rate, seed, row0=0):
        return E.epilogue_bwd_reference(h, res, weight, do.reshape(h.shape), rate, seed,
                                        row0)

    patched = [(A, f"_{name}", twin) for name, twin in PLAIN_TWINS.items()]
    patched += [(E, "_epilogue_fwd", epilogue_fwd), (E, "_epilogue_bwd", epilogue_bwd)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    try:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_pretrain_launches(cfg, launches, micro, what):
    """Per micro-step: 6 launches each of B1-B4 and, with the epilogue knob
    on, one of B5 and B6 at each vision-stream site (the self-attention and
    feed-forward outputs of every vision layer, the vision side of every
    co-attention output and of every connection feed-forward: 24)."""
    check_launches(cfg, launches, micro, what)
    per = 2 * cfg.v_num_hidden_layers + 2 * len(cfg.v_biattention_id)
    if not cfg.use_epilogue_kernels:
        per = 0
    for name in ("epilogue_fwd", "epilogue_bwd"):
        if launches[name] != per * micro:
            fail(f"{what}: {name} launched {launches[name]} times, expected "
                 f"{per} x {micro}")


# the YTb fixture's geometry: the flagship's (scripts/bench_e2e.py:62-67)
PRE_GEOMETRY = dict(max_instruction_length=S_T, max_path_length=L,
                    max_num_boxes=BOXES, min_path_length=4, min_captioned=2,
                    max_captioned=7, sparse_vision_targets=True,
                    dedup_candidates=True)


def pretrain_args(paths, seed):
    """The run configuration of the pretraining recipe on the YTb fixture."""
    from youtube_vln_tpu_torch.config import RunConfig
    args = RunConfig(pretrain=True, pre_dataset="ytb", ranking=True,
                     traj_judge=True, masked_vision=True, masked_language=True,
                     batch_size=PRE_B, learning_rate=2e-5, num_workers=0,
                     num_negatives=2, skeleton_path=paths["skeleton_path"],
                     seed=seed, **PRE_GEOMETRY)
    args.validate()
    return args


def pretrain_fixture(root, seed):
    """The YTb fixture at flagship geometry and the run configuration of
    the pretraining recipe."""
    from youtube_vln_tpu_torch.data import fixtures
    t0 = time.perf_counter()
    paths = fixtures.build_ytb_fixture(root, n_videos=PRE_VIDEOS,
                                       frames_per_video=PRE_FRAMES,
                                       k_boxes=BOXES, seed=seed,
                                       args_overrides=PRE_GEOMETRY)
    build_s = time.perf_counter() - t0
    args = pretrain_args(paths, seed)
    store_bytes = Path(paths["store_path"]).stat().st_size
    print(f"pretraining fixture: {PRE_VIDEOS} videos x {PRE_FRAMES} frames x "
          f"{BOXES} boxes, store {store_bytes / 1e9:.3f} GB, built in {build_s:.1f} s")
    return paths, args


def pretrain_path(seed):
    """Phases 10-12: the pretraining step fed by the port's YTbDataset and
    Loader; returns the launch counts of the first 5 timed steps with the
    epilogue knob on."""
    import numpy as np
    import torch
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.data import store
    from youtube_vln_tpu_torch.data.datasets import YTbDataset
    from youtube_vln_tpu_torch.data.features_reader import YTbFeaturesReader
    from youtube_vln_tpu_torch.data.loader import Loader
    from youtube_vln_tpu_torch.data.tokenizer import load_tokenizer
    from youtube_vln_tpu_torch.device import to_device
    from youtube_vln_tpu_torch.evaluation.beam_eval import prefetch_to_device
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.parallel.train_step import (build_train_step,
                                                           create_train_state)

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="ytb_fixture_") as root:
        paths, args = pretrain_fixture(root, seed)
        reader = YTbFeaturesReader(paths["store_path"])
        native = store.get_native() is not None
        print(f"store reader: {'native (native/libvlnstore.so, C path packers)' if native else 'numpy (no native library)'}")
        ds = YTbDataset(args=args, caption_path=paths["caption_path"],
                        tokenizer=load_tokenizer(paths["vocab_path"]),
                        features_reader=reader, masked_vision=True,
                        masked_language=True, training=True, seed=seed)
        if ds.num_candidates() != PRE_NC:
            fail(f"pretraining: {ds.num_candidates()} candidates, expected {PRE_NC}")
        # one process: the batches below are few, and CUDA is already up
        loader = Loader(ds, PRE_B, shuffle=True, seed=seed, num_workers=0,
                        drop_last=True)
        t0 = time.perf_counter()
        host_batches = list(loader)
        host_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)
        batch_bytes = sum(v.nbytes for v in host_batches[0].values())
        print(f"loader: {len(host_batches)} batches of {PRE_B} x {PRE_NC}, "
              f"{host_ms:.1f} ms per batch on the host, {batch_bytes / 1e6:.1f} MB")

        cfg = lily_base_config(ranking=True, traj_judge=True, masked_vision=True,
                               masked_language=True, compute_dtype="bfloat16",
                               use_epilogue_kernels=True)
        model = Lily(cfg, device="cuda").init_weights(seed)
        optimizer, _ = create_train_state(model, args, steps_per_epoch=1000)
        step = build_train_step(model, cfg, args, optimizer, device="cuda")
        batches = [to_device(b, dev) for b in host_batches[:2]]
        seeds = torch.Generator().manual_seed(seed + 7)

        def next_seed():
            return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=seeds))

        print(f"pretrain model: lily_base_config, four tasks, bf16, AdamWRef lr "
              f"{args.learning_rate}, batch {PRE_B} x {PRE_NC} x ({S_T} + {L * BOXES})")
        before = [p.detach().clone() for p in model.parameters()]
        warm = [step(batches[i % 2], next_seed()) for i in range(WARMUP_STEPS)]
        runs = []
        for knob in (True, False, False, True):
            cfg.use_epilogue_kernels = knob
            ms, peak, launches, timed = run_steps(step, batches, PRE_TIMED, next_seed)
            check_pretrain_launches(cfg, launches, PRE_TIMED,
                                    f"pretraining path, epilogue knob {'on' if knob else 'off'}")
            runs.append((knob, ms, peak, launches, timed))
        cfg.use_epilogue_kernels = True
        losses = {k: [float(m[k]) for m in warm + [m for r in runs for m in r[4]]]
                  for k in ("loss/train", "loss/language", "loss/vision",
                            "loss/ranking", "loss/traj")}
        if not all(np.isfinite(v).all() for v in losses.values()):
            fail(f"pretraining path: non-finite loss {losses}")
        moved = sum(int(not torch.equal(a, p.detach()))
                    for a, p in zip(before, model.parameters()))
        print(f"pretraining parameters moved: {moved} of {len(before)} tensors")
        if moved == 0:
            fail("pretraining path: no parameter moved")
        del before

        # three steps fed straight from the Loader (epochs 1 and 2): the
        # host assembles the next batch while the device runs a step; every
        # epoch is read to its end, so no producer is left mid-item
        torch.cuda.synchronize()
        wait_ms, fed, fed_ms, t0 = [], [], None, time.perf_counter()
        for epoch in (1, 2):
            loader.set_epoch(epoch)
            it = prefetch_to_device(loader, dev)
            while True:
                t1 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                if len(fed) < 3:
                    wait_ms.append((time.perf_counter() - t1) * 1e3)
                    fed.append(step(batch, next_seed()))
                    if len(fed) == 3:
                        torch.cuda.synchronize()
                        fed_ms = (time.perf_counter() - t0) * 1e3 / 3
        if len(fed) != 3 or not all(np.isfinite(float(m["loss/train"])) for m in fed):
            fail(f"pretraining path fed by the Loader: {len(fed)} steps, losses "
                 f"{[float(m['loss/train']) for m in fed]}")

        on = [r for r in runs if r[0]]
        off = [r for r in runs if not r[0]]
        flops = model_flops_per_traj(cfg, S_T, L * BOXES) * PRE_B * PRE_NC
        print(json.dumps({
            "pretrain_path": "YTbDataset -> Loader -> build_train_step, MLM + MVM "
                             "+ ranking + traj_judge, bf16, flagship width and depth",
            "store_reader": "native" if native else "numpy",
            "steps_per_run": PRE_TIMED, "run_order": ["on", "off", "off", "on"],
            "ms_per_step_knob_on": [r[1] for r in on],
            "ms_per_step_knob_off": [r[1] for r in off],
            "peak_memory_gib_knob_on": [r[2] / 2 ** 30 for r in on],
            "peak_memory_gib_knob_off": [r[2] / 2 ** 30 for r in off],
            "trajectories_per_s_knob_on": PRE_B * PRE_NC / statistics.mean(
                r[1] for r in on) * 1e3,
            "trajectories_per_s_knob_off": PRE_B * PRE_NC / statistics.mean(
                r[1] for r in off) * 1e3,
            "step_flops": flops, "step_bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
            "host_ms_per_batch": host_ms, "host_batch_bytes": batch_bytes,
            "loader_fed_ms_per_step": fed_ms, "loader_wait_ms": wait_ms,
            "losses": losses}))

        for knob in (True, False):
            cfg.use_epilogue_kernels = knob
            print(json.dumps(device_breakdown(
                lambda: step(batches[0], next_seed()),
                f"traced_pretrain_step_knob_{'on' if knob else 'off'}")))
        cfg.use_epilogue_kernels = True
        pretrain_gradient_check(model, cfg, args,
                                {k: v[:1] for k, v in host_batches[0].items()})
        reader.close()
    del model, optimizer, step, batches
    torch.cuda.empty_cache()
    return runs[0][3]


def pretrain_gradient_check(model, cfg, args, batch):
    """Phase 11: gradients of one pretraining step at batch 1 x 7 (every
    vision epilogue site holds 7 x 808 x 1024 elements, so the sites
    qualify) on the kernel path against the plain path."""
    import torch
    from youtube_vln_tpu_torch.device import to_device
    from youtube_vln_tpu_torch.parallel.train_step import _task_config, loss_fn

    batch = to_device(batch, torch.device("cuda"))
    tasks = _task_config(args, True)
    params = [p for p in model.parameters() if p.requires_grad]
    drop_seed = 0xD50 + 3

    def grads(kernels, dtype, dropout):
        cfg.compute_dtype = dtype
        model.train(dropout)
        reset_counts()
        try:
            with contextlib.nullcontext() if kernels else plain_launchers():
                loss = loss_fn(model, batch, tasks, drop_seed)[0]
                g = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            cfg.compute_dtype = "bfloat16"
        what = (f"pretraining gradient check ({'kernel' if kernels else 'plain'} "
                f"path, {dtype}, dropout {'on' if dropout else 'off'})")
        launches = counts()
        if kernels:
            # eval mode runs no epilogue site: it needs train mode and a rate
            cfg.use_epilogue_kernels = dropout
            try:
                check_pretrain_launches(cfg, launches, 1, what)
            finally:
                cfg.use_epilogue_kernels = True
        elif any(launches.values()):
            fail(f"{what}: kernels launched: {launches}")
        return [torch.zeros_like(p) if x is None else x.float()
                for p, x in zip(params, g)]

    def rel_l2(a, b):
        num = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
        den = sum(float((y ** 2).sum()) for y in b)
        return (num / den) ** 0.5

    for dropout in (False, True):
        err = rel_l2(grads(True, "float32", dropout), grads(False, "float32", dropout))
        print(f"check pretraining gradients, kernel vs plain path, f32, dropout "
              f"{'on' if dropout else 'off'}: relative L2 {err:.3e} (tol 1e-3)")
        if not err <= 1e-3:
            fail("pretraining gradients: kernel and plain paths disagree")
    for dropout in (False, True):
        exact = grads(False, "float32", dropout)
        k_err = rel_l2(grads(True, "bfloat16", dropout), exact)
        p_err = rel_l2(grads(False, "bfloat16", dropout), exact)
        print(f"check pretraining gradients in bf16 against f32, dropout "
              f"{'on' if dropout else 'off'}: kernel path {k_err:.3e}, plain path "
              f"{p_err:.3e} (tol 2 x plain)")
        if not k_err <= 2 * p_err:
            fail("pretraining gradients: the kernel path's bf16 error exceeds "
                 "twice the plain path's")
    model.train()


@contextlib.contextmanager
def instrumented_entries(rec):
    """While open, the training entries report into ``rec``: every
    ``Engine`` built (``engines``), every train step (``steps``: host ms
    from the call to its losses on the host, the gap since the previous
    step, the optimizer's ``step_count`` before it and the lr it takes,
    the losses and the peak device memory so far), every training epoch
    (``epochs``: seconds, the Loader's start included), every checkpoint
    saved (``saves``: seconds and bytes, a ``.dcp`` directory's files
    summed) and loaded (``loads``: seconds), every split evaluated
    (``evals``: name and ms, the readback included) and every model
    wrapped in DistributedDataParallel (``ddp``)."""
    import torch
    from youtube_vln_tpu_torch.parallel import train_step as ts
    from youtube_vln_tpu_torch.training import checkpoint as ck
    from youtube_vln_tpu_torch.training.engine import Engine
    real = (ts.build_train_step, ck.save_checkpoint, ck.load_checkpoint,
            Engine.evaluate, Engine.__init__, Engine.train_epoch, ck.save_dcp,
            ts.data_parallel)
    build, save, load, evaluate, init, train_epoch, save_dcp, data_parallel = real

    def build_recorded(model, cfg, args, optimizer, device="cuda"):
        step = build(model, cfg, args, optimizer, device=device)

        def recorded(batch, seed):
            t0 = time.perf_counter()
            before = optimizer.step_count
            metrics = step(batch, seed)
            losses = {k: float(v) for k, v in metrics.items() if k.startswith("loss/")}
            t1 = time.perf_counter()
            gap = (t0 - rec["last_end"]) * 1e3 if rec["last_end"] else None
            rec["last_end"] = t1
            rec["steps"].append(dict(ms=(t1 - t0) * 1e3, gap_ms=gap,
                                     step_count=before,
                                     lr=optimizer.schedule(before), losses=losses,
                                     peak=torch.cuda.max_memory_allocated()))
            return metrics
        return recorded

    def save_recorded(*a, **k):
        t0 = time.perf_counter()
        path = save(*a, **k)
        # a model rank above 0 gathers and writes nothing
        rec["saves"].append(dict(s=time.perf_counter() - t0, name=Path(path).name,
                                 bytes=Path(path).stat().st_size if Path(path).exists()
                                 else None))
        return path

    def save_dcp_recorded(*a, **k):
        t0 = time.perf_counter()
        path = save_dcp(*a, **k)
        files = {f.name: f.stat().st_size for f in Path(path).iterdir()}
        rec["saves"].append(dict(s=time.perf_counter() - t0, name=Path(path).name,
                                 bytes=sum(files.values()), files=files))
        return path

    def data_parallel_recorded(model, device):
        rec["ddp"].append(str(device))
        return data_parallel(model, device)

    def load_recorded(*a, **k):
        t0 = time.perf_counter()
        out = load(*a, **k)
        rec["loads"].append(time.perf_counter() - t0)
        return out

    def evaluate_recorded(self, name, epoch=0):
        t0 = time.perf_counter()
        out = evaluate(self, name, epoch)
        rec["evals"].append(dict(name=name, ms=(time.perf_counter() - t0) * 1e3,
                                 out=out))
        return out

    def init_recorded(self, *a, **k):
        init(self, *a, **k)
        rec["engines"].append(self)

    def train_epoch_recorded(self, epoch):
        t0 = time.perf_counter()
        train_epoch(self, epoch)
        torch.cuda.synchronize()
        rec["epochs"].append(time.perf_counter() - t0)

    ts.build_train_step, ck.save_checkpoint, ck.load_checkpoint = (
        build_recorded, save_recorded, load_recorded)
    Engine.evaluate, Engine.__init__, Engine.train_epoch = (
        evaluate_recorded, init_recorded, train_epoch_recorded)
    ck.save_dcp, ts.data_parallel = save_dcp_recorded, data_parallel_recorded
    try:
        yield
    finally:
        (ts.build_train_step, ck.save_checkpoint, ck.load_checkpoint,
         Engine.evaluate, Engine.__init__, Engine.train_epoch, ck.save_dcp,
         ts.data_parallel) = real


def run_entry(main, argv):
    """One run of a training entry with the launch counts and the peak
    memory reset just before it: (returned value, launch counts, record)."""
    import torch
    rec = dict(engines=[], steps=[], epochs=[], saves=[], loads=[], evals=[],
               ddp=[], last_end=None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with instrumented_entries(rec):
        out = main(argv)
    torch.cuda.synchronize()
    launches = counts()
    rec["wall_s"] = time.perf_counter() - t0
    return out, launches, rec


def check_entry_run(what, rec, launches, cfg, n_eval_batches, per_micro=(1, 1)):
    """Fatal: finite losses, and per micro-step ``per_micro`` x (6, 6) launches
    of B1/B2 (2 with remat: the recompute), 6 of B3/B4, plus 6 + 6 of B1/B2
    per eval batch, none of B5/B6."""
    import numpy as np
    engine = rec["engines"][0]
    micro = len(rec["steps"]) * engine.args.gradient_accumulation_steps
    losses = [s["losses"] for s in rec["steps"]]
    print(f"{what}: {len(rec['steps'])} steps, losses {losses}")
    if not rec["steps"] or not all(np.isfinite(list(l.values())).all() for l in losses):
        fail(f"{what}: no step or a non-finite loss: {losses}")
    fwd = per_micro[0] * micro + n_eval_batches
    want = {"attention_fwd": cfg.v_num_hidden_layers * fwd,
            "bi_attention_fwd": len(cfg.v_biattention_id) * fwd,
            "attention_bwd": cfg.v_num_hidden_layers * micro,
            "bi_attention_bwd": len(cfg.v_biattention_id) * micro,
            "epilogue_fwd": 0, "epilogue_bwd": 0}
    print(f"launches, {what}: {launches}")
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")


def median_step_ms(rec):
    return statistics.median(s["ms"] for s in rec["steps"][1:])


def train_entry_path(seed):
    """Phase 13: the training entries at full width and depth, as a user
    runs them: ``entries.train.main`` (recipe 30RS) on an R2R fixture of 48
    instructions per split, its ``--resume`` from the epoch-0 checkpoint, a
    run with ``--remat --profile_dir``, and ``entries.pretrain.main`` (the
    MRT recipe, 3 Loader workers) on the YTb fixture of phase 10; then
    phases 14 (``ddp_path``) and 15 (``tp_path``) on the same fixtures.
    Returns the launch counts of the 30RS run, of the pretraining run and
    of phases 14 and 15."""
    import numpy as np
    import torch
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.data.fixtures import build_r2r_fixture
    from youtube_vln_tpu_torch.entries import pretrain as pretrain_entry
    from youtube_vln_tpu_torch.entries import train as train_entry
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

    cfg = lily_base_config()
    with tempfile.TemporaryDirectory(prefix="train_entry_") as root:
        root = Path(root)
        t0 = time.perf_counter()
        r2r = build_r2r_fixture(root / "r2r", k_boxes=BOXES - 1, n_beams=NC,
                                path_len=L, n_paths=16, seed=seed)
        weights = root / "lily_base_seed.bin"
        model = Lily(cfg, device="cuda").init_weights(seed)
        save_checkpoint(root, "lily_base_seed", model, cfg)
        del model
        torch.cuda.empty_cache()
        print(f"train entry: R2R fixture of 48 instructions per split x {NC} beams, "
              f"seed weights saved, in {time.perf_counter() - t0:.1f} s")

        common = ["--device", "cuda",
                  "--config_file", str(REPO / "configs" / "bert_base_6_layer_6_connect.json"),
                  "--from_pretrained", str(weights), "--seed", str(seed),
                  "--output_dir", str(root / "result")]
        recipe = common + ["--data_dir", r2r["data_dir"], "--img_feature", r2r["store_path"],
                           "--bert_tokenizer", r2r["vocab_path"], "--ranking",
                           "--shuffle_visual_features", "--batch_size", str(TRAIN_B)]

        # A: recipe 30RS, one epoch, a save after it
        (best_seen, best_unseen), launches_a, rec_a = run_entry(
            train_entry.main, recipe + ["--num_epochs", "1", "--save_epochs", "1",
                                        "--save_name", "ft"])
        engine = rec_a["engines"][0]
        n_steps = len(engine.train_loader)
        n_eval = sum(len(engine.eval_loaders[s]) for s in ("val_seen", "val_unseen"))
        check_entry_run("train entry (30RS)", rec_a, launches_a, cfg, n_eval)
        if len(rec_a["steps"]) != n_steps or n_steps != 3:
            fail(f"train entry: {len(rec_a['steps'])} steps, expected 3 (48 / 16)")
        for v in (best_seen, best_unseen):
            if not 0.0 <= v <= 1.0:
                fail(f"train entry: accuracy {v} outside [0, 1]")
        data = root / "result" / "ft" / "data"
        names = sorted(p.name for p in data.glob("*.bin"))
        if names != ["0.bin", "best_seen.bin", "best_unseen.bin"]:
            fail(f"train entry: checkpoints {names}")
        for name in names:
            t1 = time.perf_counter()
            missing, unexpected, step, epoch = load_checkpoint(
                data / name, engine.model, engine.optimizer)
            load_s = time.perf_counter() - t1
            print(f"train entry checkpoint {name}: step {step}, epoch {epoch}, "
                  f"step_count {engine.optimizer.step_count}, loaded in {load_s:.2f} s")
            if missing or unexpected or (step, epoch) != (3, 0) or \
                    engine.optimizer.step_count != 3:
                fail(f"{name}: missing {missing[:3]}, unexpected {unexpected[:3]}, "
                     f"step {step}, epoch {epoch}, step_count "
                     f"{engine.optimizer.step_count}")
        del engine
        rec_a["engines"].clear()
        torch.cuda.empty_cache()

        # B: --resume from the epoch-0 checkpoint: only epoch 1 runs
        _, launches_b, rec_b = run_entry(
            train_entry.main, recipe + ["--num_epochs", "2", "--save_epochs", "1",
                                        "--skip_val", "--save_name", "ft_resume",
                                        "--from_pretrained", str(data / "0.bin"),
                                        "--resume"])
        engine = rec_b["engines"][0]
        check_entry_run("train entry, --resume", rec_b, launches_b, cfg, 0)
        first = rec_b["steps"][0]
        print(f"resume: start epoch {engine.start_epoch}, step_count "
              f"{[s['step_count'] for s in rec_b['steps']]} -> "
              f"{engine.optimizer.step_count}, first lr {first['lr']:.6e}, "
              f"schedule(3) {engine.schedule(3):.6e}")
        if (engine.start_epoch != 1 or len(rec_b["steps"]) != 3
                or first["step_count"] != 3 or engine.optimizer.step_count != 6
                or first["lr"] != engine.schedule(3)):
            fail("train entry, --resume: not epoch 1 alone from step_count 3 at "
                 "schedule(3) to 6")
        del engine
        rec_b["engines"].clear()
        shutil.rmtree(root / "result" / "ft")
        shutil.rmtree(root / "result" / "ft_resume")
        torch.cuda.empty_cache()

        # C: the same run as A with --remat and a profiler trace
        trace_dir = root / "traces"
        _, launches_c, rec_c = run_entry(
            train_entry.main, recipe + ["--num_epochs", "1", "--skip_val", "--remat",
                                        "--profile_dir", str(trace_dir),
                                        "--save_name", "ft_remat"])
        check_entry_run("train entry, --remat", rec_c, launches_c, cfg, 0, (2, 1))
        loss_a = rec_a["steps"][0]["losses"]["loss/train"]
        loss_c = rec_c["steps"][0]["losses"]["loss/train"]
        peak_a = max(s["peak"] for s in rec_a["steps"])
        peak_c = max(s["peak"] for s in rec_c["steps"])
        traces = sorted(trace_dir.glob("*.pt.trace.json*"))
        print(f"remat: first-step loss {loss_c!r} against {loss_a!r}; peak "
              f"{peak_c / 2 ** 30:.2f} GiB against {peak_a / 2 ** 30:.2f}; traces "
              f"{[(t.name, t.stat().st_size) for t in traces]}")
        if abs(loss_c - loss_a) > 1e-6 * abs(loss_a):
            fail("--remat changed the first step's loss")
        if not peak_c < peak_a:
            fail("--remat did not lower the peak device memory")
        if not traces:
            fail("--profile_dir wrote no trace")
        rec_c["engines"].clear()
        shutil.rmtree(root / "result" / "ft_remat")
        torch.cuda.empty_cache()

        # D: the MRT recipe through the pretraining entry, 3 Loader workers
        data_dir = root / "ytb_data"
        pre_paths, _ = pretrain_fixture(data_dir / "YouTube-VLN" / "ytb", seed)
        best, launches_d, rec_d = run_entry(
            pretrain_entry.main,
            common + ["--pre_dataset", "ytb", "--prefix", "merge+", "--masked_vision",
                      "--masked_language", "--ranking", "--traj_judge",
                      "--batch_size", str(PRE_B), "--learning_rate", "2e-5",
                      "--num_epochs", "1", "--data_dir", str(data_dir),
                      "--ytb_feature", pre_paths["store_path"],
                      "--skeleton_path", pre_paths["skeleton_path"],
                      "--bert_tokenizer", pre_paths["vocab_path"],
                      "--save_name", "mrt"])
        engine = rec_d["engines"][0]
        if engine.args.num_workers != 3:
            fail(f"pretrain entry: {engine.args.num_workers} Loader workers, expected 3")
        check_entry_run("pretrain entry (MRT)", rec_d, launches_d, cfg,
                        len(engine.eval_loaders["test"]))
        names = sorted(p.name for p in (root / "result" / "mrt" / "data").glob("*.bin"))
        if not {"best_ranking.bin", "best_traj.bin"} <= set(names):
            fail(f"pretrain entry: checkpoints {names}")
        print(f"pretrain entry: best {best}, checkpoints {names}")
        if sorted(best) != ["ranking", "traj"] or not all(
                0.0 <= v <= 1.0 for v in best.values()):
            fail(f"pretrain entry: best accuracies {best}")
        rec_d["engines"].clear()
        del engine
        shutil.rmtree(root / "result" / "mrt")
        torch.cuda.empty_cache()
        with phase_timer("14 ddp"):
            launches_ddp = ddp_path(seed, root, recipe, pre_paths, median_step_ms(rec_a))
        with phase_timer("15 tp"):
            launches_tp = tp_path(seed, root, common, pre_paths, data_dir)

    saves = rec_a["saves"] + rec_b["saves"] + rec_c["saves"] + rec_d["saves"]
    print(json.dumps({
        "train_entry": "python -m youtube_vln_tpu_torch.entries.train (30RS: --ranking "
                       "--shuffle_visual_features --batch_size 16) and "
                       ".entries.pretrain (MRT, 3 workers), lily_base_config, bf16",
        "steps": {k: len(r["steps"]) for k, r in
                  (("train", rec_a), ("resume", rec_b), ("remat", rec_c), ("pretrain", rec_d))},
        "ms_per_step": {"train": median_step_ms(rec_a), "resume": median_step_ms(rec_b),
                        "remat": median_step_ms(rec_c), "pretrain": median_step_ms(rec_d)},
        "step_ms": {k: [s["ms"] for s in r["steps"]] for k, r in
                    (("train", rec_a), ("resume", rec_b), ("remat", rec_c), ("pretrain", rec_d))},
        "loader_gap_ms": {k: [s["gap_ms"] for s in r["steps"][1:]] for k, r in
                          (("train", rec_a), ("pretrain", rec_d))},
        "epoch_s": {k: r["epochs"] for k, r in
                    (("train", rec_a), ("resume", rec_b), ("remat", rec_c), ("pretrain", rec_d))},
        "trajectories_per_s": {"train": TRAIN_B * TRAIN_NC / median_step_ms(rec_a) * 1e3,
                               "pretrain": PRE_B * PRE_NC / median_step_ms(rec_d) * 1e3},
        "peak_memory_gib": {"train": peak_a / 2 ** 30, "remat": peak_c / 2 ** 30,
                            "pretrain": max(s["peak"] for s in rec_d["steps"]) / 2 ** 30},
        "save_s": [s["s"] for s in saves], "save_bytes": [s["bytes"] for s in saves],
        "load_s": {"train": rec_a["loads"], "resume": rec_b["loads"],
                   "pretrain": rec_d["loads"]},
        "eval_ms": {f"{k}/{e['name']}": e["ms"] for k, r in (("train", rec_a), ("pretrain", rec_d))
                    for e in r["evals"]},
        "eval": {f"{k}/{e['name']}": e["out"] for k, r in (("train", rec_a), ("pretrain", rec_d))
                 for e in r["evals"]},
        "wall_s": {k: r["wall_s"] for k, r in
                   (("train", rec_a), ("resume", rec_b), ("remat", rec_c), ("pretrain", rec_d))},
        "first_step_loss": {"train": loss_a, "remat": loss_c}}))
    torch.cuda.empty_cache()
    return launches_a, launches_d, launches_ddp, launches_tp


# --------------------------------------------------------------------------- #
# phase 14: data parallelism
# --------------------------------------------------------------------------- #
DDP_WORLD = 2
CHILD_TIMEOUT_S = 420              # a child that outlives it fails the run
DDP_LOSS_RTOL = 1e-4               # f32 two ranks against one process


def same_bits(what, got, want) -> None:
    """Fatal unless every tensor of ``got`` equals its ``want`` bit for bit."""
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not torch.equal(g, w):
            fail(f"{what}: output {i} differs from the full launch's rows")


def offset_checks(seed):
    """Phase 14a: B1-B6 at their train shapes with dropout 0.1, each half
    of the batch launched as a rank of two would launch it (its first
    global stream or row as the offset): bitwise that half of the full
    launch (B6: dh and dres; dw and db, sums over the rows, within the
    tolerance), offset 0 bitwise the launch without one, and each offset
    launch against its plain twin with the same offset.  Returns how many
    launches were compared."""
    import torch
    from youtube_vln_tpu_torch.ops import attention as A
    from youtube_vln_tpu_torch.ops import epilogue as E

    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    s_v, bh = L * BOXES, TRAIN_B * TRAIN_NC
    half = bh // DDP_WORLD
    drop_seed = 0xDD9 + seed
    n_checked = 0

    # B1 / B3: vision self-attention, 96 x 8 heads x 808, D 128
    q, k, v, do = (heads_view(gen, bh, HEADS, s_v, 128, bf16) for _ in range(4))
    bias = key_bias(gen, bh, s_v)
    out, lse, _ = A._attention_fwd(q, k, v, bias, RATE, drop_seed, True)
    same_bits("B1 at offset 0", A._attention_fwd(q, k, v, bias, RATE, drop_seed, True, 0)[:2],
              (out, lse))
    grads = A._attention_bwd(q, k, v, bias, out, do, lse, RATE, drop_seed)
    same_bits("B3 at offset 0", A._attention_bwd(q, k, v, bias, out, do, lse, RATE,
                                                 drop_seed, 0), grads)
    for r in range(DDP_WORLD):
        rows, s0 = slice(r * half, (r + 1) * half), r * half * HEADS
        qr, kr, vr, dor, br = q[rows], k[rows], v[rows], do[rows], bias[rows]
        o, lr, _ = A._attention_fwd(qr, kr, vr, br, RATE, drop_seed, True, s0)
        same_bits(f"B1 rank {r} of {DDP_WORLD}", (o, lr), (out[rows], lse[rows]))
        check(f"B1 rank {r} (stream0 {s0}) vs plain", o,
              A.attention_reference(qr, kr, vr, br, RATE, drop_seed, 0, s0), tol)
        g = A._attention_bwd(qr, kr, vr, br, o, dor, lr, RATE, drop_seed, s0)
        same_bits(f"B3 rank {r} of {DDP_WORLD}", g, [x[rows] for x in grads])
        for name, gi, ti in zip("qkv", g, A.attention_bwd_reference(
                qr, kr, vr, br, dor, RATE, drop_seed, 0, s0)):
            check(f"B3 rank {r} d{name} vs plain", gi, ti, tol, floor=0)
        n_checked += 2
    del q, k, v, do, bias, out, lse, grads
    torch.cuda.empty_cache()

    # B2 / B4: co-attention 60 <-> 808
    vis = [heads_view(gen, bh, HEADS, s_v, 128, bf16) for _ in range(3)]
    txt = [heads_view(gen, bh, HEADS, S_T, 128, bf16) for _ in range(3)]
    vb, tb = key_bias(gen, bh, s_v), key_bias(gen, bh, S_T)
    do1, do2 = heads_view(gen, bh, HEADS, S_T, 128, bf16), heads_view(gen, bh, HEADS, s_v,
                                                                        128, bf16)
    *fwd, _ = A._bi_attention_fwd(*vis, *txt, vb, tb, RATE, RATE, drop_seed, True)
    same_bits("B2 at offset 0", A._bi_attention_fwd(*vis, *txt, vb, tb, RATE, RATE,
                                                    drop_seed, True, 0)[:4], fwd)
    grads = A._bi_attention_bwd(*vis, *txt, vb, tb, *fwd, do1, do2, RATE, RATE, drop_seed)
    same_bits("B4 at offset 0", A._bi_attention_bwd(*vis, *txt, vb, tb, *fwd, do1, do2,
                                                    RATE, RATE, drop_seed, 0), grads)
    for r in range(DDP_WORLD):
        rows, s0 = slice(r * half, (r + 1) * half), r * half * HEADS
        ops = [x[rows] for x in vis + txt]
        vbr, tbr, d1, d2 = vb[rows], tb[rows], do1[rows], do2[rows]
        *f, _ = A._bi_attention_fwd(*ops, vbr, tbr, RATE, RATE, drop_seed, True, s0)
        same_bits(f"B2 rank {r} of {DDP_WORLD}", f, [x[rows] for x in fwd])
        for c, (got, want) in enumerate(zip(f[:2], A.bi_attention_reference(
                *ops, vbr, tbr, RATE, RATE, drop_seed, s0)), 1):
            check(f"B2 rank {r} ctx{c} (stream0 {s0}) vs plain", got, want, tol)
        g = A._bi_attention_bwd(*ops, vbr, tbr, *f, d1, d2, RATE, RATE, drop_seed, s0)
        same_bits(f"B4 rank {r} of {DDP_WORLD}", g, [x[rows] for x in grads])
        for name, gi, ti in zip(("q1", "k1", "v1", "q2", "k2", "v2"), g,
                                A.bi_attention_bwd_reference(*ops, vbr, tbr, d1, d2, RATE,
                                                             RATE, drop_seed, s0)):
            check(f"B4 rank {r} d{name} vs plain", gi, ti, tol, floor=0)
        n_checked += 2
    del vis, txt, vb, tb, do1, do2, fwd, grads
    torch.cuda.empty_cache()

    # B5 / B6: the MRT vision stream, 45,248 x 1024 rows
    n, d = PRE_B * PRE_NC * L * BOXES, 1024
    hn = n // DDP_WORLD
    h, res, do = (torch.randn(n, d, generator=gen, device="cuda").to(bf16) for _ in range(3))
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    out, ops = E._epilogue_fwd(h, res, w, b, RATE, drop_seed)
    same_bits("B5 at offset 0", E._epilogue_fwd(h, res, w, b, RATE, drop_seed, 0)[:1], (out,))
    grads = E._epilogue_bwd(*ops, do, RATE, drop_seed)
    same_bits("B6 at offset 0", E._epilogue_bwd(*ops, do, RATE, drop_seed, 0), grads)
    dw_db = [torch.zeros_like(grads[2]), torch.zeros_like(grads[3])]
    for r in range(DDP_WORLD):
        rows, r0 = slice(r * hn, (r + 1) * hn), r * hn
        hr, resr, dor = h[rows], res[rows], do[rows]
        o, opsr = E._epilogue_fwd(hr, resr, w, b, RATE, drop_seed, r0)
        same_bits(f"B5 rank {r} of {DDP_WORLD}", (o,), (out[rows],))
        check(f"B5 rank {r} (row0 {r0}) vs plain", o,
              E.epilogue_reference(hr, resr, w, b, RATE, drop_seed, r0), tol)
        g = E._epilogue_bwd(*opsr, dor, RATE, drop_seed, r0)
        same_bits(f"B6 dh, dres rank {r} of {DDP_WORLD}", g[:2], [x[rows] for x in grads[:2]])
        for name, gi, ti in zip(("h", "res", "w", "b"), g, E.epilogue_bwd_reference(
                hr, resr, w, dor, RATE, drop_seed, r0)):
            check(f"B6 rank {r} d{name} vs plain", gi, ti, tol, floor=0)
        dw_db[0] += g[2]
        dw_db[1] += g[3]
        n_checked += 2
    for name, got, want in zip(("dw", "db"), dw_db, grads[2:]):
        check(f"B6 {name} summed over the ranks vs the full launch", got, want, tol, floor=0)
    del h, res, do, out, ops, grads
    torch.cuda.empty_cache()
    print(f"offsets: {n_checked} launches of B1-B6 on a rank's half equal to the rows "
          f"of the full launch, bit for bit")
    return n_checked


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(tag, world, spec, root):
    """Runs ``chip_smoke.py --ddp-child`` as ranks 0 .. world-1 (launcher
    variables set, every rank on device 0) and returns each rank's result.
    A child that fails, or outlives ``CHILD_TIMEOUT_S``, fails the run; none
    is left running."""
    spec_path = Path(root) / f"{tag}.json"
    spec_path.write_text(json.dumps(dict(spec, out=str(Path(root) / tag))))
    port = free_port()
    sys.stdout.flush()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                       "--ddp-child", str(spec_path)], env=env))
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, CHILD_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        fail(f"{tag}: a rank outlived its {CHILD_TIMEOUT_S} s timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            fail(f"{tag}: rank {r} exited with {p.returncode}")
    print(f"{tag}: {world} rank(s) in {time.perf_counter() - t0:.1f} s")
    return [json.loads((Path(root) / f"{tag}.rank{r}.json").read_text())
            for r in range(world)]


def entry_record(rec, launches):
    """What a child reports of one entry run."""
    engine = rec["engines"][0]
    return dict(losses=[s["losses"] for s in rec["steps"]],
                step_ms=[s["ms"] for s in rec["steps"]],
                ms_per_step=median_step_ms(rec) if len(rec["steps"]) > 1 else None,
                peak_gib=max(s["peak"] for s in rec["steps"]) / 2 ** 30,
                step_counts=[s["step_count"] for s in rec["steps"]],
                first_lr=rec["steps"][0]["lr"], schedule3=engine.schedule(3),
                final_step_count=engine.optimizer.step_count,
                start_epoch=engine.start_epoch, saves=rec["saves"], loads=rec["loads"],
                ddp=rec["ddp"], launches=launches)


def child_entry(run, spec):
    """One run of the train entry on this rank: fatal unless each micro-step
    launched its share of B1-B4 (``per_micro``) and the model was wrapped in
    DDP once."""
    import torch
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.entries import train as train_entry
    _, launches, rec = run_entry(train_entry.main, run["argv"])
    check_entry_run(f"{run['name']}, rank {os.environ['RANK']}", rec, launches,
                    lily_base_config(), 0, tuple(run["per_micro"]))
    if len(rec["ddp"]) != 1:
        fail(f"{run['name']}: the model was wrapped in DDP {len(rec['ddp'])} times")
    out = entry_record(rec, launches)
    if run.get("tp"):
        out["state"] = tp_state(run, rec["engines"][0])
    rec["engines"].clear()
    torch.cuda.empty_cache()
    return out


def child_mrt(run, spec):
    """The MRT step with ``use_epilogue_kernels`` on, DDP over the group: two
    steps of the YTb fixture's Loader shard of this rank (4 of the global 8
    instructions), the launches checked per micro-step, then a collective
    ``.dcp`` save, and rank 0's weights as a ``.bin`` to compare it with."""
    import numpy as np
    import torch
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.data.datasets import YTbDataset
    from youtube_vln_tpu_torch.data.features_reader import YTbFeaturesReader
    from youtube_vln_tpu_torch.data.loader import Loader
    from youtube_vln_tpu_torch.data.tokenizer import load_tokenizer
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.parallel import distributed
    from youtube_vln_tpu_torch.parallel.train_step import build_train_step, create_train_state
    from youtube_vln_tpu_torch.training import checkpoint as ck

    world, rank = distributed.world_size(), distributed.rank()
    paths, seed = run["paths"], spec["seed"]
    args = pretrain_args(paths, seed)
    reader = YTbFeaturesReader(paths["store_path"])
    ds = YTbDataset(args=args, caption_path=paths["caption_path"],
                    tokenizer=load_tokenizer(paths["vocab_path"]), features_reader=reader,
                    masked_vision=True, masked_language=True, training=True, seed=seed)
    loader = Loader(ds, PRE_B // world, shuffle=True, seed=seed, num_workers=0,
                    num_shards=world, shard=rank, drop_last=True)
    batches = list(loader)[:2]          # the epoch read to its end
    reader.close()
    cfg = lily_base_config(ranking=True, traj_judge=True, masked_vision=True,
                           masked_language=True, compute_dtype="bfloat16",
                           use_epilogue_kernels=True)
    model = Lily(cfg, device="cuda").init_weights(seed)
    optimizer, _ = create_train_state(model, args, steps_per_epoch=1000)
    step = build_train_step(model, cfg, args, optimizer, device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    metrics = [step(b, 0xA9 + i) for i, b in enumerate(batches)]
    losses = [{k: float(v) for k, v in m.items() if k.startswith("loss/")} for m in metrics]
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    launches = counts()
    check_pretrain_launches(cfg, launches, len(batches), f"MRT over DDP, rank {rank}")
    if not all(np.isfinite(list(l.values())).all() for l in losses):
        fail(f"MRT over DDP, rank {rank}: non-finite losses {losses}")
    out_dir = Path(run["out_dir"])
    t0 = time.perf_counter()
    path = ck.save_dcp(out_dir, "mrt", model, optimizer, step=optimizer.step_count, epoch=0)
    save_s = time.perf_counter() - t0
    saved = dict(path=path, s=save_s,
                 bytes=sum(f.stat().st_size for f in Path(path).iterdir()))
    if rank == 0:
        saved["bin"] = ck.save_checkpoint(out_dir, "mrt_rank0", model, cfg)
    del model, optimizer, step
    torch.cuda.empty_cache()
    return dict(losses=losses, ms_per_step=ms, launches=launches, dcp=saved)


def ddp_child(spec_path) -> int:
    """``--ddp-child``: one rank of a phase-14 group.  With ``backend`` gloo
    the group is joined here, every rank on device 0 (NCCL refuses two
    ranks on one device); with nccl the entry joins it itself."""
    import torch
    spec = json.loads(Path(spec_path).read_text())
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from youtube_vln_tpu_torch.parallel import distributed
    if spec["backend"] != "nccl":
        distributed.initialize("cuda", backend=spec["backend"])
    out = {}
    for run in spec["runs"]:
        out[run["name"]] = CHILD_RUNS[run["kind"]](run, spec)
    out["backend"] = torch.distributed.get_backend()
    out["world"] = distributed.world_size()
    Path(f"{spec['out']}.rank{distributed.rank()}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def sum_launches(*runs):
    total = dict.fromkeys(runs[0], 0)
    for launches in runs:
        for k, v in launches.items():
            total[k] += v
    return total


def dropout_free_config(root) -> Path:
    """The flagship config file with every dropout rate at 0 (the fused
    pool's, ``fusion_dropout_prob``, is not in the file: its default is 0.1)."""
    cfg = json.loads((REPO / "configs" / "bert_base_6_layer_6_connect.json").read_text())
    cfg.update({k: 0.0 for k in ("hidden_dropout_prob", "attention_probs_dropout_prob",
                                 "v_hidden_dropout_prob", "v_attention_probs_dropout_prob",
                                 "fusion_dropout_prob")})
    path = Path(root) / "bert_base_6_layer_6_connect_dropout0.json"
    path.write_text(json.dumps(cfg))
    return path


def ddp_path(seed, root, recipe, pre_paths, unwrapped_ms):
    """Phase 14: data parallelism.  (a) ``offset_checks``; (b) the 30RS
    train entry in a child process of a world-1 NCCL group, so the model is
    DDP-wrapped on the card, with ``--orbax_checkpoints`` and a ``--resume``
    from its ``.dcp``; (c) two gloo ranks on the one card: 30RS with
    ``--remat`` in f32 with dropout 0 against one process on the same global
    batches (this process, 1e-4 relative), then in bf16, then the MRT step
    with the epilogue kernels and a collective ``.dcp`` save loaded here in
    one process.  Gloo moves each step's gradients through host memory:
    (c)'s times are not a speed number.  Returns the launch counts of (b)
    and (c), every rank summed."""
    import torch
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.entries import train as train_entry
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.training import checkpoint as ck

    n_offsets = offset_checks(seed)
    root = Path(root)
    result = root / "ddp_result"

    # (b) world 1 over NCCL
    b = run_children("ddp_nccl", 1, {"backend": "nccl", "seed": seed, "runs": [
        dict(name="30RS, NCCL world 1", kind="entry", per_micro=[1, 1], argv=recipe + [
            "--num_epochs", "1", "--save_epochs", "1", "--skip_val", "--orbax_checkpoints",
            "--save_name", "ddp1", "--output_dir", str(result)]),
        dict(name="30RS, NCCL world 1, --resume", kind="entry", per_micro=[1, 1],
             argv=recipe + ["--num_epochs", "2", "--save_epochs", "1", "--skip_val",
                            "--orbax_checkpoints", "--save_name", "ddp1_resume",
                            "--output_dir", str(result), "--resume", "--from_pretrained",
                            str(result / "ddp1" / "data" / "0.dcp")])]}, root)[0]
    run_b, resumed = b["30RS, NCCL world 1"], b["30RS, NCCL world 1, --resume"]
    if (b["backend"], b["world"]) != ("nccl", 1) or run_b["ddp"] != ["cuda:0"]:
        fail(f"NCCL world 1: backend {b['backend']}, world {b['world']}, DDP {run_b['ddp']}")
    if [s["name"] for s in run_b["saves"]] != ["0.dcp"] or len(resumed["loads"]) != 1:
        fail(f"NCCL world 1: saves {run_b['saves']}, resume loads {resumed['loads']}")
    if (resumed["start_epoch"], resumed["step_counts"][0], resumed["final_step_count"]) != (
            1, 3, 6) or resumed["first_lr"] != resumed["schedule3"]:
        fail(f"NCCL world 1, --resume from 0.dcp: start epoch {resumed['start_epoch']}, "
             f"step counts {resumed['step_counts']} -> {resumed['final_step_count']}, "
             f"lr {resumed['first_lr']} against schedule(3) {resumed['schedule3']}")
    shutil.rmtree(result, ignore_errors=True)

    # (c) two gloo ranks on the one card; the one-process f32 run here first
    f32 = recipe + ["--compute_dtype", "float32", "--config_file",
                    str(dropout_free_config(root)), "--remat", "--num_epochs", "1",
                    "--skip_val", "--output_dir", str(result)]
    _, _, rec_one = run_entry(train_entry.main, f32 + ["--save_name", "f32_one"])
    one = [s["losses"] for s in rec_one["steps"]]
    rec_one["engines"].clear()
    shutil.rmtree(result, ignore_errors=True)
    torch.cuda.empty_cache()
    c = run_children("ddp_gloo", DDP_WORLD, {"backend": "gloo", "seed": seed, "runs": [
        dict(name="30RS f32", kind="entry", per_micro=[2, 1],
             argv=f32 + ["--orbax_checkpoints", "--save_name", "f32_ddp"]),
        dict(name="30RS bf16", kind="entry", per_micro=[2, 1],
             argv=recipe + ["--remat", "--num_epochs", "1", "--skip_val",
                            "--orbax_checkpoints", "--save_name", "bf16_ddp",
                            "--output_dir", str(result)]),
        dict(name="MRT", kind="mrt", paths=pre_paths, out_dir=str(root / "mrt_ddp"))]},
        root)
    for name in ("30RS f32", "30RS bf16"):
        per_rank = [r[name]["losses"] for r in c]
        if any(l != per_rank[0] for l in per_rank):
            fail(f"{name}: the ranks' global losses differ: {per_rank}")
    ddp_f32 = c[0]["30RS f32"]["losses"]
    rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
              for g, w in zip(ddp_f32, one) for k in w)
    print(f"f32 30RS, 2 gloo ranks against one process: losses {ddp_f32} against {one}, "
          f"max relative difference {rel:.3e}")
    if len(ddp_f32) != len(one) or len(one) != 3 or not rel <= DDP_LOSS_RTOL:
        fail(f"f32 30RS over 2 ranks: {len(ddp_f32)} steps against {len(one)}, "
             f"relative difference {rel} above {DDP_LOSS_RTOL}")
    if c[0]["MRT"]["losses"] != c[1]["MRT"]["losses"]:
        fail("MRT over DDP: the ranks' global losses differ")

    # the MRT step's collective .dcp save, loaded in this process alone
    cfg = lily_base_config(ranking=True, traj_judge=True, masked_vision=True,
                           masked_language=True)
    t0 = time.perf_counter()
    from_dcp = Lily(cfg, device="cuda")
    ck.load_checkpoint(c[0]["MRT"]["dcp"]["path"], from_dcp)
    dcp_load_s = time.perf_counter() - t0
    from_bin = Lily(cfg, device="cuda")
    ck.load_checkpoint(c[0]["MRT"]["dcp"]["bin"], from_bin)
    differ = [k for (k, a), b2 in zip(from_dcp.state_dict().items(),
                                      from_bin.state_dict().values()) if not torch.equal(a, b2)]
    if differ:
        fail(f"MRT .dcp loaded in one process differs from rank 0's weights: {differ[:3]}")
    del from_dcp, from_bin
    shutil.rmtree(root / "mrt_ddp", ignore_errors=True)
    shutil.rmtree(result, ignore_errors=True)
    torch.cuda.empty_cache()

    launches = sum_launches(*[run["launches"] for run in b.values() if isinstance(run, dict)],
                            *[r[name]["launches"] for r in c
                              for name in ("30RS f32", "30RS bf16", "MRT")])
    print(json.dumps({
        "ddp": "phase 14: 30RS entry over a world-1 NCCL group (DDP) and 2 gloo ranks "
               "on one card; gloo times are not a speed number",
        "offset_launches_bitwise_equal": n_offsets,
        "nccl_world1": {"ms_per_step": run_b["ms_per_step"], "unwrapped_ms_per_step":
                        unwrapped_ms, "ratio": run_b["ms_per_step"] / unwrapped_ms,
                        "step_ms": run_b["step_ms"], "peak_gib": run_b["peak_gib"],
                        "dcp_save_s": run_b["saves"][0]["s"],
                        "dcp_save_bytes": run_b["saves"][0]["bytes"],
                        "dcp_resume_load_s": resumed["loads"][0],
                        "resume_ms_per_step": resumed["ms_per_step"],
                        "launches": run_b["launches"]},
        "gloo_2_ranks_not_speed": {
            "f32_losses": ddp_f32, "one_process_f32_losses": one,
            "f32_max_rel_diff": rel,
            "one_process_f32_ms_per_step": median_step_ms(rec_one),
            "f32_ms_per_step": [r["30RS f32"]["ms_per_step"] for r in c],
            "bf16_losses": c[0]["30RS bf16"]["losses"],
            "bf16_ms_per_step": [r["30RS bf16"]["ms_per_step"] for r in c],
            "bf16_peak_gib": [r["30RS bf16"]["peak_gib"] for r in c],
            "dcp_save_s": [r["30RS bf16"]["saves"][0]["s"] for r in c],
            "dcp_save_bytes": c[0]["30RS bf16"]["saves"][0]["bytes"],
            "dcp_files_bytes": c[1]["30RS bf16"]["saves"][0]["files"],
            "mrt_losses": c[0]["MRT"]["losses"],
            "mrt_ms_per_step": [r["MRT"]["ms_per_step"] for r in c],
            "mrt_dcp_save_s": [r["MRT"]["dcp"]["s"] for r in c],
            "mrt_dcp_load_one_process_s": dcp_load_s,
            "launches_per_rank": {name: [r[name]["launches"] for r in c]
                                  for name in ("30RS f32", "30RS bf16", "MRT")}},
        "launches_ddp": launches}))
    return launches


# --------------------------------------------------------------------------- #
# phase 15: tensor parallelism over heads
# --------------------------------------------------------------------------- #
TP_MODEL = 2                       # the model axis of the children
TP_BATCH = 8                       # global batch: the ranks share one card
TP_LOSS_RTOL = 1e-4                # f32 (1, 2) against one process
TP_WIDE = 8                        # phase 15d: the text heads split (1.5 per rank)
TP_COVER = 16                      # phase 15e: every kernel site's heads split
COVER_RTOL = 1e-5                  # f32 gradients summed over covering heads, rel-L2


def head_shard_checks(seed):
    """Phase 15a: B1-B4 at the 30RS train shapes (96 x 8 heads, bf16 and
    f32, dropout 0 and 0.1) launched on every shard of a 1 x 2 and a 2 x 2
    mesh with the head mapping (``stream0`` of the data coordinate,
    ``head0`` / ``heads_total`` of the model coordinate): outputs, row
    log-sum-exps and gradients bitwise the slice of the full launch; the
    identity mapping (``head0`` 0, ``heads_total`` H) bitwise the launch
    without one and, against its plain twin, the mask of the unmapped
    streams b * H + h.  B5/B6 at 45,248 x 1024 with the data coordinate's ``row0``,
    launched once per model rank: bitwise the full launch's rows on both.
    Returns how many launches were compared."""
    import torch
    from youtube_vln_tpu_torch.ops import attention as A
    from youtube_vln_tpu_torch.ops import epilogue as E

    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    s_v, bh = L * BOXES, TRAIN_B * TRAIN_NC
    drop_seed = 0x7E9 + seed
    n_checked = 0
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for rate in (0.0, RATE):
            what = f"{str(dtype).split('.')[1]}, dropout {rate}"
            # B1 / B3: vision self-attention
            q, k, v, do = (heads_view(gen, bh, HEADS, s_v, 128, dtype) for _ in range(4))
            bias = key_bias(gen, bh, s_v)
            out, lse, _ = A._attention_fwd(q, k, v, bias, rate, drop_seed, True)
            same_bits(f"B1 identity mapping, {what}", A._attention_fwd(
                q, k, v, bias, rate, drop_seed, True, 0, 0, HEADS)[:2], (out, lse))
            grads = A._attention_bwd(q, k, v, bias, out, do, lse, rate, drop_seed)
            same_bits(f"B3 identity mapping, {what}", A._attention_bwd(
                q, k, v, bias, out, do, lse, rate, drop_seed, 0, 0, HEADS), grads)
            if rate and dtype == torch.bfloat16:
                check(f"B1 identity mapping vs plain (streams b*H + h), {what}", out,
                      A.attention_reference(q, k, v, bias, rate, drop_seed, 0, 0), tol)
            for data, model in ((1, TP_MODEL), (2, TP_MODEL)):
                rows_n, heads_n = bh // data, HEADS // model
                for d in range(data):
                    for m in range(model):
                        rows = slice(d * rows_n, (d + 1) * rows_n)
                        heads = slice(m * heads_n, (m + 1) * heads_n)
                        streams = (d * rows_n * HEADS, m * heads_n, HEADS)
                        qs, ks, vs, dos = (x[rows, heads] for x in (q, k, v, do))
                        o, ls, _ = A._attention_fwd(qs, ks, vs, bias[rows], rate,
                                                    drop_seed, True, *streams)
                        same_bits(f"B1 shard ({d}, {m}) of {data} x {model}, {what}",
                                  (o, ls), (out[rows, heads], lse[rows, heads]))
                        g = A._attention_bwd(qs, ks, vs, bias[rows], o, dos, ls, rate,
                                             drop_seed, *streams)
                        same_bits(f"B3 shard ({d}, {m}) of {data} x {model}, {what}",
                                  g, [x[rows, heads] for x in grads])
                        n_checked += 2
            del q, k, v, do, bias, out, lse, grads

            # B2 / B4: co-attention 60 <-> 808
            vis = [heads_view(gen, bh, HEADS, s_v, 128, dtype) for _ in range(3)]
            txt = [heads_view(gen, bh, HEADS, S_T, 128, dtype) for _ in range(3)]
            vb, tb = key_bias(gen, bh, s_v), key_bias(gen, bh, S_T)
            do1 = heads_view(gen, bh, HEADS, S_T, 128, dtype)
            do2 = heads_view(gen, bh, HEADS, s_v, 128, dtype)
            *fwd, _ = A._bi_attention_fwd(*vis, *txt, vb, tb, rate, rate, drop_seed, True)
            same_bits(f"B2 identity mapping, {what}", A._bi_attention_fwd(
                *vis, *txt, vb, tb, rate, rate, drop_seed, True, 0, 0, HEADS)[:4], fwd)
            grads = A._bi_attention_bwd(*vis, *txt, vb, tb, *fwd, do1, do2, rate, rate,
                                        drop_seed)
            for data, model in ((1, TP_MODEL), (2, TP_MODEL)):
                rows_n, heads_n = bh // data, HEADS // model
                for d in range(data):
                    for m in range(model):
                        rows = slice(d * rows_n, (d + 1) * rows_n)
                        heads = slice(m * heads_n, (m + 1) * heads_n)
                        streams = (d * rows_n * HEADS, m * heads_n, HEADS)
                        ops = [x[rows, heads] for x in vis + txt]
                        *f, _ = A._bi_attention_fwd(*ops, vb[rows], tb[rows], rate, rate,
                                                    drop_seed, True, *streams)
                        same_bits(f"B2 shard ({d}, {m}) of {data} x {model}, {what}", f,
                                  [x[rows, heads] for x in fwd])
                        g = A._bi_attention_bwd(*ops, vb[rows], tb[rows], *f,
                                                do1[rows, heads], do2[rows, heads], rate,
                                                rate, drop_seed, *streams)
                        same_bits(f"B4 shard ({d}, {m}) of {data} x {model}, {what}", g,
                                  [x[rows, heads] for x in grads])
                        n_checked += 2
            del vis, txt, vb, tb, do1, do2, fwd, grads
            torch.cuda.empty_cache()

    # B5 / B6: rows replicated on the model ranks, row0 of the data coordinate
    bf16 = torch.bfloat16
    n, dd = PRE_B * PRE_NC * L * BOXES, 1024
    hn = n // 2
    h, res, do = (torch.randn(n, dd, generator=gen, device="cuda").to(bf16)
                  for _ in range(3))
    w = 1.0 + 0.1 * torch.randn(dd, generator=gen, device="cuda")
    b = 0.1 * torch.randn(dd, generator=gen, device="cuda")
    out, ops = E._epilogue_fwd(h, res, w, b, RATE, drop_seed)
    grads = E._epilogue_bwd(*ops, do, RATE, drop_seed)
    for d in range(2):
        rows = slice(d * hn, (d + 1) * hn)
        for m in range(TP_MODEL):
            o, opsr = E._epilogue_fwd(h[rows], res[rows], w, b, RATE, drop_seed, d * hn)
            same_bits(f"B5 data {d}, model rank {m}", (o,), (out[rows],))
            g = E._epilogue_bwd(*opsr, do[rows], RATE, drop_seed, d * hn)
            same_bits(f"B6 dh, dres data {d}, model rank {m}", g[:2],
                      [x[rows] for x in grads[:2]])
            n_checked += 2
    del h, res, do, out, ops, grads
    torch.cuda.empty_cache()
    print(f"head shards: {n_checked} launches of B1-B6 on a shard equal to the slice of "
          f"the full launch, bit for bit")
    return n_checked


def cover_checks(seed):
    """Phase 15e: B1-B4 at the 30RS train shapes (96 x 8 heads of 128, bf16
    and f32, dropout 0 and 0.1) on the geometry of a model axis of 16, where
    each coordinate holds 64 features, half a head, at every kernel site.
    Each coordinate launches B1 / B2 on the heads that cover its features
    (``ModelShard.heads``: ``head0`` r // 2 of ``heads_total`` 8) and keeps
    its 64 features: joined over the coordinates, bitwise the full launch's
    contexts.  Each launches B3 / B4 with a gradient on its kept features
    alone; summed over the coordinates, the gradients on the full heads
    match the full launch's within ``COVER_RTOL`` relative L2 in f32 and
    ``TOL`` in bf16 (the gradient is linear in the cotangent).  One process
    stands for the 16: the kernel half of the covering-heads path.
    Returns (launches compared, the worst f32 relative L2 per kernel)."""
    import torch
    from youtube_vln_tpu_torch.ops import attention as A
    from youtube_vln_tpu_torch.parallel.tensor import ModelShard

    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    s_v, bh, d = L * BOXES, TRAIN_B * TRAIN_NC, 128
    f = HEADS * d // TP_COVER
    covers = [ModelShard(r, TP_COVER).heads(HEADS, HEADS * d) for r in range(TP_COVER)]
    drop_seed = 0x7EA + seed
    worst = {"B3": 0.0, "B4": 0.0}
    n_checked = 0

    def merged(x):
        """[B, n, S, D] -> [B, S, n * D]."""
        return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1)

    def kept_cotangent(do, r, n, off):
        """The cotangent of coordinate r's covering heads: its own features'
        of ``do``, zero elsewhere."""
        b, _, s, _ = do.shape
        part = torch.zeros(b, s, n * d, dtype=do.dtype, device="cuda")
        part[..., off:off + f] = merged(do)[..., r * f:(r + 1) * f]
        return part.view(b, s, n, d).transpose(1, 2)

    def compare(kernel, what, summed, full, dtype):
        for i, (got, want) in enumerate(zip(summed, full)):
            name = f"{kernel} gradient {i} summed over the covering heads of M = {TP_COVER}, {what}"
            if dtype == torch.float32:
                rel = float((got - want).norm() / want.norm())
                worst[kernel] = max(worst[kernel], rel)
                if not rel <= COVER_RTOL:
                    fail(f"{name}: relative L2 {rel} above {COVER_RTOL}")
            else:
                check(name, got, want, TOL["bfloat16"], floor=0.0, verbose=False)

    for dtype in (torch.bfloat16, torch.float32):
        for rate in (0.0, RATE):
            what = f"{str(dtype).split('.')[1]}, dropout {rate}"
            # B1 / B3: vision self-attention
            q, k, v, do = (heads_view(gen, bh, HEADS, s_v, d, dtype) for _ in range(4))
            bias = key_bias(gen, bh, s_v)
            out, lse, _ = A._attention_fwd(q, k, v, bias, rate, drop_seed, True)
            grads = A._attention_bwd(q, k, v, bias, out, do, lse, rate, drop_seed)
            kept, summed = [], [torch.zeros(g.shape, device="cuda") for g in grads]
            for r, (n, head0, off) in enumerate(covers):
                hs = slice(head0, head0 + n)
                ops = [x[:, hs] for x in (q, k, v)]
                o, ls, _ = A._attention_fwd(*ops, bias, rate, drop_seed, True, 0, head0, HEADS)
                kept.append(merged(o)[..., off:off + f])
                g = A._attention_bwd(*ops, bias, o, kept_cotangent(do, r, n, off), ls, rate,
                                     drop_seed, 0, head0, HEADS)
                for acc, gi in zip(summed, g):
                    acc[:, hs] += gi.float()
                n_checked += 2
            same_bits(f"B1 on the covering heads of M = {TP_COVER}, {what}",
                      (torch.cat(kept, -1),), (merged(out),))
            compare("B3", what, summed, [g.float() for g in grads], dtype)
            del q, k, v, do, bias, out, lse, grads, kept, summed

            # B2 / B4: co-attention 60 <-> 808
            vis = [heads_view(gen, bh, HEADS, s_v, d, dtype) for _ in range(3)]
            txt = [heads_view(gen, bh, HEADS, S_T, d, dtype) for _ in range(3)]
            vb, tb = key_bias(gen, bh, s_v), key_bias(gen, bh, S_T)
            do1 = heads_view(gen, bh, HEADS, S_T, d, dtype)
            do2 = heads_view(gen, bh, HEADS, s_v, d, dtype)
            *fwd, _ = A._bi_attention_fwd(*vis, *txt, vb, tb, rate, rate, drop_seed, True)
            grads = A._bi_attention_bwd(*vis, *txt, vb, tb, *fwd, do1, do2, rate, rate,
                                        drop_seed)
            kept, summed = [[], []], [torch.zeros(g.shape, device="cuda") for g in grads]
            for r, (n, head0, off) in enumerate(covers):
                hs = slice(head0, head0 + n)
                ops = [x[:, hs] for x in vis + txt]
                *fr, _ = A._bi_attention_fwd(*ops, vb, tb, rate, rate, drop_seed, True, 0,
                                             head0, HEADS)
                for side, ctx in zip(kept, fr[:2]):
                    side.append(merged(ctx)[..., off:off + f])
                g = A._bi_attention_bwd(*ops, vb, tb, *fr, kept_cotangent(do1, r, n, off),
                                        kept_cotangent(do2, r, n, off), rate, rate,
                                        drop_seed, 0, head0, HEADS)
                for acc, gi in zip(summed, g):
                    acc[:, hs] += gi.float()
                n_checked += 2
            same_bits(f"B2 on the covering heads of M = {TP_COVER}, {what}",
                      [torch.cat(side, -1) for side in kept], [merged(x) for x in fwd[:2]])
            compare("B4", what, summed, [g.float() for g in grads], dtype)
            del vis, txt, vb, tb, do1, do2, fwd, grads, kept, summed
            torch.cuda.empty_cache()
    print(f"covering heads: {n_checked} launches of B1-B4 on the heads that cover a "
          f"coordinate of M = {TP_COVER}; contexts bitwise the full launch's, summed f32 "
          f"gradients within {worst} relative L2")
    return n_checked, worst


def bits_digest(t) -> int:
    """A digest of the bits of ``t`` (two tensors with one digest are equal
    bit for bit, up to a collision of the weighted sum)."""
    import torch
    x = t.detach().contiguous().view(-1)
    ints = x.view({2: torch.int16, 4: torch.int32}[x.element_size()]).to(torch.int64)
    weights = torch.arange(ints.numel(), device=x.device, dtype=torch.int64) % 65521 + 1
    return int((ints * weights).sum())


def tp_state(run, engine):
    """What a model rank reports of its model after a phase-15 run: the
    digests of its replicated and of its sharded parameters, and the
    gathered ``.bin`` of its weights and moments (collective over the model
    group; rank 0 writes)."""
    from youtube_vln_tpu_torch.parallel import distributed
    from youtube_vln_tpu_torch.training import checkpoint as ck
    params = dict(engine.model.named_parameters())
    out = {"replicated": {n: bits_digest(p) for n, p in params.items()
                          if not hasattr(p, "tp_dim")},
           "sharded": {n: bits_digest(p) for n, p in params.items()
                       if hasattr(p, "tp_dim")},
           "mesh": [distributed.data_rank(), distributed.model_rank()]}
    if run.get("gathered"):
        out["gathered"] = ck.save_checkpoint(
            run["out_dir"], run["gathered"], engine.model, engine.cfg,
            optimizer=engine.optimizer, step=engine.optimizer.step_count,
            write=distributed.rank() == 0)
    return out


def child_tp_mrt(run, spec):
    """The MRT recipe through the pretrain entry under ``--mesh_shape 1 2``
    with the epilogue kernels (a config file that sets
    ``use_epilogue_kernels``): the launches per micro-step, and a digest of
    every B5 output, which the model ranks must share bit for bit."""
    import torch
    from youtube_vln_tpu_torch.config import LilyConfig
    from youtube_vln_tpu_torch.entries import pretrain as pretrain_entry
    from youtube_vln_tpu_torch.ops import epilogue as E
    launch = E._epilogue_fwd
    digests = []

    def recorded(*a, **k):
        out, ops = launch(*a, **k)
        digests.append(bits_digest(out))
        return out, ops

    E._epilogue_fwd = recorded
    try:
        _, launches, rec = run_entry(pretrain_entry.main, run["argv"])
    finally:
        E._epilogue_fwd = launch
    cfg = LilyConfig.from_json_file(run["config_file"])
    rank = os.environ["RANK"]
    check_pretrain_launches(cfg, launches, len(rec["steps"]), f"MRT entry, TP rank {rank}")
    out = entry_record(rec, launches)
    out["ln_digests"] = digests
    out["state"] = tp_state(run, rec["engines"][0])
    rec["engines"].clear()
    torch.cuda.empty_cache()
    return out


def check_tp_states(name, states, model):
    """Fatal unless the model ranks ``states`` (``tp_state``) sit at mesh
    coordinates (0, m), hold every replicated parameter bitwise equal and
    no sharded weight matrix equal to rank 0's (a zero bias that no task
    trains may agree)."""
    if [s["mesh"] for s in states] != [[0, m] for m in range(model)]:
        fail(f"{name}: mesh coordinates {[s['mesh'] for s in states]}")
    differ = [n for n, d in states[0]["replicated"].items()
              if any(s["replicated"][n] != d for s in states[1:])]
    same = [n for n, d in states[0]["sharded"].items() if n.endswith("weight")
            and any(s["sharded"][n] == d for s in states[1:])]
    print(f"{name}: {len(states[0]['replicated'])} replicated parameters, "
          f"{len(differ)} differ across the {model} model ranks; "
          f"{len(states[0]['sharded'])} sharded, {len(same)} equal")
    if differ or same or not states[0]["sharded"]:
        fail(f"{name}: replicated parameters that differ {differ[:3]}, sharded "
             f"ones that agree {same[:3]}")


def bin_shapes(path):
    """{key: shape} of a ``.bin``'s weights and of its first moments."""
    import torch
    b = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return ({k: tuple(v.shape) for k, v in b["model_state_dict"].items()},
            {k: tuple(v.shape) for k, v in b["optimizer_state_dict"]["exp_avg"].items()})


def losses_against_one(name, got, one):
    """Fatal unless ``got`` has ``one``'s steps and every loss within
    ``TP_LOSS_RTOL`` relative; returns the largest relative difference."""
    rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
              for g, w in zip(got, one) for k in w)
    print(f"{name} against one process: losses {got} against {one}, max relative "
          f"difference {rel:.3e}")
    if len(got) != len(one) or len(one) != 2 or not rel <= TP_LOSS_RTOL:
        fail(f"{name}: {len(got)} steps against {len(one)}, relative difference "
             f"{rel} above {TP_LOSS_RTOL}")
    return rel


def tp_path(seed, root, common, pre_paths, pre_data_dir):
    """Phase 15: tensor parallelism over heads.  (a) ``head_shard_checks``;
    (b) the 30RS train entry at full width under ``--mesh_shape 1 2`` in two
    gloo children on the one card (global batch 8, ``--remat``): f32 with
    every dropout 0 against one process on the same batches (1e-4
    relative), its gathered ``0.bin`` against the one process's in keys and
    shapes; bf16 with dropout 0.1, the replicated parameters bitwise equal
    across the ranks and the sharded ones not, its ``.dcp`` loaded in one
    process equal to the ranks' gathered weights and moments; (c) the MRT
    pretrain entry under ``--mesh_shape 1 2`` with the epilogue kernels, 2
    steps: 6 launches of B1-B4 and 24 of B5/B6 per micro-step per rank,
    every LN output of B5 bitwise equal on the two ranks; (d) the 30RS
    entry of (b) under ``--mesh_shape 1 8`` in eight gloo children, where
    each rank holds 1.5 of the 12 text heads and attends on the 2 that
    cover them: f32 against (b)'s one process (1e-4 relative), its gathered
    ``0.bin`` in keys and shapes, bf16 at dropout 0.1 with the replicated
    parameters bitwise equal across the eight ranks, 6 launches of B1-B4
    per micro-step per rank (12 of B1/B2 with ``--remat``); (e)
    ``cover_checks``, run after (a).  Gloo moves every collective through
    host memory: the times are not a speed number.  Returns the launch
    counts of (b), (c) and (d), every rank summed."""
    import torch
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.data.fixtures import build_r2r_fixture
    from youtube_vln_tpu_torch.entries import train as train_entry
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.parallel.train_step import create_train_state
    from youtube_vln_tpu_torch.training import checkpoint as ck
    from youtube_vln_tpu_torch.utils.cli import parse_run_config

    n_shards = head_shard_checks(seed)
    t0 = time.perf_counter()
    n_cover, cover_worst = cover_checks(seed)
    cover_s = time.perf_counter() - t0
    PHASE_S["15e covering heads"] = round(cover_s, 1)
    root = Path(root)
    result = root / "tp_result"
    r2r = build_r2r_fixture(root / "r2r_tp", k_boxes=BOXES - 1, n_beams=NC, path_len=L,
                            n_paths=6, seed=seed)
    recipe = common + ["--data_dir", r2r["data_dir"], "--img_feature", r2r["store_path"],
                       "--bert_tokenizer", r2r["vocab_path"], "--ranking",
                       "--shuffle_visual_features", "--batch_size", str(TP_BATCH),
                       "--remat", "--num_epochs", "1", "--skip_val", "--output_dir",
                       str(result)]
    f32 = recipe + ["--compute_dtype", "float32", "--config_file",
                    str(dropout_free_config(root)), "--save_epochs", "1"]
    mesh = ["--mesh_shape", "1", str(TP_MODEL)]

    # (b) the one process first, then the two model ranks
    _, _, rec_one = run_entry(train_entry.main, f32 + ["--save_name", "tp_one"])
    one = [s["losses"] for s in rec_one["steps"]]
    one_ms = median_step_ms(rec_one) if len(rec_one["steps"]) > 1 else rec_one["steps"][0]["ms"]
    rec_one["engines"].clear()
    torch.cuda.empty_cache()
    epilogue_cfg = json.loads((REPO / "configs" / "bert_base_6_layer_6_connect.json")
                              .read_text())
    epilogue_cfg["use_epilogue_kernels"] = True
    epilogue_cfg_path = root / "bert_base_6_layer_6_connect_epilogue.json"
    epilogue_cfg_path.write_text(json.dumps(epilogue_cfg))
    mrt_argv = common[:]
    mrt_argv[mrt_argv.index("--config_file") + 1] = str(epilogue_cfg_path)
    mrt_argv += ["--pre_dataset", "ytb", "--prefix", "merge+", "--masked_vision",
                 "--masked_language", "--ranking", "--traj_judge", "--batch_size",
                 str(PRE_B), "--learning_rate", "2e-5", "--num_epochs", "1", "--skip_val",
                 "--save_epochs", "-1", "--num_workers", "0", "--data_dir", str(pre_data_dir),
                 "--ytb_feature", pre_paths["store_path"], "--skeleton_path",
                 pre_paths["skeleton_path"], "--bert_tokenizer", pre_paths["vocab_path"],
                 "--save_name", "tp_mrt", "--output_dir", str(result)] + mesh
    c = run_children("tp_gloo", TP_MODEL, {"backend": "gloo", "seed": seed, "runs": [
        dict(name="TP 30RS f32", kind="entry", per_micro=[2, 1],
             argv=f32 + mesh + ["--save_name", "tp_f32"]),
        dict(name="TP 30RS bf16", kind="entry", per_micro=[2, 1], tp=True,
             gathered="tp_bf16_gathered", out_dir=str(root),
             argv=recipe + mesh + ["--orbax_checkpoints", "--save_epochs", "1",
                                   "--save_name", "tp_bf16"]),
        dict(name="TP MRT", kind="tp_mrt", config_file=str(epilogue_cfg_path),
             argv=mrt_argv)]}, root)

    # f32 against one process; the ranks' losses are the global batch's
    for name in ("TP 30RS f32", "TP 30RS bf16", "TP MRT"):
        per_rank = [r[name]["losses"] for r in c]
        if any(l != per_rank[0] for l in per_rank):
            fail(f"{name}: the model ranks' losses differ: {per_rank}")
    tp_f32 = c[0]["TP 30RS f32"]["losses"]
    rel = losses_against_one(f"f32 30RS under --mesh_shape 1 {TP_MODEL}", tp_f32, one)
    one_shapes = bin_shapes(result / "tp_one" / "data" / "0.bin")
    if bin_shapes(result / "tp_f32" / "data" / "0.bin") != one_shapes:
        fail(f"the gathered .bin of --mesh_shape 1 {TP_MODEL} differs from the one "
             "process's in keys or shapes")

    # bf16 with dropout: replicated parameters equal across the model ranks
    for name in ("TP 30RS bf16", "TP MRT"):
        check_tp_states(name, [r[name]["state"] for r in c], TP_MODEL)
    digests = [r["TP MRT"]["ln_digests"] for r in c]
    if len(digests[0]) != c[0]["TP MRT"]["launches"]["epilogue_fwd"] or any(
            d != digests[0] for d in digests[1:]):
        fail(f"TP MRT: {len(digests[0])} B5 outputs, equal across the ranks: "
             f"{[d == digests[0] for d in digests]}")

    # (d) --mesh_shape 1 8: the text self-attention's 12 heads of 64 over
    # 96 features a rank, split at every text layer (the vision and
    # co-attention sites hold one whole head a rank)
    t_wide = time.perf_counter()
    wide_mesh = ["--mesh_shape", "1", str(TP_WIDE)]
    wide_runs = ("TP 1x8 30RS f32", "TP 1x8 30RS bf16")
    w = run_children("tp_gloo_1x8", TP_WIDE, {"backend": "gloo", "seed": seed, "runs": [
        dict(name=wide_runs[0], kind="entry", per_micro=[2, 1],
             argv=f32 + wide_mesh + ["--save_name", "tp8_f32"]),
        dict(name=wide_runs[1], kind="entry", per_micro=[2, 1], tp=True,
             argv=recipe + wide_mesh + ["--save_name", "tp8_bf16"])]}, root)
    for name in wide_runs:
        per_rank = [r[name]["losses"] for r in w]
        if any(l != per_rank[0] for l in per_rank):
            fail(f"{name}: the model ranks' losses differ: {per_rank}")
    wide_f32 = w[0][wide_runs[0]]["losses"]
    wide_rel = losses_against_one(f"f32 30RS under --mesh_shape 1 {TP_WIDE}", wide_f32, one)
    if bin_shapes(result / "tp8_f32" / "data" / "0.bin") != one_shapes:
        fail(f"the gathered .bin of --mesh_shape 1 {TP_WIDE} differs from the one "
             "process's in keys or shapes")
    check_tp_states(wide_runs[1], [r[wide_runs[1]]["state"] for r in w], TP_WIDE)
    wide_s = time.perf_counter() - t_wide
    PHASE_S["15d tp 1x8"] = round(wide_s, 1)

    # the (1, 2) .dcp resumed in one process: the ranks' gathered state
    cfg = lily_base_config()
    _, args = parse_run_config(recipe)
    loaded = []
    t0 = time.perf_counter()
    for path in (result / "tp_bf16" / "data" / "0.dcp", root / "tp_bf16_gathered.bin"):
        model = Lily(cfg, device="cuda")
        optimizer, _ = create_train_state(model, args, 1000)
        _, _, step, _ = ck.load_checkpoint(path, model, optimizer)
        loaded.append((model, ck.optimizer_state_by_name(model, optimizer), step))
    dcp_load_s = time.perf_counter() - t0
    (m_dcp, o_dcp, s_dcp), (m_bin, o_bin, s_bin) = loaded
    differ = [k for (k, a), b2 in zip(m_dcp.state_dict().items(),
                                      m_bin.state_dict().values()) if not torch.equal(a, b2)]
    differ += [f"{k}.{n}" for k in ("exp_avg", "exp_avg_sq") for n in o_bin[k]
               if not torch.equal(o_dcp[k][n], o_bin[k][n])]
    if differ or s_dcp != s_bin or o_dcp["step_count"] != o_bin["step_count"]:
        fail(f"the (1, {TP_MODEL}) .dcp resumed in one process differs from the ranks' "
             f"gathered state: {differ[:3]}, steps {s_dcp} / {s_bin}")
    del loaded, m_dcp, m_bin, o_dcp, o_bin
    shutil.rmtree(result, ignore_errors=True)
    (root / "tp_bf16_gathered.bin").unlink()
    torch.cuda.empty_cache()

    launches = sum_launches(*[r[name]["launches"] for r in c
                              for name in ("TP 30RS f32", "TP 30RS bf16", "TP MRT")],
                            *[r[name]["launches"] for r in w for name in wide_runs])
    print(json.dumps({
        "tp": f"phase 15: --mesh_shape 1 {TP_MODEL}, 2 gloo ranks on one card, "
              f"global batch {TP_BATCH} (30RS) and {PRE_B} (MRT); (d) --mesh_shape 1 "
              f"{TP_WIDE}, {TP_WIDE} gloo ranks on one card, global batch {TP_BATCH}; "
              f"gloo moves every collective through host memory, so the times are not "
              f"a speed number",
        "card": CARD,
        "head_shard_launches_bitwise_equal": n_shards,
        "covering_heads_m16": {"launches": n_cover,
                               "contexts": "bitwise the full launch's",
                               "f32_grad_rel_l2": cover_worst,
                               "f32_grad_rel_l2_limit": COVER_RTOL, "s": cover_s},
        "mesh_1x8": {
            "f32_losses": wide_f32, "f32_max_rel_diff": wide_rel,
            "bf16_losses": w[0][wide_runs[1]]["losses"],
            "replicated_parameters_bitwise_equal": len(w[0][wide_runs[1]]["state"]["replicated"]),
            "peak_gib_per_rank": {name: [r[name]["peak_gib"] for r in w] for name in wide_runs},
            "launches_per_rank": {name: [r[name]["launches"] for r in w] for name in wide_runs},
            "gloo_not_speed": {"ms_per_step": {name: [r[name]["ms_per_step"] for r in w]
                                               for name in wide_runs},
                               "step_ms": {name: [r[name]["step_ms"] for r in w]
                                           for name in wide_runs},
                               "phase_s": wide_s}},
        "f32_losses": tp_f32, "one_process_f32_losses": one, "f32_max_rel_diff": rel,
        "peak_gib_per_rank": {name: [r[name]["peak_gib"] for r in c]
                              for name in ("TP 30RS f32", "TP 30RS bf16", "TP MRT")},
        "one_process_f32_peak_gib": max(s["peak"] for s in rec_one["steps"]) / 2 ** 30,
        "gloo_not_speed": {
            "ms_per_step": {name: [r[name]["ms_per_step"] for r in c]
                            for name in ("TP 30RS f32", "TP 30RS bf16", "TP MRT")},
            "step_ms": {name: [r[name]["step_ms"] for r in c]
                        for name in ("TP 30RS f32", "TP 30RS bf16", "TP MRT")},
            "one_process_f32_ms_per_step": one_ms,
            "dcp_save_s": [r["TP 30RS bf16"]["saves"][0]["s"] for r in c],
            "dcp_files_bytes": c[1]["TP 30RS bf16"]["saves"][0]["files"],
            "dcp_load_one_process_s": dcp_load_s},
        "bf16_losses": c[0]["TP 30RS bf16"]["losses"],
        "mrt_losses": c[0]["TP MRT"]["losses"],
        "mrt_ln_outputs_bitwise_equal": len(digests[0]),
        "launches_per_rank": {name: [r[name]["launches"] for r in c]
                              for name in ("TP 30RS f32", "TP 30RS bf16", "TP MRT")},
        "launches_tp": launches}))
    return launches


# ---------------------------------------------------------------------------
# phase 16a: the legacy ViLBERT heads at full width
# ---------------------------------------------------------------------------
LEGACY_ROWS = 32                   # rows x (60 text + 808 visual tokens)
LEGACY_GRAD_ROWS = 8               # rows of the f32 gradient check
VQA_LABELS, VQA_HIDDEN = 3129, 2048  # SimpleClassifier(1024, 2048, 3129)
LEGACY_SEED = 0x1E6                # dropout seed of the train-mode runs


def legacy_batch(rng, n, vocab):
    """n rows of 60 text tokens (the last 12 padded on odd rows) and 808
    visual tokens (8 steps x 101 boxes, ~10% masked)."""
    import numpy as np
    s_v = L * BOXES
    tokens = rng.integers(1, vocab, size=(n, S_T)).astype(np.int64)
    t_mask = np.ones((n, S_T), np.int64)
    t_mask[1::2, S_T - 12:] = 0
    segments = np.zeros((n, S_T), np.int64)
    feats = rng.normal(size=(n, s_v, FEAT)).astype(np.float32)
    locs = rng.random(size=(n, s_v, 12)).astype(np.float32)
    locs[..., 11] = np.repeat(np.arange(L), BOXES)[None]
    v_mask = (rng.random((n, s_v)) < 0.9).astype(np.int64)
    v_mask[:, ::BOXES] = 1
    return tokens, feats, locs, segments, t_mask, v_mask


def legacy_path(seed):
    """Phase 16a: ``BertForMultiModalPreTraining`` and ``VILBertForVLTasks``
    (``lily_base_config``, random weights from the seed, bf16) on 32 rows x
    (60 + 808) tokens: an eval forward of each (6 + 6 launches of B1/B2 per
    call) and a train-mode forward and backward of each at dropout 0.1 (6
    launches of each of B1-B4 per call); the eval outputs against
    ``plain_launchers()`` (the same argmax of the classifier; in bf16 the
    error against the f32 plain path at most twice the plain path's; in
    f32 within 1e-4) and the f32 train-mode gradients at 8 rows within
    1e-3 relative L2.  Returns the launches of the two runs."""
    import numpy as np
    import torch
    from youtube_vln_tpu_torch import lily_base_config
    from youtube_vln_tpu_torch.models.legacy import (BertForMultiModalPreTraining,
                                                     VILBertForVLTasks)
    from youtube_vln_tpu_torch.ops import attention as A

    cfg = lily_base_config(compute_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    pre = BertForMultiModalPreTraining(cfg).init_weights(seed).eval()
    vl = VILBertForVLTasks(cfg, VQA_LABELS, VQA_HIDDEN).init_weights(seed + 1).eval()
    batch = [torch.from_numpy(x).cuda() for x in
             legacy_batch(np.random.default_rng(seed), LEGACY_ROWS, cfg.vocab_size)]
    names = ("mlm", "vision", "seq_relationship", "vl_logits")

    def outputs(dtype="bfloat16", plain=False):
        cfg.compute_dtype = dtype
        try:
            with torch.inference_mode(), (plain_launchers() if plain
                                          else contextlib.nullcontext()):
                return [*pre(*batch), vl(*batch)]
        finally:
            cfg.compute_dtype = "bfloat16"

    outputs()                                            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    kernel = outputs()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches_eval = counts()
    print(f"launches on the legacy heads' eval path (2 calls): {launches_eval}")
    for name, per in (("attention_fwd", cfg.v_num_hidden_layers),
                      ("bi_attention_fwd", len(cfg.v_biattention_id))):
        if launches_eval[name] != 2 * per:
            fail(f"legacy eval: {name} launched {launches_eval[name]} times, "
                 f"expected {per} x 2")
    if any(launches_eval[n] for n in ("attention_bwd", "bi_attention_bwd",
                                      "epilogue_fwd", "epilogue_bwd")):
        fail(f"legacy eval: a backward or epilogue kernel launched: {launches_eval}")
    shapes = [(LEGACY_ROWS, S_T, cfg.vocab_size), (LEGACY_ROWS, L * BOXES, cfg.v_target_size),
              (LEGACY_ROWS, 2), (LEGACY_ROWS, VQA_LABELS)]
    for name, o, shape in zip(names, kernel, shapes):
        if tuple(o.shape) != shape or o.dtype != torch.float32:
            fail(f"legacy {name}: {tuple(o.shape)} {o.dtype}, expected {shape} float32")

    plain = outputs(plain=True)
    exact = outputs("float32", plain=True)
    errors = {}
    for name, k32, p32 in zip(names, outputs("float32"), exact):
        errors[f"{name}_f32"] = check(f"legacy {name}, kernel vs plain path, f32", k32,
                                      p32, 1e-4)
    for name, k, p, e in zip(names, kernel, plain, exact):
        k_err = float((k - e).abs().max())
        p_err = float((p - e).abs().max())
        errors[f"{name}_bf16"] = k_err
        print(f"check legacy {name}, bf16 against f32: kernel {k_err:.3e} (tol "
              f"{2 * p_err:.3e} = 2 x plain {p_err:.3e})")
        if not (torch.isfinite(k).all() and k_err <= 2 * p_err):
            fail(f"legacy {name}: the kernel path's bf16 error exceeds twice the plain path's")
    k, p = kernel[3], plain[3]
    path_err = float((k - p).abs().max())
    top2 = p.topk(2, dim=-1).values
    differ = k.argmax(-1) != p.argmax(-1)
    if bool((differ & (top2[:, 0] - top2[:, 1] > 2 * path_err)).any()):
        fail("legacy VL classifier: argmax differs between the kernel and plain paths")
    print(f"legacy VL classifier argmax: {int((~differ).sum())} of {LEGACY_ROWS} rows equal "
          f"(the others within a tie of 2 x {path_err:.2e})")
    del kernel, plain, exact

    # train mode at dropout 0.1: forward and backward of each head
    pre.train()
    vl.train()

    def loss_of(outs):
        outs = outs if isinstance(outs, (tuple, list)) else [outs]
        return sum(o.float().square().mean() for o in outs)

    for m in (pre, vl):                                  # warm-up
        loss_of(m(*batch, seed=LEGACY_SEED)).backward()
        m.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for m in (pre, vl):
        loss_of(m(*batch, seed=LEGACY_SEED)).backward()
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    launches_train = counts()
    check_launches(cfg, launches_train, 2, "legacy heads' train path")
    for m in (pre, vl):
        for n, prm in m.named_parameters():
            if prm.grad is not None and not bool(torch.isfinite(prm.grad).all()):
                fail(f"legacy train: non-finite gradient of {n}")
        m.zero_grad(set_to_none=True)

    small = [t[:LEGACY_GRAD_ROWS] for t in batch]
    grad_err = {}
    for tag, m in (("pretraining", pre), ("vl_tasks", vl)):
        params = [prm for prm in m.parameters() if prm.requires_grad]

        def grads(plain):
            cfg.compute_dtype = "float32"
            A.reset_launch_counts()
            try:
                with plain_launchers() if plain else contextlib.nullcontext():
                    g = torch.autograd.grad(loss_of(m(*small, seed=LEGACY_SEED)), params,
                                            allow_unused=True)
            finally:
                cfg.compute_dtype = "bfloat16"
            what = f"legacy {tag} gradient check ({'plain' if plain else 'kernel'} path)"
            if plain and any(A.LAUNCHES.values()):
                fail(f"{what}: kernels launched: {dict(A.LAUNCHES)}")
            if not plain:
                check_launches(cfg, dict(A.LAUNCHES), 1, what)
            return [torch.zeros_like(q) if x is None else x for q, x in zip(params, g)]

        gk, gp = grads(False), grads(True)
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(gk, gp))
        den = sum(float((b ** 2).sum()) for b in gp)
        grad_err[tag] = (num / den) ** 0.5
        print(f"check legacy {tag} gradients, f32, dropout 0.1, kernel vs plain path: "
              f"relative L2 {grad_err[tag]:.3e} (tol 1e-3)")
        if not grad_err[tag] <= 1e-3:
            fail(f"legacy {tag}: kernel and plain gradients disagree")
        del gk, gp
    print(json.dumps({
        "legacy": "BertForMultiModalPreTraining + VILBertForVLTasks(3129), "
                  "lily_base_config, bf16, 32 x (60 + 808) tokens",
        "eval_ms_both_heads": eval_ms, "train_fwd_bwd_ms_both_heads": train_ms,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "max_abs_err": errors, "grad_rel_l2_f32": grad_err,
        "launches_eval": launches_eval, "launches_train": launches_train}))
    del pre, vl, batch, small
    torch.cuda.empty_cache()
    return {n: launches_eval[n] + launches_train[n] for n in launches_eval}


# ---------------------------------------------------------------------------
# phase 16: the offline dataset pipeline's models at full width
# ---------------------------------------------------------------------------
PIPE_VIDEOS, PIPE_FRAMES, PIPE_H, PIPE_W = 2, 48, 720, 1280  # 720p tours at 1 fps
PIPE_HEAD_STEPS, PIPE_HEAD_BATCH = 20, 32
PIPE_CPU_FRAMES = 2                # frames per model held against the CPU
PIPE_KEYFRAME_EVERY = 4


def load_frame(path):
    """The phase's image loader (PIL is absent on the card machine): the
    frames are ``np.save`` arrays under ``####.jpg`` names."""
    import numpy as np
    return np.load(path)


def write_pipeline_frames(root, rng):
    """PIPE_VIDEOS folders of PIPE_FRAMES uint8 720 x 1280 RGB frames; the
    frame after a camera action is brightened by 50 x the action (0-2), so
    the inverse head has something to learn.  Returns the actions."""
    import numpy as np
    actions = {}
    for v in range(PIPE_VIDEOS):
        vid = f"video{v}"
        d = root / vid
        d.mkdir(parents=True)
        base = rng.integers(0, 150, (PIPE_H, PIPE_W, 3), dtype=np.uint8)
        acts = rng.integers(0, 3, PIPE_FRAMES - 1)
        for i in range(PIPE_FRAMES):
            frame = np.roll(base, 16 * i, axis=1) + np.uint8(50 * (acts[i - 1] if i else 0))
            with open(d / ("%04d.jpg" % (i + 1)), "wb") as f:
                np.save(f, frame)
        actions[vid] = acts
    return actions


def cpu_copy(model, make):
    """``make(device="cpu")`` loaded with ``model``'s weights."""
    twin = make(device="cpu")
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return twin


def cpu_check(errors, key, what, got, want):
    """A card output against the same port code on the CPU: max |card -
    CPU| within 1e-4 of the CPU output's largest value; records the ratio."""
    scale = float(want.float().abs().max())
    err = check(f"pipeline {what}, card vs CPU", got, want.to(got.device), 1e-4,
                floor=0.0, verbose=False)
    errors[key] = err / scale if scale else err
    return errors[key]


def pipeline_path(seed):
    """Phase 16: steps 3-10 of the dataset recipe on 2 synthetic videos x
    48 frames of 720 x 1280 (a 720p house tour at 1 fps), every model at
    its published width with random weights from the seed, f32: 5a
    ``run_indoor_filter`` (WideResNet-18 Places365, batch 64), 5b
    ``run_maskrcnn_filter`` (AlexNet Places365, batch 32, and Mask R-CNN
    R50-FPN at min 800 / max 1333), 6 ``build_clip_tsv`` (ViT-B/32, batch
    64), text features of seeded token ids and ``clip_captions.run``, 7-8
    ``encode_frames``, 20 Adam steps of the inverse head at batch 32,
    ``predict_actions``, ``write_action_profiles``, 3-4 ``run_extraction``
    and ``convert_tsv_to_store``, 9-10 the records, photo merging, the
    frozen testset and a Loader batch of the port's ``YTbDataset``.  Fatal:
    a non-finite output, an artifact not read back, a head loss that does
    not fall, a card output off the same code on the CPU by more than 1e-4
    of its largest value (2 frames per model)."""
    import numpy as np
    import torch
    from youtube_vln_tpu_torch.config import RunConfig
    from youtube_vln_tpu_torch.data.datasets import YTbDataset
    from youtube_vln_tpu_torch.data.features_reader import YTbFeaturesReader
    from youtube_vln_tpu_torch.data.fixtures import write_fixture_vocab
    from youtube_vln_tpu_torch.data.loader import Loader
    from youtube_vln_tpu_torch.data.store import Store
    from youtube_vln_tpu_torch.pipeline import (build_dataset, clip_captions, clip_model,
                                                detector, extraction, filters,
                                                inverse_action, maskrcnn, merge_photos,
                                                places365)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    root = Path(tempfile.mkdtemp(prefix="pipeline_"))
    frames_dir = root / "raw_frames"
    true_actions = write_pipeline_frames(frames_dir, rng)
    vids = sorted(true_actions)
    n_frames = PIPE_VIDEOS * PIPE_FRAMES
    torch.cuda.reset_peak_memory_stats()
    stage_s, errors = {}, {}

    def timed(stage, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage_s[stage] = time.perf_counter() - t0
        return out

    def frames_of(vid):
        return np.stack([load_frame(p) for p in sorted((frames_dir / vid).glob("*.jpg"))])

    def finite(name, x):
        if not np.isfinite(np.asarray(x, np.float64)).all():
            fail(f"pipeline {name}: non-finite values")

    two = frames_of(vids[0])[:PIPE_CPU_FRAMES]

    # 5a: WideResNet-18 Places365 (every class indoor: the vote keeps every
    # frame, so the chain below has frames whatever the random weights say)
    wrn = places365.WideResNet18(365).init_weights(seed)
    labels_io = np.zeros(365)
    wrn_cpu = cpu_copy(wrn, lambda device: places365.WideResNet18(365, device=device))
    with torch.inference_mode():
        got = places365.places_forward(wrn, places365.preprocess_images(two))
        want = places365.places_forward(wrn_cpu, places365.preprocess_images(two, device="cpu"))
    for name, g, w in zip(("logits", "layer4", "pooled"), got, want):
        cpu_check(errors, f"places_{name}", f"Places365 {name}", g, w)
    n = timed("5a_indoor_filter", lambda: filters.run_indoor_filter(
        frames_dir, root / "indoor_frames", wrn, labels_io, image_loader=load_frame,
        batch_size=64))
    indoor_by_video = {}
    for vid in vids:
        rows = (root / "indoor_frames" / vid / "indoor.tsv").read_text().splitlines()
        indoor_by_video[vid] = [int(r.split("\t")[1]) for r in rows]
        if len(rows) != PIPE_FRAMES or not (root / "indoor_frames" / vid
                                            / "indoor_order.tsv").exists():
            fail(f"5a: {vid}: {len(rows)} indoor rows, expected {PIPE_FRAMES}")
    if n != PIPE_VIDEOS:
        fail(f"5a: {n} videos")

    # 5b: AlexNet Places365 + Mask R-CNN R50-FPN.  Held against the CPU
    # first; then its last layer is scaled by 0.01 and the biases of 5
    # indoor classes raised by 8, so they take the top of the softmax, the
    # top-10 indoor mass passes the vote and the chain below keeps frames
    alex = places365.AlexNet(365).init_weights(seed + 1)
    alex_cpu = cpu_copy(alex, lambda device: places365.AlexNet(365, device=device))
    with torch.inference_mode():
        cpu_check(errors, "alexnet_logits", "AlexNet logits",
                  alex(places365.preprocess_images_crop(two)),
                  alex_cpu(places365.preprocess_images_crop(two, device="cpu")))
    del alex_cpu
    is_indoor = rng.random(365) < 0.5
    with torch.no_grad():
        alex.classifier[6].weight.mul_(0.01)
        alex.classifier[6].bias[torch.from_numpy(np.flatnonzero(is_indoor)[:5]).cuda()] += 8.0
    det = maskrcnn.MaskRCNNDetector(maskrcnn.MaskRCNN().init_weights(seed + 2))
    det_cpu = maskrcnn.MaskRCNNDetector(cpu_copy(det.model, maskrcnn.MaskRCNN),
                                        device="cpu")
    for i, img in enumerate(two):
        with torch.inference_mode():
            x, hw, _ = det._preprocess(img, True)
            x_cpu, _, _ = det_cpu._preprocess(img, True)
            feats = maskrcnn.backbone_fpn(det.model, x[None])
            feats_cpu = maskrcnn.backbone_fpn(det_cpu.model, x_cpu[None])
            levels = maskrcnn.rpn_head(det.model, feats)
            levels_cpu = maskrcnn.rpn_head(det_cpu.model, feats_cpu)
            for lvl, (f, fc, (o, d), (oc, dc)) in enumerate(zip(feats, feats_cpu, levels,
                                                                 levels_cpu)):
                cpu_check(errors, f"fpn_p{lvl + 2}_{i}", f"FPN P{lvl + 2}", f, fc)
                cpu_check(errors, f"rpn_obj_p{lvl + 2}_{i}", f"RPN objectness P{lvl + 2}",
                          o, oc)
                cpu_check(errors, f"rpn_deltas_p{lvl + 2}_{i}", f"RPN deltas P{lvl + 2}",
                          d, dc)
            proposals = det._proposals([(o.cpu(), d.cpu()) for o, d in levels], hw,
                                       tuple(x.shape[1:]))
            cls_g, box_g = maskrcnn.box_head(det.model, det._pool(feats, proposals))
            cls_c, box_c = maskrcnn.box_head(det_cpu.model, det_cpu._pool(feats_cpu, proposals))
        cpu_check(errors, f"box_logits_{i}", "box-head logits", cls_g, cls_c)
        cpu_check(errors, f"box_deltas_{i}", "box-head deltas", box_g, box_c)
        print(f"pipeline Mask R-CNN frame {i}, {len(proposals)} proposals, card vs CPU: "
              f"largest error / largest value {max(errors.values()):.3e} (tol 1e-4)")
    del det_cpu
    det_times = []
    real_detect = det.detect

    def detect(image, resize=True):
        out = real_detect(image, resize)
        det_times.append(det.last_timing)
        finite("Mask R-CNN boxes", out["boxes"])
        return out

    det.detect = detect
    n = timed("5b_maskrcnn_filter", lambda: filters.run_maskrcnn_filter(
        frames_dir, root / "maskrcnn", alex, is_indoor, det, image_loader=load_frame,
        batch_size=32))
    maskrcnn_by_video = {vid: filters.load_maskrcnn_filters(root / "maskrcnn" / vid
                                                            / f"{vid}.json") for vid in vids}
    if n != PIPE_VIDEOS or any(set(m) != {"indoor_locs", "person_locs"}
                               for m in maskrcnn_by_video.values()):
        fail(f"5b: {n} videos, artifacts {maskrcnn_by_video}")

    # 6: CLIP ViT-B/32 frame features, prompt features of seeded token ids
    clip = clip_model.ClipModel().init_weights(seed + 3)
    clip_cpu = cpu_copy(clip, clip_model.ClipModel)
    with torch.inference_mode():
        cpu_check(errors, "clip_image", "CLIP image features",
                  clip_model.clip_image_features(clip, clip_model.preprocess_images(two)),
                  clip_model.clip_image_features(
                      clip_cpu, clip_model.preprocess_images(two, device="cpu")))
    n = timed("6_clip_tsv", lambda: clip_model.build_clip_tsv(
        clip, frames_dir, root / "CLIP-ViT-B-32-views.tsv", image_loader=load_frame,
        batch_size=64))
    exist, clip_feats = clip_model.read_clip_tsv(root / "CLIP-ViT-B-32-views.tsv")
    if n != n_frames or len(clip_feats) != n_frames:
        fail(f"6: {n} rows written, {len(clip_feats)} read back")
    finite("CLIP features", np.concatenate(list(clip_feats.values())))
    prompts = [clip_captions.PROMPT.format(c)
               for c in clip_captions.AREAS + clip_captions.OBJECTS]
    ids = np.zeros((len(prompts), clip.cfg.context_length), np.int64)
    for r in range(len(prompts)):       # [SOT] words [EOT], the EOT the largest id
        n_words = int(rng.integers(4, 9))
        ids[r, 0] = clip.cfg.vocab_size - 2
        ids[r, 1:1 + n_words] = rng.integers(1, clip.cfg.vocab_size - 2, n_words)
        ids[r, 1 + n_words] = clip.cfg.vocab_size - 1
    token_of = dict(zip(prompts, ids))
    text = clip_model.text_features(clip, ids)
    finite("CLIP text features", text)
    cpu_check(errors, "clip_text", "CLIP text features", torch.from_numpy(text).cuda(),
              torch.from_numpy(clip_model.text_features(clip_cpu, ids, device="cpu")))
    del clip_cpu
    frames_by_video = {vid: {int(k.split("_")[-1][:4]): v[0] for k, v in clip_feats.items()
                             if k.startswith(vid + "_")} for vid in vids}
    n = clip_captions.run(frames_by_video,
                          lambda ps: clip_model.text_features(
                              clip, np.stack([token_of[p] for p in ps])),
                          root / "CLIP_captioned_images")
    captions_by_video = {vid: json.loads((root / "CLIP_captioned_images" / vid
                                          / "captions_SE.json").read_text()) for vid in vids}
    if n != n_frames or sum(map(len, captions_by_video.values())) != n_frames:
        fail(f"6: {n} frames captioned")

    # 7-8: frozen ResNet-18 features, the inverse head, the profiles
    feats_by_video = {}
    for vid in vids:
        images = frames_of(vid)
        t0 = time.perf_counter()
        feats_by_video[vid] = inverse_action.encode_frames(wrn, images, batch_size=64)
        torch.cuda.synchronize()
        stage_s["7_encode_frames"] = stage_s.get("7_encode_frames", 0.0) + time.perf_counter() - t0
        finite("ResNet-18 features", feats_by_video[vid])
    fk = np.concatenate([feats_by_video[v][:-1] for v in vids])
    fk1 = np.concatenate([feats_by_video[v][1:] for v in vids])
    y = np.concatenate([true_actions[v] for v in vids])
    pick = np.random.default_rng(seed + 4)

    def pairs():
        while True:
            sel = pick.integers(0, len(fk), PIPE_HEAD_BATCH)
            yield fk[sel], fk1[sel], y[sel]

    inverse_action.train_inverse_model(pairs(), steps=2, feat_channels=512, seed=seed)
    head, losses = timed("7_head_train", lambda: inverse_action.train_inverse_model(
        pairs(), steps=PIPE_HEAD_STEPS, lr=1e-3, feat_channels=512, seed=seed))
    finite("inverse-head losses", losses)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"inverse head: loss {first:.4f} -> {last:.4f} (mean of the first and last 5 of "
          f"{PIPE_HEAD_STEPS} steps)")
    if not last < first:
        fail("the inverse head's loss did not fall")
    head_cpu = cpu_copy(head, lambda device: inverse_action.InverseActionHead(512, device=device))
    sel = slice(0, PIPE_CPU_FRAMES)
    with torch.inference_mode():
        cpu_check(errors, "inverse_logits", "inverse-head logits",
                  head(torch.from_numpy(fk[sel]).cuda(), torch.from_numpy(fk1[sel]).cuda()),
                  head_cpu(torch.from_numpy(fk[sel]), torch.from_numpy(fk1[sel])))
    keyframes = list(range(1, PIPE_FRAMES + 1, PIPE_KEYFRAME_EVERY))
    actions_by_video = {}
    for vid in vids:
        names = timed("8_predict", lambda: inverse_action.predict_actions(
            head, list(feats_by_video[vid])))
        if len(names) != PIPE_FRAMES - 1 or not set(names) <= set(inverse_action.ACTIONS):
            fail(f"8: {len(names)} predicted actions")
        actions_by_video[vid] = {f: names[f - 1] for f in keyframes[:-1]}
        path = inverse_action.write_action_profiles(
            root / "profiles", vid, {"0": keyframes}, actions_by_video[vid],
            captions_by_video[vid])
        if len(json.loads(path.read_text())[0]) != len(keyframes) - 1:
            fail(f"8: {path} not read back")
    accuracy = float(np.mean([n == inverse_action.ACTION_MAP[int(a)] for vid in vids
                              for n, a in zip(inverse_action.predict_actions(
                                  head, list(feats_by_video[vid])), true_actions[vid])]))

    # 3-4: sharded region-feature TSVs (the seeded stand-in detector) -> store
    n = timed("3_extraction", lambda: extraction.run_extraction(
        frames_dir, root / "img_features",
        lambda sid: detector.RandomProposalExtractor(num_boxes=36, seed=sid),
        num_splits=2, num_workers=0, image_loader=load_frame))
    shards = sorted((root / "img_features").glob("*.tsv"))
    store_path = root / "ytb_features.vlnstore"
    m = timed("4_convert_tsv", lambda: detector.convert_tsv_to_store(shards, store_path))
    store = Store(store_path)
    n_store = len(store)
    store.close()
    if not n == m == n_store == n_frames:
        fail(f"3-4: {n} rows extracted, {m} converted, {n_store} in the store")

    # 9-10: records, photo merging, frozen testset, a Loader batch
    records = build_dataset.assemble_records(
        vids, captions_by_video, actions_by_video, indoor_by_video=indoor_by_video,
        maskrcnn_by_video=maskrcnn_by_video,
        trajectory_by_video={vid: keyframes for vid in vids})
    by_video = build_dataset.preprocess_records(records, min_caption=2, min_length=4)
    if not by_video:
        fail(f"9: no video survived the filters ({len(records)} records)")
    build_dataset.write_preprocessed(by_video, root / "pre", "ytb_train")
    flat = [r for items in by_video.values() for r in items]
    for r in flat:
        r["room"] = captions_by_video[r["video_id"]]["%04d.jpg" % r["frame_id"]][0] \
            .split(" with ")[0]
    caption_path = root / "merge+ytb_train.json"
    caption_path.write_text(json.dumps(merge_photos.merge_dataset(flat, "max", 4)))
    templates = [{"instructions": [" and turn [OMASK] ".join(["walk into the [MASK]"] * k)
                                   + " ."]} for k in range(1, 8)]
    (root / "templates.json").write_text(json.dumps(templates))
    tok = write_fixture_vocab(root / "vocab.txt")
    args = RunConfig(pretrain=True, pre_dataset="ytb", ranking=True, masked_vision=True,
                     masked_language=True, max_instruction_length=32, max_path_length=4,
                     max_num_boxes=36, min_path_length=3, min_captioned=2,
                     max_captioned=4, num_negatives=2, shuffler="different",
                     negative_style="normal", skeleton_path=str(root / "templates.json"))
    reader = YTbFeaturesReader(store_path)
    try:
        ds = YTbDataset(args=args, caption_path=caption_path, tokenizer=tok,
                        features_reader=reader, masked_vision=True, masked_language=True,
                        training=True, seed=seed)
        frozen = json.loads(build_dataset.freeze_testset(ds, root / "merge+testset.json")
                            .read_text())
        batch = next(iter(Loader(ds, batch_size=min(2, len(ds)), shuffle=True, seed=seed)))
    finally:
        reader.close()
    if set(frozen) != set(ds.listing_ids) or batch["instr_tokens"].shape[1:] != (7, 32):
        fail(f"9-10: testset {len(frozen)} listings, batch {batch['instr_tokens'].shape}")
    for k, v in batch.items():
        if np.asarray(v).dtype.kind == "f":
            finite(f"Loader batch {k}", v)

    dev = [t["device_s"] for t in det_times]
    host = [t["host_s"] for t in det_times]
    out = {
        "pipeline": "steps 3-10 on 2 videos x 48 frames of 720 x 1280, f32, random "
                    "weights from the seed",
        "frames": n_frames,
        "frames_per_s": {k: n_frames / stage_s[k] for k in (
            "5a_indoor_filter", "5b_maskrcnn_filter", "6_clip_tsv", "7_encode_frames",
            "3_extraction", "4_convert_tsv")},
        "stage_s": stage_s,
        "maskrcnn_ms_per_frame": {"device": 1e3 * float(np.mean(dev)),
                                  "host": 1e3 * float(np.mean(host)), "frames": len(dev)},
        "head_ms_per_step": 1e3 * stage_s["7_head_train"] / PIPE_HEAD_STEPS,
        "head_losses": losses, "head_accuracy_on_the_frames": accuracy,
        "records": len(records), "videos_kept": len(by_video), "listings": len(frozen),
        "card_vs_cpu_err_over_largest_value": max(errors.values()),
        "card_vs_cpu_worst": max(errors, key=errors.get),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "phase_s": time.perf_counter() - t_phase}
    print(json.dumps(out))
    shutil.rmtree(root, ignore_errors=True)
    del wrn, alex, det, clip, head
    torch.cuda.empty_cache()


TOOLS_STEPS, TOOLS_WINDOWS = 3, 2   # timed steps per window of phase 17's benches
# bench_e2e's fixture, one item per video: 10 batches of 8 per epoch, the
# first 2 stepped before its steady-state window of 8
TOOLS_E2E_VIDEOS, TOOLS_E2E_STEPS = 80, 8


def run_tool(name, main, argv):
    """``main(argv)`` of a tool entry in this process; its own check failing
    (a non-zero exit) fails the run."""
    print(f"tool: python -m youtube_vln_tpu_torch.entries.{name} {' '.join(argv)}",
          flush=True)
    try:
        return main(argv)
    except SystemExit as e:
        fail(f"{name}: exited with {e.code}")


def tools_path(seed, run_a):
    """Phase 17: the port's tools on the card, as a user runs them.
    ``check_kernels`` (a)-(e) first, outside the counted path; then, with
    the launch counts reset, ``profile_step full full_epi --recipe 30rs
    --table`` (the per-op table of the 30RS step, the ``profile`` line),
    ``bench_serving --dedup`` and ``bench``, a few timed windows each,
    ``bench_e2e`` (its second epoch's start-up, then 8 steady-state
    Loader-fed steps with 3 workers) on the candidate-dedup transport and
    on the dense one, ``bench_loader`` (YTb
    items and the Loader) and ``bench_loader --eval``, and ``northstar`` on
    phase 4b's fixture and weights, expecting run A's SR and SPL.  Returns
    the launch counts of the counted tools."""
    import numpy as np
    import torch
    from youtube_vln_tpu_torch.entries import (bench, bench_e2e, bench_loader,
                                               bench_serving, check_kernels,
                                               northstar, profile_step)

    checks = check_kernels.run_checks("cuda")
    print(json.dumps({"check_kernels": checks}))
    if checks["failures"]:
        fail(f"check_kernels: {checks['failures']}")
    want = ("skipped (1 device)" if torch.cuda.device_count() == 1
            else f"ok ({torch.cuda.device_count()} devices")
    if not checks["multichip_dropout"].startswith(want):
        fail(f"check_kernels (e): {checks['multichip_dropout']}")
    torch.cuda.empty_cache()

    reset_counts()
    steps = ["--steps", str(TOOLS_STEPS)]
    prof = run_tool("profile_step", profile_step.main,
                    ["full", "full_epi", "--recipe", "30rs", "--table"] + steps)
    table = prof["table"]
    if not (table["ops"] and table["kernels"] and 0 < table["device_busy_ms"]
            <= table["wall_ms"]):
        fail(f"profile_step: no device time in the traced 30RS step: {table}")
    torch.cuda.empty_cache()
    serving = run_tool("bench_serving", bench_serving.main,
                       ["--dedup", "--dispatches", "6", "--windows", str(TOOLS_WINDOWS)])
    torch.cuda.empty_cache()
    headline = run_tool("bench", bench.main,
                        steps + ["--windows", str(TOOLS_WINDOWS), "--eval_dispatches", "6"])
    torch.cuda.empty_cache()
    e2e = {}
    for transport, flag in (("dedup", "--dedup"), ("dense", "--no-dedup")):
        e2e[transport] = run_tool("bench_e2e", bench_e2e.main, [
            "--steps", str(TOOLS_E2E_STEPS), "--num_workers", "3", "--n_videos",
            str(TOOLS_E2E_VIDEOS), flag])
        torch.cuda.empty_cache()
    loader = {"ytb": run_tool("bench_loader", bench_loader.main, []),
              "eval": run_tool("bench_loader", bench_loader.main,
                               ["--eval", "--items", "4"])}
    paths = run_a["paths"]
    star = run_tool("northstar", northstar.main, [
        "--data_dir", paths["data_dir"], "--img_feature", paths["store_path"],
        "--from_pretrained", str(Path(run_a["root"]) / "lily_base_seed.bin"),
        "--config_file", str(REPO / "configs" / "bert_base_6_layer_6_connect.json"),
        "--bert_tokenizer", paths["vocab_path"], "--split", run_a["split"],
        "--output_dir", str(Path(run_a["root"]) / "result"),
        "--expected_sr", repr(run_a["sr"]), "--expected_spl", repr(run_a["spl"]),
        "--tolerance_pts", "0.01", "--device", "cuda", "--extra", "--seed", str(seed)])
    launches = counts()
    print(f"launches on the tools path: {launches}")
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        fail(f"tools path: {idle} never launched")
    if star["northstar"] != "PASS":
        fail(f"northstar: {star['northstar']} against run A's SR {run_a['sr']} "
             f"and SPL {run_a['spl']}")
    for name, line in (("bench_serving", serving), ("bench", headline),
                       ("bench_e2e", e2e["dedup"]), ("bench_e2e", e2e["dense"]),
                       ("bench_loader", loader["ytb"]), ("bench_loader", loader["eval"])):
        if not (np.isfinite(line["value"]) and line["value"] > 0):
            fail(f"{name}: {line['value']} {line['unit']}")
    print(json.dumps({"tools": {
        "profile_step_ms": prof["profile_step"],
        "profile_busy_ms": table["device_busy_ms"],
        "profile_idle_share": table["device_idle_share"],
        "serving_beams_per_s": {k: v["beams_per_s"] for k, v in
                                serving["detail"].items() if isinstance(v, dict)},
        "bench_traj_per_s": headline["value"],
        "bench_step_ms": headline["detail"]["step_ms"],
        "bench_mfu": headline["detail"]["mfu"],
        "e2e_traj_per_s": {k: v["value"] for k, v in e2e.items()},
        "e2e_epoch_start_ms": {k: v["detail"]["epoch_start_ms"] for k, v in e2e.items()},
        "e2e_device_only_traj_per_s": {k: v["detail"]["device_only_traj_per_s"]
                                       for k, v in e2e.items()},
        "e2e_host_batch_bytes": {k: v["detail"]["host_batch_bytes"]
                                 for k, v in e2e.items()},
        "e2e_slab_overflow": {k: v["detail"]["slab_overflow"] for k, v in e2e.items()},
        "loader_traj_per_s": loader["ytb"]["value"],
        "loader_eval_ms": {k: loader["eval"]["detail"][f"{k}_assembly_ms_per_instruction"]
                           for k in ("dense", "dedup")},
        "northstar": star["northstar"], "sr": star["metrics"]["success_rate"],
        "spl": star["metrics"]["spl"]}}))
    return launches


# what a child of phase 14 or 15 runs, by kind
CHILD_RUNS = {"entry": child_entry, "mrt": child_mrt, "tp_mrt": child_tp_mrt}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    ap.add_argument("--ddp-child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (REPO / "youtube_vln_tpu_torch" / "ops" / "csrc").is_dir():
        fail(f"the youtube_vln_tpu_torch package is not beside {__file__}")
    if args.ddp_child:
        return ddp_child(args.ddp_child)
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    with phase_timer("2 build"):
        occupancy = build_kernels()
    with phase_timer("3 forward checks"):
        eval_rows = kernel_checks(args.seed)
        edge_checks(args.seed)
    with phase_timer("4 eval path"):
        launches_eval, synthetic_ms = main_path(args.seed)
    # phase 4b's R2R fixture and weights, read again by phase 17
    r2r_root = tempfile.TemporaryDirectory(prefix="r2r_fixture_")
    with phase_timer("4b test entry"):
        launches_entry, run_a = entry_path(args.seed, synthetic_ms, r2r_root.name)
    with phase_timer("5-8 train checks and path"):
        rows = train_kernel_checks(args.seed)
        launches_train = train_path(args.seed)
    with phase_timer("9-12 epilogue checks and pretraining path"):
        rows.update(epilogue_kernel_checks(args.seed))
        launches_pretrain = pretrain_path(args.seed)
    with phase_timer("13-15 training entries, ddp, tp"):
        (launches_train_entry, launches_pretrain_entry, launches_ddp,
         launches_tp) = train_entry_path(args.seed)
    with phase_timer("16a legacy heads"):
        launches_legacy = legacy_path(args.seed)
    with phase_timer("16 pipeline"):
        pipeline_path(args.seed)
    with phase_timer("17 tools"):
        launches_tools = tools_path(args.seed, run_a)
    r2r_root.cleanup()
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, row in rows.items():
        row["launches_eval"] = launches_eval[name]
        row["launches_train"] = launches_train[name]
        row["launches_pretrain"] = launches_pretrain[name]
        row["launches_entry"] = launches_entry[name]
        row["launches_train_entry"] = launches_train_entry[name]
        row["launches_pretrain_entry"] = launches_pretrain_entry[name]
        row["launches_ddp"] = launches_ddp[name]
        row["launches_tp"] = launches_tp[name]
        row["launches_legacy"] = launches_legacy[name]
        row["launches_tools"] = launches_tools[name]
        row["launches"] = (launches_eval[name] + launches_train[name]
                           + launches_pretrain[name] + launches_entry[name]
                           + launches_train_entry[name] + launches_pretrain_entry[name]
                           + launches_ddp[name] + launches_tp[name]
                           + launches_legacy[name] + launches_tools[name])
        if name in eval_rows:
            row["eval_shape"] = {k: eval_rows[name][k] for k in keys}
        row.update(occupancy.get(name, {}))
    print(json.dumps({"phase_s": PHASE_S}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
