#!/usr/bin/env python3
"""Device time of the kernels B1-B6 of one checkout of this repository on
one CUDA card, for comparing two checkouts.

    python3 kernel_timing.py [--tree DIR]

DIR is a checkout (default: the one holding this script), for example an
earlier commit unpacked with ``git archive`` into an ignored directory.
The script builds DIR's kernels (into DIR's ``build/kernels``) and times
DIR's launchers in ``youtube_vln_tpu_torch/ops/attention.py`` and
``ops/epilogue.py`` at the shapes of ``chip_smoke.py``, inputs from seed 0:

  * eval: B1 over [30, 8, 808, 808] and B2 over 60 <-> 808, no dropout,
    bf16, D = 128, laid out as the model makes them (split_heads views, a
    key bias with ~10% of the keys at -10000 and one fully masked row);
  * train: B1 with the LSE output, B3, B2 with the LSE outputs and B4 at
    B*H = 96 x 8, dropout 0.1;
  * pretrain: B5 and B6 at the vision epilogue sites of a pretraining
    step, [45,248, 1024] bf16, dropout 0.1.

Each time is the mean of 20 launches after 3 warm-up launches, between
two CUDA events; B5 comes with a ``torch.add`` moving its bytes (a
memory-rate yardstick) and B6 also runs without dropout (no Philox
draws).  It prints one JSON line: the tree, the card's name and power
limit, and ms per launch by kernel.  Times vary by several percent
between calls: compare two trees within one call, in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# this checkout's harness, whatever tree is timed
from chip_smoke import (BOXES, HEADS, L, NC, PRE_B, PRE_NC, RATE, S_T, TRAIN_B, TRAIN_NC,
                        cuda_ms, heads_view, key_bias)

S_V, D, SEED = 808, 128, 0x5EED
ROWS = TRAIN_B * TRAIN_NC  # trajectories of one fine-tuning step
EPI_ROWS, EPI_D = PRE_B * PRE_NC * L * BOXES, 1024  # vision rows of a pretraining step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_timing: no CUDA device")
    sys.path.insert(0, str(args.tree.resolve()))
    from youtube_vln_tpu_torch.ops import attention as A
    from youtube_vln_tpu_torch.ops import epilogue as E

    gen = torch.Generator(device="cuda").manual_seed(0)

    def operand(b, s):
        return heads_view(gen, b, HEADS, s, D, torch.bfloat16)

    def bias(b, s):
        return key_bias(gen, b, s)

    ms = {}
    with torch.no_grad():
        # eval: no autograd, no dropout, no LSE
        q, k, v = (operand(NC, S_V) for _ in range(3))
        kb = bias(NC, S_V)
        ms["B1 eval"] = cuda_ms(lambda: A.fused_attention(q, k, v, kb))
        vis = [operand(NC, S_V) for _ in range(3)]
        txt = [operand(NC, S_T) for _ in range(3)]
        vb, tb = bias(NC, S_V), bias(NC, S_T)
        ms["B2 eval"] = cuda_ms(lambda: A.fused_bi_attention(*vis, *txt, vb, tb))
        del q, k, v, vis, txt

        # train: forward with LSE, dropout, and the backward
        q, k, v, do = (operand(ROWS, S_V) for _ in range(4))
        kb = bias(ROWS, S_V)
        out, lse, _ = A._attention_fwd(q, k, v, kb, RATE, SEED, True)
        ms["B1 train"] = cuda_ms(lambda: A._attention_fwd(q, k, v, kb, RATE, SEED, True))
        ms["B3 train"] = cuda_ms(lambda: A._attention_bwd(q, k, v, kb, out, do, lse,
                                                          RATE, SEED))
        del q, k, v, do, out, lse
        vis = [operand(ROWS, S_V) for _ in range(3)]
        txt = [operand(ROWS, S_T) for _ in range(3)]
        vb, tb = bias(ROWS, S_V), bias(ROWS, S_T)
        do1, do2 = operand(ROWS, S_T), operand(ROWS, S_V)
        c1, c2, l1, l2, _ = A._bi_attention_fwd(*vis, *txt, vb, tb, RATE, RATE, SEED, True)
        ms["B2 train"] = cuda_ms(lambda: A._bi_attention_fwd(*vis, *txt, vb, tb, RATE, RATE,
                                                             SEED, True))
        ms["B4 train"] = cuda_ms(lambda: A._bi_attention_bwd(
            *vis, *txt, vb, tb, c1, c2, l1, l2, do1, do2, RATE, RATE, SEED))
        del vis, txt, do1, do2, c1, c2, l1, l2

        # pretrain: the vision epilogue sites, B6 on the operands B5 read
        h, res, do = (torch.randn(EPI_ROWS, EPI_D, generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(3))
        w = 1.0 + 0.1 * torch.randn(EPI_D, generator=gen, device="cuda")
        b = 0.1 * torch.randn(EPI_D, generator=gen, device="cuda")
        _, ops = E._epilogue_fwd(h, res, w, b, RATE, SEED)
        ms["B5 pretrain"] = cuda_ms(lambda: E._epilogue_fwd(h, res, w, b, RATE, SEED))
        out = torch.empty_like(h)
        ms["torch.add, B5's bytes"] = cuda_ms(lambda: torch.add(h, res, out=out))
        ms["B6 pretrain"] = cuda_ms(lambda: E._epilogue_bwd(*ops, do, RATE, SEED))
        ms["B6 pretrain, no dropout"] = cuda_ms(lambda: E._epilogue_bwd(*ops, do, 0.0, SEED))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(json.dumps({"tree": str(args.tree), "card": smi.stdout.strip().splitlines()[0],
                      "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
