#!/usr/bin/env python3
"""Long-context attention on one CUDA card: the KV-tiled route (K6, K6b)
against plain math and SDPA (counterpart of `scripts/attn_bench.py`).

    python3 scripts/torch_attn_bench.py [--iters 10]

MiCo's cross-attention context grows as n_frames x 257: a 32-frame video is
8,224 tokens, past the resident kernel K2's MAX_RESIDENT_KV = 8192. There
`flash_attention` sends fewer than KV_TILED_MIN_Q = 128 query rows to plain
math and more to K6 (K6b under autograd); that threshold was measured on a
TPU. This script times, on bf16 inputs of unit std made from seed 0:

  - forward at attn_bench.py's shapes (B 64 x 12 heads at Lk 8224 with Lq
    40, 128 and 512; B 8 x 16 heads of 88 at Lq 1024, Lk 16384) and an Lq
    sweep at B 64, Lk 8224: K6 (`kv_tiled_attention`, no LSE), plain math
    (`plain_attention`, the route below the threshold) and SDPA (one
    PyTorch call, a yardstick the port never calls);
  - forward + backward of a sum of squares at attn_bench.py's backward
    shapes and the same Lq sweep: `flash_attention` under autograd with
    KV_TILED_MIN_Q set to 1 for the run, so that it takes K6 with LSE, then
    K6b, at every Lq; plain math under autograd; SDPA under autograd.

Each time is the mean of `--iters` calls by CUDA events after two warm-up
calls. Prints the card's name and power limit, one line per shape, the
smallest swept Lq at which the K6 route beats plain math forward and
forward + backward, and one JSON line. Runs from any working directory.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FWD_SHAPES = [
    # (label, b, h, lq, lk, d): scripts/attn_bench.py's
    ("32-frame BERT cross-attn (caption q-rows)", 64, 12, 40, 8224, 64),
    ("Lk=8224 at the threshold", 64, 12, 128, 8224, 64),
    ("Lk=8224 large-q", 64, 12, 512, 8224, 64),
    ("16k generic long context", 8, 16, 1024, 16384, 88),
]
BWD_SHAPES = [
    ("16k fwd+bwd", 2, 16, 1024, 16384, 88),
    ("Lk=8224 fwd+bwd large-q", 8, 12, 512, 8224, 64),
]
SWEEP_LQ = (16, 32, 40, 64, 96, 128, 192, 256)


def cuda_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attn_bench: needs a CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from mico_tpu_torch.ops import _build
    from mico_tpu_torch.ops import flash_attention as fa
    from mico_tpu_torch.ops.attention import plain_attention

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, h, lq, lk, d, grad=False):
        return [torch.randn(s, generator=gen, device="cuda",
                            dtype=torch.bfloat16).requires_grad_(grad)
                for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d))]

    def fwd_row(label, b, h, lq, lk, d):
        q, k, v = inputs(b, h, lq, lk, d)
        scale = d ** -0.5
        flops = 4 * b * h * lq * lk * d
        row = dict(label=label, shape=[b, h, lq, lk, d], flops=flops)
        with torch.no_grad():
            row["k6_ms"] = cuda_ms(
                lambda: fa.kv_tiled_attention(q, k, v, None, scale), args.iters)
            row["plain_ms"] = cuda_ms(
                lambda: plain_attention(q, k, v, scale=scale), args.iters)
            row["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), args.iters)
        print(f"fwd {label} {tuple(row['shape'])}: K6 {row['k6_ms']:.4f} ms "
              f"({flops / row['k6_ms'] / 1e9:.1f} TFLOP/s), plain "
              f"{row['plain_ms']:.4f}, SDPA {row['sdpa_ms']:.4f} "
              f"(plain / K6 {row['plain_ms'] / row['k6_ms']:.2f})", flush=True)
        return row

    def bwd_row(label, b, h, lq, lk, d):
        q, k, v = inputs(b, h, lq, lk, d, grad=True)
        scale = d ** -0.5

        def run(attn):
            out = attn(q, k, v)
            torch.autograd.grad(out.float().square().sum(), (q, k, v))

        row = dict(label=label, shape=[b, h, lq, lk, d],
                   flops=14 * b * h * lq * lk * d)   # 2 + 5 products
        row["k6_ms"] = cuda_ms(lambda: run(
            lambda q, k, v: fa.flash_attention(q, k, v, scale=scale)),
            args.iters)
        row["plain_ms"] = cuda_ms(lambda: run(
            lambda q, k, v: plain_attention(q, k, v, scale=scale)), args.iters)
        row["sdpa_ms"] = cuda_ms(lambda: run(
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                           scale=scale)),
            args.iters)
        print(f"fwd+bwd {label} {tuple(row['shape'])}: K6+K6b "
              f"{row['k6_ms']:.4f} ms, plain {row['plain_ms']:.4f}, SDPA "
              f"{row['sdpa_ms']:.4f} (plain / K6 "
              f"{row['plain_ms'] / row['k6_ms']:.2f})", flush=True)
        return row

    min_q, fa.KV_TILED_MIN_Q = fa.KV_TILED_MIN_Q, 1
    fa.reset_launch_counts()
    fwd = [fwd_row(*s) for s in FWD_SHAPES]
    bwd = [bwd_row(*s) for s in BWD_SHAPES]
    sweep_fwd = [fwd_row(f"sweep Lq={lq}", 64, 12, lq, 8224, 64)
                 for lq in SWEEP_LQ]
    sweep_bwd = [bwd_row(f"sweep Lq={lq}", 64, 12, lq, 8224, 64)
                 for lq in SWEEP_LQ]
    counts = fa.launch_counts()
    fa.KV_TILED_MIN_Q = min_q
    if not (counts["K6"] and counts["K6b"]):
        raise AssertionError(f"the K6 route launched no kernel: {counts}")

    def crossover(rows):
        won = [r["shape"][2] for r in rows if r["k6_ms"] < r["plain_ms"]]
        return min(won) if won else None

    res = dict(card=card, iters=args.iters, fwd=fwd, fwd_bwd=bwd,
               sweep_fwd=sweep_fwd, sweep_fwd_bwd=sweep_bwd,
               k6_beats_plain_from_lq_fwd=crossover(sweep_fwd),
               k6_beats_plain_from_lq_fwd_bwd=crossover(sweep_bwd),
               kv_tiled_min_q=fa.KV_TILED_MIN_Q, launches=counts)
    print(f"K6 beats plain math from Lq = {res['k6_beats_plain_from_lq_fwd']} "
          f"(forward) and {res['k6_beats_plain_from_lq_fwd_bwd']} (forward + "
          f"backward) at B 64 x 12 heads, Lk 8224; KV_TILED_MIN_Q is "
          f"{fa.KV_TILED_MIN_Q} [{card}]", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
