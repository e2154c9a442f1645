#!/usr/bin/env python3
"""Sustained matmul rates on one CUDA card: the counterpart of
`scripts/matmul_probe.py`, and the library yardstick of P1.

    python3 scripts/torch_matmul_probe.py

For each of the JAX probe's four shapes (ViT-g's fc1/fc2 over 112 frames,
a qkv-like and a projection-like product, and an 8192^3 roofline), a chain
of DEPTH = 8 pairs x·W1 then ·W2 (x (M, K), W1 (K, N), W2 (N, K)), each
product through `torch.matmul` with its output rounded to the input dtype,
as the JAX probe's `jnp.dot(..., preferred_element_type=float32).astype`.
bf16 products accumulate in fp32 (reduced-precision reductions off); JAX's
Precision.DEFAULT / HIGHEST pair has no separate meaning for bf16 inputs on
this card, so bf16 runs once. For the fp32 case the pair maps onto TF32:
HIGHEST is TF32 off (full fp32), DEFAULT is TF32 on. Inputs are normal
(std 0.02) from a card generator seeded with 0. Prints ms per chain and
TF/s (2·2·DEPTH·M·K·N over the time, CUDA events over 4 chains after one
warm-up) with the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

DEPTH = 8
N_ITER = 4
SHAPES = [
    (28784, 1408, 6144, "fc1/fc2"),
    (28784, 1408, 4224, "qkv-ish"),
    (28784, 1408, 1408, "proj"),
    (8192, 8192, 8192, "roofline"),
]


def chain(x, w1s, w2s):
    for w1, w2 in zip(w1s, w2s):
        x = torch.matmul(torch.matmul(x, w1), w2)
    return x


def probe(m: int, k: int, n: int, dtype: torch.dtype, tf32: bool) -> float:
    """ms of one chain of DEPTH (m, k) x (k, n), (m, n) x (n, k) pairs."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return (0.02 * torch.randn(*shape, generator=gen, device="cuda")).to(
            dtype)

    x, w1s, w2s = rnd(m, k), rnd(DEPTH, k, n), rnd(DEPTH, n, k)
    chain(x, w1s, w2s)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(N_ITER):
        chain(x, w1s, w2s)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / N_ITER


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_matmul_probe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    rows = []
    try:
        for m, k, n, label in SHAPES:
            for dtype, prec, tf32 in ((torch.bfloat16, "bf16", False),
                                      (torch.float32, "HIGHEST", False),
                                      (torch.float32, "DEFAULT", True)):
                ms = probe(m, k, n, dtype, tf32)
                tf = 2 * 2 * DEPTH * m * k * n / ms / 1e9
                rows.append(dict(m=m, k=k, n=n, label=label,
                                 dtype=str(dtype).split(".")[-1],
                                 precision=prec, ms=ms, tflops=tf))
                print(f"({m:6d},{k:5d},{n:5d}) {label:10s} {prec:8s} "
                      f"{ms:9.3f} ms  {tf:6.1f} TF/s [{card}]", flush=True)
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": card, "depth": DEPTH, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
