#!/usr/bin/env python3
"""P1, the fused ViT MLP, timed on one CUDA card: the counterpart of
`scripts/pallas_matmul_probe.py`.

    python3 scripts/torch_mlp_probe.py [ROWS_PER_BLOCK ...]   # default 16 32

The probe's geometry, M, K, N = 28784, 1408, 6144 (ViT-g's fc1 over 112
frames; fc2 is the transpose), and its "scan": a chain of DEPTH = 8 calls of
`mico_tpu_torch.ops.fused_mlp.fused_mlp`, each out = x + bf16(bf16(
gelu_tanh(x·W1))·W2) with its own weights, the output feeding the next
call. Inputs are bf16, made on the card from seed 0 at the probe's scale
(std 0.02). `ROWS_PER_BLOCK` is the CUDA design's one tiling knob (the rows
one block owns, 16 or 32), in the place of `pallas_mlp`'s `tile_m`. For each
value it prints ms per chain and TF/s (2·2·DEPTH·M·K·N over the time), then
the same chain through the library route (`torch.matmul` fc1, `F.gelu`
tanh, `torch.matmul` fc2, the residual add), with the card's name and
power limit. Ends with one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mico_tpu_torch.ops.fused_mlp import fused_mlp  # noqa: E402

M, K, N = 28784, 1408, 6144   # fc1 geometry (fc2 is the transpose)
DEPTH = 8
N_ITER = 4


def probe_inputs(m: int = M, k: int = K, n: int = N, depth: int = DEPTH,
                 scale: float = 0.02, seed: int = 0):
    """x (m, k) and `depth` weight pairs (k, n), (n, k), bf16 on the card,
    normal with std `scale`, from a card generator seeded with `seed`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")
                ).to(torch.bfloat16)

    return rnd(m, k), rnd(depth, k, n), rnd(depth, n, k)


def mlp_chain(x, w1s, w2s, rows_per_block: int = 32):
    """The probe's scan: one P1 call per weight pair, chained."""
    for w1, w2 in zip(w1s, w2s):
        x = fused_mlp(x, w1, w2, rows_per_block)
    return x


def library_chain(x, w1s, w2s):
    """The same chain through one PyTorch call per stage (bf16 products
    with fp32 accumulation; the hidden tensor goes through HBM)."""
    for w1, w2 in zip(w1s, w2s):
        h = F.gelu(torch.matmul(x, w1), approximate="tanh")
        x = torch.matmul(h, w2) + x
    return x


def time_ms(fn, n_iter: int = N_ITER) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mlp_probe: needs a CUDA device", file=sys.stderr)
        return 2
    rows = [int(a) for a in sys.argv[1:]] or [16, 32]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    x, w1s, w2s = probe_inputs()
    flops = 2 * 2 * DEPTH * M * K * N
    result = {"card": card, "shape": [M, K, N], "depth": DEPTH}
    for r in rows:
        ms = time_ms(lambda: mlp_chain(x, w1s, w2s, r))
        result[f"p1_rows{r}_ms"] = ms
        print(f"P1 fused mlp rows_per_block={r:3d}: {ms:9.3f} ms  "
              f"{flops / ms / 1e9:7.1f} TF/s [{card}]", flush=True)
    ms = time_ms(lambda: library_chain(x, w1s, w2s))
    result["library_ms"] = ms
    print(f"library matmul+gelu+matmul+add:    {ms:9.3f} ms  "
          f"{flops / ms / 1e9:7.1f} TF/s [{card}]", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
