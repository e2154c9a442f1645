#!/usr/bin/env python3
"""P1, the fused ViT MLP, timed on one CUDA card: the counterpart of
`scripts/pallas_matmul_probe.py`.

    python3 scripts/torch_mlp_probe.py [--iters 10]

The probe's geometry, M, K, N = 28784, 1408, 6144 (ViT-g's fc1 over 112
frames; fc2 is the transpose), and its "scan": a chain of DEPTH = 8 calls of
`mico_tpu_torch.ops.fused_mlp.fused_mlp`, each out = x + bf16(bf16(
gelu_tanh(x·W1))·W2) with its own weights, the output feeding the next
call. Inputs are bf16, made on the card from seed 0 at the probe's scale
(std 0.02). Prints, with the card's name and power limit:

  - one P1 call's device ms from torch.profiler (every kernel the call
    ran, summed), by kernel name (fc1 and fc2 are the two instances of
    `epi_gemm_kernel`), and the chain's ms per call by CUDA events, with
    its TF/s (2·2·M·K·N a call);
  - the same for the library route: `torch.matmul` fc1, `F.gelu` tanh,
    `torch.matmul` fc2 and the residual add (one PyTorch call a stage);
  - the bound: 2·2·M·K·N over 989 TFLOP/s.

Ends with one JSON line. It runs against the `mico_tpu_torch` of the tree
it lies in, so a copy in an older tree times that tree's P1: that is how a
parent/change A/B runs in one call.
"""

from __future__ import annotations

import argparse
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
PEAK_BF16_FLOPS = 989e12


def probe_inputs(m: int = M, k: int = K, n: int = N, depth: int = DEPTH,
                 scale: float = 0.02, seed: int = 0):
    """x (m, k) and `depth` weight pairs (k, n), (n, k), bf16 on the card,
    normal with std `scale`, from a card generator seeded with `seed`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")
                ).to(torch.bfloat16)

    return rnd(m, k), rnd(depth, k, n), rnd(depth, n, k)


def mlp_chain(x, w1s, w2s):
    """The probe's scan: one P1 call per weight pair, chained."""
    for w1, w2 in zip(w1s, w2s):
        x = fused_mlp(x, w1, w2)
    return x


def library_mlp(x, w1, w2):
    """One MLP through one PyTorch call per stage (bf16 products with fp32
    accumulation; the hidden tensor goes through HBM)."""
    h = F.gelu(torch.matmul(x, w1), approximate="tanh")
    return torch.matmul(h, w2) + x


def library_chain(x, w1s, w2s):
    for w1, w2 in zip(w1s, w2s):
        x = library_mlp(x, w1, w2)
    return x


def event_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
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
        print("torch_mlp_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from torch_qkv_bench import device_kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    x, w1s, w2s = probe_inputs()
    flops = 2 * 2 * M * K * N
    result = {"card": card, "shape": [M, K, N], "depth": DEPTH,
              "bound_ms": 1e3 * flops / PEAK_BF16_FLOPS}
    for name, one, chain in (
            ("p1", lambda: fused_mlp(x, w1s[0], w2s[0]), mlp_chain),
            ("library", lambda: library_mlp(x, w1s[0], w2s[0]),
             library_chain)):
        kern = {n: ms
                for n, (ms, _) in device_kernels(one, args.iters).items()}
        dev = sum(kern.values())
        ms = event_ms(lambda: chain(x, w1s, w2s), max(1, args.iters // 4))
        result[name] = {"device_ms": dev, "device_ms_by_kernel": kern,
                        "chain_ms": ms}
        print(f"{name}: device {dev:.4f} ms a call "
              f"({1e-9 * flops / dev:.1f} TF/s); chain of {DEPTH} "
              f"{ms:.3f} ms ({DEPTH * flops / ms / 1e9:.1f} TF/s) [{card}]",
              flush=True)
        for k, v in sorted(kern.items(), key=lambda kv: -kv[1]):
            print(f"    {v:.4f} ms  {k[:100]}", flush=True)
    print(f"bound {result['bound_ms']:.4f} ms (operations)", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
