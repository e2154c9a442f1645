#!/usr/bin/env python3
"""How far K1 and its plain version each sit from fp64, on one CUDA card.

    python3 scripts/torch_k1_rounding.py

K1 (`fused_ln_qkv_self_attention`) rounds p where the Pallas body does
(flash_attention.py:1609-1617): the unnormalised exp2(s - m) goes to bf16
for the PV product and the output is divided by the fp32 row sum. Its plain
version follows `_fused_ln_qkv_reference`, which rounds the normalised
softmax. This script holds both against two fp64 twins, one with each
rounding point (every other step in fp64, bf16 roundings where the kernels
round), at x (8, 257, 1408) bf16, H = 16, D = 88, for W_qkv drawn at std
0.02 (the model's init; scores of std ~0.6) and 0.05 (scores of std ~3.6),
three draws each, affine on and off. Each cell prints max and mean |d| and
how many elements exceed chip_smoke.py's tolerance (2e-2 + 2e-2·|want|).
Ends with one JSON line of every cell.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mico_tpu_torch.ops import flash_attention as fa  # noqa: E402

B, L, NH, D = 8, 257, 16, 88
RTOL = ATOL = 2e-2


def twin64(x, g, b0, w, bias, affine, pallas_p):
    """fp64 twin rounding xn, qkv, p and the output to bf16; p rounded
    before normalising (Pallas body) or after (the JAX reference)."""
    xf = x.double()
    mean = xf.mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt((xf - mean).square().mean(-1, keepdim=True)
                                   + 1e-6)
    if affine:
        xn = xn * g.double() + b0.double()
    xn = xn.bfloat16().double()
    qkv = (xn @ w.double() + bias.double()).bfloat16().double()
    q, k, v = (t.reshape(B, L, NH, D).transpose(1, 2)
               for t in qkv.split(NH * D, -1))
    s = (q @ k.transpose(-1, -2)) * D ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    if pallas_p:
        o = (e.bfloat16().double() @ v) / e.sum(-1, keepdim=True)
    else:
        o = (e / e.sum(-1, keepdim=True)).bfloat16().double() @ v
    return o.bfloat16().transpose(1, 2).reshape(B, L, NH * D)


def gap(got, want) -> dict:
    got, want = got.double(), want.double()
    d = (got - want).abs()
    return {"max": d.max().item(), "mean": d.mean().item(),
            "over_tol": int((d > ATOL + RTOL * want.abs()).sum().item())}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_rounding: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    cells = []
    for std in (0.02, 0.05):
        gen = torch.Generator().manual_seed(1)
        for draw in range(3):
            def r(*s, scale=1.0, mean=0.0):
                return (mean + scale * torch.randn(*s, generator=gen)).cuda()

            w = NH * D
            x = r(B, L, w).bfloat16()
            g, b0 = r(w, scale=0.1, mean=1.0), r(w, scale=0.1)
            wq, bias = r(w, 3 * w, scale=std).bfloat16(), r(3 * w, scale=std)
            args = (x, g, b0, wq, bias)
            for affine in (True, False):
                kern = fa.fused_ln_qkv_self_attention(
                    *args, NH, D ** -0.5, 1e-6, affine)
                plain = fa.fused_ln_qkv_plain(*args, NH, D ** -0.5, 1e-6,
                                              affine)
                ref = twin64(*args, affine, pallas_p=False)
                pallas = twin64(*args, affine, pallas_p=True)
                cell = {"std": std, "draw": draw, "affine": affine,
                        "kernel_vs_plain": gap(kern, plain),
                        "kernel_vs_pallas_twin": gap(kern, pallas),
                        "plain_vs_reference_twin": gap(plain, ref),
                        "pallas_twin_vs_reference_twin": gap(pallas, ref)}
                cells.append(cell)
                print(f"std {std} draw {draw} affine {affine}: " + "; ".join(
                    f"{k} max {v['max']:.3e} mean {v['mean']:.3e} over "
                    f"{v['over_tol']}" for k, v in cell.items()
                    if isinstance(v, dict)), flush=True)
    print(json.dumps({"card": card, "cells": cells}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
