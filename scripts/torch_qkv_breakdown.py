#!/usr/bin/env python3
"""Where K5's device time goes at bigE's pass, or K1's GEMM's at ViT-g's,
on one CUDA card: the kernel as it is and with one design choice undone or
one stage cut short.

    python3 scripts/torch_qkv_breakdown.py [--kernel K5|K1]

Each variant is a copy of `mico_tpu_torch` under `build/qkv_breakdown/`
(git-ignored) with one edit to its sources; only `fused_qkv_attn.cu` (K5)
or `fused_ln_qkv_attn.cu` (K1) is built there (all variants at once).
K5's variants:

  - base:            the kernels as they are;
  - kv_loads_only:   the attention's consumers skip all compute once their
                     Q tile and the head's K and V have landed (the loads'
                     own time; the output is then wrong, only its time is
                     read);
  - no_kv_loads:     the producer loads Q tiles but no K or V (the compute's
                     own time, on whatever shared memory holds);
  - ieee_division:   o / l by fp32 division a value instead of the
                     reciprocal and one FMA correction;
  - regs_240:        240 registers for the attention's consumers and 24 for
                     its producer, against 232 and 40;
  - cluster_1:       the GEMM in clusters of one CTA (no W multicast);
  - no_gemm_stores:  the GEMM's epilogue writes neither the staging tile nor
                     the TMA stores (its output is then wrong).

Each is timed on `chip_smoke.fused_qkv_inputs` at x (112, 257, 1792), 16
heads of 112, by `scripts/torch_qkv_bench.py`'s `device_kernels`
(torch.profiler, 50 calls): the GEMM's and the attention's device ms per
K5 call. K1's variants, each timed as the GEMM stage alone
(`ln_gemm_bias`) on `chip_smoke.k1_inputs` at x (112, 257, 1408) with the
affine:

  - base:            the LayerNorm in the consumers' A registers;
  - rs_without_ln:   the consumers load A into registers and skip the
                     normalisation (an RS GEMM of the raw x: the output is
                     then wrong, only its time is read);
  - mean0_rstd1:     (mean, rstd) = (0, 1) for every row in place of the
                     statistics: the compiler then drops the subtraction
                     and the product, so this times the arithmetic less
                     those two (and the statistics' loads; wrong output).

Prints the card's name and power limit and a line per variant. Runs from
any working directory.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "qkv_breakdown"
VARIANTS = {
    "base": [],
    "kv_loads_only": [
        ("qkv_attn.cuh", "      hop::mbar_wait(&qfull[wgi], n & 1);\n",
         "      hop::mbar_wait(&qfull[wgi], n & 1);\n"
         "      if (L > 0) {\n"
         "        if (tid == 0) hop::mbar_arrive(&qempty[wgi]);\n"
         "        hop::mbar_wait(vfull, 0);\n"
         "        continue;\n"
         "      }\n")],
    "no_kv_loads": [
        ("qkv_attn.cuh",
         "        load_block(ks, kfull, &tma_k, 0);\n"
         "        load_block(vs, vfull, &tma_v, 0);\n",
         "        hop::mbar_arrive(kfull);\n        hop::mbar_arrive(vfull);\n")],
    "ieee_division": [
        ("qkv_attn.cuh",
         "pack_bf16(div_by(o[4 * j], l0, r0), div_by(o[4 * j + 1], l0, r0));",
         "pack_bf16(o[4 * j] / l0, o[4 * j + 1] / l0);"),
        ("qkv_attn.cuh",
         "pack_bf16(div_by(o[4 * j + 2], l1, r1), div_by(o[4 * j + 3], l1, r1));",
         "pack_bf16(o[4 * j + 2] / l1, o[4 * j + 3] / l1);")],
    "regs_240": [
        ("qkv_attn.cuh", "hop::setmaxnreg_inc<232>();", "hop::setmaxnreg_inc<240>();"),
        ("qkv_attn.cuh", "hop::setmaxnreg_dec<40>();", "hop::setmaxnreg_dec<24>();")],
    "cluster_1": [
        ("wgmma_gemm.cuh", "constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 1;")],
    "no_gemm_stores": [
        ("wgmma_gemm.cuh", "  for (int j = 0; j < BN / 8; ++j) {",
         "  for (int j = 0; j < BN / 8 * (N < 0); ++j) {"),
        ("wgmma_gemm.cuh", "    for (int c = 0; c < BN / 64; ++c)",
         "    for (int c = 0; c < BN / 64 * (N < 0); ++c)")],
}
K1_VARIANTS = {
    "base": [],
    "rs_without_ln": [
        ("wgmma_gemm.cuh", "    a[kk][0] = ln_pair(a[kk][0], m0, r0, g0);\n"
         "    a[kk][1] = ln_pair(a[kk][1], m1, r1, g0);\n"
         "    a[kk][2] = ln_pair(a[kk][2], m0, r0, g1);\n"
         "    a[kk][3] = ln_pair(a[kk][3], m1, r1, g1);\n", "")],
    "mean0_rstd1": [
        ("wgmma_gemm.cuh",
         "        const float2 s0 = row < M ? stats[row] : make_float2(0.f, 0.f);",
         "        const float2 s0 = make_float2(0.f, 1.f);"),
        ("wgmma_gemm.cuh",
         "        const float2 s1 = row + 8 < M ? stats[row + 8] : make_float2(0.f, 0.f);",
         "        const float2 s1 = make_float2(0.f, 1.f);")],
}
TIMER = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from mico_tpu_torch.ops import flash_attention as fa
sys.path.insert(0, sys.argv[2])
sys.path.insert(0, sys.argv[3])
from chip_smoke import fused_qkv_inputs
from torch_qkv_bench import device_kernels, stage_ms
a = fused_qkv_inputs(torch.Generator().manual_seed(4), 112, 257, 16, 112)
kern = device_kernels(lambda: fa.fused_qkv_self_attention(
    a["x"], a["w"], a["bias"], 16, a["scale"]), 50)
print(f"{sys.argv[4]}: GEMM {stage_ms(kern, 'gemm'):.4f} ms, attention "
      f"{stage_ms(kern, 'attn'):.4f} ms a K5 call", flush=True)
'''
K1_TIMER = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from mico_tpu_torch.ops import flash_attention as fa
sys.path.insert(0, sys.argv[2])
sys.path.insert(0, sys.argv[3])
from chip_smoke import k1_inputs
from torch_qkv_bench import device_kernels, stage_ms
x, g, b0, w, bias, nh, scale, eps = k1_inputs(
    torch.Generator().manual_seed(1), 112)
x2 = x.view(-1, x.shape[-1])
kern = device_kernels(lambda: fa.ln_gemm_bias(x2, g, b0, w, bias, eps, True),
                      50)
print(f"{sys.argv[4]}: GEMM {stage_ms(kern, 'gemm'):.4f} ms, statistics "
      f"{stage_ms(kern, 'stats'):.4f} ms a call", flush=True)
'''


def make_variant(name: str, edits, source: str) -> Path:
    tree = OUT / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "mico_tpu_torch", tree / "mico_tpu_torch")
    csrc = tree / "mico_tpu_torch" / "csrc"
    for f in csrc.glob("*.cu"):
        if f.stem != source:
            f.unlink()
    for fname, old, new in edits:
        path = csrc / fname
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {fname} no longer has {old!r}")
        path.write_text(text.replace(old, new))
    return tree


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("K5", "K1"), default="K5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_qkv_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    k1 = args.kernel == "K1"
    variants, timer = (K1_VARIANTS, K1_TIMER) if k1 else (VARIANTS, TIMER)
    source = "fused_ln_qkv_attn" if k1 else "fused_qkv_attn"
    trees = {name: make_variant(f"{args.kernel}_{name}", edits, source)
             for name, edits in variants.items()}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from mico_tpu_torch.ops import _build; _build.build_all()",
         str(tree)]) for tree in trees.values()]
    if any(p.wait() for p in builds):
        raise RuntimeError("a variant failed to build")
    for name, tree in trees.items():
        subprocess.run([sys.executable, "-c", timer, str(tree), str(ROOT),
                        str(ROOT / "scripts"), name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
