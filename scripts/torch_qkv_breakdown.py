#!/usr/bin/env python3
"""Where K5's device time goes at bigE's pass, K1's GEMM's at ViT-g's or
K9's at CLIP-L/14's, on one CUDA card: the kernel as it is and with one
design choice undone or one stage cut short.

    python3 scripts/torch_qkv_breakdown.py [--kernel K5|K1|K9]

Each variant is a copy of `mico_tpu_torch` under `build/qkv_breakdown/`
(git-ignored) with one edit to its sources; only `fused_qkv_attn.cu` (K5),
`fused_ln_qkv_attn.cu` (K1) or `packed_cls_attn.cu` (K9) is built there
(all variants at once).
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

K9's variants (`packed_attn.cu` is built beside, for K3), each timed at
CLIP-L/14's pass, qkv (112, 257, 3 x 16 x 64), and the train pass's, (32,
257, 3 x 16 x 88) (unit std, seed 5), as K9's device ms a call beside K3's
on the same input; each variant's build also names the K9 instances whose
wgmmas ptxas serialised ("C751x" in `-Xptxas -v`, from one more build of
the variant's source; <NT, STREAM>: NT 64-column chunks of D, STREAM the
streamed keys past 272):

  - base:            K9 as it is;
  - no_cls_row:      no CLS-row code at all: the producer warpgroup's three
                     other warps stage the CLS token and stop, compiled out
                     past that (row 0 is then wrong);
  - column:          the CLS column on the consumers' CUDA cores from the
                     staged Q tile (K9's path past 256 patch rows) in place
                     of k_cls in the key block's tail;
  - exp2:            K3's exp2 in place of K9's natural exp (wrong values;
                     the exponent's own cost).

Prints the card's name and power limit and a line per variant. Runs from
any working directory.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
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
K9_VARIANTS = {
    "base": [],
    "no_cls_row": [
        ("qkv_attn.cuh",
         "  const bf16* kg = row0 + a.ld + a.W;        // patch key 0\n",
         "#if 0\n  const bf16* kg = row0 + a.ld + a.W;\n"),
        ("qkv_attn.cuh",
         "    *reinterpret_cast<uint32_t*>(orow + 2 * ct) = pack_bf16(o0 / lc, o1 / lc);\n  }\n",
         "    *reinterpret_cast<uint32_t*>(orow + 2 * ct) = pack_bf16(o0 / lc, o1 / lc);\n  }\n#endif\n")],
    "column": [
        ("qkv_attn.cuh", "  if (P > 256)\n", "  if (P > 0)\n")],
    "exp2": [
        ("qkv_attn.cuh", "  if constexpr (NAT)\n    return nat_exp(x);",
         "  if constexpr (NAT && sizeof(x) == 0)\n    return nat_exp(x);")],
}
K9_TIMER = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from mico_tpu_torch.ops import flash_attention as fa
sys.path.insert(0, sys.argv[3])
from torch_qkv_bench import device_ms
gen = torch.Generator().manual_seed(5)
out = []
for b, l, nh, d in ((112, 257, 16, 64), (32, 257, 16, 88)):
    qkv = torch.randn(b, l, 3 * nh * d, generator=gen).to("cuda",
                                                         torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    k9 = device_ms(lambda: fa.packed_qkv_cls_attention(qkv, nh, d ** -0.5),
                   50)
    k3 = device_ms(lambda: fa.packed_attention(q, k, v, nh, d ** -0.5), 50)
    out.append(f"({b}, {l}, {3 * nh * d}) K9 {k9:.4f} ms (K3 {k3:.4f})")
print(f"{sys.argv[4]}: " + "; ".join(out), flush=True)
'''
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


def make_variant(name: str, edits, sources) -> Path:
    tree = OUT / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "mico_tpu_torch", tree / "mico_tpu_torch")
    csrc = tree / "mico_tpu_torch" / "csrc"
    for f in csrc.glob("*.cu"):
        if f.stem not in sources:
            f.unlink()
    for fname, old, new in edits:
        path = csrc / fname
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {fname} no longer has {old!r}")
        path.write_text(text.replace(old, new))
    return tree


def ptxas_flags(tree: Path, source: str) -> str:
    """The K9 instances whose wgmmas ptxas serialised in the variant's
    source (its "C751x" notes under -Xptxas -v, which name the function)."""
    import re

    from mico_tpu_torch.ops import _build

    csrc = tree / "mico_tpu_torch" / "csrc"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc),
         "-o", str(tree / "ptxas.so"), str(csrc / f"{source}.cu")],
        capture_output=True, text=True, check=True)
    notes = set()
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"\((C751\d)\).*cls_attn_kernelILi(\d)ELb(\d)", line)
        if m:
            notes.add(f"{m.group(1)} <{m.group(2)}, "
                      f"{'true' if m.group(3) == '1' else 'false'}>")
    return ("wgmmas serialised in " + ", ".join(sorted(notes))) if notes \
        else "no wgmma serialised"


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("K5", "K1", "K9"), default="K5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_qkv_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    variants, timer, source = {
        "K5": (VARIANTS, TIMER, "fused_qkv_attn"),
        "K1": (K1_VARIANTS, K1_TIMER, "fused_ln_qkv_attn"),
        "K9": (K9_VARIANTS, K9_TIMER, "packed_cls_attn")}[args.kernel]
    sources = (source, "packed_attn") if args.kernel == "K9" else (source,)
    trees = {name: make_variant(f"{args.kernel}_{name}", edits, sources)
             for name, edits in variants.items()}
    if args.kernel == "K9":
        for name, tree in trees.items():
            print(f"{name}: ptxas {ptxas_flags(tree, source)}", flush=True)
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
