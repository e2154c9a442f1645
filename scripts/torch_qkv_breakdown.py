#!/usr/bin/env python3
"""Where K5's device time goes at bigE's pass, on one CUDA card: the kernel
as it is and with one design choice undone or one stage cut short.

    python3 scripts/torch_qkv_breakdown.py

Each variant is a copy of `mico_tpu_torch` under `build/qkv_breakdown/`
(git-ignored) with one edit to its sources; only `fused_qkv_attn.cu` is
built there (all variants at once):

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
K5 call. Prints the card's name and power limit and a line per variant.
Runs from any working directory.
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
         "        load_block(ks, kfull, 1, 0);\n        load_block(vs, vfull, 2, 0);\n",
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
        ("wgmma_gemm.cuh", "      for (int j = 0; j < BN / 8; ++j) {",
         "      for (int j = 0; j < BN / 8 * (M < 0); ++j) {"),
        ("wgmma_gemm.cuh", "        for (int c = 0; c < BN / 64; ++c)",
         "        for (int c = 0; c < BN / 64 * (M < 0); ++c)")],
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


def make_variant(name: str, edits) -> Path:
    tree = OUT / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "mico_tpu_torch", tree / "mico_tpu_torch")
    csrc = tree / "mico_tpu_torch" / "csrc"
    for f in csrc.glob("*.cu"):
        if f.stem != "fused_qkv_attn":
            f.unlink()
    for fname, old, new in edits:
        path = csrc / fname
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {fname} no longer has {old!r}")
        path.write_text(text.replace(old, new))
    return tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_qkv_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    trees = {name: make_variant(name, edits) for name, edits in VARIANTS.items()}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from mico_tpu_torch.ops import _build; _build.build_all()",
         str(tree)]) for tree in trees.values()]
    if any(p.wait() for p in builds):
        raise RuntimeError("a variant failed to build")
    for name, tree in trees.items():
        subprocess.run([sys.executable, "-c", TIMER, str(tree), str(ROOT),
                        str(ROOT / "scripts"), name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
