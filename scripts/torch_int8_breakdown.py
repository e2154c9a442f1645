#!/usr/bin/env python3
"""Where K7's fast plan spends its device time, on one CUDA card: the
kernel as it is and with one stage cut short.

    python3 scripts/torch_int8_breakdown.py [--iters 50]

Each variant is a copy of `mico_tpu_torch` under `build/int8_breakdown/`
(git-ignored) with one edit to `csrc/int8_cross_attn.cu` (and, where a
constant must match, to `ops/int8_attention.py`); that source is the only
one built there (all variants at once):

  - base:        the kernel as it is;
  - no_mma:      every tensor-core product (mma.sync) replaced by one
                 integer and one fp32 operation on its operands, so the
                 dequantisation still runs (wrong output, only its time is
                 read);
  - no_dequant:  the int8 words go to the products as they are, with no
                 conversion, scale or rounding (wrong output);
  - no_loads:    the ring's stages are filled by TMA once; later stages
                 reuse what they hold (the bytes out of the way; wrong
                 output);
  - warps8, warps16: 8 or 16 consumer warps (stages of 128 or 256 keys)
                 in place of 12, with the plan's constant to match.

Each is timed by torch.profiler over `--iters` calls at the beam vision
decode step, q (64, 6, 768) over int8 K/V (64, 2056, 768), and the audio
beam step, q (128, 6, 768) over 514 keys (seed 0, `chip_smoke.k7_inputs`),
on the fast plan `k7_plan` gives. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "int8_breakdown"
SOURCE = "int8_cross_attn"

FAKE_MMA = '''namespace k7 {

// stands in for mma_bf16: one integer and one fp32 operation on the
// operands, no tensor core
__device__ __forceinline__ void fake_mma(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  c[0] += __uint_as_float((a[0] ^ b0 ^ b1) & 0x3fffffffu);
}
'''

VARIANTS = {
    "base": [],
    "no_mma": [
        ("namespace k7 {\n", FAKE_MMA),
        ("mma_bf16(acc[t], qa[s],", "fake_mma(acc[t], qa[s],"),
        ("mma_bf16(o[t], pf, b0, b1);", "fake_mma(o[t], pf, b0, b1);")],
    "no_dequant": [
        ("  return pack_bf16(byte_value(u, i) * s, byte_value(u, i + 1) * s);",
         "  return u ^ (uint32_t)i ^ __float_as_uint(s);"),
        ("        const uint32_t b0 = pack_bf16(byte_value(u[0][w], by) * "
         "vcur.s[0],\n"
         "                                      byte_value(u[1][w], by) * "
         "vcur.s[1]);\n"
         "        const uint32_t b1 = pack_bf16(byte_value(u[2][w], by) * "
         "vcur.s[2],\n"
         "                                      byte_value(u[3][w], by) * "
         "vcur.s[3]);\n",
         "        const uint32_t b0 = u[0][w] ^ u[1][w] ^ (uint32_t)by;\n"
         "        const uint32_t b1 = u[2][w] ^ u[3][w] ^ (uint32_t)by;\n")],
    "no_loads": [
        ("            if (round > 0) hop::mbar_wait(&empty[slot], phase ^ 1);\n"
         "            hop::mbar_expect_tx(&full[slot], STAGE);\n",
         "            if (round > 0) {\n"
         "              hop::mbar_wait(&empty[slot], phase ^ 1);\n"
         "              hop::mbar_arrive(&full[slot]);\n"
         "              if (++slot == a.stages) {\n"
         "                slot = 0;\n"
         "                phase ^= 1;\n"
         "              }\n"
         "              continue;\n"
         "            }\n"
         "            hop::mbar_expect_tx(&full[slot], STAGE);\n")],
}
for _w in (8, 16):
    VARIANTS[f"warps{_w}"] = [
        ("constexpr int WARPS = 12;", f"constexpr int WARPS = {_w};"),
        ("ops/int8_attention.py", "K7_FAST_WARPS = 12",
         f"K7_FAST_WARPS = {_w}")]

TIMER = r'''
import sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
from mico_tpu_torch.ops import int8_attention as i8   # the variant's
import chip_smoke as cs

gen = torch.Generator().manual_seed(0)
sms = torch.cuda.get_device_properties(0).multi_processor_count
for what, b, lq, lk in (("beam vision", 64, 6, 2056),
                        ("audio beam", 128, 6, 514)):
    a = cs.k7_inputs(gen, b, lq, lk)
    plan = i8.k7_plan(b, 12, lq, lk, sms)
    dev = cs.device_time_ms(lambda: i8.int8_cross_attention(*a),
                            iters=int(sys.argv[4]))
    print(f"{sys.argv[3]}: {what} ({b}, {lq}, {lk}), plan {tuple(plan)}: "
          f"device {cs.ms_text(dev)} ms a call", flush=True)
'''


def make_variant(name: str, edits) -> Path:
    tree = OUT / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "mico_tpu_torch", tree / "mico_tpu_torch")
    csrc = tree / "mico_tpu_torch" / "csrc"
    for f in csrc.glob("*.cu"):
        if f.stem != SOURCE:
            f.unlink()
    for edit in edits:
        rel, old, new = edit if len(edit) == 3 else (f"csrc/{SOURCE}.cu",
                                                     *edit)
        path = tree / "mico_tpu_torch" / rel
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {rel} no longer has {old!r}")
        path.write_text(text.replace(old, new, 1))
    return tree


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    trees = {name: make_variant(name, edits)
             for name, edits in VARIANTS.items()}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from mico_tpu_torch.ops import _build; _build.build_all()",
         str(tree)]) for tree in trees.values()]
    if any(p.wait() for p in builds):
        raise RuntimeError("a variant failed to build")
    for name, tree in trees.items():
        subprocess.run([sys.executable, "-c", TIMER, str(tree), str(ROOT),
                        name, str(args.iters)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
