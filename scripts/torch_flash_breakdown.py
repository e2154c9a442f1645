#!/usr/bin/env python3
"""Where K2's device time goes at ITM and the recompute decode, on one CUDA
card: the kernel timed whole and cut short at three points.

    python3 scripts/torch_flash_breakdown.py

Each variant is a copy of `mico_tpu_torch` under `build/flash_breakdown/`
(git-ignored) whose `csrc/flash_attn.cuh` has one edit; only `flash_attn.cu`
is built there:

  - base:       the kernel as it is;
  - launch:     every block returns at once (the launch, and the combine
                kernel on the workspace as it lies where a plan splits);
  - loads:      blocks return once the Q tile and the first rounds of K/V
                have landed;
  - no_handoff: key warps 1.. return after their chunks, without handing
                their partials to key warp 0 (the output is then wrong; only
                its time is read).

Each is timed at ITM (q (3, 12, 30, 64) over 257 keys) and the decode (q (1,
12, 10, 64) over 1028 keys) at a few plans (splits x key warps) by
`scripts/torch_flash_bench.py`'s `device_ms` (torch.profiler, 200 calls).
Prints the card's name and power limit and a line per variant and shape.
Runs from any working directory.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "flash_breakdown"
VARIANTS = {
    "base": [],
    "launch": [("  const int split = blockIdx.x % a.nsplit;",
                "  if (a.Lk > 0) return;\n"
                "  const int split = blockIdx.x % a.nsplit;")],
    "loads": [("  cp_async_wait_n(pre);            // the Q tile landed\n"
               "  __syncthreads();",
               "  cp_async_wait_n(pre);            // the Q tile landed\n"
               "  __syncthreads();\n"
               "  if (a.Lk > 0) {\n"
               "    cp_async_wait<0>();\n"
               "    __syncthreads();\n"
               "    return;\n"
               "  }")],
    "no_handoff": [("  if (KW > 1) {\n    // key warps",
                    "  if (kw > 0) return;\n"
                    "  if (KW > 1 && a.Lk < 0) {\n    // key warps")],
}
TIMER = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from mico_tpu_torch.ops import flash_attention as fa
sys.path.insert(0, sys.argv[2])
from torch_flash_bench import device_ms, heads_view
gen = torch.Generator().manual_seed(0)
for shape, plans in (((3, 12, 30, 257, 64), ((1, 1), (1, 5), (3, 2))),
                     ((1, 12, 10, 1028, 64), ((1, 1), (1, 5), (3, 2),
                                              (4, 5)))):
    q, k, v = heads_view(gen, *shape)
    times = []
    for n, kw in plans:
        ms = device_ms(lambda: fa._flash_launch(
            q, k, v, None, 0.125, tiled=False, splits=n, key_warps=kw),
            200)[0]
        times.append(f"{n}x{kw}: {ms:.4f}")
    print(f"{sys.argv[3]} {shape}: " + ", ".join(times), flush=True)
'''


def make_variant(name: str, edits) -> Path:
    tree = OUT / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "mico_tpu_torch", tree / "mico_tpu_torch")
    csrc = tree / "mico_tpu_torch" / "csrc"
    for f in csrc.glob("*.cu"):
        if f.stem != "flash_attn":
            f.unlink()
    header = csrc / "flash_attn.cuh"
    text = header.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: the kernel no longer has {old!r}")
        text = text.replace(old, new)
    header.write_text(text)
    return tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name, edits in VARIANTS.items():
        tree = make_variant(name, edits)
        subprocess.run([sys.executable, "-c", TIMER, str(tree),
                        str(ROOT / "scripts"), name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
