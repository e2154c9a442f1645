#!/usr/bin/env python3
"""Whether two trees compile a kernel to the same machine code: the SASS
(`cuobjdump -sass`) of every function whose name holds a given word, in
the libraries that `mico_tpu_torch/ops/_build.py` built in each tree.

    python3 scripts/torch_sass_diff.py TREE_A TREE_B [--stems a,b] [--word w]

Each tree is a checkout whose `build/mico_tpu_torch/` holds its libraries
(run `_build.build_all()` from it first). By default it compares the GEMM
kernels (`--word gemm`) of K1, K5, K8 and P1's libraries, the ones that
share `wgmma_gemm.cuh` and `hopper.cuh`. Prints one line per function:
identical or differs, with the instruction counts. Needs the CUDA toolkit
(`cuobjdump` beside `nvcc`); no card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

STEMS = "fused_ln_qkv_attn,fused_qkv_attn,fused_qkv_attn_proj,fused_mlp"


def sass_functions(lib: Path, word: str, cuobjdump: str) -> dict:
    """{function name: its SASS lines} for the functions naming `word`."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if word in m.group(1) else None
            if name:
                funcs[name] = []
        elif name and line.strip():
            funcs[name].append(line.strip())
    return funcs


def library(tree: Path, stem: str) -> Path:
    libs = sorted((tree / "build" / "mico_tpu_torch").glob(f"lib{stem}-*.so"),
                  key=lambda p: p.stat().st_mtime)
    if not libs:
        raise FileNotFoundError(f"{tree}: no built library for {stem}.cu")
    return libs[-1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree_a", type=Path)
    ap.add_argument("tree_b", type=Path)
    ap.add_argument("--stems", default=STEMS)
    ap.add_argument("--word", default="gemm")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from mico_tpu_torch.ops import _build

    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    same = True
    for stem in args.stems.split(","):
        a = sass_functions(library(args.tree_a, stem), args.word, cuobjdump)
        b = sass_functions(library(args.tree_b, stem), args.word, cuobjdump)
        if not a or set(a) != set(b):
            print(f"{stem}: functions differ or none found: {sorted(a)} / "
                  f"{sorted(b)}")
            same = False
            continue
        for name in sorted(a):
            eq = a[name] == b[name]
            same &= eq
            print(f"{stem}: {name[:90]}: "
                  f"{'identical' if eq else 'differs'} ({len(a[name])} / "
                  f"{len(b[name])} lines)")
    print("all identical" if same else "some differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
