#!/usr/bin/env python3
"""Where K6b's device time goes at the long-context step's cross-attention,
on one CUDA card: the kernel as it is and with one stage cut short or one
design choice undone.

    python3 scripts/torch_k6b_breakdown.py [--iters 50]

Each variant is a copy of `mico_tpu_torch` under `build/k6b_breakdown/`
(git-ignored) with one edit to `csrc/kv_tiled_attn_bwd.cu`, the only
source built there (all variants at once):

  - base:         the kernel as it is;
  - no_math:      P^T is the exponent and dS^T dP^T - delta, no exp and no
                  products (chunks with no mask; wrong output, only its
                  time is read);
  - no_products:  no dV, dK or dQ product (S^T, dP^T, the elementwise work,
                  the staging and the barriers remain);
  - no_scores:    no S^T or dP^T product (the elementwise work runs on
                  whatever the registers hold);
  - no_overlap:   each chunk's products retire before the next chunk's
                  elementwise work starts;
  - no_loads:     K and V are loaded into the ring's stages once; later
                  chunks reuse what the stages hold (the loads' latency and
                  bandwidth out of the way; wrong output);
  - stages6:      six K/V stages and two P^T/dS^T buffers (with their extra
                  barrier) in place of four and three;
  - no_stores:    dV and dK are not written (no TMA stores).

Each is timed on q, k, v, g (2, 12, 128, 64) over 8,224 keys in BERT's
strided layout (unit std, seed 0; lse and delta from the plain forward on
the card), by torch.profiler over `--iters` calls: the pass's and the
combine's device ms a call. The base variant is also timed at other split
counts. Each variant's build names the ptxas notes about its wgmmas
("C75xx" under -Xptxas -v). Prints the card's name and power limit first.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "k6b_breakdown"
SOURCE = "kv_tiled_attn_bwd"

VARIANTS = {
    "base": [],
    "no_math": [
        ("        const float p = fast_exp2(t);\n"
         "        st[x] = p;\n"
         "        dt[x] = p * (dt[x] - dlt) * scale;\n",
         "        st[x] = t;\n"
         "        dt[x] -= dlt;\n")],
    "no_products": [
        ("      ss_keys<NT>(acc, pb + wgi * 2 * CHUNK, wgi ? qs : gs);\n"
         "      ss_dq<NT>(dq, pb + (2 + wgi) * CHUNK, kv);\n", "")],
    "no_scores": [
        ("      ss_scores<KS>(st, kv, qw);\n"
         "      ss_scores<KS>(dt, kv + TILE, gw);\n", "")],
    "no_overlap": [
        ("        hop::wgmma_wait<1>();    // chunk i + 1's scores",
         "        hop::wgmma_wait<0>();")],
    "no_loads": [
        ("          hop::mbar_expect_tx(&full[st], 2 * TILE);",
         "          if (n > 0) {\n"
         "            hop::mbar_arrive(&full[st]);\n"
         "            continue;\n"
         "          }\n"
         "          hop::mbar_expect_tx(&full[st], 2 * TILE);")],
    "stages6": [
        ("constexpr int STAGES = NT == 1 ? 4 : 2;",
         "constexpr int STAGES = NT == 1 ? 6 : 2;"),
        ("constexpr int NB = NT == 1 ? 3 : 2;", "constexpr int NB = 2;")],
    "no_stores": [
        ("          store_tile(omap, ot + c * CHUNK, c, h, key0, b, oswap);",
         "          (void)omap;")],
}

TIMER = r'''
import sys
sys.path.insert(0, sys.argv[1])
import torch
from mico_tpu_torch.ops import flash_attention as fa   # the variant's
sys.path.insert(1, sys.argv[2])
from torch_flash_bench import heads_view
from torch_qkv_bench import device_kernels

gen = torch.Generator().manual_seed(0)
b, h, lq, lk, d = 2, 12, 128, 8224, 64
q, k, v = heads_view(gen, b, h, lq, lk, d)
g = torch.randn(b, lq, h, d, generator=gen).to("cuda", torch.bfloat16
                                               ).transpose(1, 2)
scale = d ** -0.5
o, lse = fa.kv_tiled_attention_plain(q, k, v, None, scale, return_lse=True)
delta = (g.float() * o.float()).sum(-1, keepdim=True).contiguous()
iters = int(sys.argv[4])
for splits in ([None, 3, 4, 6, 8, 11] if sys.argv[3] == "base" else [None]):
    plan = (fa.k6b_plan(lk, b * h, fa._sm_count(0)) if splits is None
            else fa.chunk_splits(lk, splits))
    by = device_kernels(lambda: fa._k6b_launch(
        q, k, v, g, lse, delta, None, scale, *plan), iters)
    pas = sum(ms for n, (ms, _) in by.items() if "k6b_kernel" in n)
    comb = sum(ms for n, (ms, _) in by.items() if "combine" in n)
    print(f"{sys.argv[3]}: splits {plan[0]} x {plan[1]} chunks: pass "
          f"{pas:.4f} ms, combine {comb:.4f} ms a call", flush=True)
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
    path = csrc / f"{SOURCE}.cu"
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: {SOURCE}.cu no longer has {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return tree


def ptxas_notes(tree: Path) -> str:
    """ptxas's notes about the variant's wgmmas (C75xx under -Xptxas -v),
    with the kernel instance <NT, KS> each names."""
    from mico_tpu_torch.ops import _build

    csrc = tree / "mico_tpu_torch" / "csrc"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc),
         "-o", str(tree / "ptxas.so"), str(csrc / f"{SOURCE}.cu")],
        capture_output=True, text=True, check=True)
    notes = set()
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"\((C75\d\d)\).*k6b_kernelILi(\d)ELi(\d)", line)
        if m:
            notes.add(f"{m.group(1)} <{m.group(2)}, {m.group(3)}>")
    return ", ".join(sorted(notes)) or "none"


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k6b_breakdown: needs a CUDA device", file=sys.stderr)
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
        print(f"{name}: ptxas notes {ptxas_notes(tree)}", flush=True)
        subprocess.run([sys.executable, "-c", TIMER, str(tree),
                        str(ROOT / "scripts"), name, str(args.iters)],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
