#!/usr/bin/env python3
"""K7, the int8 cross-attention of the KV-cached decode, on one CUDA card:
its device and host time per call beside the library route and the bound,
at the shapes the decode gives it.

    python3 scripts/torch_int8_bench.py [--iters 50] [--sweep]

Shapes (q (B, Lq, 768) bf16 over int8 K/V (B, Lk, 768) with (B, Lk, 12)
fp32 scales from `quantize_kv`, seed 0, K at twice V's spread): beam vision
(64, 6, 2056), greedy vision (64, 2, 2056), audio beam (128, 6, 514) and
one 4-frame video caption (1, 6, 1028). For each: the largest |d| and mean
|d| against the plain twin; `device_ms`, the kernels' own time per call
from torch.profiler; `host_ms`, the wrapper's time to issue one call (a
loop of `--iters` calls with no synchronize), and `host_min_ms`, the least
of ten such loops (the host's cores are shared, and the least filters out
other work); `ms` by CUDA events; the library route (dequantise K and V to
bf16, then one SDPA call; the port never calls it) by stage, device ms
each (`dequant_k`, `dequant_v`, `sdpa`); `bound_ms`, the larger of the
bytes (int8 K/V, scales, q and the output, each once) over 3.35 TB/s and
the operations over 989 TFLOP/s, and `roofline_share` = bound_ms /
device_ms. `--sweep` also times the device over the fast
plan's CTAs and ring stages at each shape.

Prints the card's name and power limit first, a line per shape, and one
JSON line. Runs against the `mico_tpu_torch` of the tree it lies in: copied
into an older tree (a `git archive` of the parent), it times that tree's
kernel, whose wrapper has no plan to report or sweep.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = (("beam vision", 64, 6, 2056), ("greedy vision", 64, 2, 2056),
          ("audio beam", 128, 6, 514), ("one video caption", 1, 6, 1028))
HEADS, WIDTH = 12, 768


def host_min_ms(fn, iters: int, windows: int = 10) -> float:
    """The least, over `windows` loops of `iters` calls with no synchronize
    inside, of the host's time to issue one call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e3 * best / iters


def library_stages(q, k8, ks, v8, vs, heads):
    """The library route's three stages as closures: K and V dequantised to
    bf16 (B, nh, Lk, d) views, then SDPA on them."""
    import torch.nn.functional as F

    b, lq, h = q.shape
    lk, d = k8.shape[1], h // heads

    def dq(x8, s):
        x = x8.view(b, lk, heads, d) * s[..., None]
        return x.to(torch.bfloat16).transpose(1, 2)

    kd, vd = dq(k8, ks), dq(v8, vs)
    qh = q.view(b, lq, heads, d).transpose(1, 2)
    return {"dequant_k": lambda: dq(k8, ks), "dequant_v": lambda: dq(v8, vs),
            "sdpa": lambda: F.scaled_dot_product_attention(
                qh, kd, vd, scale=d ** -0.5)}


def main() -> int:
    import chip_smoke as cs
    from mico_tpu_torch.ops import int8_attention as i8

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_bench: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    has_plan = hasattr(i8, "k7_plan")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    out = []
    for what, b, lq, lk in SHAPES:
        a = cs.k7_inputs(gen, b, lq, lk, HEADS, WIDTH)
        q, k8, ks, v8, vs, heads = a
        got = i8.int8_cross_attention(*a)
        want = i8.int8_cross_attention_plain(*a, 0.125)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()

        def k7():
            return i8.int8_cross_attention(*a)

        flops = 4 * b * lq * lk * WIDTH
        nbytes = (k8.numel() + v8.numel() + 4 * (ks.numel() + vs.numel())
                  + 2 * 2 * q.numel())
        bms, by = cs.bound_ms(flops, nbytes)
        dev = cs.device_time_ms(k7, iters=args.iters)
        row = dict(shape=what, b=b, lq=lq, lk=lk,
                   plan=(i8.k7_plan(b, heads, lq, lk, sms)._asdict()
                         if has_plan else "parent"),
                   max_abs_err=diff.max().item(),
                   mean_abs_err=diff.mean().item(),
                   mean_abs_ref=want.float().abs().mean().item(),
                   device_ms=dev, host_ms=cs.host_time_ms(k7, iters=args.iters),
                   host_min_ms=host_min_ms(k7, args.iters),
                   ms=cs.cuda_time_ms(k7, iters=args.iters),
                   bound_ms=bms, bound_by=by,
                   roofline_share=None if dev is None else bms / dev)
        stages = {k: cs.device_time_ms(fn, iters=args.iters)
                  for k, fn in library_stages(*a).items()}
        row["library_device_ms"] = stages
        row["library_ms"] = cs.cuda_time_ms(lambda: cs.k7_library(*a),
                                            iters=args.iters)
        print(f"{what} q ({b}, {lq}, {WIDTH}) over {lk} keys, plan "
              f"{row['plan']}: device {cs.ms_text(dev)} ms, host "
              f"{row['host_ms']:.4f} (least {row['host_min_ms']:.4f}), events "
              f"{row['ms']:.4f}; bound {bms:.4f} ({by}), share "
              f"{cs.ms_text(row['roofline_share'], 3)}; library "
              + ", ".join(f"{k} {cs.ms_text(v)}" for k, v in stages.items())
              + f" (events {row['library_ms']:.4f}); max|d| "
              f"{row['max_abs_err']:.3e} mean|d| {row['mean_abs_err']:.3e}",
              flush=True)
        if args.sweep and has_plan:
            plan = i8.k7_plan(b, heads, lq, lk, sms)
            sweep = {}
            if plan.route == "fast":
                for ctas in sorted({max(1, sms // 2), min(b * heads, sms),
                                    b * heads}):
                    for st in range(i8.K7_MIN_STAGES, plan.stages + 1):
                        p = plan._replace(ctas=min(ctas, b * heads), stages=st)
                        sweep[f"{p.ctas} CTAs x {st} stages"] = (
                            cs.device_time_ms(lambda: i8._k7_launch(
                                q, k8, ks, v8, vs, heads, 0.125, p),
                                iters=args.iters))
            sweep["large plan"] = cs.device_time_ms(
                lambda: i8._k7_launch(q, k8, ks, v8, vs, heads, 0.125,
                                      plan._replace(route="large")),
                iters=args.iters)
            row["sweep_device_ms"] = sweep
            print("  sweep: " + ", ".join(
                f"{k} {cs.ms_text(v)}" for k, v in sweep.items()), flush=True)
        out.append(row)
        del a, q, k8, ks, v8, vs, got, want, diff
    print(json.dumps({"card": card, "k7": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
