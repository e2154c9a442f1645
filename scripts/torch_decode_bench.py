#!/usr/bin/env python3
"""Caption decode throughput of the port on one CUDA card (counterpart of
`scripts/decode_bench.py`).

    python3 scripts/torch_decode_bench.py [--preset vision|audio|qa]
        [--modes sample,beam] [--iters 5] [--int8] [--split-heads]
        [--profile] [--trace DIR]

Presets as `decode_bench.py`: vision, batch 64 over a 2056-token condition
(8 frames x 257, the vision captioner deployment); audio, batch 128 over 514
tokens (2 audio slices); qa, batch 64 over 2056 tokens with a 25-token
question prefix and 10 answer tokens (modes greedy_qa and beam_qa). Other
presets decode 40 new tokens. The model is BERT-base in bf16 with random
weights from seed 0; the condition is drawn on the card from seed 1.
`--int8` stores the cross K/V as int8 and decodes through kernel K7;
`--split-heads` stores them per head (`CROSS_KV_SPLIT_HEADS`).

Prints the card's name and power limit, then for each mode ms/batch,
items/s and ms/step, the median of `--iters` runs after one warm-up (host
clock, each run ending in a synchronize). `--profile` decodes each mode once
more under `torch.profiler` and prints device time per decode step by
kernel group, the top kernels, the device operations per step, and the
device's busy and idle shares over the decode: the idle share is the
host's cost of the eager step loop.
`--trace DIR` also writes each mode's chrome trace there. Ends with one JSON
line of the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PRESETS = {
    "vision": dict(b=64, cond_tokens=2056),
    "audio": dict(b=128, cond_tokens=514),
    "qa": dict(b=64, cond_tokens=2056, prefix_len=25, new_tokens=10),
}
NEW_TOKENS = 40

GROUPS = (
    ("K7 int8_cross_attn", ("int8_cross",)),
    ("K2 flash", ("flash_kernel", "combine_kernel")),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "sm90_xmma", "nvjet", "Kernel2",
                       "gemv")),
    ("softmax", ("softmax", "Softmax")),
    ("sort (top-k)", ("sort", "Sort", "radix", "Radix")),
    ("layer_norm", ("layer_norm", "LayerNorm")),
    ("copies, gathers, concat", ("copy", "Copy", "CatArray", "cat_", "gather",
                                 "index", "scatter")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other elementwise"


def profile_decode(fn, steps: int, trace: str = ""):
    """Device time by kernel per decode step and the busy share of one
    decode under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if trace:
        prof.export_chrome_trace(trace)
    by_kernel = defaultdict(float)
    launches = 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] += dev_us / 1e3
            launches += evt.count
    busy_ms = sum(by_kernel.values())
    groups = defaultdict(float)
    for name, ms in by_kernel.items():
        groups[group_of(name)] += ms / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms,
                device_ops_per_step=launches / steps,
                groups_ms_per_step=dict(groups),
                top_ms_per_step=[(n[:100], ms / steps) for n, ms in top])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="vision", choices=sorted(PRESETS))
    ap.add_argument("--modes", default=None,
                    help="comma list; default sample,beam "
                         "(greedy_qa,beam_qa for --preset qa)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--int8", action="store_true",
                    help="int8 cross K/V through kernel K7")
    ap.add_argument("--split-heads", action="store_true",
                    help="store the cross K/V split per head")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--trace", default="", help="directory for chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_bench: needs a CUDA device", file=sys.stderr)
        return 2
    from mico_tpu_torch import generation as gen
    from mico_tpu_torch.config import BertConfig
    from mico_tpu_torch.models._params import Init
    from mico_tpu_torch.models.bert import Bert
    from mico_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.build_all()
    gen.CROSS_KV_SPLIT_HEADS = args.split_heads
    preset = PRESETS[args.preset]
    b, lk = preset["b"], preset["cond_tokens"]
    new_tokens = preset.get("new_tokens", NEW_TOKENS)
    prefix_len = preset.get("prefix_len", 0)
    cfg = BertConfig()
    bert = Bert(cfg, Init(torch.Generator().manual_seed(0)))
    bert = bert.to("cuda", torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    cond = torch.randn((b, lk, cfg.encoder_width), generator=g,
                       device="cuda", dtype=torch.bfloat16)
    kw = dict(max_new_tokens=new_tokens, num_beams=3, top_k=10,
              int8_cross_kv=args.int8)
    fns = {
        "sample": lambda: gen.generate(bert, cond, mode="sample", **kw),
        "beam": lambda: gen.generate(bert, cond, mode="beam", **kw),
    }
    default_modes = "sample,beam"
    if prefix_len:
        ids = torch.randint(200, 20000, (b, prefix_len), generator=g,
                            device="cuda")
        mask = torch.ones_like(ids)
        fns["greedy_qa"] = lambda: gen.generate_answers(
            bert, ids, mask, cond, mode="greedy", **kw)
        fns["beam_qa"] = lambda: gen.generate_answers(
            bert, ids, mask, cond, mode="beam", **kw)
        default_modes = "greedy_qa,beam_qa"
    route = ("int8 (K7)" if args.int8 else "bf16") + (
        ", split heads" if args.split_heads else "")
    print(f"preset {args.preset}: B={b}, condition ({b}, {lk}, "
          f"{cfg.encoder_width}) bf16, {new_tokens} new tokens, cross K/V "
          f"{route}", flush=True)
    results = {}
    for mode in (args.modes or default_modes).split(","):
        fn = fns[mode]
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms = statistics.median(times)
        res = dict(ms_per_batch=ms, runs_ms=times, items_per_s=1e3 * b / ms,
                   ms_per_step=ms / new_tokens)
        print(f"{mode}: {ms:.2f} ms/batch  {1e3 * b / ms:.2f} items/s  "
              f"({ms / new_tokens:.3f} ms/step; runs {[round(x, 2) for x in times]})"
              f" [{card}]", flush=True)
        if args.profile:
            trace = ""
            if args.trace:
                os.makedirs(args.trace, exist_ok=True)
                trace = os.path.join(args.trace, f"decode_{args.preset}_{mode}"
                                     f"{'_int8' if args.int8 else ''}.json")
            prof = profile_decode(fn, new_tokens, trace)
            res["profile"] = prof
            print(f"  profiled decode: {prof['wall_ms']:.2f} ms host clock, "
                  f"device busy {prof['busy_ms']:.2f} ms, idle "
                  f"{100 * prof['idle_share']:.1f}%, "
                  f"{prof['device_ops_per_step']:.1f} device operations "
                  f"(kernels, copies) per step", flush=True)
            print("  device time per decode step by group (ms):", flush=True)
            for grp, gms in sorted(prof["groups_ms_per_step"].items(),
                                   key=lambda kv: -kv[1]):
                print(f"    {grp:26s} {gms:8.4f}", flush=True)
            print("  top kernels (ms per step):", flush=True)
            for name, kms in prof["top_ms_per_step"]:
                print(f"    {kms:8.4f}  {name}", flush=True)
        results[mode] = res
    print(json.dumps({"card": card, "preset": args.preset, "b": b,
                      "cond_tokens": lk, "new_tokens": new_tokens,
                      "int8": args.int8, "split_heads": args.split_heads,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
