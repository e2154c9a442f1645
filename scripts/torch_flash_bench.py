#!/usr/bin/env python3
"""K2 and K6, the streamed online-softmax attention, on one CUDA card: the
time of a call split into the device's time and the wrapper's host time,
beside SDPA on the same inputs.

    python3 scripts/torch_flash_bench.py [--iters 100] [--sweep]

The shapes are the ones the port's paths give the two kernels, bf16 of unit
std from seed 0, q/k/v strided (B, H, L, D) views of (B, L, H, D) tensors
as BERT makes them:

  - K2 at ITM's cross-attention, q (3, 12, 30, 64) over 257 keys (12
    launches per ITM on every tower);
  - K2 at the recompute caption decode, q (1, 12, 10, 64) over 1028 keys
    (96 launches per 8-token caption);
  - K2 at the long-context step's causal self-attention, q (2, 12, 128,
    64) over 128 keys with a (2, 1, 128, 128) causal bias (12 per step);
  - K6 at the long-context step's cross-attention, q (2, 12, 128, 64) over
    8,224 keys, with the LSE (as training runs it) and without.

For each: `ms`, the mean time of one call by CUDA events over `--iters`
back-to-back calls (what a caller waits, host included when the host is
the slower); `device_ms`, the kernels' own time per call from
torch.profiler (every device kernel the call ran, summed over the calls and
divided by their number; `kernels_per_call` says how many); `host_ms`, the
host's time to issue one call (a loop of calls with no synchronize inside,
so the host never waits for the device); and the same three for one SDPA
call (`F.scaled_dot_product_attention`, a yardstick the port never calls).
`bound_ms` is the larger of the bytes over 3.35 TB/s and the operations
over 989 TFLOP/s; `roofline_share` is bound_ms / device_ms. `--sweep` also
times the device over query rows a block, split and key-warp counts at
each shape (`flash_attention._flash_launch` with the counts given). Prints the
card's name and power limit, a line per shape and one JSON line. Runs from
any working directory, against the `mico_tpu_torch` of the tree it lies in
(a copy of it in an older tree times that tree's kernels).
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def event_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """The host's time to issue one call: no synchronize inside the loop."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / iters


def device_ms(fn, iters: int):
    """(device ms per call, device kernels per call, kernel names) from
    torch.profiler: for each kernel the calls ran, its mean recorded
    duration times its launches per call. The profiler now and then loses
    kernel records, so a sum divided by the calls would read low. The calls
    are identical, so a kernel recorded in fewer than half of them (cuDNN's
    memset once: 3 of 50) counts once a call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, launches, names = 0.0, 0, set()
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if (dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            per_call = max(round(evt.count / iters), 1)
            total_us += dev_us / evt.count * per_call
            launches += per_call
            names.add(evt.key[:90])
    if not launches:
        raise RuntimeError("torch.profiler recorded no device kernel")
    return total_us / 1e3, launches, sorted(names)


def timing(fn, iters: int) -> dict:
    dev, per_call, names = device_ms(fn, iters)
    return dict(ms=event_ms(fn, iters), device_ms=dev, host_ms=host_ms(
        fn, iters), kernels_per_call=per_call, kernels=names)


def heads_view(gen, b, h, lq, lk, d):
    """Unit-std bf16 q, k, v as BERT's attention makes them: q a (B, Lq, H,
    D) tensor and k, v column slices of one (B, Lk, 2, H, D) projection,
    each viewed as (B, H, L, D)."""
    def r(*s):
        return torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)

    kv = r(b, lk, 2, h, d)
    return (r(b, lq, h, d).transpose(1, 2), kv[:, :, 0].transpose(1, 2),
            kv[:, :, 1].transpose(1, 2))


def cases(gen):
    causal = torch.full((128, 128), -10000.0).triu(1)
    causal = causal.expand(2, 1, 128, 128).contiguous().cuda()
    return [
        ("K2 ITM", (3, 12, 30, 257, 64), None, False),
        ("K2 recompute decode", (1, 12, 10, 1028, 64), None, False),
        ("K2 long-context causal self-attention", (2, 12, 128, 128, 64),
         causal, False),
        ("K6 long-context cross-attention, with LSE", (2, 12, 128, 8224, 64),
         None, True),
        ("K6 long-context cross-attention, no LSE", (2, 12, 128, 8224, 64),
         None, False),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bench: needs a CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from mico_tpu_torch.ops import _build
    from mico_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; package "
          f"{Path(fa.__file__).resolve().parent.parent}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, (b, h, lq, lk, d), bias, lse in cases(gen):
        q, k, v = heads_view(gen, b, h, lq, lk, d)
        scale = d ** -0.5
        if name.startswith("K6"):
            def kernel():
                return fa.kv_tiled_attention(q, k, v, bias, scale,
                                             return_lse=lse)
        else:
            def kernel():
                return fa.flash_attention(q, k, v, bias=bias, scale=scale)
        mask = None if bias is None else bias.to(torch.bfloat16)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=scale)

        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        nbytes += 4 * (bias.numel() if bias is not None else 0)
        nbytes += 4 * b * h * lq if lse else 0
        flops = 4 * b * h * lq * lk * d
        bound = 1e3 * max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS)
        row = dict(name=name, shape=[b, h, lq, lk, d], bias=bias is not None,
                   lse=lse, bound_ms=bound, kernel=timing(kernel, args.iters),
                   sdpa=timing(sdpa, args.iters), card=card)
        bias_rows = 0 if bias is None else (1 if bias.shape[2] == 1 else -1)
        if hasattr(fa, "flash_plan"):   # a tree from before the plan has none
            plan = fa.flash_plan(lq, lk, b * h, d, bias_rows,
                                 fa._sm_count(q.device.index))
        else:
            plan = (None, 1, 1)
        row.update(row_warps=plan[0], key_warps=plan[1], splits=plan[2])
        kt, st = row["kernel"], row["sdpa"]
        row["roofline_share"] = bound / kt["device_ms"]
        print(f"{name} {tuple(row['shape'])}: kernel {kt['ms']:.4f} ms "
              f"(device {kt['device_ms']:.4f} in {kt['kernels_per_call']:g} "
              f"kernels, host {kt['host_ms']:.4f}); SDPA {st['ms']:.4f} "
              f"(device {st['device_ms']:.4f}, host {st['host_ms']:.4f}); "
              f"bound {bound:.5f}, roofline share "
              f"{row['roofline_share']:.3f}; splits {row['splits']}, key "
              f"warps {row['key_warps']} [{card}]", flush=True)
        if args.sweep:
            sweep = {}
            chunks = -(-lk // fa.KV_CHUNK)
            counts = (range(1, chunks + 1) if chunks <= 24
                      else (1, 2, 3, 4, 6, 8, 11, 12, 16, 22))
            for brows, n, kw in itertools.product(
                    (16, 128) if 16 < lq and chunks <= 24 else (128,),
                    counts, (1, 2, 3, 4, 5, 8)):
                got = fa.flash_plan(lq, lk, b * h, d, bias_rows,
                                    fa._sm_count(q.device.index), n, kw, brows)
                key = f"{16 * got[0]}r{got[2]}x{got[1]}"
                if key not in sweep:
                    sweep[key] = device_ms(lambda: fa._flash_launch(
                        q, k, v, bias, scale, tiled=name.startswith("K6"),
                        return_lse=lse, splits=n, key_warps=kw,
                        block_rows=brows), args.iters)[0]
            row["device_ms_by_rows_r_splits_x_key_warps"] = sweep
            print("  device ms by rows r splits x key warps: " + ", ".join(
                f"{n}: {ms:.4f}" for n, ms in sweep.items()), flush=True)
        rows.append(row)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
