#!/usr/bin/env python3
"""K2 and K6, the streamed online-softmax attention, on one CUDA card: the
time of a call split into the device's time and the wrapper's host time,
beside SDPA on the same inputs.

    python3 scripts/torch_flash_bench.py [--iters 100] [--sweep]
    python3 scripts/torch_flash_bench.py --kernel K6b [--iters 100] [--sweep]

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
each shape (`flash_attention._flash_launch` with the counts given).

`--kernel K6b` times K6's backward instead, at the long-context step's
cross-attention (q, g (2, 12, 128, 64) over 8,224 keys, BERT's layout, from
K6's lse and δ), with no bias and with a (2, 1, 1, 8224) padding bias: the
device ms a call in all and by kernel (the split-key pass and the dQ
combine), event and host ms, beside SDPA's autograd backward alone, pinned
to each backend (flash, cuDNN, memory-efficient; the fastest is K6b's
yardstick); `--sweep` adds the device ms over split counts. Prints the
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
    torch.profiler, by `torch_qkv_bench.device_kernels`: for each kernel the
    calls ran, its mean recorded duration times its launches per call. The
    profiler now and then loses kernel records, so a sum divided by the
    calls would read low. The calls are identical, so a kernel recorded in
    fewer than half of them (cuDNN's memset once: 3 of 50) counts once a
    call."""
    from torch_qkv_bench import device_kernels

    by = device_kernels(fn, iters)
    return (sum(ms for ms, _ in by.values()), sum(n for _, n in by.values()),
            sorted(name[:90] for name in by))


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


def bench_k6b(fa, card: str, iters: int, sweep: bool) -> list:
    """K6b at the long-context step's cross-attention beside SDPA's
    backward per pinned backend (`chip_smoke.sdpa_bwd_pinned`)."""
    from chip_smoke import sdpa_bwd_pinned
    from torch_qkv_bench import device_kernels

    gen = torch.Generator().manual_seed(0)
    b, h, lq, lk, d = 2, 12, 128, 8224, 64
    q, k, v = heads_view(gen, b, h, lq, lk, d)
    go = torch.randn(b, lq, h, d, generator=gen).to(
        "cuda", torch.bfloat16).transpose(1, 2)
    scale = d ** -0.5
    pad = torch.ones(b, lk)
    pad[1, 6000:] = 0
    rows = []
    for label, bias in (("no bias", None), ("(2, 1, 1, 8224) padding bias",
                                            ((1.0 - pad) * -10000.0)[
                                                :, None, None, :].cuda())):
        o, lse = fa.kv_tiled_attention(q, k, v, bias, scale, return_lse=True)
        delta = (go.float() * o.float()).sum(-1, keepdim=True).contiguous()

        def k6b():
            return fa.kv_tiled_attention_bwd(q, k, v, go, lse, delta, bias,
                                             scale)

        by = {n: ms for n, (ms, _) in device_kernels(k6b, iters).items()}
        row = dict(name=f"K6b long-context cross-attention, {label}",
                   shape=[b, h, lq, lk, d], card=card,
                   device_ms=sum(by.values()), device_ms_by_kernel=by,
                   ms=event_ms(k6b, iters), host_ms=host_ms(k6b, iters))
        if bias is None:
            row["sdpa_backward_device_ms"] = {
                n: device_ms(fn, iters)[0]
                for n, fn in sdpa_bwd_pinned(lambda: (q, k, v), go,
                                             scale).items()}
        if sweep and hasattr(fa, "_k6b_launch"):
            row["device_ms_by_splits"] = {}
            for n in (1, 2, 3, 4, 5, 6, 8, 11, 16, 22):
                plan = fa.chunk_splits(lk, n)
                row["device_ms_by_splits"].setdefault(plan[0], device_ms(
                    lambda: fa._k6b_launch(q, k, v, go, lse, delta, bias,
                                           scale, *plan), iters)[0])
        print(f"{row['name']}: device {row['device_ms']:.4f} ms a call "
              f"({by}), event {row['ms']:.4f}, host {row['host_ms']:.4f}; "
              f"SDPA backward {row.get('sdpa_backward_device_ms')}; "
              f"splits {row.get('device_ms_by_splits')} [{card}]",
              flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--kernel", choices=("K2K6", "K6b"), default="K2K6")
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
    if args.kernel == "K6b":
        rows = bench_k6b(fa, card, args.iters, args.sweep)
        print(json.dumps({"card": card, "rows": rows}))
        return 0
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
