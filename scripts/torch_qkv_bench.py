#!/usr/bin/env python3
"""K5 and K8 (the post-norm block's projection-fused attention), K1 (the
LN-fused attention of the ViT-g omni step), K3 (the packed attention of
ViT training), K9 (K3's CLS-split form) or K4 (K3's backward) on one CUDA
card: each call's time, and the device's time per stage beside one PyTorch
call for the same stage.

    python3 scripts/torch_qkv_bench.py [--kernel K5|K1|K3|K9|K4] [--iters 50]

--kernel K1: at the omni step's ViT-g pass, x (112, 257, 1408) bf16 with 16
heads of 88 and the LN affine on (`chip_smoke.k1_inputs`, seed 1): K1's
event ms and device ms by stage (the statistics pass, the GEMM, the
attention) beside F.layer_norm, F.linear at the qkv shape and SDPA on that
qkv, and the library route's event ms.
--kernel K3: at the train step's pass, qkv (32, 257, 4224) (16 heads of 88),
and CLIP-L/14's, (112, 257, 3072) (16 heads of 64), unit-std column slices
of a fused qkv (seed 3): K3's event and device ms beside SDPA's.
--kernel K9: at CLIP-L/14's pass and the train step's (unit-std fused qkv,
seed 5): K9's event and device ms beside K3's and SDPA's device ms on the
same input.
--kernel K4: at the train step's pass, qkv (32, 257, 4224) with g (32,
257, 1408), and the long-context step's, (64, 257, 4224) (unit std, seed
3; dq, dk, dv into one dqkv, as the autograd Function calls it): K4's
event ms and device ms, in all and by launch (kernels named "rows" and
"cols"), beside SDPA's autograd backward alone in device ms with each
backend that takes the shape pinned (flash, cuDNN, memory-efficient).
--kernel K5 (the default): at the bigE omni step's ViT pass, x (112, 257,
1792) bf16 with 16 heads of 112 (`chip_smoke.fused_qkv_inputs`: unit-std
x, weights and biases at the init std 0.02, seed 4), it prints:
  - for each of K5 and K8: `ms`, the mean time of one call by CUDA events
    over `--iters` back-to-back calls; `device_ms`, the kernels' own time
    per call from torch.profiler, split by stage: the qkv GEMM, the
    attention and (K8) the out-projection GEMM. A kernel is filed under a
    stage by its name ("gemm" or "attn"); K8's two GEMMs share a name, so
    its out-projection is K8's GEMM time less K5's. The profiler now and
    then loses kernel records: a kernel recorded in fewer than half of the
    identical calls counts once a call;
  - beside them, F.linear at the qkv and the out-projection shape and SDPA
    (`F.scaled_dot_product_attention`) on the q/k/v of the same qkv, each
    with its event and device ms: yardsticks the port never calls;
  - each stage's TFLOP/s and roofline share (bound / device ms; the bound
    is the larger of its operations over 989 TFLOP/s and its bytes over
    3.35 TB/s, each input read once and each output written once);
  - where the tree has `bf16_gemm_bias`, the GEMM stage alone.
Prints the card's name and power limit first and ends with one JSON line.
Runs from any working directory, against the `mico_tpu_torch` of the tree
it lies in: copied into an older tree it times that tree's kernels, which
is how a parent/change A/B runs in one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
B, L, H, D = 112, 257, 16, 112


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


def device_kernels(fn, iters: int) -> dict:
    """{kernel name: (device ms per call, launches per call)} from
    torch.profiler, with the lost-record rule of the module docstring."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if (dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            per_call = max(round(evt.count / iters), 1)
            out[evt.key] = (dev_us / evt.count * per_call / 1e3, per_call)
    if not out:
        raise RuntimeError("torch.profiler recorded no device kernel")
    return out


def stage_ms(kernels: dict, word: str) -> float:
    return sum(ms for name, (ms, _) in kernels.items() if word in name)


def bound(flops: float, nbytes: float) -> float:
    return 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def device_ms(fn, iters: int) -> float:
    return sum(ms for ms, _ in device_kernels(fn, iters).values())


def bench_k1(fa, card: str, it: int) -> dict:
    """K1 at the omni step's ViT-g pass, by stage, beside its library
    route's stages."""
    import torch.nn.functional as F

    from chip_smoke import k1_inputs, k1_library

    args = k1_inputs(torch.Generator().manual_seed(1), 112)
    x, g, b0, w, bias, nh, scale, eps = args
    b, l, wd = x.shape
    d = wd // nh

    def k1():
        return fa.fused_ln_qkv_self_attention(*args, True)

    kern = device_kernels(k1, it)
    stages = {"statistics": stage_ms(kern, "stats"),
              "GEMM": stage_ms(kern, "gemm"),
              "attention": stage_ms(kern, "attn")}
    gx, bx, wt, b16 = g.to(x.dtype), b0.to(x.dtype), w.t(), bias.to(x.dtype)
    xn = F.layer_norm(x, (wd,), gx, bx, eps)
    qkv = F.linear(xn, wt, b16)
    q, k, v = qkv.view(b, l, 3, nh, d).permute(2, 0, 3, 1, 4)
    lib = {"F.layer_norm": device_ms(
               lambda: F.layer_norm(x, (wd,), gx, bx, eps), it),
           "F.linear": device_ms(lambda: F.linear(xn, wt, b16), it),
           "SDPA": device_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, scale=scale), it)}
    row = dict(ms=event_ms(k1, it),
               device_ms=sum(ms for ms, _ in kern.values()),
               kernels={n: ms for n, (ms, _) in kern.items()},
               stages_device_ms=stages, library_device_ms=lib,
               library_ms=event_ms(lambda: k1_library(*args, True), it))
    print(f"K1 x {tuple(x.shape)}: {row['ms']:.4f} ms a call (events), "
          f"device {row['device_ms']:.4f} ms [{card}]; library route "
          f"{row['library_ms']:.4f} ms (events)", flush=True)
    print("  device ms by stage: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + "; beside: " + ", ".join(
        f"{k} {v:.4f}" for k, v in lib.items()), flush=True)
    return {"kernel": "K1", "shape": [b, l, nh, d], "K1": row}


def bench_k3(fa, card: str, it: int) -> dict:
    """K3 at the train pass and at CLIP-L/14's, beside SDPA."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(3)
    rows = {}
    for b, l, nh, d in ((32, 257, 16, 88), (112, 257, 16, 64)):
        w = nh * d
        qkv = torch.randn(b, l, 3 * w, generator=gen).to("cuda",
                                                         torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        qh, kh, vh = (t.view(b, l, nh, d).transpose(1, 2) for t in (q, k, v))
        scale = d ** -0.5

        def k3():
            return fa.packed_attention(q, k, v, nh, scale)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, scale=scale)

        bms = bound(4.0 * b * nh * l * l * d, 2.0 * (qkv.numel() + b * l * w))
        row = dict(ms=event_ms(k3, it), device_ms=device_ms(k3, it),
                   sdpa_ms=event_ms(sdpa, it), sdpa_device_ms=device_ms(sdpa, it),
                   bound_ms=bms)
        rows[f"{b}x{l}x{nh}x{d}"] = row
        print(f"K3 qkv ({b}, {l}, {3 * w}): {row['ms']:.4f} ms a call "
              f"(events), device {row['device_ms']:.4f} ms; SDPA "
              f"{row['sdpa_ms']:.4f}, device {row['sdpa_device_ms']:.4f} ms; "
              f"bound {bms:.4f} ms [{card}]", flush=True)
    return {"kernel": "K3", "K3": rows}


def bench_k9(fa, card: str, it: int) -> dict:
    """K9 at CLIP-L/14's pass and the train pass, beside K3 and SDPA on the
    same input."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(5)
    rows = {}
    for b, l, nh, d in ((112, 257, 16, 64), (32, 257, 16, 88)):
        w = nh * d
        qkv = torch.randn(b, l, 3 * w, generator=gen).to("cuda",
                                                         torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        qh, kh, vh = (t.view(b, l, nh, d).transpose(1, 2) for t in (q, k, v))
        scale = d ** -0.5

        def k9():
            return fa.packed_qkv_cls_attention(qkv, nh, scale)

        def k3():
            return fa.packed_attention(q, k, v, nh, scale)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, scale=scale)

        bms = bound(4.0 * b * nh * l * l * d, 2.0 * (qkv.numel() + b * l * w))
        row = dict(ms=event_ms(k9, it), device_ms=device_ms(k9, it),
                   k3_device_ms=device_ms(k3, it),
                   sdpa_device_ms=device_ms(sdpa, it), bound_ms=bms)
        rows[f"{b}x{l}x{nh}x{d}"] = row
        print(f"K9 qkv ({b}, {l}, {3 * w}): {row['ms']:.4f} ms a call "
              f"(events), device {row['device_ms']:.4f} ms; K3 device "
              f"{row['k3_device_ms']:.4f}, SDPA device "
              f"{row['sdpa_device_ms']:.4f} ms; bound {bms:.4f} ms [{card}]",
              flush=True)
    return {"kernel": "K9", "K9": rows}


def bench_k4(fa, card: str, it: int) -> dict:
    """K4 at the train pass and the long-context pass, by launch, beside
    SDPA's backward per pinned backend (`chip_smoke.sdpa_bwd_backends`)."""
    from chip_smoke import sdpa_bwd_backends

    gen = torch.Generator().manual_seed(3)
    rows = {}
    for b, l, nh, d in ((32, 257, 16, 88), (64, 257, 16, 88)):
        w = nh * d
        qkv = torch.randn(b, l, 3 * w, generator=gen).to("cuda",
                                                         torch.bfloat16)
        g = torch.randn(b, l, w, generator=gen).to("cuda", torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        dqkv = torch.empty_like(qkv)
        scale = d ** -0.5

        def k4():
            return fa.packed_attention_bwd(q, k, v, g, nh, scale, dqkv)

        kern = device_kernels(k4, it)
        lib = {n: device_ms(fn, it) for n, fn in
               sdpa_bwd_backends(qkv, g, nh, scale).items()}
        bms = bound(10.0 * b * nh * l * l * d,
                    2.0 * (2 * qkv.numel() + g.numel()))
        row = dict(ms=event_ms(k4, it),
                   device_ms=sum(ms for ms, _ in kern.values()),
                   by_launch={"rows": stage_ms(kern, "rows"),
                              "cols": stage_ms(kern, "cols")},
                   kernels={n: ms for n, (ms, _) in kern.items()},
                   sdpa_backward_device_ms=lib, bound_ms=bms)
        rows[f"{b}x{l}x{nh}x{d}"] = row
        print(f"K4 qkv ({b}, {l}, {3 * w}): {row['ms']:.4f} ms a call "
              f"(events), device {row['device_ms']:.4f} ms (rows "
              f"{row['by_launch']['rows']:.4f}, cols "
              f"{row['by_launch']['cols']:.4f}); SDPA backward device " +
              ", ".join(f"{n} {ms:.4f}" for n, ms in lib.items()) +
              f" ms; bound {bms:.4f} ms [{card}]", flush=True)
    return {"kernel": "K4", "K4": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("K5", "K1", "K3", "K9", "K4"),
                    default="K5")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_qkv_bench: needs a CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from chip_smoke import fused_qkv_inputs
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
    if args.kernel != "K5":
        bench = {"K1": bench_k1, "K3": bench_k3, "K9": bench_k9,
                 "K4": bench_k4}[args.kernel]
        print(json.dumps({"card": card, "iters": args.iters,
                          **bench(fa, card, args.iters)}))
        return 0

    a = fused_qkv_inputs(torch.Generator().manual_seed(4), B, L, H, D)
    x, w, bias, wp, bp = a["x"], a["w"], a["bias"], a["wp"], a["bp"]
    scale = a["scale"]
    m, wd = B * L, H * D
    it = args.iters

    def k5():
        return fa.fused_qkv_self_attention(x, w, bias, H, scale)

    def k8():
        return fa.fused_qkv_attn_proj(x, w, bias, wp, bp, H, scale)

    x2, wt, wpt = x.view(m, wd), w.t(), wp.t()
    b16, bp16 = bias.to(x.dtype), bp.to(x.dtype)
    qkv = F.linear(x2, wt, b16)
    q, k, v = qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
    o = k5().view(m, wd)

    def lin_qkv():
        return F.linear(x2, wt, b16)

    def lin_proj():
        return F.linear(o, wpt, bp16)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    f_qkv = 2.0 * m * wd * 3 * wd
    f_proj = 2.0 * m * wd * wd
    f_att = 4.0 * B * H * L * L * D
    by_qkv = 2.0 * (m * wd + w.numel() + m * 3 * wd) + 4 * bias.numel()
    by_proj = 2.0 * (2 * m * wd + wp.numel()) + 4 * bp.numel()
    by_att = 2.0 * (m * 3 * wd + m * wd)
    bounds = {"qkv GEMM": bound(f_qkv, by_qkv), "attention": bound(f_att, by_att),
              "out-projection GEMM": bound(f_proj, by_proj)}
    flops = {"qkv GEMM": f_qkv, "attention": f_att,
             "out-projection GEMM": f_proj}

    rows = {}
    kern5 = device_kernels(k5, it)
    kern8 = device_kernels(k8, it)
    g5, g8 = stage_ms(kern5, "gemm"), stage_ms(kern8, "gemm")
    stages5 = {"qkv GEMM": g5, "attention": stage_ms(kern5, "attn")}
    stages8 = {"qkv GEMM": g5, "attention": stage_ms(kern8, "attn"),
               "out-projection GEMM": g8 - g5}
    for name, fn, kern, stages in (("K5", k5, kern5, stages5),
                                   ("K8", k8, kern8, stages8)):
        rows[name] = dict(ms=event_ms(fn, it),
                          device_ms=sum(ms for ms, _ in kern.values()),
                          kernels={n: ms for n, (ms, _) in kern.items()},
                          stages_device_ms=stages)
    lib = {}
    for name, fn in (("F.linear qkv", lin_qkv), ("SDPA", sdpa),
                     ("F.linear out-projection", lin_proj)):
        kern = device_kernels(fn, it)
        lib[name] = dict(ms=event_ms(fn, it),
                         device_ms=sum(ms for ms, _ in kern.values()),
                         kernels={n: ms for n, (ms, _) in kern.items()})
    yard = {"qkv GEMM": "F.linear qkv", "attention": "SDPA",
            "out-projection GEMM": "F.linear out-projection"}
    for name in ("K5", "K8"):
        r = rows[name]
        print(f"{name}: {r['ms']:.4f} ms a call (events), device "
              f"{r['device_ms']:.4f} ms [{card}]", flush=True)
        r["stages"] = {}
        for st, ms in r["stages_device_ms"].items():
            y = lib[yard[st]]
            r["stages"][st] = dict(
                device_ms=ms, tflops=flops[st] / ms / 1e9,
                roofline_share=bounds[st] / ms, bound_ms=bounds[st],
                library=yard[st], library_device_ms=y["device_ms"],
                ratio_to_library=ms / y["device_ms"])
            print(f"  {st:20s} device {ms:.4f} ms, "
                  f"{flops[st] / ms / 1e9:7.1f} TFLOP/s, roofline share "
                  f"{bounds[st] / ms:.3f} (bound {bounds[st]:.4f}); "
                  f"{yard[st]} device {y['device_ms']:.4f} ms "
                  f"({ms / y['device_ms']:.2f}x)", flush=True)
    for name, r in lib.items():
        print(f"{name}: {r['ms']:.4f} ms a call (events), device "
              f"{r['device_ms']:.4f} ms", flush=True)
    alone = None
    if hasattr(fa, "bf16_gemm_bias"):
        kern = device_kernels(lambda: fa.bf16_gemm_bias(x2, w, bias), it)
        ms = sum(v for v, _ in kern.values())
        alone = dict(device_ms=ms, tflops=f_qkv / ms / 1e9)
        print(f"GEMM stage alone, qkv shape: device {ms:.4f} ms, "
              f"{f_qkv / ms / 1e9:.1f} TFLOP/s", flush=True)
    print(json.dumps({"card": card, "shape": [B, L, H, D], "iters": it,
                      "rows": rows, "library": lib, "gemm_alone": alone,
                      "bounds_ms": bounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
