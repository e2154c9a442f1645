#!/usr/bin/env python3
"""Where the time of the port's omni step goes, on one CUDA card.

    python3 scripts/torch_omni_profile.py [--vision-encoder TYPE]
                                          [--cls-split] [--attn-proj]
                                          [--trace out/trace.json]

Builds the full-width MiCo port in bf16 (random weights, seed 0) on the
vision tower `--vision-encoder` (default `evaclip01_giant`, the pre-norm
ViT-g on K1; `evaclip02_bige` is the post-norm EVA02-CLIP-bigE on K5;
`clip_vit_large_14_336px` is the OpenAI-CLIP ViT-L/14 at 224 px on K3, or
on K9 with `--cls-split`, which sets `PACKED_CLS_SPLIT`; `--attn-proj` sets
`FUSED_ATTN_PROJ`, which takes bigE's blocks to K8),
runs chip_smoke.py's omni step (S = 16: a 112-frame ViT pass, BERT over
(16, 30) tokens, heads, similarity) 3 times under `torch.profiler` after 2
warm-up steps, and prints:
  - the step's host-clock time and the device's busy and idle shares over
    the profiled window;
  - device time by kernel, with the launches of K1 (ln_stats, its
    LN-prologue wgmma GEMM), of K5 and K8 (their wgmma GEMM), of the wgmma
    attention that K1, K3, K5 and K8 share and of K9 named, grouped into
    those / K2 / cuBLAS GEMMs / LayerNorm / GELU / the rest;
  - the top kernels by device time.
`--trace` also writes the chrome trace. Ends with one JSON line of the
grouped numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import S, omni_inputs, omni_step  # noqa: E402

STEPS = 3

GROUPS = (
    ("K1 ln_stats", ("ln_stats_kernel",)),
    ("K1 LN-prologue GEMM", ("ln_gemm_kernel",)),
    ("K5/K8 GEMM", ("wgmma_gemm_kernel",)),
    ("K1/K3/K5/K8 attention", ("qkv_attn_kernel",)),
    ("K9 CLS-split attention", ("cls_attn_kernel",)),
    ("K2 flash", ("flash_kernel", "combine_kernel")),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "sm90_xmma", "nvjet", "Kernel2")),
    ("layer_norm", ("layer_norm", "LayerNorm")),
    ("gelu", ("gelu", "GeluCUDAKernel")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other elementwise / copies"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vision-encoder", default="evaclip01_giant",
                    choices=("evaclip01_giant", "evaclip02_bige",
                             "clip_vit_large_14_336px"),
                    help="the vision tower (MiCoConfig.vision_encoder_type)")
    ap.add_argument("--cls-split", action="store_true",
                    help="set PACKED_CLS_SPLIT (K9 for the K3 route)")
    ap.add_argument("--attn-proj", action="store_true",
                    help="set FUSED_ATTN_PROJ (K8 for a post-norm tower's K5)")
    ap.add_argument("--trace", help="write the chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_omni_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.ops import _build
    from mico_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.build_all()
    fa.PACKED_CLS_SPLIT = args.cls_split
    fa.FUSED_ATTN_PROJ = args.attn_proj
    cfg = MiCoConfig(vision_encoder_type=args.vision_encoder,
                     max_vision_sample_num=4, max_audio_sample_num=2)
    model = MiCo(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    dev = {k: torch.from_numpy(v).cuda() for k, v in omni_inputs().items()}
    for _ in range(2):
        omni_step(model, **dev)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            omni_step(model, **dev)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    by_kernel = defaultdict(float)
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] += dev_us / 1e3 / STEPS
    busy_ms = sum(by_kernel.values())
    step_ms = wall_ms / STEPS
    groups = defaultdict(float)
    for name, ms in by_kernel.items():
        groups[group_of(name)] += ms
    tower = (args.vision_encoder
             + (" (PACKED_CLS_SPLIT)" if args.cls_split else "")
             + (" (FUSED_ATTN_PROJ)" if args.attn_proj else ""))
    print(f"omni step S={S} on {tower}: {step_ms:.3f} ms "
          f"host clock over {STEPS} "
          f"steps; device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / step_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / step_ms):.1f}% [{card}]")
    print("device time by group (ms/step, share of busy):")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:28s} {ms:9.3f}  {100 * ms / busy_ms:5.1f}%")
    print("top kernels (ms/step):")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f}  {name[:110]}")
    print(json.dumps({"card": card, "vision_encoder": args.vision_encoder,
                      "cls_split": args.cls_split,
                      "attn_proj": args.attn_proj,
                      "step_ms": step_ms, "busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / step_ms,
                      "groups_ms": dict(groups)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
