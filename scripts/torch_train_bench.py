#!/usr/bin/env python3
"""Pretraining step throughput of the port on one CUDA card (counterpart of
`scripts/train_bench.py`).

    python3 scripts/torch_train_bench.py [--task ret%tva_cap%tva] [--batch 8]
        [--frames 4] [--audio-slices 2] [--steps 8] [--profile]
    python3 scripts/torch_train_bench.py --long-context [--batch 2] [--profile]

The model is MiCo-ViT-g at full width (EVA01-CLIP-g/14, BERT-base) with
fp32 master weights and AdamW moments from seed 0 and bf16 compute, dropout
and drop-path on; the batch is `--batch` synthetic samples of `--frames`
RGB frames and `--audio-slices` fbank slices at 224 px and a 40-token
caption, made with numpy from seed 0 (`mico_tpu_torch.train.workload`). The
defaults are `configs/pretrain-omni.json`'s task and sample shape.
`--long-context` is `scripts/train_bench.py --long-context`'s sample: task
cap%tv over 32 frames (8,224 condition tokens) with 128-token captions and
no audio, B 2 by default, BERT's attention-probability dropout 0 so that the
cross-attention takes K6 and K6b (`workload.long_context_config`).

Prints the card's name and power limit, each step's host-clock time (each
ending in a synchronize: the step reads its loss), then one line with
ms/step (the median after two warm-up steps), samples/s and model TFLOP/s
(the analytic matmul FLOPs of `mix_train_flops`). `--profile` runs one more
step under `torch.profiler` and prints device time per step by kernel group
(K3, K4, cuBLAS GEMM, optimizer, ...), the device operations per step and
the device's idle share: over the profiled step (whose host clock the
profiler inflates) and against the unprofiled median step. User-annotation
ranges (`Optimizer.step`) are left out of the device time: their kernels
are counted on their own. Ends with one JSON line of the numbers. Runs
from any working directory.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WARMUP = 2
# K2 and K6 are instances of two templates, `flash_kernel<KS, NW, TILED>` and
# its `combine_kernel<TILED>`: K6 is TILED true, matched first
GROUPS = (
    ("K3 packed_attn", ("qkv_attn_kernel",)),
    ("K9 CLS-split attention", ("cls_attn_kernel",)),
    ("K4 packed_attn_bwd", ("k4_rows_kernel", "k4_cols_kernel",
                            "k4_dq_cast_kernel")),
    ("K6 kv_tiled", ("true>(mico::flash::FlashArgs",)),
    # K6b's split-key pass and dQ combine (`dq_kernel` and `dkv_kernel`:
    # its earlier two-launch design, for timing an older tree)
    ("K6b kv_tiled_bwd", ("k6b_kernel", "k6b::combine_kernel", "dq_kernel",
                          "dkv_kernel")),
    ("K2 flash", ("flash_kernel", "combine_kernel")),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "sm90_xmma", "nvjet", "Kernel2",
                       "gemv")),
    ("optimizer and clip (multi-tensor)", ("multi_tensor_apply", "adam",
                                           "Adam")),
    ("softmax", ("softmax", "Softmax")),
    ("layer_norm", ("layer_norm", "LayerNorm")),
    ("copies, gathers, concat", ("copy", "Copy", "CatArray", "cat_", "gather",
                                 "index", "scatter")),
    ("reductions", ("reduce_kernel", "Reduce")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other elementwise"


def profile_step(fn) -> dict:
    """Device time by kernel group, device operations and the idle share of
    one step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = defaultdict(float)
    ops = 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if (dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            by_kernel[evt.key] += dev_us / 1e3
            ops += evt.count
    busy_ms = sum(by_kernel.values())
    groups = defaultdict(float)
    for name, ms in by_kernel.items():
        groups[group_of(name)] += ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms, device_ops=ops,
                groups_ms=dict(groups),
                top_ms=[(n[:100], ms) for n, ms in top])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", default="ret%tva_cap%tva")
    ap.add_argument("--batch", type=int, default=None,
                    help="8, or 2 with --long-context")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--audio-slices", type=int, default=2)
    ap.add_argument("--long-context", action="store_true",
                    help="cap%%tv over 32 frames with 128-token captions")
    ap.add_argument("--steps", type=int, default=8,
                    help=f"timed steps after {WARMUP} warm-up steps")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_bench: needs a CUDA device", file=sys.stderr)
        return 2
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.ops import _build
    from mico_tpu_torch.ops import flash_attention as fa
    from mico_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mico_tpu_torch.train.train_step import make_train_step
    from mico_tpu_torch.train import workload as wl

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.build_all()
    if args.long_context:
        args.task, args.frames = wl.LONG_CONTEXT_TASK, wl.LONG_CONTEXT_FRAMES
        args.audio_slices, cap_len = 0, wl.LONG_CONTEXT_CAPTION_LEN
        args.batch = args.batch or 2
        cfg = wl.long_context_config()
        batch = wl.long_context_batch(args.batch, seed=0)
    else:
        cap_len, args.batch = wl.CAPTION_LEN, args.batch or 8
        cfg = MiCoConfig(max_vision_sample_num=args.frames,
                         max_audio_sample_num=args.audio_slices)
        batch = wl.synthetic_batch(args.batch, frames=args.frames,
                                   audio=args.audio_slices, seed=0)
    model = MiCo(cfg, device="cuda", seed=0)
    opt = build_optimizer(model, OptimConfig(
        num_train_steps=WARMUP + args.steps + 1))
    step = make_train_step(cfg, opt, args.task)
    gen = torch.Generator().manual_seed(0)
    print(f"task {args.task}: B={args.batch}, {args.frames} frames + "
          f"{args.audio_slices} audio slices per sample, {cap_len}-token "
          f"captions; fp32 master weights, bf16 compute, attention-"
          f"probability dropout {cfg.bert_config.attention_probs_dropout_prob}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(WARMUP + args.steps):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        out = step(model, batch, gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(out["loss_total"].item())
        print(f"  step {i + 1}: {times[-1]:.2f} ms, loss_total "
              f"{losses[-1]:.5f}, launches {fa.launch_counts()}", flush=True)
    ms = statistics.median(times[WARMUP:])
    flops = wl.pretrain_step_flops(cfg, args.batch, args.frames,
                                   args.audio_slices, cap_len, args.task)
    res = dict(card=card, task=args.task, batch=args.batch,
               frames=args.frames, audio_slices=args.audio_slices,
               caption_len=cap_len,
               step_ms=ms, step_times_ms=times, losses=losses,
               samples_per_s=1e3 * args.batch / ms,
               model_tflops_per_s=flops / (ms * 1e-3) / 1e12,
               model_flops_per_step=flops,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               launches_per_step=fa.launch_counts())
    print(f"{ms:.2f} ms/step  {res['samples_per_s']:.3f} samples/s  "
          f"{res['model_tflops_per_s']:.2f} model TFLOP/s  (median of "
          f"{args.steps} after {WARMUP} warm-up; {flops / 1e12:.3f} TFLOP/step; "
          f"peak memory {res['peak_memory_bytes'] / 2 ** 30:.2f} GiB) [{card}]",
          flush=True)
    if args.profile:
        prof = profile_step(lambda: step(model, batch, gen))
        prof["idle_share_of_unprofiled_step"] = 1.0 - prof["busy_ms"] / ms
        res["profile"] = prof
        print(f"  profiled step: {prof['wall_ms']:.2f} ms host clock, device "
              f"busy {prof['busy_ms']:.2f} ms, idle "
              f"{100 * prof['idle_share']:.1f}% of the profiled step and "
              f"{100 * prof['idle_share_of_unprofiled_step']:.1f}% of the "
              f"unprofiled median, {prof['device_ops']} device operations",
              flush=True)
        print("  device time per step by group (ms):", flush=True)
        for grp, gms in sorted(prof["groups_ms"].items(), key=lambda kv: -kv[1]):
            print(f"    {grp:36s} {gms:9.3f}", flush=True)
        print("  top kernels (ms per step):", flush=True)
        for name, kms in prof["top_ms"]:
            print(f"    {kms:9.3f}  {name}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
