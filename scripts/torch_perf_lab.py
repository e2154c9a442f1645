#!/usr/bin/env python3
"""Perf lab: the ViT-g forward's variants on one CUDA card, the counterpart
of `scripts/perf_lab.py`.

    python3 scripts/torch_perf_lab.py [VARIANT ...]      # default: base

Each variant times the 40-layer EVA01-CLIP-g/14 forward (`evaclip01_giant`:
width 1408, 16 heads of 88, 257 tokens) at B frames of 224 x 224 (112 by
default, the bench's omni ViT pass), bf16 weights drawn from seed 0 and
bf16 pixels from numpy seed 0, under `torch.no_grad()`: one warm-up, then 6
steps on the host clock ending in a synchronize. It prints ms/step, TF/s by
`perf_lab`'s FLOP count (qkv, proj, attention and MLP products and the
patch embed) and frames/s, with the card's name and power limit, and the
kernel launches of one step. The knobs are those of the port
(`mico_tpu_torch.ops.flash_attention`, `mico_tpu_torch.ops.layers`), set
for the variant and restored after it. As in JAX's `run_variant`, every
variant starts from `FUSED_QKV_PROJ` and `FUSED_LN_QKV` off, so `base` is
the linear qkv → K3 route:

  base, batch224, batch56, batch168   K3 at B 112, 224, 56, 168
  attn_xla                            plain attention (no kernel)
  attn_cls_split                      `PACKED_CLS_SPLIT`: K9
  ln_bf16                             `LN_STATS_DTYPE` bf16, K3
  folded                              LN affines folded, K3
  fused_qkv, fused_qkv_b224           `FUSED_QKV_PROJ`: K5 at B 112, 224
  fused_proj                          and `FUSED_ATTN_PROJ`: K8
  fused_ln                            and `FUSED_LN_QKV`: K1

`barrier` and `batch224_bar` set an XLA optimization barrier after each
LayerNorm (`mico_tpu/ops/layers.py:17, 70`); PyTorch runs eagerly and has no
counterpart, so they are named and not run. Ends with one JSON line.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mico_tpu_torch.config import eva_config_for_encoder_type  # noqa: E402
from mico_tpu_torch.models import eva_vit  # noqa: E402
from mico_tpu_torch.models._params import Init  # noqa: E402
from mico_tpu_torch.ops import flash_attention as fa  # noqa: E402
from mico_tpu_torch.ops import layers  # noqa: E402

STEPS = 6
NOT_RUN = "an XLA optimization barrier; PyTorch runs eagerly and has none"

VARIANTS = {
    "base": dict(),
    "barrier": None,
    "batch224": dict(b=224),
    "batch224_bar": None,
    "batch56": dict(b=56),
    "batch168": dict(b=168),
    "attn_xla": dict(attn_impl="plain"),
    "attn_cls_split": dict(cls_split=True),
    "ln_bf16": dict(ln_bf16=True),
    "folded": dict(folded=True),
    "fused_qkv": dict(fused_qkv=True),
    "fused_qkv_b224": dict(fused_qkv=True, b=224),
    "fused_proj": dict(fused_qkv=True, fused_proj=True),
    "fused_ln": dict(fused_qkv=True, fused_ln=True),
}


def vit_flops(b: int, cfg) -> float:
    """`perf_lab.vit_flops` (scripts/perf_lab.py:26-33)."""
    l, w, h = cfg.seq_len, cfg.width, cfg.mlp_hidden
    per_layer = 2 * l * w * (3 * w) + 2 * l * w * w
    per_layer += 2 * 2 * l * l * w
    per_layer += 2 * 2 * l * w * h
    return b * (cfg.layers * per_layer + 2 * l * w * (3 * cfg.patch_size ** 2))


def build_vit(seed: int = 0):
    """The ViT-g tower in bf16 on the card, drawn from `seed` on the CPU."""
    cfg = eva_config_for_encoder_type("evaclip01_giant")
    vit = eva_vit.EvaVisionTransformer(cfg, Init(torch.Generator().manual_seed(
        seed)))
    return cfg, vit.to(device="cuda", dtype=torch.bfloat16)


def run_variant(vit, cfg, name: str, card: str, b: int = 112,
                attn_impl: str = "flash", ln_bf16: bool = False,
                folded: bool = False, cls_split: bool = False,
                fused_qkv: bool = False, fused_proj: bool = False,
                fused_ln: bool = False) -> dict:
    saved = {k: getattr(fa, k) for k in ("PACKED_CLS_SPLIT", "FUSED_QKV_PROJ",
                                         "FUSED_ATTN_PROJ", "FUSED_LN_QKV")}
    fa.PACKED_CLS_SPLIT = cls_split
    fa.FUSED_QKV_PROJ = fused_qkv
    fa.FUSED_ATTN_PROJ = fused_proj
    fa.FUSED_LN_QKV = fused_ln
    layers.LN_STATS_DTYPE = torch.bfloat16 if ln_bf16 else torch.float32
    try:
        model = vit
        if folded:
            model = copy.deepcopy(vit)
            model.fold_inference_params()
        pixels = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (b, 3, 224, 224)).astype(np.float32)).to("cuda", torch.bfloat16)

        @torch.no_grad()
        def fwd():
            return eva_vit.eva_vit_forward(model, pixels,
                                           compute_dtype=torch.bfloat16,
                                           attn_impl=attn_impl)

        fa.reset_launch_counts()
        out = fwd()
        torch.cuda.synchronize()
        launches = {k: v for k, v in fa.launch_counts().items() if v}
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{name}: non-finite output")
        t0 = time.perf_counter()
        for _ in range(STEPS):
            out = fwd()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / STEPS
    finally:
        for k, v in saved.items():
            setattr(fa, k, v)
        layers.LN_STATS_DTYPE = torch.float32
    tf = vit_flops(b, cfg) / dt / 1e12
    print(f"{name:14s} B={b:4d} {dt * 1e3:8.2f} ms/step  {tf:6.1f} TF/s  "
          f"{b / dt:7.1f} frames/s  launches {launches} [{card}]", flush=True)
    return dict(b=b, ms=dt * 1e3, tflops=tf, frames_per_s=b / dt,
                launches=launches)


def main() -> int:
    names = sys.argv[1:] or ["base"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"torch_perf_lab: unknown variants {unknown}; "
              f"known: {list(VARIANTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_perf_lab: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    cfg, vit = build_vit()
    result = {"card": card}
    for name in names:
        kw = VARIANTS[name]
        if kw is None:
            print(f"{name:14s} not run: {NOT_RUN}", flush=True)
            result[name] = "not run: " + NOT_RUN
            continue
        result[name] = run_variant(vit, cfg, name, card, **kw)
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
