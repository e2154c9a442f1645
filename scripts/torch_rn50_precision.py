#!/usr/bin/env python3
"""How far CLIP RN50's bf16 route sits from its fp32 one, under three
settings of its BatchNorms, on one CUDA card (or `--device cpu`).

    python3 scripts/torch_rn50_precision.py [--batch 16] [--device cuda]

Draws `models.modified_resnet.ModifiedResNet` (RN50, 224 px) from seed 0 in
fp32 (TF32 off) and runs B random images (numpy seed 0, as chip_smoke.py's
eva_clip phase makes them) through it in fp32 and through a bf16 copy, with
the BNs:
  - drawn: identity statistics, as `init_modified_resnet` draws them;
  - batch_stats: each BN's mean and variance set, in forward order, to
    the batch statistics of its input in the fp32 pass (a trained
    network's BNs hold such statistics of its data);
  - unit_map: the drawn BNs, the first one's scale divided by the RMS of
    the fp32 trunk's map (chip_smoke.py's `scale_to_unit_map`).
For each it prints the trunk map's std, the smallest per-image cosine of
bf16 to fp32 after the stem and after each stage's last block, of the
trunk's map and of the forward's output, and the std of the fp32 attention
pool's scores. Ends with one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mico_tpu_torch.models import modified_resnet as mrn  # noqa: E402
from mico_tpu_torch.ops.layers import linear  # noqa: E402


def fit_batch_stats(rn, pixels) -> None:
    """Each BN's mean/var from its input in one fp32 pass, in order."""
    bn = mrn._bn

    def fit(x, p):
        p.get("mean").copy_(x.mean(dim=(0, 2, 3)))
        p.get("var").copy_(x.var(dim=(0, 2, 3), unbiased=False))
        return bn(x, p)

    mrn._bn = fit
    try:
        mrn.modified_resnet_trunk(rn, pixels)
    finally:
        mrn._bn = bn


def scale_to_unit_map(rn, pixels) -> None:
    rms = mrn.modified_resnet_trunk(rn, pixels).square().mean().sqrt()
    rn.stem_bn1.get("w").div_(rms)


def stage_maps(rn, pixels, dtype) -> list:
    """The stem's output, then each stage's last block's (the trunk's)."""
    x = pixels.to(dtype)
    for i in (1, 2, 3):
        x = mrn._conv(x, getattr(rn, f"stem_conv{i}"),
                      stride=2 if i == 1 else 1, padding=1)
        x = F.relu(mrn._bn(x, getattr(rn, f"stem_bn{i}")))
    maps = [F.avg_pool2d(x, 2)]
    for stage in rn.stages:
        x = maps[-1]
        for block in stage:
            x = block(x)
        maps.append(x)
    return maps


def pool_score_std(rn, feat) -> float:
    """The std of the fp32 pool's scores of its mean query."""
    p, heads = rn.attnpool, rn.cfg.heads
    n, c = feat.shape[:2]
    t = feat.flatten(2).transpose(1, 2)
    t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1) + p.get("pos")
    q = linear(t[:, :1], p.get("q_w"), p.get("q_b"))
    k = linear(t, p.get("k_w"), p.get("k_b"))
    q = q.reshape(n, 1, heads, -1).transpose(1, 2)
    k = k.reshape(n, -1, heads, c // heads).transpose(1, 2)
    return ((q @ k.transpose(-1, -2)) * (c // heads) ** -0.5).std().item()


def min_cos(a, b) -> float:
    return F.cosine_similarity(a.double().flatten(1), b.double().flatten(1),
                               dim=-1).min().item()


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pixels = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (a.batch, 3, 224, 224)).astype(np.float32)).to(a.device)
    out = {}
    for setting, prepare in (("drawn", None), ("batch_stats", fit_batch_stats),
                             ("unit_map", scale_to_unit_map)):
        rn32 = mrn.ModifiedResNet(mrn.ModifiedResNetConfig(),
                                  device=a.device, seed=0)
        if prepare is not None:
            prepare(rn32, pixels)
        rn = copy.deepcopy(rn32).to(torch.bfloat16)
        m32, m16 = (stage_maps(r, pixels, d) for r, d in
                    ((rn32, torch.float32), (rn, torch.bfloat16)))
        o32 = mrn.attention_pool(rn32, m32[-1])
        o16 = mrn.attention_pool(rn, m16[-1])
        out[setting] = dict(
            map_std=m32[-1].std().item(),
            cosine_by_stage=[min_cos(x, y) for x, y in zip(m16, m32)],
            trunk_cosine=min_cos(m16[-1], m32[-1]),
            forward_cosine=min_cos(o16, o32),
            pool_score_std=pool_score_std(rn32, m32[-1]))
        print(setting, {k: (round(v, 6) if isinstance(v, float)
                            else [round(x, 6) for x in v])
                        for k, v in out[setting].items()}, flush=True)
        del rn, rn32, m32, m16
    card = (torch.cuda.get_device_name(0) if a.device.startswith("cuda")
            else "cpu")
    print(json.dumps({"device": card, "batch": a.batch, **out}))


if __name__ == "__main__":
    main()
