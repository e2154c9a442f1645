#!/usr/bin/env python3
"""Where MiCo-on-bigE's bf16 outputs leave its fp32 ones, on one CUDA card.

    python3 scripts/torch_bige_precision.py

Builds MiCo on EVA02-CLIP-bigE-14-plus at full width and depth (fp32
weights from seed 0 on the card, and a bf16 copy of them) and runs
chip_smoke.py's one-sample ITM input (its first image, its three captions)
through four routes: bf16 on the kernels (K5 in the ViT, K2 in BERT's
cross-attention), bf16 on the plain routes (no kernel) and fp32 on the plain
routes (TF32 off), and fp32 on the plain routes over the bf16
copy's weights (rounded to bf16, held in fp32), which separates the weights'
rounding from the arithmetic's. It prints:
  - per ViT block (every 8th and the last), on the fp32 route: the std of the
    block input x (a post-norm block does not normalise it), the std of the
    scaled attention scores, the share of query rows whose largest softmax
    probability exceeds 0.9, and the relative error |x' - x32| / |x32| of
    each other route's block output;
  - each route's CLS embedding cosine and ITM gap to fp32, and of the bf16
    routes to the fp32 route on the rounded weights; the ITM gap of three
    mixed runs: bf16 BERT over the fp32 vision tokens (the BERT side's
    share) and fp32 BERT over each bf16 route's vision tokens (the tower's
    share);
  - for each of 64 images (the omni batch's 16, as chip_smoke.py makes
    them from numpy seeds 0-3), the tower on four bf16
    routes that split K5 into its GEMM and its attention: K5 (the
    hand-written GEMM and the packed attention kernel), cuBLAS + the packed
    attention kernel (the tower's training route, K3, at rates 0), K5's
    plain twin (fp32 GEMM, attention with the normalised p rounded) and the
    plain route (cuBLAS, `plain_attention`); for each: the ITM gap with
    BERT in bf16 (K2) and in fp32 (the tower's share), the mean signed ITM
    shift, the CLS cosine, the relative error of the tower's output (over
    all tokens, and the largest per token), and how many images pass the
    gates (ITM within 1e-2, cosine >= 0.999).
  - K5 at the tower's own block inputs (image 0 on the K5 route, blocks
    0, 16, 32, 48, 63): its GEMM's qkv against the fp64 product rounded
    once to bf16 (beside cuBLAS's on the same operands: share of elements
    off that rounding, and the signed shrink sum((got - exact) sign(exact))
    / sum |exact|, which a truncating accumulation makes positive toward
    zero), and its attention output against an fp64 twin of its own
    rounding points on its own qkv (share of elements off, largest
    difference over the output's rms), beside how far the kernel's and the plain
    twin's attention each sit from the fp64 attention without p rounding.
Ends with one JSON line.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import CAPTIONS, TEXT_LEN, omni_inputs  # noqa: E402

BLOCKS = (0, 8, 16, 24, 32, 40, 48, 56, 63)


def block_inputs(model, pixels) -> list:
    """The input x of every ViT block for `pixels`, captured by hooks."""
    xs = []
    hooks = [blk.register_forward_pre_hook(lambda m, a: xs.append(a[0]))
             for blk in model.vision_encoder.blocks]
    try:
        model.forward_vision_encoder(pixels)
    finally:
        for h in hooks:
            h.remove()
    return xs


def score_stats(blk, x, cfg) -> tuple:
    """(std of the scaled scores, share of rows with max probability > 0.9)
    of the block's attention on its input x (fp32, one frame)."""
    nh, hd = cfg.num_heads, cfg.head_dim
    qkv = x.float() @ blk.get("qkv_w").float() + blk.packed_qkv_bias().float()
    b, l, _ = qkv.shape
    q, k, _ = qkv.view(b, l, 3, nh, hd).permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    p = torch.softmax(s, dim=-1)
    return s.std().item(), (p.amax(dim=-1) > 0.9).float().mean().item()


def k5_at(blk, x, cfg) -> dict:
    """K5's GEMM and attention against fp64 on one real block input x
    (B, L, W) bf16: the C entry is called with a qkv buffer this function
    reads back."""
    from mico_tpu_torch.ops import flash_attention as fa
    from mico_tpu_torch.ops.attention import plain_attention

    nh, hd = cfg.num_heads, cfg.head_dim
    b, l, wd = x.shape
    w = blk.get("qkv_w").to(torch.bfloat16).contiguous()
    bias = blk.packed_qkv_bias().float().contiguous()
    qkv = torch.empty((b, l, 3 * wd), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((b, l, wd), dtype=torch.bfloat16, device=x.device)
    rc = fa._k5_entry()(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                        qkv.data_ptr(), out.data_ptr(), b, l, wd, nh, hd,
                        float(hd ** -0.5 * fa.LOG2E), fa._stream())
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"fused_qkv_attn: CUDA error {rc}")
    exact = x.double() @ w.double() + bias.double()
    cublas = torch.addmm(bias.to(torch.bfloat16), x.reshape(-1, wd),
                         w).reshape(b, l, 3 * wd)
    row = {}
    for name, got in (("gemm K5", qkv), ("gemm cuBLAS", cublas)):
        row[f"{name} off"] = (got != exact.bfloat16()).float().mean().item()
        row[f"{name} shrink"] = ((exact - got.double()) * exact.sign()).sum(
        ).item() / exact.abs().sum().item()
    q, k, v = (t.reshape(b, l, nh, hd).transpose(1, 2).double()
               for t in qkv.split(wd, dim=-1))
    s = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    lsum = e.sum(-1, keepdim=True)
    twin64 = (e.bfloat16().double() @ v) / lsum
    o64 = (e / lsum) @ v

    def packed(t):
        return t.transpose(1, 2).reshape(b, l, wd)

    row["attn K5 off own rounding"] = (
        out != packed(twin64).bfloat16()).float().mean().item()
    want = packed(twin64).bfloat16().double()
    row["attn K5 max |d| / rms"] = ((out.double() - want).abs().max()
                                    / want.square().mean().sqrt()).item()
    qh, kh, vh = (t.reshape(b, l, nh, hd).transpose(1, 2)
                  for t in qkv.split(wd, dim=-1))
    plain = packed(plain_attention(qh, kh, vh, scale=hd ** -0.5))
    ref = packed(o64)
    for name, got in (("K5", out), ("plain", plain)):
        row[f"attn {name} err vs fp64"] = ((got.double() - ref).norm()
                                           / ref.norm()).item()
    return row


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bige_precision: needs a CUDA device", file=sys.stderr)
        return 2
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.text import BertWordPieceTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    cfg = MiCoConfig(vision_encoder_type="evaclip02_bige",
                     max_vision_sample_num=4, max_audio_sample_num=2)
    m32 = MiCo(cfg, device="cuda", seed=0)
    m16 = copy.deepcopy(m32).to(dtype=torch.bfloat16)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                use_flash_attention=False)
    cfg16p = dataclasses.replace(cfg, use_flash_attention=False)
    m32.cfg = cfg32
    images = torch.from_numpy(np.concatenate(
        [omni_inputs(seed)["image"] for seed in range(4)])).cuda()
    image = images[:1]
    enc = BertWordPieceTokenizer()(CAPTIONS, max_length=TEXT_LEN)
    ids = torch.from_numpy(enc["input_ids"]).long().cuda()
    mask = torch.from_numpy(enc["attention_mask"]).long().cuda()

    def tokens(model, pixels=image):
        return model.forward_vision_encoder(pixels)

    def itm(model, vision_tokens):
        cond = model.get_multimodal_forward_input_vision(vision_tokens)
        seq = model.forward_multimodal_encoder(
            ids, mask, cond.expand(ids.shape[0], -1, -1))
        return torch.softmax(model.itm_head(seq[:, 0]).float(), dim=1)[:, 1]

    def cls_embed(model, vision_tokens):
        f = model.contra_head("v", vision_tokens[:, :, 0].mean(dim=1)).double()
        return f / f.norm(dim=-1, keepdim=True)

    eva = cfg.eva_config
    x32 = block_inputs(m32, image)
    runs = {}
    m32r = copy.deepcopy(m16).to(dtype=torch.float32)
    m32r.cfg = cfg32
    for name, model, cfgx in (("bf16 kernels", m16, cfg),
                              ("bf16 plain", m16, cfg16p),
                              ("fp32 rounded weights", m32r, cfg32)):
        model.cfg = cfgx
        runs[name] = dict(xs=block_inputs(model, image), tokens=tokens(model))
        runs[name]["itm"] = itm(model, runs[name]["tokens"])
        runs[name]["cls"] = cls_embed(model, runs[name]["tokens"])
    del m32r
    v32 = tokens(m32)
    p32 = itm(m32, v32)
    rows = []
    print(f"ViT blocks on the fp32 route (x: block input; err: relative "
          f"error of the next block's input) [{card}]")
    for i in BLOCKS:
        s_std, peaked = score_stats(m32.vision_encoder.blocks[i], x32[i], eva)
        row = dict(block=i, x_std=x32[i].std().item(), score_std=s_std,
                   peaked_rows=peaked)
        nxt = x32[i + 1] if i + 1 < len(x32) else None
        for name, run in runs.items():
            got = run["xs"][i + 1] if nxt is not None else None
            row[f"err {name}"] = (None if got is None else (
                (got.float() - nxt).norm() / nxt.norm()).item())
        rows.append(row)
        print("  " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))
    e32 = cls_embed(m32, v32)
    result = dict(card=card, blocks=rows, itm_fp32=p32.tolist())
    rounded = runs["fp32 rounded weights"]
    for name, run in runs.items():
        cos = (run["cls"] * e32).sum().item()
        gap = (run["itm"] - p32).abs().max().item()
        cos_r = (run["cls"] * rounded["cls"]).sum().item()
        gap_r = (run["itm"] - rounded["itm"]).abs().max().item()
        result[name] = dict(cls_cosine=cos, itm=run["itm"].tolist(),
                            itm_gap=gap, cls_cosine_to_rounded=cos_r,
                            itm_gap_to_rounded=gap_r)
        print(f"{name}: image CLS cosine to fp32 {cos:.6f}; ITM "
              f"{[round(p, 5) for p in run['itm'].tolist()]} vs fp32 "
              f"{[round(p, 5) for p in p32.tolist()]}, max |d| {gap:.3e}; "
              f"to fp32 on the rounded weights: cosine {cos_r:.6f}, ITM "
              f"max |d| {gap_r:.3e}")
    m16.cfg = cfg
    bert_side = (itm(m16, v32.to(torch.bfloat16)) - p32).abs().max().item()
    tower_side = {name: (itm(m32, runs[name]["tokens"].float())
                         - p32).abs().max().item()
                  for name in ("bf16 kernels", "bf16 plain")}
    result.update(itm_gap_bf16_bert_fp32_tower=bert_side,
                  itm_gap_fp32_bert_bf16_tower=tower_side)
    print(f"ITM gap, bf16 BERT (K2) over the fp32 tower's tokens: "
          f"{bert_side:.3e}; fp32 BERT over each bf16 route's tokens: "
          + ", ".join(f"{n} {g:.3e}" for n, g in tower_side.items()))

    kernel_rows = []
    print(f"K5 at the K5 route's own block inputs, image 0 [{card}]")
    for i in (0, 16, 32, 48, 63):
        row = dict(block=i, **k5_at(m16.vision_encoder.blocks[i],
                                    runs["bf16 kernels"]["xs"][i], eva))
        kernel_rows.append(row)
        print("  " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))
    result["k5_at_block_inputs"] = kernel_rows

    from mico_tpu_torch.models import eva_vit as vit_mod
    from mico_tpu_torch.ops import flash_attention as fa

    def tower_k3(px):
        """The training route at rates 0: cuBLAS qkv, the packed kernel."""
        out = vit_mod.eva_vit_forward(
            m16.vision_encoder, px.reshape(-1, *px.shape[2:]),
            compute_dtype=torch.bfloat16, attn_impl="flash",
            train_rng=torch.Generator().manual_seed(0))
        return out.reshape(1, 1, *out.shape[1:])

    def tower_twin(px):
        """K5's plain twin in bf16: the JAX gate's route for other dtypes."""
        real = fa.kernel_route
        fa.kernel_route = lambda x: False
        try:
            return tokens(m16, px)
        finally:
            fa.kernel_route = real

    m16.cfg = cfg
    routes = {"K5": lambda px: tokens(m16, px),
              "cuBLAS + packed kernel (K3)": tower_k3,
              "K5 twin": tower_twin}
    print(f"each image of four omni batches on four bf16 tower routes: ITM max "
          f"|d| to fp32 with bf16 BERT / fp32 BERT, CLS cosine, largest "
          f"per-token relative error [{card}]")
    per_image = []
    for i in range(images.shape[0]):
        px = images[i:i + 1]
        v32 = tokens(m32, px)
        p32, e32 = itm(m32, v32), cls_embed(m32, v32)
        m16.cfg = cfg16p
        vals = {"plain": (tokens(m16, px), cfg16p)}
        m16.cfg = cfg
        vals.update({n: (f(px), cfg) for n, f in routes.items()})
        row = {}
        for name, (v16, cfgx) in vals.items():
            m16.cfg = cfgx
            tok_err = ((v16.float() - v32).norm(dim=-1)
                       / v32.norm(dim=-1)).max().item()
            d = itm(m16, v16) - p32
            row[name] = dict(
                itm_gap=d.abs().max().item(), itm_shift=d.mean().item(),
                token_err=((v16.float() - v32).norm()
                           / v32.norm()).item(),
                itm_gap_fp32_bert=(itm(m32, v16.float())
                                   - p32).abs().max().item(),
                cls_cosine=(cls_embed(m16, v16) * e32).sum().item(),
                token_err_max=tok_err)
        m16.cfg = cfg
        per_image.append(row)
        print(f"  image {i}: " + "; ".join(
            f"{n} {r['itm_gap']:.2e}/{r['itm_gap_fp32_bert']:.2e} "
            f"(shift {r['itm_shift']:+.2e}), {r['cls_cosine']:.6f}, "
            f"{r['token_err']:.4f}/{r['token_err_max']:.3f}"
            for n, r in row.items()))
    summary = {}
    for name in per_image[0]:
        gaps = sorted(r[name]["itm_gap"] for r in per_image)
        tower = sorted(r[name]["itm_gap_fp32_bert"] for r in per_image)
        summary[name] = dict(
            itm_gap_median=gaps[len(gaps) // 2], itm_gap_max=gaps[-1],
            tower_gap_median=tower[len(tower) // 2], tower_gap_max=tower[-1],
            itm_pass=sum(g <= 1e-2 for g in gaps),
            cosine_pass=sum(r[name]["cls_cosine"] >= 0.999
                            for r in per_image),
            token_err_max=max(r[name]["token_err_max"] for r in per_image),
            token_err_mean=sum(r[name]["token_err"] for r in per_image)
            / len(per_image),
            itm_shift_mean=sum(r[name]["itm_shift"] for r in per_image)
            / len(per_image),
            itm_gap_rms=(sum(g * g for g in gaps) / len(gaps)) ** 0.5)
        print(f"{name}: ITM gap median {summary[name]['itm_gap_median']:.3e}, "
              f"max {summary[name]['itm_gap_max']:.3e} (fp32 BERT: median "
              f"{summary[name]['tower_gap_median']:.3e}, max "
              f"{summary[name]['tower_gap_max']:.3e}); "
              f"{summary[name]['itm_pass']} of {len(gaps)} images within "
              f"1e-2, {summary[name]['cosine_pass']} at cosine >= 0.999; "
              f"largest token error {summary[name]['token_err_max']:.3f}; "
              f"mean tower error {summary[name]['token_err_mean']:.4f}, "
              f"mean ITM shift {summary[name]['itm_shift_mean']:+.3e}, "
              f"ITM gap rms {summary[name]['itm_gap_rms']:.3e}")
    result.update(per_image=per_image, per_image_summary=summary)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
