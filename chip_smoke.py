#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mico_tpu_torch`) on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase, one card

Phases, run in order (any failure exits non-zero):
  1. device: the card's name and power limit, and the kernels' build time
     (nvcc over `mico_tpu_torch/csrc/*.cu`, at first use, into `build/`);
  2. kernels: K1 and K2 against their plain PyTorch versions on the card in
     bf16, at the main path's shapes and layouts (the tensors that are then
     timed) and at smaller and biased cases, with their times beside the
     plain version, a one-call PyTorch yardstick and the card's bound;
  3. main: the full-width MiCo-ViT-g omni step (S = 16: 1 image + 4 video
     frames + 2 audio slices in one 112-frame ViT pass, BERT over (16, 30)
     tokens, heads, similarity), ITM for 1 image x 3 captions, and
     `EmbeddingPipeline.embed_texts` and `_run`, with random weights from
     seed 0; each path runs with the launch counts set to 0 just before it,
     and its own counts are held to it (K1 40 per ViT pass, K2 12 per ITM
     pass);
  4. cosine: the same one-sample inputs through the port on the CPU in fp32
     (the plain versions) against the card's bf16 output: each embedding at
     cosine >= 0.999, ITM probabilities within 1e-2.
The line before them is a JSON summary of the run, the second-to-last line
is {"kernels": [...]} with per-kernel numbers, and the last is
{"ok": true, "device": {...}}. Without CUDA it exits with code 2 and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the path whose own launch count the kernels line reports for each kernel
KERNEL_PATH = {"K1": "omni step", "K2": "ITM"}
# published H100 SXM peaks (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
RTOL = ATOL = 2e-2          # bf16 ulp is 2^-8; fp32 sums run in other orders
MEAN_ERR_MAX = 2e-3
COSINE_MIN = 0.999          # the repo's embedding gate (BASELINE.md:23)
ITM_PROB_TOL = 1e-2
S = 16                      # omni samples per step, as bench.py
TEXT_LEN = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call on the card, by CUDA events over `iters` calls."""
    for _ in range(warmup):
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


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item()}
    log(f"  {name}: max|d| {err['max_abs_err']:.3e}  "
        f"mean|d| {err['mean_abs_err']:.3e}")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    if err["mean_abs_err"] > MEAN_ERR_MAX:
        raise AssertionError(f"{name}: mean |d| {err['mean_abs_err']:.3e} "
                             f"> {MEAN_ERR_MAX}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def k1_inputs(gen, b, l=257, nh=16, d=88, dev="cuda"):
    """The projection at the model's init scale (std 0.02, as `MiCo`
    draws it): scores of std ~0.6, as the seeded main path gives K1."""
    w = nh * d

    def rnd(*shape, s=1.0, mean=0.0):
        return (mean + s * torch.randn(*shape, generator=gen)).to(dev)

    x = rnd(b, l, w).to(torch.bfloat16)
    g, b0 = rnd(w, s=0.1, mean=1.0), rnd(w, s=0.1)
    wq = rnd(w, 3 * w, s=0.02).to(torch.bfloat16)
    bias = rnd(3 * w, s=0.02)
    return x, g, b0, wq, bias, nh, d ** -0.5, 1e-6


def k1_library(x, g, b0, w, bias, nh, scale, eps, affine):
    """One PyTorch call per stage: F.layer_norm, torch.matmul, SDPA."""
    import torch.nn.functional as F

    b, l, wd = x.shape
    xn = F.layer_norm(x, (wd,), g.to(x.dtype) if affine else None,
                      b0.to(x.dtype) if affine else None, eps)
    qkv = torch.matmul(xn, w) + bias.to(x.dtype)
    q, k, v = qkv.view(b, l, 3, nh, wd // nh).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    return o.transpose(1, 2).reshape(b, l, wd)


def itm_cross_qkv(gen, n=3, width=768, heads=12, enc_width=1408):
    """K2's inputs as the ITM cross-attention makes them: q from the text
    rows and k/v from one image's condition tokens expanded to the n
    captions, each a (B, L, H, D) linear output viewed as (B, H, L, D)."""
    from mico_tpu_torch.ops.layers import linear

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen)).to("cuda",
                                                            torch.bfloat16)

    text, cond = r(n, TEXT_LEN, width), r(1, 257, enc_width).expand(n, -1, -1)
    wq = r(width, width, scale=width ** -0.5)
    wk, wv = (r(enc_width, width, scale=enc_width ** -0.5) for _ in range(2))
    d = width // heads
    q = linear(text, wq).reshape(n, TEXT_LEN, heads, d).transpose(1, 2)
    k, v = (linear(cond, w).reshape(n, 257, heads, d).transpose(1, 2)
            for w in (wk, wv))
    return q, k, v


def phase_kernels(fa) -> list:
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(1)
    errs = {"K1": [], "K2": []}
    log("phase kernels: K1 fused_ln_qkv_self_attention vs fused_ln_qkv_plain")
    # B = 8 and the bench ViT pass (16 samples x 7 frames); the B = 112
    # tensors are the ones timed below
    for b in (8, S * 7):
        args = k1_inputs(gen, b)
        for affine in (True, False):
            got = fa.fused_ln_qkv_self_attention(*args, affine)
            want = fa.fused_ln_qkv_plain(*args, affine)
            errs["K1"].append(compare(f"K1 ({b}, 257, 1408) affine={affine}",
                                      got, want))
            del got, want
    k1_args = args

    log("phase kernels: K2 flash_attention vs flash_attention_plain")

    def qkv(b, h, lq, lk, d=64):
        def r(*s):
            return torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)
        return r(b, h, lq, d), r(b, h, lk, d), r(b, h, lk, d)

    itm_qkv = itm_cross_qkv(gen)
    cases = [("no bias, ITM layout: q (3,12,30,64), k/v (3,12,257,64) "
              "strided views of (3,L,12,64)", itm_qkv, None)]
    for lk in (257, 1028):
        cases.append((f"no bias q (4,12,30,64) kv (4,12,{lk},64)",
                      qkv(4, 12, 30, lk), None))
    pad = torch.ones(4, 70)
    pad[1, 50:] = 0
    pad[3, 20:] = 0
    cases.append(("bias (4,1,1,70) padding mask, L = 70", qkv(4, 12, 70, 70),
                  ((1.0 - pad) * -10000.0)[:, None, None, :].cuda()))
    full = (torch.rand(4, 30, 257, generator=gen) > 0.3).float()
    full[:, :, 0] = 1
    cases.append(("bias (4,1,30,257) mask", qkv(4, 12, 30, 257),
                  ((1.0 - full) * -10000.0)[:, None].cuda()))
    for name, (q, k, v), bias in cases:
        got = fa.flash_attention(q, k, v, bias=bias)
        want = fa.flash_attention_plain(q, k, v, bias, q.shape[-1] ** -0.5)
        errs["K2"].append(compare(f"K2 {name}", got, want))

    log("phase kernels: times at the main path's shapes")
    rows = []
    # K1 at the bench ViT pass: 16 samples x 7 frames, affine (unfolded) as
    # the omni step runs it; affine off is the folded serving route
    args = k1_args
    x, g, b0, w, bias, nh, scale, eps = args
    b, l, wd = x.shape
    d = wd // nh
    flops = 2 * b * l * wd * 3 * wd + 4 * b * nh * l * l * d
    nbytes = 2 * (2 * x.numel() + w.numel()) + 4 * (bias.numel() + 2 * wd)
    bms, by = bound_ms(flops, nbytes)
    rows.append(dict(
        name="K1 fused_ln_qkv_self_attention", route="cuda",
        source="mico_tpu_torch/csrc/fused_ln_qkv_attn.cu",
        replaces="mico_tpu/ops/flash_attention.py:1624",
        shape=f"x ({b}, {l}, {wd}) bf16, W ({wd}, {3 * wd}), H={nh}, D={d}",
        ms=cuda_time_ms(lambda: fa.fused_ln_qkv_self_attention(*args, True)),
        ms_affine_off=cuda_time_ms(
            lambda: fa.fused_ln_qkv_self_attention(*args, False)),
        plain_ms=cuda_time_ms(lambda: fa.fused_ln_qkv_plain(*args, True),
                              iters=5, warmup=1),
        library_ms=cuda_time_ms(lambda: k1_library(*args, True)),
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
    ))
    # K2 at the ITM cross-attention: 1 image x 3 captions, compared above
    q, k, v = itm_qkv
    flops = 4 * q.shape[0] * 12 * TEXT_LEN * 257 * 64
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bms, by = bound_ms(flops, nbytes)
    rows.append(dict(
        name="K2 flash_attention", route="cuda",
        source="mico_tpu_torch/csrc/flash_attn.cu",
        replaces="mico_tpu/ops/flash_attention.py:93",
        shape="q (3, 12, 30, 64), k/v (3, 12, 257, 64) bf16 strided views "
              "of (3, L, 12, 64), no bias",
        ms=cuda_time_ms(lambda: fa.flash_attention(q, k, v)),
        plain_ms=cuda_time_ms(
            lambda: fa.flash_attention_plain(q, k, v, None, 0.125)),
        library_ms=cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125)),
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
    ))
    for row in rows:
        key = row["name"].split()[0]
        row["max_abs_err"] = max(e["max_abs_err"] for e in errs[key])
        row["mean_abs_err"] = max(e["mean_abs_err"] for e in errs[key])
        row["kernel_ms"] = row["ms"]
        if "ms_affine_off" in row:
            log(f"  {row['name']} affine=False: {row['ms_affine_off']:.4f} ms")
        log(f"  {row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
            f"library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"by {row['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def omni_inputs(seed: int = 0):
    """bench.py's omni sample batch, made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        image=rng.standard_normal((S, 1, 3, 224, 224)).astype(f),
        video=rng.standard_normal((S, 4, 3, 224, 224)).astype(f),
        audio=rng.standard_normal((S, 2, 224, 224)).astype(f),
        ids=rng.integers(200, 20000, (S, TEXT_LEN)).astype(np.int64),
        mask=np.ones((S, TEXT_LEN), np.int64),
    )


def omni_step(model, image, video, audio, ids, mask):
    """bench.py's step: every frame in one ViT pass, heads v/v/a/t, the
    similarity of each text to every image, video and audio embedding."""
    from mico_tpu_torch.models.mico import pool_frames_for_contra

    aud3 = audio[:, :, None].expand(-1, -1, 3, -1, -1)
    frames = torch.cat([image, video, aud3], dim=1)
    tokens = model.forward_vision_encoder(frames)

    def head(name, pooled):
        f = model.contra_head(name, pooled).float()
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    feats = {name: head(h, pool_frames_for_contra(tokens[:, lo:hi]))
             for name, h, lo, hi in (("image", "v", 0, 1), ("video", "v", 1, 5),
                                     ("audio", "a", 5, 7))}
    seq = model.forward_multimodal_encoder(ids, mask)
    feats["text"] = head("t", model.pool_text_for_contra(seq))
    feats["sims"] = feats["text"] @ torch.cat(
        [feats["image"], feats["video"], feats["audio"]]).T
    return feats


def itm_probs(model, image, ids, mask):
    """ITM of one image against every caption (inference_demo.py:75-86)."""
    vision_output = model.forward_vision_encoder(image)
    cond = model.get_multimodal_forward_input_vision(vision_output)
    cond = cond.expand(ids.shape[0], -1, -1)
    seq = model.forward_multimodal_encoder(ids, mask, cond)
    return torch.softmax(model.itm_head(seq[:, 0]).float(), dim=1)[:, 1]


CAPTIONS = ["a man is skiing in a snowy day.", "it's a hot day",
            "two dogs play with a red ball on the grass"]


def check_unit(name, feats):
    if not torch.isfinite(feats).all():
        raise AssertionError(f"{name}: non-finite values")
    norms = torch.linalg.vector_norm(feats.float(), dim=-1)
    if not torch.allclose(norms, torch.ones_like(norms), atol=1e-3):
        raise AssertionError(f"{name}: norms {norms.tolist()} are not 1")


def phase_main(fa, card: str) -> dict:
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.serve import EmbeddingPipeline
    from mico_tpu_torch.text import BertWordPieceTokenizer

    cfg = MiCoConfig(max_vision_sample_num=4, max_audio_sample_num=2)
    t0 = time.perf_counter()
    model = MiCo(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    nlayers, nbert = cfg.eva_config.layers, cfg.bert_config.num_hidden_layers
    log(f"phase main: MiCo-ViT-g (ViT {nlayers} layers, width "
        f"{cfg.eva_config.width}; BERT {nbert} layers) bf16 on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    inp = omni_inputs()
    dev = {k: torch.from_numpy(v).cuda() for k, v in inp.items()}
    tok = BertWordPieceTokenizer()
    enc = tok(CAPTIONS, max_length=TEXT_LEN)
    cap_ids = torch.from_numpy(enc["input_ids"]).long().cuda()
    cap_mask = torch.from_numpy(enc["attention_mask"]).long().cuda()

    paths = {}

    def counted(fn, k1, k2, what):
        """Run one path with every count set to 0 just before it; keep its
        own counts and hold them to the path."""
        fa.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = fa.launch_counts()
        paths[what] = got
        if (got["K1"], got["K2"]) != (k1, k2):
            raise AssertionError(f"{what}: launches {got}, expected "
                                 f"K1 {k1}, K2 {k2}")
        return out

    out = counted(lambda: omni_step(model, **dev), nlayers, 0, "omni step")
    for name in ("image", "video", "audio", "text"):
        check_unit(f"omni {name}", out[name])
    if out["sims"].shape != (S, 3 * S) or not torch.isfinite(out["sims"]).all():
        raise AssertionError(f"similarity {tuple(out['sims'].shape)} not finite")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        omni_step(model, **dev)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = statistics.median(times)
    log(f"  omni step S={S}: median {step_ms:.2f} ms of {len(times)} "
        f"({[round(t, 2) for t in times]}), {1e3 * S / step_ms:.2f} samples/s "
        f"[{card}]")

    itm = counted(lambda: itm_probs(model, dev["image"][:1], cap_ids, cap_mask),
                  nlayers, nbert, "ITM")
    if itm.shape != (3,) or not torch.isfinite(itm).all():
        raise AssertionError(f"ITM probabilities {itm}")
    log(f"  ITM 1 image x 3 captions: {[round(p, 5) for p in itm.tolist()]}")

    pipe = EmbeddingPipeline(model, cfg, tok, batch_size=8, io_workers=4)
    try:
        tf = counted(lambda: pipe.embed_texts(CAPTIONS), 0, 0, "embed_texts")
        check_unit("embed_texts", torch.from_numpy(tf))
        images = [inp["image"][i % S] for i in range(20)]
        images[5] = None
        feats = counted(
            lambda: pipe._run(images, lambda a: a,
                              lambda m, x: pipe._embed_pixels(m, x, head="v")),
            3 * nlayers, 0, "_run 20 images")
    finally:
        pipe.close()
    if pipe.last_failures != [5] or feats.shape != (20, cfg.contra_dim):
        raise AssertionError(f"_run: failures {pipe.last_failures}, "
                             f"shape {feats.shape}")
    if np.abs(feats[5]).max() != 0.0:
        raise AssertionError("_run: the failed item's row is not zero")
    check_unit("_run", torch.from_numpy(np.delete(feats, 5, axis=0)))
    # the folded model must agree with the canonical one on the same frame
    folded_cos = float(feats[0] @ out["image"][0].cpu().numpy())
    log(f"  pipeline: texts {tf.shape}, images {feats.shape}, failures "
        f"{pipe.last_failures}, folded vs canonical image cosine "
        f"{folded_cos:.6f}")
    if not folded_cos >= COSINE_MIN:
        raise AssertionError(f"folded pipeline cosine {folded_cos}")
    log(f"  launches by path (each counted from 0): {paths}")
    return dict(cfg=cfg, out=out, itm=itm, inp=inp, cap_ids=cap_ids.cpu(),
                cap_mask=cap_mask.cpu(), step_ms=step_ms, step_times=times,
                paths=paths)


# ---------------------------------------------------------------------------
# phase 4: card bf16 against CPU fp32
# ---------------------------------------------------------------------------


def phase_cosine(main: dict) -> dict:
    from mico_tpu_torch.models.mico import MiCo

    cfg = dataclasses.replace(main["cfg"], compute_dtype="float32")
    t0 = time.perf_counter()
    ref = MiCo(cfg, device="cpu", seed=0)
    one = {k: torch.from_numpy(v[:1]) for k, v in main["inp"].items()}
    with torch.inference_mode():
        want = omni_step(ref, **one)
        itm_want = itm_probs(ref, one["image"], main["cap_ids"], main["cap_mask"])
    log(f"phase cosine: CPU fp32 reference in {time.perf_counter() - t0:.1f} s")
    result = {}
    for name in ("image", "video", "audio", "text"):
        got = main["out"][name][:1].cpu().double()
        cos = torch.nn.functional.cosine_similarity(
            got, want[name].double()).item()
        result[name] = cos
        log(f"  {name}: cosine {cos:.6f}")
        if not cos >= COSINE_MIN:
            raise AssertionError(f"{name} cosine {cos} < {COSINE_MIN}")
    gap = (main["itm"].cpu() - itm_want).abs().max().item()
    result["itm_max_abs_diff"] = gap
    log(f"  ITM probabilities: card {main['itm'].tolist()} vs CPU "
        f"{itm_want.tolist()}, max |d| {gap:.3e}")
    if not gap <= ITM_PROB_TOL:
        raise AssertionError(f"ITM probability gap {gap} > {ITM_PROB_TOL}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one "
              "NVIDIA H100", file=sys.stderr)
        return 2
    from mico_tpu_torch.ops import _build
    from mico_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, device {kind}")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s into {_build.BUILD_DIR}")

    rows = phase_kernels(fa)
    main_out = phase_main(fa, card)
    cosine = phase_cosine(main_out)
    paths = main_out["paths"]
    for row in rows:
        key = row["name"].split()[0]
        path = KERNEL_PATH[key]
        row.update(launches=paths[path][key], launches_path=path,
                   launches_by_path={p: c[key] for p, c in paths.items()})
    print(json.dumps({"card": card, "build_s": build_s,
                      "omni_step_ms": main_out["step_ms"],
                      "omni_step_times_ms": main_out["step_times"],
                      "samples_per_s": 1e3 * S / main_out["step_ms"],
                      "launches_by_path": paths, "cosine": cosine}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
