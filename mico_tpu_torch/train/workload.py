"""The pretraining workloads as a benchmark sees them: a synthetic batch of
the recipe's shapes, made with numpy from a seed, and the analytic matmul
FLOPs of one train step (the port's copy of `mix_train_flops`,
scripts/train_bench.py:36-110). Two samples: `configs/pretrain-omni.json`'s,
and the long-context caption sample of `train_bench.py --long-context`
(:132-137, 200-203): 'cap%tv' over 32 frames (8,224 condition tokens) with
128-token captions and no audio, the shape whose cross-attention takes the
KV-tiled kernels K6 and K6b."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mico_tpu_torch.config import (BERT_CLS_ID, BERT_SEP_ID, BertConfig,
                                   MiCoConfig)

# configs/pretrain-omni.json: task, frames and audio slices per sample
PRETRAIN_TASK = "ret%tva_cap%tva"
PRETRAIN_FRAMES = 4
PRETRAIN_AUDIO = 2
CAPTION_LEN = 40          # MiCoConfig.max_caption_len
# scripts/train_bench.py --long-context
LONG_CONTEXT_TASK = "cap%tv"
LONG_CONTEXT_FRAMES = 32
LONG_CONTEXT_CAPTION_LEN = 128


def synthetic_batch(b: int, frames: int = PRETRAIN_FRAMES,
                    audio: int = PRETRAIN_AUDIO, cap_len: int = CAPTION_LEN,
                    size: int = 224, seed: int = 0,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """b samples: `frames` RGB frames (b, frames, 3, size, size), `audio`
    fbank slices (b, audio, size, size; no key when 0) and a caption of
    `cap_len` tokens ([CLS] ids [SEP], every third row padded after 3/4 of
    its length)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, 20000, (b, cap_len)).astype(np.int64)
    mask = np.ones((b, cap_len), np.int64)
    ids[:, 0] = BERT_CLS_ID
    for i in range(b):
        n = cap_len if i % 3 else 3 * cap_len // 4
        ids[i, n - 1] = BERT_SEP_ID
        ids[i, n:] = 0
        mask[i, n:] = 0
    arrays = {
        "vision_pixels": rng.standard_normal(
            (b, frames, 3, size, size)).astype(np.float32),
        "caption_ids": ids, "caption_mask": mask,
    }
    if audio:
        arrays["audio_spectrograms"] = rng.standard_normal(
            (b, audio, size, size)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def mix_train_flops(b, cfg, bert, task, *, n_frames, n_audio, n_depth,
                    cap_len, sub_len, q_len, ans_len, itm_dedup=False):
    """Analytic matmul FLOPs of one train step for a task mix, each tower
    once per step (the memoized features): the shared ViT over vision,
    audio and depth frames, BERT's subtitle pass, and per subtask the ITC
    text pass, ITM's 3×bs cross-attention pass, the caption and the QA
    passes; ×3 for the backward. cfg is the EvaVitConfig, bert the
    BertConfig."""
    l, w, h, d = cfg.seq_len, cfg.width, cfg.mlp_hidden, cfg.layers
    bw, bd, bi = bert.hidden_size, bert.num_hidden_layers, bert.intermediate_size

    def vit(frames):
        return frames * d * (
            2 * l * w * (4 * w) + 2 * 2 * l * l * w + 2 * 2 * l * w * h
        )

    def bert_pass(rows, seq, cond, kv_rows=None):
        per_layer = (
            2 * seq * bw * (4 * bw)
            + 2 * 2 * seq * seq * bw
            + 2 * seq * bw * bi * 2
        )
        fl = rows * bd * per_layer
        if cond:
            per_cross = (
                2 * seq * bw * bw
                + 2 * 2 * seq * cond * bw
                + 2 * seq * bw * bw
            )
            fl += rows * bd * per_cross
            fl += (kv_rows if kv_rows is not None else rows) * bd * (
                2 * cond * bw * bw * 2
            )
        return fl

    subs = [s.split("%") for s in task.split("_")]
    all_groups = {g for _, *gs in subs for g in gs}
    mods_used = {m for g in all_groups for m in g[1:]}

    def cond_tokens(group):
        per = {"v": n_frames * l, "i": n_frames * l, "a": n_audio * l,
               "d": n_depth * l, "s": sub_len}
        return sum(per[m] for m in group[1:])

    fl = 0
    tower_frames = 0
    if mods_used & {"v", "i"}:
        tower_frames += n_frames
    if "a" in mods_used:
        tower_frames += n_audio
    if "d" in mods_used:
        tower_frames += n_depth
    fl += b * vit(tower_frames)
    if "s" in mods_used:
        fl += bert_pass(b, sub_len, 0)

    for kind, *groups in subs:
        if kind == "ret":
            fl += bert_pass(b, cap_len, 0)
            for g in groups:
                fl += bert_pass(3 * b, cap_len, cond_tokens(g),
                                kv_rows=b if itm_dedup else None)
        elif kind == "cap":
            for g in groups:
                fl += bert_pass(b, cap_len, cond_tokens(g))
        elif kind == "qa":
            for g in groups:
                fl += bert_pass(b, q_len + ans_len, cond_tokens(g))
    return 3 * fl


def long_context_config(**bert) -> MiCoConfig:
    """MiCo-ViT-g for the long-context sample: 32 frames, 128-token
    captions, BERT's attention-probability dropout 0 (`bert` overrides more
    of BertConfig). A positive rate sends attention to plain math
    (`mico_tpu/ops/attention.py:82-86`), so the JAX bench reaches K6 and K6b
    only with `--no-dropout`; this keeps hidden dropout and drop-path."""
    return MiCoConfig(
        max_vision_sample_num=LONG_CONTEXT_FRAMES,
        max_caption_len=LONG_CONTEXT_CAPTION_LEN,
        bert_override=BertConfig(**{"attention_probs_dropout_prob": 0.0,
                                    **bert}))


def long_context_batch(b: int, size: int = 224, seed: int = 0,
                       device="cuda") -> Dict[str, torch.Tensor]:
    """The long-context caption sample: 32 frames, a 128-token caption, no
    audio."""
    return synthetic_batch(b, frames=LONG_CONTEXT_FRAMES, audio=0,
                           cap_len=LONG_CONTEXT_CAPTION_LEN, size=size,
                           seed=seed, device=device)


def pretrain_step_flops(cfg, b: int, frames: int = PRETRAIN_FRAMES,
                        audio: int = PRETRAIN_AUDIO,
                        cap_len: int = CAPTION_LEN,
                        task: str = PRETRAIN_TASK) -> int:
    """`mix_train_flops` of one step of `task` on a MiCoConfig; the
    long-context step is `pretrain_step_flops(cfg, b, LONG_CONTEXT_FRAMES,
    0, LONG_CONTEXT_CAPTION_LEN, LONG_CONTEXT_TASK)`."""
    return mix_train_flops(b, cfg.eva_config, cfg.bert_config, task,
                           n_frames=frames, n_audio=audio, n_depth=0,
                           cap_len=cap_len, sub_len=0, q_len=0, ans_len=0)
