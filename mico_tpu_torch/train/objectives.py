"""Training objectives: the VAST task engine (counterpart of
`mico_tpu/train/objectives.py`).

  - ITC (vast.py:394-417): similarity / temperature against the other
    side's detached features, label smoothing 0.1, symmetric CE.
  - ITM (vast.py:419-457): hard negatives drawn from the softmaxed
    similarities (diagonal zeroed, +1e-4), a 3×bs batch [pos | cond-neg |
    text-neg] through BERT's cross-attention, 2-way CE on CLS.
  - CAP (vast.py:485-512): 60% masking, causal 3D mask, MLM loss.
  - QA (vast.py:557-611): part-causal mask, 99% answer masking.

`compute_features` memoizes each tower in a per-step cache, so each
encoder runs once per step however many subtasks read it. Randomness comes
from a CPU `torch.Generator` (`train_rng`); `Draws` hands recorded masks
and negative indices to the steps that would draw them, in call order.

`axis_name` is the data axis's process group (`parallel.mesh`; None on one
process), and each rank holds its rows of the global batch. The losses are
written so that their mean over the ranks, which the data-parallel step
averages, is the one-process loss on the global batch (the JAX run path's
step, `mico_tpu/train/train_step.py:81`):
  - ITC: each side against the other side's features gathered from every
    rank, detached as the one-process loss detaches them, the targets on
    this rank's diagonal block;
  - ITM: negatives drawn over the gathered rows (this rank's diagonal
    zeroed), the condition features gathered WITH gradient, so a negative
    drawn from another rank's rows sends its gradient home;
  - CAP / QA: the MLM mean over the global batch's valid tokens
    (`models.bert.mlm_loss`), not a mean of the ranks' means;
  - injected `Draws` hold the global batch's rows; each rank takes its
    own.
Under tensor parallelism `axis_name` stays the data group: the ranks of a
model group run the same rows on their parts of the model, and with
`shard_condition_sequence` the condition tokens travel token-sharded over
the model group (`parallel.tensor_parallel.SequenceShard`) to BERT's
cross-attentions, which gather them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.models import mico as mico_mod
from mico_tpu_torch.models.mico import MiCo
from mico_tpu_torch.ops.layers import fork_generator, split_generator
from mico_tpu_torch.parallel.collectives import (all_gather_concat,
                                                 all_gather_no_grad,
                                                 data_axis_index,
                                                 data_axis_size)
from mico_tpu_torch.parallel.tensor_parallel import (model_axis_of,
                                                     scatter_sequence,
                                                     seq_cat, seq_map)
from mico_tpu_torch.train.masker import mask_tokens


@dataclass
class Draws:
    """Recorded draws, consumed in call order: `masks` holds one (masked
    ids, labels) pair per `mask_tokens` call, `negatives` one (condition,
    text) pair of negative indices per ITM pass. Each holds the global
    batch's rows (the negatives index the gathered rows); `take` gives
    this rank's."""

    masks: List = field(default_factory=list)
    negatives: List = field(default_factory=list)

    def take(self, kind: str, group=None):
        n = data_axis_size(group)
        r = data_axis_index(group)
        return tuple(x[r * (x.shape[0] // n):(r + 1) * (x.shape[0] // n)]
                     for x in getattr(self, kind).pop(0))


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# features (batch_get)
# ---------------------------------------------------------------------------


def compute_features(model: MiCo, cfg: MiCoConfig,
                     batch: Dict[str, torch.Tensor], modalities: str,
                     train_rng: Optional[torch.Generator] = None,
                     cache: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Encoder outputs, the pooled contra feature and the condition tokens
    for a fused-modality string ('v', 'a', 'va', 'vs', ...) (mico_tpu
    objectives.py:49-161). batch: vision_pixels (b,n,3,h,w),
    audio_spectrograms (b,n,T,M), depth_pixels, subtitle_ids/_mask (b,L).
    `cache` (one per step) memoizes each tower. `shard_condition_sequence`
    (sequence parallelism, objectives.py:139-150) hands each
    `condition_feats_*` on token-sharded over the model group
    (`tensor_parallel.SequenceShard`), which each cross-attention gathers;
    on a model axis of 1 (or none) it changes nothing, as JAX's constraint
    on a 1-wide axis does not. Under pipeline stages the condition stays
    whole: JAX's constraint only lays out its replicated program, and BERT
    is not split (the model has no tensor-parallel axis)."""
    out: Dict[str, torch.Tensor] = {}
    pooled = {}
    cache = {} if cache is None else cache
    kv, ka, kd, ks = split_generator(train_rng, 4)

    def tower(name, run):
        if name not in cache:
            tokens = run()
            pooled = (mico_mod.pool_audio_for_contra(cfg, tokens)
                      if name == "audio"
                      else mico_mod.pool_vision_for_contra(cfg, tokens))
            cache[name] = (pooled,
                           mico_mod.condition_input(model, tokens, name))
        return cache[name]

    if "v" in modalities or "i" in modalities:
        feat, cond = tower("vision", lambda: mico_mod.forward_vision_encoder(
            model, batch["vision_pixels"], train_rng=kv))
        for m in ("v", "i"):     # 'i': MiCo's image alias
            if m in modalities:
                pooled[m] = feat
                out[f"condition_feats_{m}"] = cond
    if "a" in modalities:
        pooled["a"], out["condition_feats_a"] = tower(
            "audio", lambda: mico_mod.forward_audio_encoder(
                model, batch["audio_spectrograms"], train_rng=ka))
    if "d" in modalities:
        pooled["d"], out["condition_feats_d"] = tower(
            "depth", lambda: mico_mod.forward_depth_encoder(
                model, batch["depth_pixels"], train_rng=kd))
    if "s" in modalities:
        if "subtitle" not in cache:
            sub = mico_mod.forward_multimodal_encoder(
                model, batch["subtitle_ids"], batch["subtitle_mask"],
                train_rng=ks).sequence_output
            cache["subtitle"] = (sub[:, 0],
                                 mico_mod.subtitle_condition_input(model, sub))
        pooled["s"], out["condition_feats_s"] = cache["subtitle"]

    key = f"condition_feats_{modalities}"
    if key not in out:
        out[key] = torch.cat([out[f"condition_feats_{m}"] for m in modalities],
                             dim=1)
    if len(modalities) == 1:
        feat = mico_mod.contra_head(model, modalities, pooled[modalities])
    else:
        cat = torch.cat([pooled[m] for m in modalities], dim=-1)
        feat = mico_mod.contra_head(model, modalities, cat)
    out[f"feat_{modalities}"] = _normalize(feat)
    if cfg.shard_condition_sequence:
        axis = model_axis_of(model)
        for k in out:
            if k.startswith("condition_feats_"):
                out[k] = scatter_sequence(out[k], 1, axis)
    return out


def compute_text_feature(model: MiCo, cfg: MiCoConfig, batch: Dict,
                         ids_key: str = "caption_ids",
                         mask_key: str = "caption_mask",
                         train_rng: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    seq = mico_mod.forward_multimodal_encoder(
        model, batch[ids_key], batch[mask_key],
        train_rng=train_rng).sequence_output
    return _normalize(mico_mod.contra_head(model, "t", seq[:, 0]))


def caption_stream_for(batch: Dict, mods: str):
    """VAST-27M batches carry vision, audio and omni captions: 'tv' trains
    on the vision caption, 'ta' on the audio one, fused groups on the omni
    one (vast.py:655-780); other batches have `caption_ids` alone."""
    if any(f"{s}_caption_ids" in batch for s in ("vision", "audio", "omni")):
        src = {"v": "vision", "a": "audio"}.get(mods, "omni")
        key = f"{src}_caption_ids"
        if key in batch:
            return batch[key], batch[f"{src}_caption_mask"]
    return batch["caption_ids"], batch["caption_mask"]


# ---------------------------------------------------------------------------
# ITC
# ---------------------------------------------------------------------------


def _smoothed_ce(logits: torch.Tensor, targets: torch.Tensor,
                 smoothing: float = 0.1) -> torch.Tensor:
    n = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    soft = F.one_hot(targets, n) * (1 - smoothing) + smoothing / n
    return -(soft * logp).sum(dim=-1).mean()


def itc_loss(feat_cond: torch.Tensor, feat_t: torch.Tensor,
             temp: torch.Tensor, axis_name=None,
             label_smoothing: float = 0.1):
    """Symmetric InfoNCE; each side's negatives are the other side's
    detached features, gathered from every rank (`all_gather_no_grad`:
    the one-process loss on the global batch detaches them too, so the
    gather needs no gradient). → (loss, sim_t2cond, sim_cond2t), the sims
    (b, world·b) reused by ITM's negative sampling."""
    sim_cond2t = (feat_cond @ all_gather_no_grad(feat_t, axis_name).T) / temp
    sim_t2cond = (feat_t @ all_gather_no_grad(feat_cond, axis_name).T) / temp
    bs = feat_t.shape[0]
    targets = data_axis_index(axis_name) * bs + torch.arange(
        bs, device=feat_t.device)
    loss = 0.5 * (_smoothed_ce(sim_cond2t, targets, label_smoothing)
                  + _smoothed_ce(sim_t2cond, targets, label_smoothing))
    return loss, sim_t2cond, sim_cond2t


# ---------------------------------------------------------------------------
# ITM
# ---------------------------------------------------------------------------


def _negatives(sim: torch.Tensor, generator: torch.Generator,
               offset: int = 0) -> torch.Tensor:
    """One index per row from softmax(sim) + 1e-4 with the diagonal (this
    rank's rows start at column `offset`) zeroed (vast.py:429-436).
    Non-finite weights (a diverged step) draw uniformly: the step's
    finiteness check then reports the loss, rather than the sampler
    failing on the device."""
    w = torch.softmax(sim.detach().float(), dim=1) + 1e-4
    w = torch.where(torch.isfinite(w), w, 1.0)
    rows = torch.arange(w.shape[0], device=w.device)
    w[rows, rows + offset] = 0.0
    return torch.multinomial(w, 1, generator=generator)[:, 0]


def itm_loss(model: MiCo, cfg: MiCoConfig, condition_feats: torch.Tensor,
             input_ids: torch.Tensor, attention_mask: torch.Tensor,
             sim_t2cond: torch.Tensor, sim_cond2t: torch.Tensor,
             axis_name=None,
             train_rng: Optional[torch.Generator] = None,
             dedup_cross_kv: bool = False,
             negatives=None) -> torch.Tensor:
    """Hard-negative ITM (vast.py:419-457). `negatives`: recorded
    (condition, text) index tensors into the gathered rows, in place of
    the draws from train_rng. dedup_cross_kv projects the cross-K/V once
    per unique condition row (`kv_index`): the same math, off by default
    as JAX's ITM_DEDUP_CROSS_KV."""
    bs = input_ids.shape[0]
    dev = input_ids.device
    k_neg, k_drop = split_generator(train_rng, 2)
    if negatives is None:
        if train_rng is None:
            raise ValueError("itm_loss draws its negatives from train_rng")
        gen = fork_generator(k_neg, sim_t2cond.device)
        offset = data_axis_index(axis_name) * bs
        neg_cond, neg_text = (_negatives(sim_t2cond, gen, offset),
                              _negatives(sim_cond2t, gen, offset))
    else:
        neg_cond, neg_text = (x.to(dev, torch.long) for x in negatives)
    # a token-sharded condition (sequence parallelism) is gathered over
    # the data axis block by block: the batch is its first dimension
    cond_neg = seq_map(lambda c: all_gather_concat(c, axis_name)[neg_cond],
                       condition_feats)
    ids_all = all_gather_no_grad(input_ids, axis_name)
    mask_all = all_gather_no_grad(attention_mask, axis_name)
    ids_3 = torch.cat([input_ids, input_ids, ids_all[neg_text]])
    mask_3 = torch.cat([attention_mask, attention_mask, mask_all[neg_text]])
    pos = torch.arange(bs, device=neg_cond.device)
    if not dedup_cross_kv:
        cond_u = seq_cat([condition_feats, cond_neg, condition_feats])
        row_idx = None
    elif axis_name is None:
        # negatives are drawn from the local rows: b unique conditions
        cond_u, row_idx = condition_feats, torch.cat([pos, neg_cond, pos])
    else:
        # negatives may come from other ranks: 2b unique conditions
        cond_u = seq_cat([condition_feats, cond_neg])
        row_idx = torch.cat([pos, bs + pos, pos])
    seq = mico_mod.forward_multimodal_encoder(
        model, ids_3, mask_3, cond_u, train_rng=k_drop,
        condition_row_index=row_idx).sequence_output
    logits = mico_mod.itm_head(model, seq[:, 0])
    labels = (torch.arange(3 * bs, device=logits.device) < bs).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def compute_slice_scores(model: MiCo, cfg: MiCoConfig,
                         condition_feats: torch.Tensor,
                         input_ids: torch.Tensor,
                         attention_mask: torch.Tensor) -> torch.Tensor:
    """ITM match probability per (text, condition slice) pair
    (vast.py:373-380)."""
    seq = mico_mod.forward_multimodal_encoder(
        model, input_ids, attention_mask, condition_feats).sequence_output
    logits = mico_mod.itm_head(model, seq[:, 0])
    return torch.softmax(logits.float(), dim=-1)[:, 1]


# ---------------------------------------------------------------------------
# captioning / QA
# ---------------------------------------------------------------------------


def causal_3d_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(b, L) pad mask → (b, L, L) causal mask (vast.py:491-494)."""
    b, l = attention_mask.shape
    return torch.tril(attention_mask[:, None, :].expand(b, l, l))


def part_causal_3d_mask(question_mask: torch.Tensor,
                        answer_mask: torch.Tensor) -> torch.Tensor:
    """Question prefix bidirectional, answer causal, question rows blind to
    the answer (vast.py:591-596)."""
    b, ql = question_mask.shape
    full = torch.cat([question_mask, answer_mask], dim=1)
    l = full.shape[1]
    m = full[:, None, :].expand(b, l, l).long()
    ans = torch.ones((l, l), dtype=torch.long, device=full.device)
    ans[ql:, ql:] = torch.tril(ans[ql:, ql:])
    ans[:ql, ql:] = 0
    return m * ans[None]


def caption_loss(model: MiCo, cfg: MiCoConfig, condition_feats: torch.Tensor,
                 input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 train_rng: Optional[torch.Generator] = None,
                 mask_prob: float = 0.6, masked=None,
                 axis_name=None) -> torch.Tensor:
    """Masked captioning under the causal mask. `masked`: recorded (masked
    ids, labels) in place of mask_tokens' draws."""
    k_mask, k_drop = split_generator(train_rng, 2)
    masked_ids, labels = mask_tokens(
        input_ids, mask_prob, k_mask,
        range_end=cfg.bert_config.vocab_size, drawn=masked)
    return mico_mod.forward_multimodal_encoder(
        model, masked_ids, causal_3d_mask(attention_mask), condition_feats,
        labels=labels, train_rng=k_drop, data_group=axis_name).loss


def qa_loss(model: MiCo, cfg: MiCoConfig, condition_feats: torch.Tensor,
            question_ids: torch.Tensor, question_mask: torch.Tensor,
            answer_ids: torch.Tensor, answer_mask: torch.Tensor,
            train_rng: Optional[torch.Generator] = None,
            mask_prob: float = 0.99, masked=None,
            axis_name=None) -> torch.Tensor:
    k_mask, k_drop = split_generator(train_rng, 2)
    masked_ans, ans_labels = mask_tokens(
        answer_ids, mask_prob, k_mask,
        range_end=cfg.bert_config.vocab_size, drawn=masked)
    ids = torch.cat([question_ids.long(), masked_ans], dim=1)
    labels = torch.cat([torch.full_like(question_ids, -100).long(),
                        ans_labels], dim=1)
    return mico_mod.forward_multimodal_encoder(
        model, ids, part_causal_3d_mask(question_mask, answer_mask),
        condition_feats, labels=labels, train_rng=k_drop,
        data_group=axis_name).loss


# ---------------------------------------------------------------------------
# task dispatch (VAST.forward)
# ---------------------------------------------------------------------------


def task_losses(model: MiCo, cfg: MiCoConfig, batch: Dict[str, torch.Tensor],
                task: str, train_rng: Optional[torch.Generator],
                axis_name=None,
                draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
    """task: the reference grammar, e.g. 'ret%tva_cap%tva' or 'qa%tv'
    (vast.py:317-371). Returns the loss dict: this rank's share under a
    process group `axis_name` (their mean over the ranks is the global
    batch's loss). Each tower runs once per call (one feature cache for
    every group). Every stochastic step draws from `train_rng` in turn."""
    losses: Dict[str, torch.Tensor] = {}
    feat_cache: dict = {}
    for sub in task.split("_"):
        kind, *groups = sub.split("%")
        feats = {}
        for g in groups:
            feats.update(compute_features(model, cfg, batch, g[1:],
                                          train_rng=train_rng,
                                          cache=feat_cache))
        if kind == "ret":
            itc, itm = [], []
            feat_t_cache = {}
            for g in groups:
                mods = g[1:]
                cap_ids, cap_mask = caption_stream_for(batch, mods)
                ck = id(cap_ids)
                if ck not in feat_t_cache:
                    feat_t_cache[ck] = compute_text_feature(
                        model, cfg, {"ids": cap_ids, "mask": cap_mask},
                        ids_key="ids", mask_key="mask", train_rng=train_rng)
                li, s_t2c, s_c2t = itc_loss(
                    feats[f"feat_{mods}"], feat_t_cache[ck],
                    model.contra_temp, axis_name)
                itc.append(li)
                itm.append(cfg.itm_ratio * itm_loss(
                    model, cfg, feats[f"condition_feats_{mods}"], cap_ids,
                    cap_mask, s_t2c, s_c2t, axis_name, train_rng=train_rng,
                    negatives=draws.take("negatives", axis_name)
                    if draws else None))
            losses["loss_itc"] = sum(itc) / len(itc)
            losses["loss_itm"] = sum(itm) / len(itm)
        elif kind == "cap":
            caps = []
            for g in groups:
                cap_ids, cap_mask = caption_stream_for(batch, g[1:])
                caps.append(caption_loss(
                    model, cfg, feats[f"condition_feats_{g[1:]}"], cap_ids,
                    cap_mask, train_rng=train_rng,
                    masked=draws.take("masks", axis_name) if draws else None,
                    axis_name=axis_name))
            losses["loss_cap"] = sum(caps) / len(caps)
        elif kind == "qa":
            qas = []
            for g in groups:
                qas.append(qa_loss(
                    model, cfg, feats[f"condition_feats_{g[1:]}"],
                    batch["question_ids"], batch["question_mask"],
                    batch["answer_ids"], batch["answer_mask"],
                    train_rng=train_rng,
                    masked=draws.take("masks", axis_name) if draws else None,
                    axis_name=axis_name))
            losses["loss_qa"] = sum(qas) / len(qas)
        else:
            raise ValueError(f"unknown task {kind}")
    return losses
