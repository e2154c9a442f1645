"""Evaluation registry (counterpart of `mico_tpu/evaluation/__init__.py`):
the `evaluation_mm` package the reference imports but does not ship
(data/utils/pipeline.py:9). Its call shape is reconstructed from the call
sites:

    evaluate_fn = evaluation_registry[run_cfg.evaluation_type]
    eval_log = evaluate_fn(evaluator, val_loaders, run_cfg, global_step)
    # → {loader_name: {metric: value}}, metrics incl. CIDEr / accuracy /
    #   video_r1 (best-metric tracking, data/utils/pipeline.py:168-179)

Tasks per loader name "task--dataset" (data/model/vast.py:317-371):
  ret%XX  — contrastive retrieval recall (t2v/v2t r1/5/10) per subtask,
            optionally re-ranked by the ITM head
  cap%XX  — caption generation + BLEU-4/CIDEr-D; captioner_mode emits
            generate_nums top-k samples per clip instead of scoring
            (data/model/vast.py:521-553)
  qa%XX   — beam-decoded short answers + VQA accuracy

The port runs each pass eagerly under `torch.inference_mode()` on the
model's device, in the model's compute dtype (in place of JAX's jit cache):
the ViT takes its inference route (K1 on the card), BERT's cross-attention
in the ITM re-rank K2. Across processes each rank evaluates its shard of
the set (the unpadded sampler: data index r takes items r, r + world,
...; the ranks of a model group run the same items on their parts of a
tensor-parallel model, or on the tower of a pipeline-staged model gathered
whole, and only model index 0's shard is kept) and
the shards' outputs merge through `gather_objects` before scoring, as in
JAX (:188-204, :346-367, :417-439), so every rank computes the metrics of
the whole set, and rank 0 alone writes the annotation and submission
files. The port puts the merged items back in the set's order (JAX
concatenates the shards), so the metrics are a one-process evaluation's
also where they break ties by position (the ITM re-rank's floor scores).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.data.tokenize_collate import BatchTokenizer, device_batch
from mico_tpu_torch.evaluation.metrics import (
    bleu4,
    cider_d,
    retrieval_recall,
    vqa_accuracy,
)
from mico_tpu_torch.generation import generate, generate_answers
from mico_tpu_torch.models.mico import MiCo
from mico_tpu_torch.parallel.collectives import (data_shards,
                                                 gather_objects,
                                                 process_count,
                                                 process_index)
from mico_tpu_torch.parallel.pipeline_parallel import whole_tower
from mico_tpu_torch.train.objectives import (
    compute_features,
    compute_slice_scores,
    compute_text_feature,
)
from mico_tpu_torch.utils.logger import LOGGER


def _subtasks(task: str):
    parts = task.split("%")
    return parts[0], parts[1:]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def _item_order(counts) -> list:
    """(shard, item) pairs of gathered shards in the set's order: shard r's
    k-th item is the set's item r + k·world (the unpadded sampler)."""
    world = len(counts)
    return [sk for _, sk in sorted((r + k * world, (r, k))
                                   for r, n in enumerate(counts)
                                   for k in range(n))]


class Evaluator:
    """Eval passes of one model: the model (`MiCo`) as it stands, its
    config and the tokenizer."""

    def __init__(self, cfg: MiCoConfig, model: MiCo, tokenizer,
                 run_cfg=None):
        if cfg.pipeline_stages > 1:
            # as JAX's evaluator (:75-81): pipeline stages are a
            # training-memory tool, and one inference pass gains nothing
            # from them; `evaluation_mm` runs on the tower gathered whole
            # (`pipeline_parallel.whole_tower`)
            cfg = dataclasses.replace(cfg, pipeline_stages=1)
        # the token-sharded condition is a training layout: the evaluation
        # reads whole condition tokens (a tensor-parallel model gathers
        # nothing for them: its towers' outputs are whole on every rank)
        cfg = dataclasses.replace(cfg, shard_condition_sequence=False)
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.tok = tokenizer
        self.run_cfg = run_cfg or {}
        self.batch_tok = BatchTokenizer(
            tokenizer,
            max_caption_len=cfg.max_caption_len,
            max_omni_caption_len=cfg.max_omni_caption_len,
            max_subtitle_len=cfg.max_subtitle_len,
        )

    def _arrays(self, tb) -> Dict[str, torch.Tensor]:
        return device_batch(tb, self.device)

    def _features(self, modalities: str, arrays) -> Dict[str, torch.Tensor]:
        return compute_features(self.model, self.cfg, arrays, modalities)

    def _cond(self, modalities: str, arrays) -> torch.Tensor:
        return self._features(modalities, arrays)[
            f"condition_feats_{modalities}"]

    # ---- retrieval ----

    def _flatten_captions(self, tb, task):
        """Multi-caption eval sets: every caption becomes a text row, with
        the reference's ids_txt row→visual-item mapping (IndexAnno id_txt,
        vast.py:441-443 raw-caption flattening).
        → (flat texts, local map)."""
        flat, local = [], []
        for j, c in enumerate(tb["raw_captions"]):
            caps = c if isinstance(c, list) else [c]
            flat.extend(caps)
            local.extend([j] * len(caps))
        return flat, local

    def _encode_texts(self, texts, task):
        omni = any("s" in s[1:] for s in _subtasks(task)[1])
        length = (self.cfg.max_omni_caption_len if omni
                  else self.cfg.max_caption_len)
        enc = self.tok(texts, max_length=length)
        return enc["input_ids"], enc["attention_mask"]

    @torch.inference_mode()
    def eval_retrieval(self, loader, task: str,
                       itm_rerank: bool = False) -> Dict[str, float]:
        _, subs = _subtasks(task)
        feats = {m: [] for m in (s[1:] for s in subs)}
        conds = {m: [] for m in feats} if itm_rerank else None
        feats_t, txt2vis = [], []
        text_ids, text_masks = [], []
        n_vis = 0
        for batch in loader:
            tb = self.batch_tok(batch, task)
            arrays = self._arrays(tb)
            b = len(tb["ids"])
            for sub in subs:
                m = sub[1:]
                out = self._features(m, arrays)
                feats[m].append(_host(out[f"feat_{m}"]))
                if itm_rerank:
                    conds[m].append(out[f"condition_feats_{m}"])
            # text side: one row per caption (multi-caption sets flatten)
            flat, local = self._flatten_captions(tb, task)
            ids, mask = self._encode_texts(flat, task)
            feats_t.append(_host(compute_text_feature(
                self.model, self.cfg,
                {"caption_ids": torch.from_numpy(ids).to(self.device),
                 "caption_mask": torch.from_numpy(mask).to(self.device)})))
            if itm_rerank:
                text_ids.append(ids)
                text_masks.append(mask)
            txt2vis.extend(n_vis + j for j in local)
            n_vis += b
        if process_count() > 1:
            # every rank holds its shard of the gallery: gather all before
            # scoring (the reference ddp_allgathers for the same reason,
            # data/utils/distributed.py:133-149)
            cat = (lambda xs: np.concatenate(xs) if xs else None)
            shards = data_shards(gather_objects(dict(
                t=cat(feats_t), v={m: cat(c) for m, c in feats.items()},
                txt2vis=np.asarray(txt2vis, np.int64), n_vis=n_vis,
                conds=({m: torch.cat(cs).cpu() if cs else None
                        for m, cs in conds.items()} if itm_rerank else None),
                text_ids=cat(text_ids), text_masks=cat(text_masks))))
            feats_t, txt2vis = [], []
            feats = {m: [] for m in feats}
            conds = {m: [] for m in feats} if itm_rerank else None
            text_ids, text_masks = [], []
            for j, (r, k) in enumerate(_item_order(
                    [sh["n_vis"] for sh in shards])):
                sh = shards[r]
                texts = np.nonzero(sh["txt2vis"] == k)[0]
                feats_t.append(sh["t"][texts])
                txt2vis += [j] * len(texts)
                if itm_rerank:
                    text_ids.append(sh["text_ids"][texts])
                    text_masks.append(sh["text_masks"][texts])
                for m in feats:
                    feats[m].append(sh["v"][m][k:k + 1])
                    if itm_rerank:
                        conds[m].append(sh["conds"][m][k:k + 1].to(
                            self.device))
        results: Dict[str, float] = {}
        t = np.concatenate(feats_t)
        for m, chunks in feats.items():
            v = np.concatenate(chunks)
            sim = t @ v.T
            for k, val in retrieval_recall(sim, txt2vis).items():
                results[f"{k}_{m}"] = val
            if itm_rerank:
                sim_r = self._itm_rerank(sim, torch.cat(conds[m]),
                                         np.concatenate(text_ids),
                                         np.concatenate(text_masks))
                for k, val in retrieval_recall(sim_r, txt2vis).items():
                    results[f"{k}_itm_{m}"] = val
        results["video_r1"] = float(np.mean(
            [v for k, v in results.items() if k.startswith("video_r1")]))
        return results

    def _scores(self, cond_n, ids, mask) -> np.ndarray:
        dev = self.device
        return _host(compute_slice_scores(
            self.model, self.cfg, cond_n, torch.from_numpy(ids).to(dev),
            torch.from_numpy(mask).to(dev)))

    def _itm_rerank(self, sim, cond, text_ids, text_masks) -> np.ndarray:
        """Re-score each text's top `cfg.itm_rerank_num` ITC candidates with
        the ITM head (reference model_cfg.itm_rerank_num; BLIP/VAST-style
        coarse-to-fine retrieval). With cfg.ret_bidirection_evaluation the
        vis→text direction is re-ranked too; scores outside the top-N keep
        a rank-preserving floor of -1. `cond`: the condition tokens of
        every visual item, on the model's device."""
        n = min(self.cfg.itm_rerank_num, sim.shape[1])
        out = np.full_like(sim, -1.0)
        top = np.argsort(-sim, axis=1)[:, :n]
        for i in range(sim.shape[0]):
            rows = torch.from_numpy(top[i]).to(self.device)
            out[i, top[i]] = self._scores(
                cond[rows], np.repeat(text_ids[i][None], n, axis=0),
                np.repeat(text_masks[i][None], n, axis=0))
        if self.cfg.ret_bidirection_evaluation:
            nt = min(self.cfg.itm_rerank_num, sim.shape[0])
            top_t = np.argsort(-sim, axis=0)[:nt]        # (nt, n_vis)
            for j in range(sim.shape[1]):
                rows = top_t[:, j]
                cond_n = cond[j][None].expand(nt, *cond.shape[1:])
                s = self._scores(cond_n, text_ids[rows], text_masks[rows])
                # average with the t2v pass where both scored the pair
                cur = out[rows, j]
                out[rows, j] = np.where(cur > -1.0, (cur + s) / 2.0, s)
        return out

    # ---- captioning ----

    @torch.inference_mode()
    def eval_caption(self, loader, task: str, captioner_mode: bool = False,
                     generate_nums: int = 1,
                     output_path: Optional[str] = None) -> Dict[str, float]:
        _, subs = _subtasks(task)
        rc = self.run_cfg
        hyps: Dict[str, list] = {s: [] for s in subs}
        refs, ids = [], []
        annotations = []
        bert, dtype = self.model.bert, self.model.compute_dtype
        for batch in loader:
            tb = self.batch_tok(batch, task)
            arrays = self._arrays(tb)
            for sub in subs:
                cond = self._cond(sub[1:], arrays)
                if captioner_mode:
                    # VAST-27M annotation mode: generate_nums top-k samples
                    # per clip (data/model/vast.py:521-537); the draws come
                    # from a torch generator seeded as JAX seeds its key
                    toks = generate(
                        bert, cond.repeat_interleave(generate_nums, dim=0),
                        max_new_tokens=self.cfg.max_caption_len,
                        mode="sample", top_k=int(rc.get("top_k", 10)),
                        generator=torch.Generator(self.device).manual_seed(
                            len(ids)),
                        compute_dtype=dtype)
                else:
                    toks = generate(bert, cond,
                                    max_new_tokens=self.cfg.max_caption_len,
                                    mode="beam", num_beams=self.cfg.beam_size,
                                    compute_dtype=dtype)
                hyps[sub].extend(self.tok.batch_decode(toks.cpu().numpy()))
            ids.extend(tb["ids"])
            caps = tb.get("raw_captions")
            if caps is not None:
                refs.extend([c if isinstance(c, list) else [c] for c in caps])
        if process_count() > 1:
            shards = data_shards(gather_objects(dict(hyps=hyps, refs=refs,
                                                     ids=ids)))
            order = _item_order([len(sh["ids"]) for sh in shards])
            g = generate_nums if captioner_mode else 1
            hyps = {s: [h for r, k in order
                        for h in shards[r]["hyps"][s][k * g:(k + 1) * g]]
                    for s in subs}
            refs = ([shards[r]["refs"][k] for r, k in order]
                    if any(sh["refs"] for sh in shards) else [])
            ids = [shards[r]["ids"][k] for r, k in order]
        results: Dict[str, float] = {}
        if captioner_mode:
            for sub in subs:
                grouped = [hyps[sub][i : i + generate_nums]
                           for i in range(0, len(hyps[sub]), generate_nums)]
                annotations.extend({"clip_id": i, f"{sub}_captions": g}
                                   for i, g in zip(ids, grouped))
            if output_path and process_index() == 0:
                with open(output_path, "w") as f:
                    json.dump(annotations, f)
            results["num_annotated"] = float(len(ids))
            return results
        for sub in subs:
            if refs:
                results[f"CIDEr_{sub}"] = cider_d(hyps[sub], refs)
                results[f"Bleu4_{sub}"] = bleu4(hyps[sub], refs)
        if results:
            results["CIDEr"] = float(np.mean(
                [v for k, v in results.items() if k.startswith("CIDEr")]))
        return results

    # ---- QA ----

    @torch.inference_mode()
    def eval_qa(self, loader, task: str,
                submission_path: Optional[str] = None) -> Dict[str, float]:
        """VQA eval; with `submission_path` also dumps
        [{question_id, answer}] for test-server submission (the dataset
        `make_submission` flag, reference data/data/IndexAnno.py eval
        fields)."""
        _, subs = _subtasks(task)
        preds: Dict[str, list] = {s: [] for s in subs}
        answers = []
        question_ids = []
        bert, dtype = self.model.bert, self.model.compute_dtype
        for batch in loader:
            tb = self.batch_tok(batch, task)
            arrays = self._arrays(tb)
            for sub in subs:
                cond = self._cond(sub[1:], arrays)
                toks = generate_answers(
                    bert, arrays["question_ids"], arrays["question_mask"],
                    cond, max_new_tokens=10, mode="beam",
                    num_beams=self.cfg.beam_size, compute_dtype=dtype)
                preds[sub].extend(self.tok.batch_decode(toks.cpu().numpy()))
            answers.extend(batch.get("raw_answers", [None] * len(tb["ids"])))
            question_ids.extend(batch.get("question_ids_raw",
                                          batch.get("ids", [])))
        if process_count() > 1:
            shards = data_shards(gather_objects(dict(
                preds=preds, answers=answers, qids=question_ids)))
            order = _item_order([len(sh["answers"]) for sh in shards])
            preds = {s: [shards[r]["preds"][s][k] for r, k in order]
                     for s in subs}
            answers = [shards[r]["answers"][k] for r, k in order]
            qids = [sh["qids"] for sh in shards]
            question_ids = ([qids[r][k] for r, k in order]
                            if all(len(q) == len(sh["answers"]) for q, sh in
                                   zip(qids, shards)) else sum(qids, []))
        results = {}
        scored = [a for a in answers if a is not None]
        for sub in subs:
            if scored:
                results[f"accuracy_{sub}"] = vqa_accuracy(
                    [p for p, a in zip(preds[sub], answers) if a is not None],
                    scored)
        if results:
            results["accuracy"] = float(np.mean(list(results.values())))
        if submission_path:
            sub0 = subs[0]
            if process_index() == 0:
                with open(submission_path, "w") as f:
                    json.dump([{"question_id": q, "answer": p}
                               for q, p in zip(question_ids, preds[sub0])],
                              f)
            results["num_submitted"] = float(len(preds[sub0]))
        return results


def evaluation_mm(evaluator: Evaluator, val_loaders: Dict, run_cfg,
                  global_step: int) -> Dict[str, Dict[str, float]]:
    """Evaluate every val loader according to its task prefix. A model
    staged over pipeline stages is evaluated on its tower gathered whole
    (every rank of a model group calls this; the blocks gathered are freed
    after it)."""
    with whole_tower(evaluator.model):
        return _evaluation_mm(evaluator, val_loaders, run_cfg, global_step)


def _evaluation_mm(evaluator: Evaluator, val_loaders: Dict, run_cfg,
                   global_step: int) -> Dict[str, Dict[str, float]]:
    logs: Dict[str, Dict[str, float]] = {}
    for name, loader in val_loaders.items():
        task = name.split("--")[0]
        head = task.split("%")[0].split("_")[0]
        captioner_mode = bool(run_cfg.get("captioner_mode", False))
        out_dir = run_cfg.get("output_dir", ".")
        if head == "ret":
            logs[name] = evaluator.eval_retrieval(
                loader, task,
                itm_rerank=bool(run_cfg.get("itm_rerank", False)))
        elif head == "cap":
            logs[name] = evaluator.eval_caption(
                loader, task, captioner_mode=captioner_mode,
                generate_nums=int(run_cfg.get("generate_nums", 1)),
                output_path=os.path.join(
                    out_dir, f"annotations_step{global_step}_{name}.json"
                ) if captioner_mode else None)
        elif head == "qa":
            logs[name] = evaluator.eval_qa(
                loader, task,
                submission_path=os.path.join(
                    out_dir, f"submission_step{global_step}_{name}.json"
                ) if run_cfg.get("make_submission") else None)
        else:
            LOGGER.warning("unknown eval task %s for loader %s", task, name)
        LOGGER.info("eval step %d %s: %s", global_step, name, logs.get(name))
    return logs


evaluation_registry = {"evaluation_mm": evaluation_mm}
