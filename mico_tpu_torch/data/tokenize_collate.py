"""Host-side tokenize bridge: raw-text batch → fixed-shape token batch
(counterpart of `mico_tpu/data/tokenize_collate.py`).

The reference tokenizes inside the model (`VAST.batch_get`,
data/model/vast.py:81-137: padding="max_length", truncation at
max_caption_len / max_subtitle_len / max_omni_caption_len; answers at
max_length=10, vast.py:580-585). The port tokenizes between the loader and
the step, as the JAX package does: the same token ids and shapes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mico_tpu_torch.text import BertWordPieceTokenizer

MAX_ANSWER_LEN = 10  # reference data/model/vast.py:584


class BatchTokenizer:
    """Adds `caption_ids/caption_mask`, `subtitle_ids/subtitle_mask`,
    `question_ids/question_mask`, `answer_ids/answer_mask` to a collated
    batch, as the task string requires. Raw fields are kept for eval."""

    def __init__(self, tokenizer: BertWordPieceTokenizer,
                 max_caption_len: int = 40, max_omni_caption_len: int = 70,
                 max_subtitle_len: int = 70):
        self.tok = tokenizer
        self.max_caption_len = max_caption_len
        self.max_omni_caption_len = max_omni_caption_len
        self.max_subtitle_len = max_subtitle_len

    def _encode(self, texts, max_length: int):
        # multi-caption eval samples carry lists; train uses the first
        flat = [t[0] if isinstance(t, list) else t for t in texts]
        enc = self.tok(flat, max_length=max_length)
        return enc["input_ids"], enc["attention_mask"]

    def __call__(self, batch: Dict, task: str) -> Dict:
        out = dict(batch)
        # caption length: omni when the fused-modality subtasks include
        # subtitles (reference omni_caption_tokens, vast.py:130-137)
        cap_len = (
            self.max_omni_caption_len
            if any("s" in sub for sub in task.replace("_", "%").split("%")[1:])
            else self.max_caption_len
        )
        if "raw_captions" in batch and "caption_ids" not in batch:
            ids, mask = self._encode(batch["raw_captions"], cap_len)
            out["caption_ids"], out["caption_mask"] = ids, mask
        if "raw_subtitles" in batch and "subtitle_ids" not in batch:
            ids, mask = self._encode(batch["raw_subtitles"],
                                     self.max_subtitle_len)
            out["subtitle_ids"], out["subtitle_mask"] = ids, mask
        if "raw_questions" in batch and "question_ids" not in batch:
            ids, mask = self._encode(batch["raw_questions"],
                                     self.max_caption_len)
            out["question_ids"], out["question_mask"] = ids, mask
        if "raw_answers" in batch and "answer_ids" not in batch:
            answers = [a[0] if isinstance(a, list) else a
                       for a in batch["raw_answers"]]
            ids, mask = self._encode(answers, MAX_ANSWER_LEN)
            out["answer_ids"], out["answer_mask"] = ids, mask
        # VAST-27M pretraining batches carry per-source caption lists
        # (vision/audio/omni); each subtask picks its own caption stream
        # (reference vast.py:107-137 {vision,audio,omni}_caption_tokens)
        for src, length in (("vision", self.max_caption_len),
                            ("audio", self.max_caption_len),
                            ("omni", self.max_omni_caption_len)):
            raw = f"raw_{src}_captions"
            if raw in batch and f"{src}_caption_ids" not in batch:
                ids, mask = self._encode(batch[raw], length)
                out[f"{src}_caption_ids"] = ids
                out[f"{src}_caption_mask"] = mask
        return out


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The array leaves of a batch as tensors on `device` (host-only string
    and list fields dropped; tensors already there stay as they are)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
    return out
