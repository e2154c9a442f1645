"""Annotation-indexed dataset (counterpart of
`mico_tpu/data/anno_dataset.py`).

The reference `AnnoIndexedDataset` (data/data/IndexAnno.py:23-121) and its
collate (IndexAnno.py:124-150):
  - a JSON list of annotation dicts; the id from the first of
    video_id/image_id/image/id;
  - captions from `desc` or `caption`; `id_txt` repeats the id per caption
    for multi-caption retrieval eval;
  - QA fields: training picks a random answer from a list (vqav2), eval
    keeps the full list and the question_id;
  - corrupt vision/audio/depth → log and resample a random index (train
    and eval, as the reference behaves);
  - collate: ndarray fields stacked into float32 batches, str/list fields
    kept as lists.
"""

from __future__ import annotations

import json
import random
from typing import Optional

import numpy as np

from mico_tpu_torch.data.mappers import (AudioMapper, DecodeCache,
                                         DepthMapper, VisionMapper)

_ID_KEYS = ("video_id", "image_id", "image", "id")

# collate field order matches __getitem__'s tuple (IndexAnno.py:124-137)
_FIELDS = (
    "ids",
    "raw_captions",
    "vision_pixels",
    "ids_txt",
    "raw_questions",
    "raw_answers",
    # eval-time VQA question identifiers (reference IndexAnno question_id);
    # named *_raw so the tokenize bridge's token arrays keep `question_ids`
    "question_ids_raw",
    "audio_spectrograms",
    "raw_subtitles",
    "depth_pixels",
    # VAST-27M per-source caption streams (the task engine picks one per
    # fused-modality subtask; reference vast.py:655-780)
    "raw_vision_captions",
    "raw_audio_captions",
    "raw_omni_captions",
)

# annotation-key spellings accepted for the VAST-27M caption sources
_VAST27M_KEYS = {
    "raw_vision_captions": ("vision_cap", "vision_caption", "vision_captions"),
    "raw_audio_captions": ("audio_cap", "audio_caption", "audio_captions"),
    "raw_omni_captions": ("vast_cap", "omni_cap", "omni_caption",
                          "omni_captions"),
}


class AnnoIndexedDataset:
    def __init__(self, d_cfg: dict, model_cfg: dict,
                 seed: Optional[int] = None):
        self.vision_mapper = (VisionMapper(d_cfg, model_cfg, seed)
                              if "vision" in d_cfg else None)
        self.audio_mapper = (AudioMapper(d_cfg, model_cfg, seed)
                             if "audio" in d_cfg else None)
        self.depth_mapper = (DepthMapper(d_cfg, model_cfg, seed)
                             if "depth" in d_cfg else None)
        with open(d_cfg["txt"]) as f:
            self.annos = json.load(f)
        self.idx = list(range(len(self.annos)))
        self.dataset_name = d_cfg.get("name", "dataset")
        self.training = bool(d_cfg.get("training", True))
        self.annfile = d_cfg.get("annfile")
        self.make_submission = bool(d_cfg.get("make_submission", False))
        self.multi_evaluation = bool(d_cfg.get("multi_evaluation", False))
        self.collate_fn = anno_collate
        self._rng = random.Random(seed)
        # decodes a DataLoader's workers run ahead of `__getitem__`
        self.decode_cache = DecodeCache()
        for mapper in self._mappers():
            mapper.decode = self.decode_cache

    def _mappers(self):
        return [m for m in (self.vision_mapper, self.audio_mapper,
                            self.depth_mapper) if m is not None]

    def prefetch(self, indices, pool) -> None:
        """Start decoding the files of `indices` on `pool`: the pure
        decodes only, so every draw still happens in `__getitem__`."""
        for i in indices:
            anno = self.annos[i]
            id_ = next(anno[k] for k in _ID_KEYS if k in anno)
            for mapper in (self.vision_mapper, self.audio_mapper):
                if mapper is not None:
                    mapper.prefetch(id_, pool, self.decode_cache)

    def __len__(self) -> int:
        return len(self.annos)

    def _resample(self, id_, what: str, depth: int):
        if depth > 16:
            raise ValueError(f"too many corrupt samples near {id_}")
        resample = self._rng.choice(self.idx)
        print(f"current idx {id_} from {self.dataset_name} returns wrong "
              f"{what}, use {resample} instead.")
        return self.__getitem__(resample, depth + 1)

    def __getitem__(self, i: int, _depth: int = 0):
        anno = self.annos[i]
        id_ = next(anno[k] for k in _ID_KEYS if k in anno)

        raw_captions = anno.get("desc", anno.get("caption"))
        num_samples = (len(raw_captions) if isinstance(raw_captions, list)
                       else 1)
        id_txt = [id_] * num_samples

        raw_subtitles = anno.get("subtitle")
        question = answer = question_id = None
        if "question" in anno:
            question = anno["question"]
            answer = anno["answer"]
            if self.training and isinstance(answer, list):  # vqav2
                answer = self._rng.choice(answer)
            elif not self.training:
                question_id = anno.get("question_id")

        vision_pixels = None
        if self.vision_mapper is not None:
            vision_pixels = self.vision_mapper.read(id_)
            if vision_pixels is None:
                return self._resample(id_, "image/video", _depth)

        audio_spectrograms = None
        if self.audio_mapper is not None:
            audio_spectrograms = self.audio_mapper.read(id_)
            if audio_spectrograms is None:
                if not self.training:
                    raise ValueError(f"corrupt eval audio for {id_}")
                return self._resample(id_, "audio", _depth)

        depth_pixels = None
        if self.depth_mapper is not None:
            depth_pixels = self.depth_mapper.read(id_)
            if depth_pixels is None:
                return self._resample(id_, "depth", _depth)

        vast27m = tuple(next((anno[k] for k in keys if k in anno), None)
                        for keys in _VAST27M_KEYS.values())
        return (id_, raw_captions, vision_pixels, id_txt, question, answer,
                question_id, audio_spectrograms, raw_subtitles,
                depth_pixels) + vast27m


def anno_collate(samples) -> dict:
    batch = {}
    for key, column in zip(_FIELDS, zip(*samples)):
        if column[0] is None:
            continue
        if isinstance(column[0], np.ndarray):
            batch[key] = np.stack(column).astype(np.float32)
        else:
            batch[key] = list(column)
    return batch
