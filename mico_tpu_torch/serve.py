"""Omni-modal embedding serving pipeline (counterpart of `mico_tpu/serve.py`).

A thread pool decodes and preprocesses items on the host (the processors
of `media/`); ready items are packed into fixed-size batches (the last one
padded) and copied to the card through pinned host buffers with
`non_blocking=True`, so the copy of batch i+1 is queued behind the compute
of batch i; every modality of a batch folds into one encoder pass (image =
1-frame video; audio tiled to 3 channels through the shared ViT, or
through the config's separate BEATs/AST tower, whose fbank size the caller
passes as `melbins`, `target_length` and `resize_melbin_num`). Vision
pools by the tower's rule (`MiCo.pool_vision_for_contra`: CLS, or Swin's
patch mean), audio by its tower's. Failed items come back as zero rows,
with their indices in `last_failures`.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.media import AudioProcessor, ImageProcessor, VideoProcessor
from mico_tpu_torch.media.video_io import video_format
from mico_tpu_torch.models.mico import MiCo, resolve_device


def _l2_normalize(feat: torch.Tensor) -> torch.Tensor:
    feat = feat.float()
    return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)


class _PinnedStager:
    """Two pinned host buffers used in turn for host → device copies; a
    buffer is refilled only after the copy that last read it has finished."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.bufs: List[Optional[torch.Tensor]] = [None, None]
        self.events: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(arr)
        if not self.pinned:
            return src.to(self.device)
        i, self.turn = self.turn, self.turn ^ 1
        buf = self.bufs[i]
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self.bufs[i] = torch.empty_like(src).pin_memory()
        elif self.events[i] is not None:
            self.events[i].synchronize()
        buf.copy_(src)
        out = buf.to(self.device, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record()
        return out


class EmbeddingPipeline:
    """Batched omni-modal embedding extraction.

    >>> pipe = EmbeddingPipeline(model, cfg, tokenizer)
    >>> out = pipe.embed_images(paths)              # (N, contra_dim)
    >>> out = pipe.embed_videos(paths)
    >>> out = pipe.embed_audio(paths)
    >>> out = pipe.embed_texts(strings)
    Failed items come back as zero rows + indices in `pipe.last_failures`.

    `model` is a `MiCo`; with `fold_constants` (the default) the pipeline
    serves a folded copy of an EVA tower, so the caller's model keeps its
    canonical layout (a CLIP tower's folded copy is the model itself).
    A video given as a directory is read as its frame images.
    """

    def __init__(
        self,
        model: MiCo,
        cfg: MiCoConfig,
        tokenizer=None,
        batch_size: int = 16,
        io_workers: Optional[int] = None,
        melbins: int = 224,
        target_length: int = 224,
        resize_melbin_num: int = 224,
        fold_constants: bool = True,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if fold_constants and model.cfg.is_eva:
            # LN affines / LayerScale folded into the adjacent matmuls — a
            # reparametrization (MiCo.fold_inference_params) on a copy; a
            # CLIP tower folds to itself, so it is served as it is
            model = copy.deepcopy(model).fold_inference_params()
        self.model = model.to(self.device)
        self.cfg = cfg
        self.tok = tokenizer
        self.batch_size = batch_size
        if io_workers is None:
            io_workers = max(2, min(32, os.cpu_count() or 1))
        self.pool = ThreadPoolExecutor(max_workers=io_workers)
        self.image_proc = ImageProcessor(
            cfg.vision_resolution, cfg.vision_encoder_type, training=False)
        self.video_procs = {fmt: VideoProcessor(
            cfg.vision_resolution, cfg.vision_encoder_type,
            sample_num=cfg.max_vision_sample_num, data_format=fmt,
            training=False) for fmt in ("raw", "frame")}
        self.audio_proc = AudioProcessor(
            melbins=melbins, target_length=target_length,
            resize_melbin_num=resize_melbin_num,
            sample_num=cfg.max_audio_sample_num, training=False)
        self.stager = _PinnedStager(self.device)
        self.last_failures: List[int] = []

    def close(self) -> None:
        self.pool.shutdown(wait=True)

    # ---- device programs (one per modality head) ---------------------------

    def _embed_pixels(self, model: MiCo, pixels: torch.Tensor,
                      head: str) -> torch.Tensor:
        tokens = model.forward_vision_encoder(pixels)
        return _l2_normalize(model.contra_head(
            head, model.pool_vision_for_contra(tokens)))

    def _embed_audio(self, model: MiCo, spectrograms: torch.Tensor) -> torch.Tensor:
        tokens = model.forward_audio_encoder(spectrograms)
        return _l2_normalize(model.contra_head(
            "a", model.pool_audio_for_contra(tokens)))

    def _embed_text(self, model: MiCo, ids: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        seq = model.forward_multimodal_encoder(ids, mask)
        return _l2_normalize(model.contra_head("t", model.pool_text_for_contra(seq)))

    # ---- host-side batching ------------------------------------------------

    def _run(self, items: Sequence, proc: Callable, device_fn: Callable
             ) -> np.ndarray:
        """Threaded `proc` over the items (a None result is a failure) →
        fixed-size padded batches → `device_fn(model, batch)` on the card.
        `proc` runs a few batches ahead of the device (a bounded window, so
        long item lists stream at constant host memory)."""
        self.last_failures = []
        bs = self.batch_size
        n = len(items)
        window = 4 * bs
        futures = [self.pool.submit(proc, p) for p in items[:window]]
        next_submit = len(futures)

        outs = []
        sample_shape = None
        chunk, chunk_start = [], 0

        def flush(chunk, start):
            nonlocal sample_shape
            if sample_shape is None:
                sample_shape = next(
                    (np.asarray(x).shape for x in chunk if x is not None), None)
            for j, x in enumerate(chunk):
                if x is None:
                    self.last_failures.append(start + j)
            if sample_shape is None:       # all failures so far: zero rows
                outs.append((start, len(chunk), None))
                return
            arr = np.zeros((bs, *sample_shape), np.float32)
            for j, x in enumerate(chunk):
                if x is not None:
                    arr[j] = x
            outs.append((start, len(chunk),
                         device_fn(self.model, self.stager.to_device(arr))))

        for i in range(n):
            fut = futures[i]
            futures[i] = None   # release: a Future retains its result array
            chunk.append(fut.result())
            futures.append(self.pool.submit(proc, items[next_submit])
                           if next_submit < n else None)
            next_submit += 1
            if len(chunk) == bs:
                flush(chunk, chunk_start)
                chunk, chunk_start = [], i + 1
        if chunk:
            flush(chunk, chunk_start)

        dim = next((o.shape[-1] for _, _, o in outs if o is not None),
                   self.cfg.contra_dim)
        feats = np.zeros((n, dim), np.float32)
        for start, count, o in outs:
            if o is not None:
                feats[start:start + count] = o[:count].cpu().numpy()
        feats[self.last_failures] = 0.0
        return feats

    def embed_images(self, paths: Sequence[str]) -> np.ndarray:
        return self._run(   # (1, 3, R, R): an image is a 1-frame video
            paths, self.image_proc,
            lambda model, x: self._embed_pixels(model, x, head="v"))

    def embed_videos(self, paths: Sequence[str]) -> np.ndarray:
        return self._run(
            paths, lambda p: self.video_procs[video_format(p)](p),
            lambda model, x: self._embed_pixels(model, x, head="v"))

    def embed_depth(self, paths: Sequence[str]) -> np.ndarray:
        return self._run(
            paths, self.image_proc,
            lambda model, x: self._embed_pixels(model, x, head="d"))

    def embed_audio(self, paths: Sequence[str]) -> np.ndarray:
        return self._run(paths, self.audio_proc, self._embed_audio)

    def embed_texts(self, texts: Sequence[str], max_length: int = 30
                    ) -> np.ndarray:
        self.last_failures = []
        enc = self.tok(list(texts), max_length=max_length)
        bs = self.batch_size
        n = len(texts)
        pad = (-n) % bs
        ids = np.pad(enc["input_ids"], ((0, pad), (0, 0)))
        mask = np.pad(enc["attention_mask"], ((0, pad), (0, 0)))
        outs = []
        for start in range(0, len(ids), bs):
            outs.append(self._embed_text(
                self.model,
                self.stager.to_device(ids[start:start + bs]),
                self.stager.to_device(mask[start:start + bs]),
            ))
        return torch.cat(outs).cpu().numpy()[:n]

    def similarity(self, text_feats: np.ndarray, media_feats: np.ndarray
                   ) -> np.ndarray:
        return text_feats @ media_feats.T
