"""Vision, depth and audio sample mappers (counterpart of
`mico_tpu/data/mappers.py`).

Rebuilds of the reference mappers, on the port's host media code:
  - VisionMapper (reference data/data/vision_mapper.py:16-211): formats
    `video_frame` (sorted image directories), `image_rawimage` (extension
    fallback, zeros for a missing file), `video_feats` (h5/npy clip
    features with mean-pool bucketing) and `video_rawvideo` (containers
    decoded by `media/video_io.py`'s cv2 route, the JAX module's fallback;
    extension fallback);
  - DepthMapper: per-id depth maps through the shared vision tower;
  - AudioMapper (reference data/data/audio_mapper.py:9-94): the fbank of
    the configured tower (`media.processors.encoder_fbank`: BEATs at 16
    kHz, 2**15 scaling, Kaldi defaults; AST at the file's own rate, a
    mean-centred wave, a Hanning window; the shared ViT as BEATs), its
    mean and std, zero-pad + fixed-window slicing, chunk sampling, zeros
    on a missing file.
Every draw comes from the mapper's own `random.Random(seed)`, in the JAX
module's order, so one corpus and seed give the JAX package's samples.
"""

from __future__ import annotations

import os
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from mico_tpu_torch.media.chunking import sample_chunk_indices
from mico_tpu_torch.media.image_io import load_image_chw
from mico_tpu_torch.media.processors import (
    AUDIO_ENCODER_STATS,
    _random_resized_crop,
    _resize_normalize_host,
    _resize_short_center_crop,
    _stats_for,
    encoder_fbank,
)
from mico_tpu_torch.media.video_io import read_frames_chw, video_num_frames

VIDEO_EXT_FALLBACK = ("", ".mp4", ".avi", ".webm", ".mkv")
IMAGE_EXT_FALLBACK = ("", ".jpg", ".JPEG")
AUDIO_EXT_FALLBACK = ("", ".wav", ".mp3", ".mkv")


class DecodeCache:
    """Results of pure decode functions (`fn(*args)`: no draw, the same
    output for the same arguments), computed ahead on worker threads and
    taken once by the reader; a key that was not submitted is computed
    where it is asked for. An exception is raised where the result is
    taken, as the inline call would raise it."""

    def __init__(self):
        self._futures: Dict = {}
        self._lock = threading.Lock()

    def submit(self, pool: ThreadPoolExecutor, fn, *args) -> None:
        key = (fn, args)
        with self._lock:
            if key not in self._futures:
                self._futures[key] = pool.submit(fn, *args)

    def __call__(self, fn, *args):
        with self._lock:
            fut = self._futures.pop((fn, args), None)
        return fn(*args) if fut is None else fut.result()

    def clear(self) -> None:
        with self._lock:
            futures, self._futures = self._futures, {}
        for fut in futures.values():
            fut.cancel()


def _inline(fn, *args):
    return fn(*args)


def middle_frames(path: str, sample_num: int) -> np.ndarray:
    """The evaluation frames of a container: the middle frame of each of
    `sample_num` chunks (no draw), decoded by `video_io`."""
    idx = sample_chunk_indices(video_num_frames(path), sample_num, False)
    return read_frames_chw(path, idx)


def _resolve_path(base: str, id_: str, fallbacks) -> Optional[str]:
    for ext in fallbacks:
        p = os.path.join(base, str(id_)) + ext
        if os.path.exists(p):
            return p
    return None


class VisionMapper:
    """d_cfg keys: vision (root dir / h5 path), name, training,
    vision_format, vision_sample_num, optional vision_transforms /
    dense_extraction / extract_fps / frame_fps; model_cfg keys:
    vision_resolution, vision_encoder_type."""

    def __init__(self, d_cfg: dict, model_cfg: dict,
                 seed: Optional[int] = None):
        self.vision = d_cfg["vision"]
        self.name = d_cfg.get("name", "dataset")
        self.training = bool(d_cfg.get("training", True))
        self.vision_format = d_cfg["vision_format"]
        self.dense_extraction = bool(d_cfg.get("dense_extraction", False))
        self.extract_fps = d_cfg.get("extract_fps")
        self.frame_fps = d_cfg.get("frame_fps")
        if self.vision_format.startswith("video"):
            self.sample_num = int(d_cfg["vision_sample_num"])
        self.resolution = int(model_cfg.get("vision_resolution", 224))
        self.mean, self.std = _stats_for(
            model_cfg.get("vision_encoder_type", "evaclip01_giant"))
        self.vision_transforms = d_cfg.get("vision_transforms", "none")
        if self.vision_transforms not in ("none", "crop_flip"):
            raise NotImplementedError(self.vision_transforms)
        self._rng = random.Random(seed)
        self.decode = _inline     # the dataset's DecodeCache when it has one

    def prefetch(self, id_, pool: ThreadPoolExecutor, cache: DecodeCache):
        """Submit the decodes `read(id_)` will ask for (every frame of a
        training video: its draws pick them later; an evaluation
        container's middle frames, which need no draw)."""
        if self.vision_format == "video_rawvideo":
            path = _resolve_path(self.vision, id_, VIDEO_EXT_FALLBACK)
            if path and not self.training and not self.dense_extraction:
                cache.submit(pool, middle_frames, path, self.sample_num)
            return
        if self.vision_format == "image_rawimage":
            path = _resolve_path(self.vision, id_, IMAGE_EXT_FALLBACK)
            paths = [path] if path else []
        elif self.vision_format == "video_frame":
            frame_dir = os.path.join(self.vision, str(id_))
            if not os.path.isdir(frame_dir):
                return
            names = sorted(os.listdir(frame_dir))
            if not self.training and not self.dense_extraction:
                names = [names[i] for i in sample_chunk_indices(
                    len(names), self.sample_num, False)]
            paths = [os.path.join(frame_dir, n) for n in names]
        else:
            return
        for p in paths:
            cache.submit(pool, load_image_chw, p)

    # ---- transforms (reference vision_mapper.py:54-78) ----

    def _normalize(self, frames01: np.ndarray) -> np.ndarray:
        m = np.asarray(self.mean, np.float32).reshape(1, 3, 1, 1)
        s = np.asarray(self.std, np.float32).reshape(1, 3, 1, 1)
        return (frames01.astype(np.float32) - m) / s

    def _transform(self, frames01: np.ndarray) -> np.ndarray:
        """(n,3,H,W) float [0,1] → (n,3,R,R) normalized float32."""
        r = self.resolution
        if self.vision_transforms == "crop_flip":
            if self.training:
                frames01 = _random_resized_crop(frames01, r, self._rng)
                if self._rng.random() < 0.5:
                    frames01 = frames01[..., ::-1].copy()
                return self._normalize(frames01)
            return self._normalize(_resize_short_center_crop(frames01, r))
        return _resize_normalize_host(frames01, r, tuple(self.mean),
                                      tuple(self.std))

    # ---- readers ----

    def read(self, id_) -> Optional[np.ndarray]:
        """The sample's (n, 3, R, R) frames, or None when its file is
        corrupt (the caller resamples)."""
        try:
            if self.vision_format == "video_rawvideo":
                return self._read_rawvideo(id_)
            if self.vision_format == "video_frame":
                return self._read_frames(id_)
            if self.vision_format == "image_rawimage":
                return self._read_image(id_)
            if self.vision_format == "video_feats":
                return self._read_feats(id_)
            raise NotImplementedError(self.vision_format)
        except (NotImplementedError, ImportError):
            raise           # a configuration error, not a corrupt sample
        except Exception as e:  # noqa: BLE001 — corrupt sample → resample
            print(e, id_)
            return None

    def _read_rawvideo(self, id_) -> np.ndarray:
        path = _resolve_path(self.vision, id_, VIDEO_EXT_FALLBACK)
        if path is None:
            raise FileNotFoundError(f"{id_} under {self.vision}")
        return self._read_rawvideo_path(path)

    def _read_rawvideo_path(self, path: str) -> np.ndarray:
        if not self.training and not self.dense_extraction:
            return self._transform(self.decode(middle_frames, path,
                                               self.sample_num))
        n = video_num_frames(path)
        sample_num = self.sample_num
        if self.dense_extraction:
            import cv2

            cap = cv2.VideoCapture(path)
            fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
            cap.release()
            sample_num = max(1, int(n * self.extract_fps / fps))
        idx = sample_chunk_indices(n, sample_num, self.training, self._rng)
        return self._transform(read_frames_chw(path, idx))

    def _read_frames(self, id_) -> np.ndarray:
        frame_dir = os.path.join(self.vision, str(id_))
        names = sorted(os.listdir(frame_dir))
        sample_num = self.sample_num
        if self.dense_extraction:
            sample_num = max(1, int(len(names) * self.extract_fps
                                    / self.frame_fps))
        idx = sample_chunk_indices(len(names), sample_num, self.training,
                                   self._rng)
        frames = np.stack([
            self.decode(load_image_chw, os.path.join(frame_dir, names[i]))
            for i in idx])
        return self._transform(frames)

    def _read_image(self, id_) -> np.ndarray:
        path = _resolve_path(self.vision, id_, IMAGE_EXT_FALLBACK)
        if path is None:
            # the reference returns zeros only for the known-missing llava
            # set (vision_mapper.py:196-199); this logs and zero-fills any
            print("not have im", id_)
            return np.zeros((1, 3, self.resolution, self.resolution),
                            np.float32)
        return self._transform(self.decode(load_image_chw, path)[None])

    def _read_feats(self, id_) -> np.ndarray:
        """Pre-extracted clip features: h5 (`c3d_features` or flat) or
        per-id .npy; rows L2-normalized, then mean-pooled into
        `num_pre_clips` buckets (reference vision_mapper.py:86-117)."""
        if self.vision.endswith("hdf5") or self.vision.endswith("h5"):
            import h5py

            with h5py.File(self.vision, "r") as f:
                g = f[str(id_)]
                feat = g["c3d_features"][:] if "c3d_features" in g else g[:]
        else:
            feat = np.load(os.path.join(self.vision, f"{id_}.npy"))
        feat = feat.astype(np.float32)
        feat /= np.maximum(np.linalg.norm(feat, axis=1, keepdims=True), 1e-12)
        num_pre_clips = int(getattr(self, "num_pre_clips", 32))
        n_src = feat.shape[0]
        idxs = np.round(np.arange(0, num_pre_clips + 1) / num_pre_clips
                        * n_src).astype(np.int64)
        idxs = np.clip(idxs, 0, n_src - 1)
        out = []
        for i in range(num_pre_clips):
            s, e = idxs[i], idxs[i + 1]
            out.append(feat[s:e].mean(axis=0) if s < e else feat[s])
        return np.stack(out)


class DepthMapper:
    """Depth maps for the MiCo 'd' modality. d_cfg keys: depth (root dir of
    per-id depth images; grayscale or RGB, read as 3 channels), optional
    depth_sample_num (stacked maps per id via `{id}_k` suffixes; default
    1). Depth rides the shared vision tower, so it takes the vision
    resolution and normalization."""

    def __init__(self, d_cfg: dict, model_cfg: dict,
                 seed: Optional[int] = None):
        self.depth_dir = d_cfg["depth"]
        self.training = bool(d_cfg.get("training", True))
        self.sample_num = int(d_cfg.get("depth_sample_num", 1))
        self.resolution = int(model_cfg.get("vision_resolution", 224))
        self.mean, self.std = _stats_for(
            model_cfg.get("vision_encoder_type", "evaclip01_giant"))
        self._rng = random.Random(seed)
        self.decode = _inline

    def read(self, id_) -> Optional[np.ndarray]:
        try:
            maps = []
            fallbacks = IMAGE_EXT_FALLBACK + (".png",)
            for k in range(self.sample_num):
                cand = str(id_) if self.sample_num == 1 else f"{id_}_{k}"
                path = _resolve_path(self.depth_dir, cand, fallbacks)
                if path is None and self.sample_num > 1:
                    # fewer maps than requested: repeat the base map
                    path = _resolve_path(self.depth_dir, id_, fallbacks)
                if path is None:
                    print("not have depth", id_)
                    return np.zeros((self.sample_num, 3, self.resolution,
                                     self.resolution), np.float32)
                maps.append(self.decode(load_image_chw, path))
            return _resize_normalize_host(np.stack(maps), self.resolution,
                                          tuple(self.mean), tuple(self.std))
        except Exception as e:  # noqa: BLE001 — corrupt sample → resample
            print(e, id_)
            return None


class AudioMapper:
    """d_cfg keys: audio (root dir), training, audio_sample_num; model_cfg
    keys: audio_melbins, audio_target_length, audio_encoder_type ("beats",
    "ast" or "shared"), vision_resolution. A slice is (target_length,
    melbins); the shared ViT reads it as an image, so there both must
    equal the resolution."""

    # audio_encoder_type → (mean, std) (reference audio_mapper.py:19-26);
    # the shared tower takes BEATs' fbank and statistics
    ENCODER_STATS = {**AUDIO_ENCODER_STATS,
                     "shared": AUDIO_ENCODER_STATS["beats"]}

    def __init__(self, d_cfg: dict, model_cfg: dict,
                 seed: Optional[int] = None):
        self.audio_dir = d_cfg["audio"]
        self.training = bool(d_cfg.get("training", True))
        self.sample_num = int(d_cfg["audio_sample_num"])
        self.melbins = int(model_cfg.get("audio_melbins", 64))
        self.target_length = int(model_cfg.get("audio_target_length", 1024))
        self.audio_encoder_type = model_cfg.get("audio_encoder_type", "beats")
        if self.audio_encoder_type not in self.ENCODER_STATS:
            raise NotImplementedError(
                f"audio_encoder_type {self.audio_encoder_type!r}")
        r = int(model_cfg.get("vision_resolution", 224))
        if (self.audio_encoder_type == "shared"
                and (self.target_length, self.melbins) != (r, r)):
            raise ValueError(
                f"the shared ViT reads an audio slice as a (target_length, "
                f"melbins) = ({self.target_length}, {self.melbins}) image; "
                f"set model_cfg.audio_target_length and audio_melbins to the "
                f"vision resolution {r}")
        self.mean, self.std = self.ENCODER_STATS[self.audio_encoder_type]
        self._rng = random.Random(seed)
        self.decode = _inline

    def prefetch(self, id_, pool: ThreadPoolExecutor, cache: DecodeCache):
        path = _resolve_path(self.audio_dir, id_, AUDIO_EXT_FALLBACK)
        if path is not None:
            cache.submit(pool, encoder_fbank, path, self.audio_encoder_type,
                         self.melbins)

    def read(self, id_) -> Optional[np.ndarray]:
        path = _resolve_path(self.audio_dir, id_, AUDIO_EXT_FALLBACK)
        if path is None:
            print("not have audios", id_)
            return np.zeros((self.sample_num, self.target_length,
                             self.melbins), np.float32)
        try:
            fb = self.decode(encoder_fbank, path, self.audio_encoder_type,
                             self.melbins)
            fb = (fb - self.mean) / (self.std * 2)
            src = fb.shape[0]
            t = self.target_length
            pad_len = max(t * self.sample_num - src, t - src % t)
            fb = np.pad(fb, ((0, pad_len), (0, 0)))
            total = fb.shape[0] // t
            idx = sample_chunk_indices(total, self.sample_num, self.training,
                                       self._rng)
            return np.stack([fb[i * t : (i + 1) * t] for i in idx])
        except Exception as e:  # noqa: BLE001
            print(e)
            return None
