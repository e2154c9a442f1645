"""Modality processors: host decode and preprocessing (counterpart of
`mico_tpu/media/processors.py`).

API-parity ports of the reference processors:
  - ImageProcessor  (model/imageprocessor.py:10-63)
  - VideoProcessor  (model/videoprocessor.py:17-108)
  - AudioProcessor  (model/audioprocessor.py:15-78)

Numerics preserved: CLIP vs ImageNet mean/std selection by encoder type,
torch-bilinear (no antialias) resize, chunk sampling (train random / eval
middle), Kaldi fbank on 2**15-scaled 16 kHz mono with mel-axis bilinear
resize and (x - 15.41663) / (2 * 6.55582) normalization, zero-pad + window
slicing. Everything runs in numpy in the caller's (host) thread, on the
same sampling math as the JAX module's host twins; the batch then goes to
the card whole. A failed decode prints and returns None, and a missing
audio file gives zeros (the reference contracts).
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

from mico_tpu_torch.media.audio_io import load_waveform
from mico_tpu_torch.media.chunking import sample_chunk_indices
from mico_tpu_torch.media.image_io import load_image_chw
from mico_tpu_torch.media.video_io import read_frames_chw, video_num_frames
from mico_tpu_torch.ops.fbank import FbankConfig, kaldi_fbank_np
from mico_tpu_torch.ops.interpolate import interp_bilinear_2d_np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _stats_for(encoder_type: str):
    if encoder_type.startswith("clip") or encoder_type.startswith("evaclip"):
        return CLIP_MEAN, CLIP_STD
    return IMAGENET_MEAN, IMAGENET_STD


def _normalize(frames: np.ndarray, mean, std) -> np.ndarray:
    m = np.asarray(mean, np.float32).reshape(1, 3, 1, 1)
    s = np.asarray(std, np.float32).reshape(1, 3, 1, 1)
    return (frames - m) / s


def _resize_normalize_host(frames, resolution: int, mean, std):
    """(n, 3, H, W) [0,1] → (n, 3, R, R) normalized."""
    x = interp_bilinear_2d_np(np.asarray(frames, np.float32),
                              (resolution, resolution))
    return _normalize(x, mean, std)


def _wave_to_fbank_host(wave, melbins: int, resize_melbin_num: int, mean, std):
    """16 kHz mono wave → normalized (frames, resize_melbin_num) fbank."""
    fb = kaldi_fbank_np(np.asarray(wave, np.float32) * np.float32(2.0**15),
                        FbankConfig(num_mel_bins=melbins))
    if melbins != resize_melbin_num:
        fb = interp_bilinear_2d_np(
            fb[None, None], (fb.shape[0], resize_melbin_num))[0, 0]
    return (fb - mean) / (2.0 * std)


# audio_encoder_type → the mean and std that normalize its fbank
# (reference audio_mapper.py:19-26); the shared ViT takes BEATs'
AUDIO_ENCODER_STATS = {"ast": (-4.2677393, 4.5689974),
                       "beats": (15.41663, 6.55582)}


def encoder_fbank(path: str, encoder_type: str, melbins: int) -> np.ndarray:
    """An audio file's raw (frames, melbins) Kaldi fbank as the data
    mapper computes it for `encoder_type` (`mico_tpu/data/mappers.py:
    245-266`): "ast" at the file's own rate, the wave mean-centred, a
    Hanning window; "beats" (and the shared ViT) at 16 kHz, scaled by
    2**15, the Kaldi defaults. No mel-axis resize."""
    if encoder_type == "ast":
        wave, sr = load_waveform(path, target_sr=0)
        wave = wave - wave.mean()
        cfg = FbankConfig(num_mel_bins=melbins, sample_frequency=float(sr),
                          window_type="hanning")
    else:
        wave, _ = load_waveform(path, target_sr=16000)
        wave = wave * 2.0**15
        cfg = FbankConfig(num_mel_bins=melbins)
    return kaldi_fbank_np(np.asarray(wave, np.float32), cfg)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _cubic_weights(in_len: int, out_len: int) -> np.ndarray:
    """(in_len, out_len) float32 weights of `jax.image.resize(...,
    "bicubic")` along one axis: Keys' kernel (a = -0.5, not torch's -0.75)
    widened by in/out when shrinking (antialias), each column normalised
    to sum 1, columns sampling outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_len / in_len))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_len, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_len, dtype=f32)[:, None])
    weights = _keys_cubic(x / kernel_scale)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_len - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def _resize_bicubic(frames: np.ndarray, out_hw) -> np.ndarray:
    """(..., H, W) float32 → (..., out_h, out_w), `jax.image.resize`'s
    antialiased bicubic; an axis whose size does not change is left as it
    is."""
    x = np.asarray(frames, np.float32)
    (h, w), (nh, nw) = x.shape[-2:], out_hw
    if nw != w:
        x = x @ _cubic_weights(w, nw)
    if nh != h:
        x = np.swapaxes(np.swapaxes(x, -1, -2) @ _cubic_weights(h, nh), -1, -2)
    return np.ascontiguousarray(x)


def resize_max_size(frames: np.ndarray, max_size: int,
                    fill: float = 0.0) -> np.ndarray:
    """Aspect-preserving longest-side resize + center pad to a square — the
    reference `ResizeMaxSize` eval transform (model/evaclip/transform.py:
    13-36). frames: (n, 3, H, W) in [0, 1]."""
    h, w = frames.shape[-2:]
    scale = max_size / float(max(h, w))
    if scale == 1.0:
        return frames
    nh, nw = round(h * scale), round(w * scale)
    x = _resize_bicubic(frames, (nh, nw))
    ph, pw = max_size - nh, max_size - nw
    return np.pad(
        x,
        ((0, 0), (0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)),
        constant_values=fill,
    )


class ImageProcessor:
    def __init__(
        self,
        image_resolution: int,
        image_encoder_type: str,
        image_transforms: str = "none",
        training: bool = True,
    ):
        if image_transforms not in ("none", "crop_flip", "resize_longest_max"):
            raise NotImplementedError(image_transforms)
        self.resolution = image_resolution
        self.mean, self.std = _stats_for(image_encoder_type)
        self.transforms = image_transforms
        self.training = training
        self._rng = random.Random()

    def transform(self, frames: np.ndarray) -> np.ndarray:
        """(n, 3, H, W) float in [0,1] → (n, 3, R, R) normalized."""
        r = self.resolution
        if self.transforms == "crop_flip":
            if self.training:
                frames = _random_resized_crop(frames, r, self._rng)
                if self._rng.random() < 0.5:
                    frames = frames[..., ::-1]
                frames = np.ascontiguousarray(frames)
            else:
                frames = _resize_short_center_crop(frames, r)
            return _normalize(frames, self.mean, self.std)
        if self.transforms == "resize_longest_max":
            frames = resize_max_size(frames, r)
            return _normalize(frames, self.mean, self.std).astype(np.float32)
        return _resize_normalize_host(frames, r, self.mean, self.std)

    def __call__(self, image_file: str) -> Optional[np.ndarray]:
        """→ (1, 3, R, R) or None on failure (reference contract)."""
        try:
            img = load_image_chw(image_file)
        except Exception as e:  # noqa: BLE001 — reference returns None
            print(e)
            return None
        return self.transform(img[None])


class VideoProcessor:
    def __init__(
        self,
        video_resolution: int,
        video_encoder_type: str,
        sample_num: int = 4,
        video_transforms: str = "none",
        data_format: str = "raw",
        training: bool = True,
    ):
        self.image = ImageProcessor(
            video_resolution, video_encoder_type, video_transforms, training)
        self.sample_num = sample_num
        self.data_format = data_format
        self.training = training
        self._rng = random.Random()

    def __call__(self, video_file: str) -> Optional[np.ndarray]:
        """→ (sample_num, 3, R, R) or None."""
        try:
            if self.data_format == "raw":
                n = video_num_frames(video_file)
                idx = sample_chunk_indices(
                    n, self.sample_num, self.training, self._rng)
                frames = read_frames_chw(video_file, idx)
            elif self.data_format == "frame":
                names = sorted(os.listdir(video_file))
                idx = sample_chunk_indices(
                    len(names), self.sample_num, self.training, self._rng)
                frames = np.stack([
                    load_image_chw(os.path.join(video_file, names[i]))
                    for i in idx])
            else:
                raise NotImplementedError(self.data_format)
        except Exception as e:  # noqa: BLE001
            print(e, video_file)
            return None
        return self.image.transform(frames)


class AudioProcessor:
    def __init__(
        self,
        melbins: int,
        target_length: int,
        sample_num: int,
        frame_shift: int = 10,
        resize_melbin_num: int = 224,
        mean: float = 15.41663,
        std: float = 6.55582,
        training: bool = True,
    ):
        self.melbins = melbins
        self.target_length = target_length
        self.sample_num = sample_num
        self.resize_melbin_num = resize_melbin_num
        self.mean = mean
        self.std = std
        self.training = training
        self._rng = random.Random()

    def from_waveform(self, wave: np.ndarray) -> np.ndarray:
        """16 kHz mono float wave → (sample_num, target_length, mel)."""
        fb = _wave_to_fbank_host(
            wave, self.melbins, self.resize_melbin_num, self.mean, self.std)
        src = fb.shape[0]
        t = self.target_length
        pad_len = max(t * self.sample_num - src, t - src % t)
        fb = np.pad(fb, ((0, pad_len), (0, 0)))
        total = fb.shape[0] // t
        idx = sample_chunk_indices(total, self.sample_num, self.training,
                                   self._rng)
        return np.stack([fb[i * t : (i + 1) * t] for i in idx])

    def __call__(self, wav_file: str) -> Optional[np.ndarray]:
        if not os.path.exists(wav_file):
            print("not have audios", wav_file)
            return np.zeros(
                (self.sample_num, self.target_length, self.melbins), np.float32)
        try:
            wave, _ = load_waveform(wav_file, target_sr=16000)
            return self.from_waveform(wave)
        except Exception as e:  # noqa: BLE001
            print(e)
            return None


# ---------------------------------------------------------------------------
# crop_flip helpers (train-time augmentation path)
# ---------------------------------------------------------------------------


def _random_resized_crop(frames: np.ndarray, r: int, rng: random.Random):
    """torchvision RandomResizedCrop(r, scale=[0.8,1.0], ratio=[1,1])."""
    _, _, h, w = frames.shape
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(0.8, 1.0)
        side = int(round(target_area**0.5))
        if side <= h and side <= w:
            i = rng.randint(0, h - side)
            j = rng.randint(0, w - side)
            crop = frames[:, :, i : i + side, j : j + side]
            return interp_bilinear_2d_np(np.asarray(crop, np.float32), (r, r))
    side = min(h, w)
    i, j = (h - side) // 2, (w - side) // 2
    crop = frames[:, :, i : i + side, j : j + side]
    return interp_bilinear_2d_np(np.asarray(crop, np.float32), (r, r))


def _resize_short_center_crop(frames: np.ndarray, r: int):
    """torchvision Resize(r) (short side) + CenterCrop(r)."""
    _, _, h, w = frames.shape
    if h <= w:
        nh, nw = r, max(r, int(round(w * r / h)))
    else:
        nh, nw = max(r, int(round(h * r / w))), r
    x = interp_bilinear_2d_np(np.asarray(frames, np.float32), (nh, nw))
    top = (nh - r) // 2
    left = (nw - r) // 2
    return x[:, :, top : top + r, left : left + r]
