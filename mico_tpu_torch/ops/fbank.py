"""Kaldi-compatible log-mel filterbank (counterpart of `mico_tpu/ops/fbank.py`).

Reproduces `torchaudio.compliance.kaldi.fbank(waveform, num_mel_bins,
sample_frequency=16000, frame_length=25, frame_shift=10)` with torchaudio
defaults (dither=0, remove_dc_offset, preemphasis 0.97, povey window,
round_to_power_of_two, snip_edges, use_power, use_log_fbank), the call the
reference audio preprocessing makes (model/audioprocessor.py:40,
data/data/audio_mapper.py:49-62).

The power spectrum is two real DFT products (frames @ cos, frames @ sin)
and the mel projection a third, on the same fp32 matrices as the JAX
module, so both keep the same rounding points (not `torch.fft`).
`kaldi_fbank` runs in torch on the card or the CPU, with TF32 off for its
products; `kaldi_fbank_np` is its numpy twin, which the media processors
run in their host threads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FbankConfig:
    num_mel_bins: int = 224
    sample_frequency: float = 16000.0
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0          # <=0 → offset from Nyquist
    window_type: str = "povey"

    @property
    def window_size(self) -> int:
        return int(self.sample_frequency * self.frame_length_ms * 0.001)

    @property
    def window_shift(self) -> int:
        return int(self.sample_frequency * self.frame_shift_ms * 0.001)

    @property
    def padded_window_size(self) -> int:
        # round_to_power_of_two=True
        n = 1
        while n < self.window_size:
            n <<= 1
        return n


def _mel_scale(freq: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log(1.0 + freq / 700.0)


def _mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Triangular mel filterbank, Kaldi convention.

    Returns (num_mel_bins, padded_window_size // 2 + 1); the final (Nyquist)
    column is zero, matching torchaudio's zero-pad of the bank matrix.
    """
    num_fft_bins = cfg.padded_window_size // 2
    nyquist = 0.5 * cfg.sample_frequency
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq

    mel_low = _mel_scale(np.array(cfg.low_freq))
    mel_high = _mel_scale(np.array(high_freq))
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)

    bin_idx = np.arange(cfg.num_mel_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta

    fft_bin_width = cfg.sample_frequency / cfg.padded_window_size
    mel = _mel_scale(fft_bin_width * np.arange(num_fft_bins,
                                               dtype=np.float64))[None, :]

    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    bank = np.maximum(0.0, np.minimum(up_slope, down_slope))
    bank = np.concatenate([bank, np.zeros((cfg.num_mel_bins, 1))], axis=1)
    return bank.astype(np.float32)


def _window(cfg: FbankConfig) -> np.ndarray:
    n = cfg.window_size
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(a * i)
    if cfg.window_type == "povey":
        w = np.power(hann, 0.85)
    elif cfg.window_type == "hanning":
        w = hann
    elif cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    else:
        raise ValueError(f"unsupported window {cfg.window_type}")
    return w.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _static_matrices(cfg_items: tuple):
    cfg = FbankConfig(**dict(cfg_items))
    n = cfg.padded_window_size
    k = n // 2 + 1
    t = np.arange(n, dtype=np.float64)[:, None]
    f = np.arange(k, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * t * f / n
    dft_cos = np.cos(ang).astype(np.float32)   # (n, k)
    dft_sin = np.sin(ang).astype(np.float32)
    return _window(cfg), dft_cos, dft_sin, _mel_banks(cfg)


def num_frames(num_samples: int, cfg: FbankConfig = FbankConfig()) -> int:
    """snip_edges frame count."""
    if num_samples < cfg.window_size:
        return 0
    return 1 + (num_samples - cfg.window_size) // cfg.window_shift


def _frame_index(m: int, cfg: FbankConfig) -> np.ndarray:
    return (np.arange(m, dtype=np.int64)[:, None] * cfg.window_shift
            + np.arange(cfg.window_size, dtype=np.int64)[None, :])


@contextlib.contextmanager
def _tf32_off():
    """fp32 products in fp32: the DFT loses its low-energy bins to TF32's
    10-bit mantissa (JAX runs these products at HIGHEST precision)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def kaldi_fbank(waveform: torch.Tensor,
                cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """waveform: (num_samples,) float (the caller applies any 2**15
    scaling), on any device. Returns (num_frames, num_mel_bins) log-mel
    features, float32, on the waveform's device."""
    window, dft_cos, dft_sin, mel = _static_matrices(
        tuple(dataclasses.asdict(cfg).items()))
    m = num_frames(waveform.shape[0], cfg)
    if m <= 0:
        raise ValueError("waveform shorter than one frame")
    dev = waveform.device

    def const(a):
        return torch.from_numpy(a).to(dev)

    idx = torch.from_numpy(_frame_index(m, cfg)).to(dev)
    frames = waveform.float()[idx]                               # (m, ws)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=1, keepdim=True)
    if cfg.preemphasis != 0.0:
        prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        frames = frames - cfg.preemphasis * prev
    frames = frames * const(window)
    frames = torch.nn.functional.pad(
        frames, (0, cfg.padded_window_size - cfg.window_size))
    with _tf32_off():
        re = frames @ const(dft_cos)
        im = frames @ const(dft_sin)
        power = re * re + im * im                                # (m, k)
        feats = power @ const(mel).T
    eps = float(np.finfo(np.float32).eps)
    return torch.log(torch.clamp_min(feats, eps))


def kaldi_fbank_np(waveform: np.ndarray,
                   cfg: FbankConfig = FbankConfig()) -> np.ndarray:
    """Numpy twin of `kaldi_fbank`: the same math on the same matrices."""
    window, dft_cos, dft_sin, mel = _static_matrices(
        tuple(dataclasses.asdict(cfg).items()))
    m = num_frames(waveform.shape[0], cfg)
    if m <= 0:
        raise ValueError("waveform shorter than one frame")
    frames = np.asarray(waveform, np.float32)[_frame_index(m, cfg)]
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if cfg.preemphasis != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - cfg.preemphasis * prev
    frames = frames * window
    frames = np.pad(frames, ((0, 0), (0, cfg.padded_window_size
                                      - cfg.window_size)))
    re = frames @ dft_cos
    im = frames @ dft_sin
    power = re * re + im * im
    feats = power @ mel.T
    return np.log(np.maximum(feats, np.finfo(np.float32).eps))
