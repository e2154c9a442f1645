"""Audio decode on the host (counterpart of `mico_tpu/media/audio_io.py`).

Replaces torchaudio.load + Resample (reference model/audioprocessor.py:34-37).
The port reads 16-bit PCM WAV with the stdlib `wave` module; other
containers (mp4, flac, ...) and resampling need the native libav decoder,
which is not ported yet (ROADMAP.md, queue 1: native media decoders and
`.orbax` loading), and raise `IOError`. Returns float32 mono in [-1, 1]:
channel 0, Kaldi convention.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

NATIVE_DECODERS = ("the native media decoders are not ported yet (ROADMAP.md, "
                   "queue 1: native media decoders and .orbax loading)")


def load_wav_stdlib(path: str) -> Tuple[np.ndarray, int]:
    """16-bit PCM .wav → (channel 0 as float32 / 32768, its sample rate)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        nch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width != 2:
        raise IOError(f"{path}: {8 * width}-bit PCM; only 16-bit is read")
    raw = np.frombuffer(raw, dtype=np.int16)
    return (raw.reshape(-1, nch)[:, 0] / 32768.0).astype(np.float32), sr


def load_waveform(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """→ (float32 mono waveform at target_sr, source sample rate);
    `target_sr` 0 keeps the file's own rate (the AST branch's request)."""
    try:
        wav, sr = load_wav_stdlib(path)
    except (wave.Error, EOFError) as e:
        raise IOError(f"{path} is not a PCM WAV file ({e}); other containers "
                      f"need decoding: {NATIVE_DECODERS}") from None
    if target_sr and sr != target_sr:
        raise IOError(f"{path} is at {sr} Hz, not {target_sr}; resampling: "
                      f"{NATIVE_DECODERS}")
    return wav, sr
