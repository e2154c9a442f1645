"""Audio decode on the host (counterpart of `mico_tpu/media/audio_io.py`).

Replaces torchaudio.load + Resample (reference model/audioprocessor.py:34-37).
Where the JAX package sends every file through libav
(`mico_tpu/csrc/audio_decode.cpp`), the port has its own decoder written by
hand, `mico_tpu_torch/csrc/audio_decode.cpp`, built with `g++` at first use
(`ops/_build.build_host`) and loaded with ctypes. It reads RIFF/WAVE (PCM
u8/s16/s24/s32, float 32/64, WAVE_FORMAT_EXTENSIBLE) and FLAC, and resamples
as libswresample 4's default float path does; `resample_plain` is that
resampler as a numpy formula, the plain version the C++ is held against.
MP3, AAC/MP4, Ogg and other containers raise `IOError` naming what was
found: they need libav (`NATIVE_DECODERS`). Returns float32 mono in
[-1, 1]: channel 0, Kaldi convention.
"""

from __future__ import annotations

import ctypes
import functools
import math
import wave
from typing import Tuple

import numpy as np

NATIVE_DECODERS = ("MP3, AAC and Vorbis need libav's decoders, which the port "
                   "does not have (ROADMAP.md, queue 1: libav codecs)")

# the C entry's return codes (csrc/audio_decode.cpp)
_UNSUPPORTED = -2

_F32P = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from mico_tpu_torch.ops import _build

    lib = _build.load_host("audio_decode")
    lib.mico_decode_audio.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_F32P),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    lib.mico_decode_audio.restype = ctypes.c_int
    lib.mico_resample.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_F32P), ctypes.POINTER(ctypes.c_int64)]
    lib.mico_resample.restype = ctypes.c_int
    lib.mico_audio_error.argtypes = []
    lib.mico_audio_error.restype = ctypes.c_char_p
    lib.mico_free.argtypes = [_F32P]
    return lib


def _take(lib, rc: int, data, n, what: str) -> np.ndarray:
    if rc != 0:
        msg = f"{what}: {lib.mico_audio_error().decode()}"
        if rc == _UNSUPPORTED:
            msg += f"; {NATIVE_DECODERS}"
        raise IOError(msg)
    try:
        return np.ctypeslib.as_array(data, shape=(n.value,)).copy()
    finally:
        lib.mico_free(data)


def load_waveform(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """→ (float32 mono waveform at target_sr, source sample rate);
    `target_sr` 0 keeps the file's own rate (the AST branch's request)."""
    lib = _lib()
    data, n, src_sr = _F32P(), ctypes.c_int64(), ctypes.c_int()
    rc = lib.mico_decode_audio(str(path).encode(), int(target_sr),
                               ctypes.byref(data), ctypes.byref(n),
                               ctypes.byref(src_sr))
    return _take(lib, rc, data, n, str(path)), src_sr.value


def resample(x: np.ndarray, src_sr: int, dst_sr: int) -> np.ndarray:
    """The C++ resampler alone: float32 mono at src_sr → dst_sr."""
    lib = _lib()
    x = np.ascontiguousarray(x, np.float32)
    data, n = _F32P(), ctypes.c_int64()
    rc = lib.mico_resample(x.ctypes.data_as(_F32P), x.size, int(src_sr),
                           int(dst_sr), ctypes.byref(data), ctypes.byref(n))
    return _take(lib, rc, data, n, f"resample {src_sr} -> {dst_sr} Hz")


# ---------------------------------------------------------------------------
# The resampler's plain version: libswresample 4's defaults as a formula
# ---------------------------------------------------------------------------

CUTOFF, FILTER_SIZE, PHASE_SHIFT, KAISER_BETA = 0.97, 32, 10, 9.0


def _bessel_i0(x: np.ndarray) -> np.ndarray:
    """I0 by its power series, as the C++ sums it."""
    h = x * x / 4.0
    t, s, k = np.ones_like(x), np.ones_like(x), 1
    while True:
        t = t * h / (float(k) * k)
        nxt = s + t
        if np.array_equal(nxt, s):
            return nxt
        s, k = nxt, k + 1


def _resample_plan(src_sr: int, dst_sr: int) -> dict:
    """The filter bank and step of libswresample's `resample_init` with its
    defaults: {taps, phases, alloc, src_incr, dst_incr, bank ((phases + 1,
    alloc) float32; row `phases` is row 0 a sample later)}."""
    factor = min(dst_sr * CUTOFF / src_sr, 1.0)
    phases = 1 << PHASE_SHIFT
    taps = max(int(math.ceil(FILTER_SIZE / factor)), 1)
    if taps > 1:
        taps = (taps + 1) & ~1
    g = math.gcd(src_sr, dst_sr)
    if dst_sr // g <= phases:                    # exact_rational
        phases = dst_sr // g
    alloc, center = (taps + 7) & ~7, (taps - 1) // 2
    ph_nb = phases if phases % 2 else phases // 2 + 1
    ph = np.arange(ph_nb, dtype=np.float64)[:, None]
    i = np.arange(taps, dtype=np.float64)[None, :]
    x = math.pi * ((i - center) - ph / phases) * factor
    with np.errstate(divide="ignore", invalid="ignore"):
        if factor == 1.0:
            s = np.sin(math.pi * ph / phases) * (1 if center & 1 else -1)
            y = s * np.where(np.arange(taps) % 2 == 0, 1.0, -1.0) / x
        else:
            y = np.sin(x) / x
    y = np.where(x == 0, 1.0, y)
    w = 2.0 * x / (factor * taps * math.pi)
    y = y * _bessel_i0(KAISER_BETA * np.sqrt(np.maximum(1 - w * w, 0.0)))
    norm = 0.0
    for v in y[0]:                               # summed in tap order
        norm += v
    rows = (y * 1 / norm).astype(np.float32)
    bank = np.zeros((phases + 1, alloc), np.float32)
    bank[:ph_nb, :taps] = rows
    if phases % 2 == 0:
        for p in range(ph_nb):
            if phases - p == p:                  # mirrored in place
                half = bank[p, :taps // 2].copy()
                bank[p, taps - taps // 2:taps] = half[::-1]
            else:
                bank[phases - p, :taps] = bank[p, :taps][::-1]
    bank[phases, 1:] = bank[0, :alloc - 1]
    bank[phases, 0] = bank[0, alloc - 1]
    a, b = dst_sr, src_sr * phases
    gg = math.gcd(a, b)
    src_incr, dst_incr = a // gg, b // gg
    while dst_incr < (1 << 20) and src_incr < (1 << 20):
        src_incr, dst_incr = 2 * src_incr, 2 * dst_incr
    return dict(taps=taps, phases=phases, alloc=alloc, src_incr=src_incr,
                dst_incr=dst_incr, bank=bank)


def _steps(plan: dict, k: np.ndarray):
    """(window start, phase, frac) of outputs k."""
    tot = k * plan["dst_incr"]
    ph = tot // plan["src_incr"]
    center = (plan["taps"] - 1) // 2
    return (ph // plan["phases"] - center, ph % plan["phases"],
            tot % plan["src_incr"])


def resample_plain(x: np.ndarray, src_sr: int, dst_sr: int,
                   chunk: int = 1 << 15) -> np.ndarray:
    """libswresample's `swr_convert` and flush, mono float32, with its
    defaults: the input reflected about its first sample (no delay), a
    reflected flush of half what is left after the outputs whose window
    ends inside the input, every window of `taps` taps (linear between two
    phases when the step is not a whole number of phases; the library's
    vector loops read `alloc` taps, which reaches one sample further on the
    last phase's row)."""
    x = np.asarray(x, np.float32)
    n = len(x)
    if src_sr == dst_sr or n == 0:
        return x.copy()
    plan = _resample_plan(src_sr, dst_sr)
    L, alloc = plan["taps"], plan["alloc"]
    if n <= L:
        r = (n + 1) // 2
        if n + r < L + 1:
            return np.zeros(0, np.float32)
    else:
        k = np.arange((n + L) * dst_sr // src_sr + 3, dtype=np.int64)
        start = _steps(plan, k)[0]
        first_out = int(np.argmax(start + L - 1 > n - 1))
        r = (min(n - int(start[first_out]), L) + 1) // 2
    last = n - 1 + r
    post = x[::-1][:r + 1]
    v = np.concatenate([x[1:L + 1][::-1] if n > L else
                        np.concatenate([x, x[::-1][:r]])[1:L + 1][::-1],
                        x, post, np.zeros(alloc, np.float32)])
    k = np.arange((last + 1) * dst_sr // src_sr + 3, dtype=np.int64)
    start, phase, frac = _steps(plan, k)
    keep = start + L - 1 <= last
    start, phase, frac = start[keep], phase[keep], frac[keep]
    bank = plan["bank"]
    linear = plan["dst_incr"] % plan["src_incr"] != 0
    out = np.empty(len(start), np.float32)
    taps = np.arange(alloc)
    for lo in range(0, len(start), chunk):
        s = slice(lo, lo + chunk)
        win = v[(start[s] + L)[:, None] + taps[None, :]]
        val = (win * bank[phase[s]]).sum(1, dtype=np.float32)
        if linear:
            v2 = (win * bank[phase[s] + 1]).sum(1, dtype=np.float32)
            val = (val.astype(np.float64) + (v2 - val).astype(np.float64)
                   * (1.0 / plan["src_incr"]) * frac[s]).astype(np.float32)
        out[s] = val
    return out


def load_wav_stdlib(path: str) -> Tuple[np.ndarray, int]:
    """16-bit PCM .wav → (channel 0 as float32 / 32768, its sample rate):
    the twin of JAX's stdlib reader (no resampling, 16-bit only)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        nch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width != 2:
        raise IOError(f"{path}: {8 * width}-bit PCM; only 16-bit is read")
    raw = np.frombuffer(raw, dtype=np.int16)
    return (raw.reshape(-1, nch)[:, 0] / 32768.0).astype(np.float32), sr
