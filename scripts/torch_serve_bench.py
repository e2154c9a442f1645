"""End-to-end serving bench of the port: host decode + preprocess + device
embed (counterpart of `scripts/serve_bench.py`).

MiCo on EVA01-CLIP-g/14 in bf16 with random weights (seed 0) behind
`EmbeddingPipeline(batch_size=16, io_workers=8)` on the card. The media
are written here into a temporary directory, from a seed: a 640x480 JPEG
and a 4 s 320x240 mp4 (`mp4v`) through cv2, a 10 s 44.1 kHz stereo 16-bit
FLAC (`tests/torch_flac_writer.py`) and a 10 s 22.05 kHz 16-bit WAV. Each
file is replicated `--n` times through the pipeline.

For each modality it prints the end-to-end rate (file -> normalised
embedding on the host) and the host-only rate (decode + preprocess through
the same thread pool), each the mean of `--reps` timed runs after one
warm-up (`utils.profiling.StepTimer`), and ends with one JSON line.

Usage (on the card): python scripts/torch_serve_bench.py [--n 64]
    [--modalities image,video,audio_flac,audio_wav] [--reps 3]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import wave

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def flac_writer():
    spec = importlib.util.spec_from_file_location(
        "torch_flac_writer", os.path.join(ROOT, "tests", "torch_flac_writer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write_flac


def write_media(root: str, seed: int) -> dict:
    import cv2

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:480, 0:640]
    img = np.stack([x * 255 // 640, y * 255 // 480, (x + y) % 256], -1)
    img = (img + rng.integers(-20, 21, img.shape)).clip(0, 255).astype(np.uint8)
    image = os.path.join(root, "test.jpeg")
    cv2.imwrite(image, img)
    video = os.path.join(root, "test.mp4")
    out = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                          (320, 240))
    for k in range(100):
        frame = np.roll(img[::2, ::2], 3 * k, axis=1)
        out.write(np.ascontiguousarray(frame))
    out.release()
    t = np.arange(10 * 44100) / 44100
    pcm = np.stack([0.4 * np.sin(2 * np.pi * (200 + 300 * t) * t),
                    0.3 * np.sin(2 * np.pi * 440 * t)], 1)
    pcm = pcm + 0.05 * rng.standard_normal(pcm.shape)
    flac = os.path.join(root, "test.flac")
    flac_writer()(flac, np.round(pcm * 32767).astype(np.int64), 44100, 16,
                  assignments=["mid_side"])
    t = np.arange(10 * 22050) / 22050
    x = 0.4 * np.sin(2 * np.pi * (150 + 200 * t) * t) \
        + 0.05 * rng.standard_normal(t.shape)
    wav = os.path.join(root, "test.wav")
    with wave.open(wav, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(22050)
        f.writeframes((x * 32767).clip(-32768, 32767).astype(np.int16)
                      .tobytes())
    return {"image": image, "video": video, "audio_flac": flac,
            "audio_wav": wav}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--modalities",
                    default="image,video,audio_flac,audio_wav")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--io_workers", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.serve import EmbeddingPipeline
    from mico_tpu_torch.utils.profiling import StepTimer

    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_bench: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    cfg = MiCoConfig(max_vision_sample_num=4, max_audio_sample_num=2)
    model = MiCo(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    pipe = EmbeddingPipeline(model, cfg, batch_size=args.batch_size,
                             io_workers=args.io_workers)
    del model
    jobs = {"image": (pipe.embed_images, lambda p: pipe.image_proc(p)),
            "video": (pipe.embed_videos,
                      lambda p: pipe.video_procs["raw"](p)),
            "audio_flac": (pipe.embed_audio, lambda p: pipe.audio_proc(p)),
            "audio_wav": (pipe.embed_audio, lambda p: pipe.audio_proc(p))}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        media = write_media(tmp, seed=0)
        for mod in args.modalities.split(","):
            fn, proc = jobs[mod]
            paths = [media[mod]] * args.n
            e2e, host = StepTimer(warmup=1), StepTimer(warmup=1)
            for _ in range(args.reps + 1):
                with e2e:              # embeddings come back on the host
                    out = fn(paths)
                if out.shape[0] != args.n or pipe.last_failures:
                    raise AssertionError(f"{mod}: {out.shape}, failures "
                                         f"{pipe.last_failures}")
                if not np.isfinite(out).all():
                    raise AssertionError(f"{mod}: non-finite embeddings")
            for _ in range(args.reps + 1):
                with host:
                    for r in [pipe.pool.submit(proc, p) for p in paths]:
                        if r.result() is None:
                            raise AssertionError(f"{mod}: decode failed")
            results[mod] = dict(
                end_to_end_items_per_s=1e3 * args.n / e2e.mean_ms,
                host_items_per_s=1e3 * args.n / host.mean_ms,
                end_to_end_ms=e2e.mean_ms, host_ms=host.mean_ms,
                file_bytes=os.path.getsize(media[mod]))
            r = results[mod]
            print(f"{mod:10s} end-to-end {r['end_to_end_items_per_s']:8.2f} "
                  f"items/s   host decode+preproc only "
                  f"{r['host_items_per_s']:8.2f} items/s   [{card}]",
                  flush=True)
    pipe.close()
    print(json.dumps({"card": card, "n": args.n, "reps": args.reps,
                      "batch_size": args.batch_size,
                      "io_workers": args.io_workers, "modalities": results}))


if __name__ == "__main__":
    main()
