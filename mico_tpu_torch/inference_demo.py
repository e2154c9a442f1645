"""Omni-modal inference demo on the port (counterpart of the root
`inference_demo.py`): load a released-layout checkpoint directory (or a
native `.npz` one), embed an image, a video and an audio clip and two
texts, score retrieval and ITM, and write a beam-search caption.

    python -m mico_tpu_torch.inference_demo --pretrain_dir MiCo-g \
        [--image example/test.jpeg] [--video example/test.mp4] \
        [--audio example/test.flac] [--device cuda]

The port decodes images through OpenCV or PIL where they are installed
and binary PPM/PGM with its own reader; a video from a container through
OpenCV or from a directory of frame images; audio from FLAC or WAV at
any rate through its own decoder (`media/audio_io.py`, resampled to
16 kHz as libswresample does). The video and audio branches run when their
paths exist. It runs on CUDA and raises without a card unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

TEXTS = ("a man is skiing in a snowy day.", "it's a hot day")
TEXT_LEN = 30


def _run_stage(name: str, fn: Callable):
    return fn()


def _decoded(arr: Optional[np.ndarray], path: str) -> np.ndarray:
    if arr is None:        # the processor printed why
        raise IOError(f"could not decode {path}")
    return arr


def run_demo(pretrain_dir: str, image: str, video: Optional[str] = None,
             audio: Optional[str] = None, *, vocab: Optional[str] = None,
             resolution: int = 224, melbins: int = 224,
             target_length: int = 224, resize_melbin_num: int = 224,
             dtype: str = "float32", device="cuda",
             consumed: Optional[set] = None,
             stage: Callable = _run_stage) -> dict:
    """The demo's outputs for `TEXTS` as numpy arrays (unit embeddings
    `feat_*`, the
    similarities `sim_t2v`, `video_sim`, `audio_sim`, ITM probabilities
    `itm`, `caption_tokens` and `captions`), the `cfg`, the number of
    parameters placed (`n_params`), and `times`:
    seconds of `load` (config, checkpoint, conversion, placement),
    `preprocess` (decode, resize, fbank, tokenize) and `device` (the model's
    work and the copies to the card, each stage ended by a synchronize).

    stage(name, fn) runs each device stage ("image ViT", "text", "ITM",
    "caption", "video ViT", "audio ViT") and returns fn()'s result: a hook
    for callers that count kernel launches by stage. consumed: as
    `load_from_pretrained_dir`'s."""
    from mico_tpu_torch import generation
    from mico_tpu_torch.convert import mico_from_jax
    from mico_tpu_torch.media import (AudioProcessor, ImageProcessor,
                                      VideoProcessor)
    from mico_tpu_torch.media.video_io import video_format
    from mico_tpu_torch.models.mico import resolve_device
    from mico_tpu_torch.text import BertWordPieceTokenizer
    from mico_tpu_torch.train.checkpoints import load_from_pretrained_dir

    dev = resolve_device(device)
    times = {"load": 0.0, "preprocess": 0.0, "device": 0.0}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        if key == "device" and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times[key] += time.perf_counter() - t0
        return out

    def on_device(name, fn):
        return timed("device", lambda: stage(name, fn))

    def load():
        params, cfg = load_from_pretrained_dir(
            pretrain_dir, video_resolution=resolution,
            config_overrides={"compute_dtype": dtype}, consumed=consumed)
        return mico_from_jax(params, cfg, device=dev), cfg

    model, cfg = timed("load", load)
    out = {"cfg": cfg, "n_params": sum(p.numel() for p in model.parameters())}
    tokenizer = (BertWordPieceTokenizer(vocab) if vocab
                 else BertWordPieceTokenizer())

    def unit(f):
        f = f.float()
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    def to_dev(arr):
        return torch.from_numpy(arr[None]).to(dev)

    def pixels_feat(arr):
        tokens = model.forward_vision_encoder(to_dev(arr))
        return tokens, unit(model.contra_head(
            "v", model.pool_vision_for_contra(tokens)))

    # ---- image branch (image = 1-frame video) ----
    proc = ImageProcessor(resolution, cfg.vision_encoder_type, training=False)
    arr = timed("preprocess", lambda: _decoded(proc(image), image))
    vision_output, feat_v = on_device("image ViT", lambda: pixels_feat(arr))

    # ---- text branch ----
    toks = timed("preprocess", lambda: tokenizer(list(TEXTS),
                                                 max_length=TEXT_LEN))

    def text():
        ids = torch.from_numpy(toks["input_ids"]).long().to(dev)
        mask = torch.from_numpy(toks["attention_mask"]).long().to(dev)
        seq = model.forward_multimodal_encoder(ids, mask)
        return ids, mask, unit(model.contra_head(
            "t", model.pool_text_for_contra(seq)))

    ids, mask, feat_t = on_device("text", text)
    out.update(feat_image=feat_v, feat_text=feat_t, sim_t2v=feat_t @ feat_v.T)

    # ---- ITM: one image scored against every caption ----
    def itm():
        cond = model.get_multimodal_forward_input_vision(vision_output)
        seq = model.forward_multimodal_encoder(
            ids, mask, cond.expand(ids.shape[0], -1, -1))
        probs = torch.softmax(model.itm_head(seq[:, 0]).float(), dim=1)
        return cond, probs[:, 1]

    cond, out["itm"] = on_device("ITM", itm)

    # ---- caption generation (beam, length_penalty 0.6) ----
    tokens = on_device("caption", lambda: generation.generate(
        model.bert, cond, max_new_tokens=cfg.max_caption_len, mode="beam",
        num_beams=cfg.beam_size, length_penalty=0.6))
    out["caption_tokens"] = tokens
    out["captions"] = tokenizer.batch_decode(tokens[:, 1:].cpu().numpy())

    # ---- video branch ----
    if video and os.path.exists(video):
        vp = VideoProcessor(
            resolution, cfg.vision_encoder_type,
            sample_num=cfg.max_vision_sample_num,
            data_format=video_format(video),
            training=False)
        arr = timed("preprocess", lambda: _decoded(vp(video), video))
        _, fv = on_device("video ViT", lambda: pixels_feat(arr))
        out.update(feat_video=fv, video_sim=feat_t @ fv.T)

    # ---- audio branch ----
    if audio and os.path.exists(audio):
        apz = AudioProcessor(
            melbins=melbins, target_length=target_length,
            resize_melbin_num=resize_melbin_num,
            sample_num=cfg.max_audio_sample_num, training=False)
        arr = timed("preprocess", lambda: _decoded(apz(audio), audio))

        def audio_feat():
            tokens = model.forward_audio_encoder(to_dev(arr))
            return unit(model.contra_head(
                "a", model.pool_audio_for_contra(tokens)))

        fa = on_device("audio ViT", audio_feat)
        out.update(feat_audio=fa, audio_sim=feat_t @ fa.T)

    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.cpu().numpy()
    out["times"] = times
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pretrain_dir", default="MiCo-g")
    ap.add_argument("--image", default="example/test.jpeg")
    ap.add_argument("--video", default="example/test.mp4",
                    help="a container OpenCV reads, or a directory of frame "
                         "images")
    ap.add_argument("--audio", default="example/test.flac",
                    help="FLAC or WAV, at any sample rate")
    ap.add_argument("--vocab", default=None,
                    help="WordPiece vocab (default: the package's)")
    ap.add_argument("--resolution", type=int, default=224)
    # demo fbank geometry: 224x224 "spectrogram images"
    # (reference model/audioprocessor.py:81-85)
    ap.add_argument("--melbins", type=int, default=224)
    ap.add_argument("--target_length", type=int, default=224)
    ap.add_argument("--resize_melbin_num", type=int, default=224)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = run_demo(
        args.pretrain_dir, args.image, args.video, args.audio,
        vocab=args.vocab, resolution=args.resolution, melbins=args.melbins,
        target_length=args.target_length,
        resize_melbin_num=args.resize_melbin_num, dtype=args.dtype,
        device=args.device)
    print("sim_t2v:", out["sim_t2v"])
    print("itm scores:", out["itm"])
    print("caption:", out["captions"])
    if "video_sim" in out:
        print("video sim:", out["video_sim"])
    if "audio_sim" in out:
        print("audio sim:", out["audio_sim"])
    print("seconds:", {k: round(v, 3) for k, v in out["times"].items()})


if __name__ == "__main__":
    main()
