"""The port's demo entry (`mico_tpu_torch/inference_demo.py`) against the
JAX functions that the root `inference_demo.py` calls, in its order, on
one released-layout directory (`log/hps.json` + `ckpt/model_step_N.pt` at
the tiny config) and the same media files: a PPM image, a directory of PPM
frames and a 44.1 kHz stereo FLAC, as JAX's demo defaults to
`test.flac` (fp32 on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu import generation as jax_generation
from mico_tpu.media import AudioProcessor, ImageProcessor, VideoProcessor
from mico_tpu.models.mico import MiCoModel
from mico_tpu.text import BertWordPieceTokenizer
from mico_tpu.train.checkpoints import load_from_pretrained_dir
from mico_tpu_torch import inference_demo

from torch_flac_writer import write_flac
from torch_port_common import (configs, media_files, perturbed_params,
                               reference_state_dict, tiny_model_cfg,
                               torch_state_dict, write_hps)

TOL = dict(rtol=1e-5, atol=1e-5)
RES = 28
AUDIO = dict(melbins=28, target_length=28, resize_melbin_num=28)


@pytest.fixture(scope="module")
def demo_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    jcfg, _ = configs()
    sd = reference_state_dict(perturbed_params(jcfg, seed=4))
    pre = root / "MiCo"
    write_hps(pre, tiny_model_cfg())
    os.makedirs(pre / "ckpt")
    torch.save(torch_state_dict(sd), pre / "ckpt" / "model_step_7.pt")
    media = media_files(str(root), seed=4)
    rng = np.random.default_rng(4)
    t = np.arange(int(1.2 * 44100)) / 44100
    pcm = np.stack([0.4 * np.sin(2 * np.pi * (300 + 200 * t) * t),
                    0.3 * np.sin(2 * np.pi * 523 * t)], 1)
    pcm = pcm + 0.05 * rng.standard_normal(pcm.shape)
    media["audio"] = str(root / "audio.flac")
    write_flac(media["audio"], np.round(pcm * 32767).astype(np.int64),
               44100, 16, assignments=["mid_side", "left_side"])
    return str(pre), media


def jax_demo(pretrain_dir, image, video, audio, texts):
    """`inference_demo.py:43-122` in its order, with the frame directory
    read as frames (the JAX demo opens a container)."""
    params, cfg = load_from_pretrained_dir(
        pretrain_dir, video_resolution=RES,
        config_overrides={"compute_dtype": "float32"})
    model = MiCoModel(params, cfg)
    tokenizer = BertWordPieceTokenizer(inference_demo_vocab())

    def unit(f):
        return f / jnp.linalg.norm(f, axis=-1, keepdims=True)

    proc = ImageProcessor(RES, cfg.vision_encoder_type, training=False)
    vision_output = model.forward_vision_encoder(jnp.asarray(proc(image)[None]))
    feat_v = unit(model.contra_head("v", model.pool_vision_for_contra(
        vision_output)))
    toks = tokenizer(list(texts), max_length=30)
    seq = model.forward_multimodal_encoder(
        jnp.asarray(toks["input_ids"]), jnp.asarray(toks["attention_mask"]))
    feat_t = unit(model.contra_head("t", model.pool_text_for_contra(seq)))
    out = {"sim_t2v": np.asarray(feat_t @ feat_v.T)}
    cond = model.get_multimodal_forward_input_vision(vision_output)
    cond_itm = jnp.broadcast_to(cond, (toks["input_ids"].shape[0],)
                                + cond.shape[1:])
    slice_out = model.forward_multimodal_encoder(
        jnp.asarray(toks["input_ids"]), jnp.asarray(toks["attention_mask"]),
        cond_itm)
    out["itm"] = np.asarray(jax.nn.softmax(
        model.itm_head(slice_out[:, 0]), axis=1)[:, 1])
    out["caption_tokens"] = np.asarray(jax_generation.generate(
        model.params["bert"], cfg.bert_config, cond,
        max_new_tokens=cfg.max_caption_len, mode="beam",
        num_beams=cfg.beam_size, length_penalty=0.6))
    vp = VideoProcessor(RES, cfg.vision_encoder_type,
                        sample_num=cfg.max_vision_sample_num,
                        data_format="frame", training=False)
    vout = model.forward_vision_encoder(jnp.asarray(vp(video)[None]))
    fv = unit(model.contra_head("v", model.pool_vision_for_contra(vout)))
    out["video_sim"] = np.asarray(feat_t @ fv.T)
    apz = AudioProcessor(sample_num=cfg.max_audio_sample_num, training=False,
                         **AUDIO)
    aout = model.forward_audio_encoder(jnp.asarray(apz(audio)[None]))
    fa = unit(model.contra_head("a", model.pool_audio_for_contra(aout)))
    out["audio_sim"] = np.asarray(feat_t @ fa.T)
    return out


def inference_demo_vocab():
    from pathlib import Path

    return (Path(__file__).resolve().parent.parent / "mico_tpu" / "assets"
            / "vocab.txt")


@pytest.fixture(scope="module")
def both(demo_dir):
    pre, media = demo_dir
    stages = []

    def stage(name, fn):
        stages.append(name)
        return fn()

    got = inference_demo.run_demo(
        pre, media["image"], media["video"], media["audio"],
        resolution=RES, device="cpu", stage=stage, **AUDIO)
    want = jax_demo(pre, media["image"], media["video"], media["audio"],
                    inference_demo.TEXTS)
    return got, want, stages


@pytest.mark.parametrize("key", ["sim_t2v", "itm", "video_sim", "audio_sim"])
def test_scores_match_jax(both, key):
    got, want, _ = both
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], **TOL)


def test_beam_caption_tokens_equal(both):
    got, want, _ = both
    np.testing.assert_array_equal(got["caption_tokens"], want["caption_tokens"])
    assert len(got["captions"]) == 1 and isinstance(got["captions"][0], str)


def test_stages_and_times(both):
    got, _, stages = both
    assert stages == ["image ViT", "text", "ITM", "caption", "video ViT",
                      "audio ViT"]
    assert set(got["times"]) == {"load", "preprocess", "device"}
    assert all(v > 0 for v in got["times"].values())
    for name in ("feat_image", "feat_text", "feat_video", "feat_audio"):
        np.testing.assert_allclose(np.linalg.norm(got[name], axis=-1), 1.0,
                                   rtol=1e-5)


def test_missing_branches_are_skipped(demo_dir):
    pre, media = demo_dir
    got = inference_demo.run_demo(pre, media["image"], "no/such/dir",
                                  "no/such.wav", resolution=RES, device="cpu",
                                  **AUDIO)
    assert "video_sim" not in got and "audio_sim" not in got


def test_undecodable_image_raises(demo_dir, tmp_path):
    pre, _ = demo_dir
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    with pytest.raises(IOError, match="could not decode"):
        inference_demo.run_demo(pre, str(bad), resolution=RES, device="cpu")


def test_main_needs_a_card_unless_cpu(demo_dir, capsys):
    pre, media = demo_dir
    args = ["--pretrain_dir", pre, "--image", media["image"], "--video",
            media["video"], "--audio", media["audio"], "--resolution",
            str(RES), "--melbins", "28", "--target_length", "28",
            "--resize_melbin_num", "28"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            inference_demo.main(args)
    inference_demo.main(args + ["--device", "cpu"])
    printed = capsys.readouterr().out
    for line in ("sim_t2v:", "itm scores:", "caption:", "video sim:",
                 "audio sim:"):
        assert line in printed

