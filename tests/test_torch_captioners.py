"""The data half's two captioners on the port, end to end on the CPU:
`python -m mico_tpu_torch.run --config configs/caption-generation-{audio,
vision}.json --pretrain_dir DIR` (`run.main`, `--device cpu`) from a native
`.npz` directory of the default VAST model (ViT + BEATs + BERT) at the tiny
size, over a corpus written here (16 kHz WAVs, cv2 `mp4v` videos): the
inherited model keys come from the directory's `hps.json`, the tower is
the saved one, and the annotation JSON holds `generate_nums` captions a
clip. A `ret%tva` evaluation re-ranks by ITM over the vision + BEATs
condition tokens. `EmbeddingPipeline.embed_audio` on a BEATs tower pools by
the token mean, as JAX's pipeline does.

The tiny BEATs (2 layers, 64 wide) stands in for `BeatsConfig()`: the
configs name `beats`, and `mico_config_from_dict` lifts no audio override
(nor does JAX's), so the module's `BeatsConfig` and the registry width are
patched for the run."""

import json
import os

import numpy as np
import pytest
import torch

import mico_tpu_torch.evaluation as tev
import mico_tpu_torch.run as trun
from mico_tpu_torch import config as tconfig
from mico_tpu_torch.models import audio as taudio
from mico_tpu_torch.models import mico as tmico
from mico_tpu_torch.models.mico import MiCo
from mico_tpu_torch.train.checkpoints import ModelSaver

from torch_port_common import MODEL_TOL, TINY, close, configs, \
    perturbed_params, port_model, write_hps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_BEATS = dict(embed_dim=32, encoder_layers=2, encoder_embed_dim=64,
                  encoder_ffn_embed_dim=128, encoder_attention_heads=2,
                  conv_pos=16, conv_pos_groups=4)
N = 6                 # clips
FRAMES = 8            # the vision captioner's vision_sample_num
MELBINS, TARGET = 16, 32
BeatsConfig = taudio.BeatsConfig      # the class, before the patch below


@pytest.fixture(scope="module")
def tiny_beats():
    """`BeatsConfig()` and the `beats` width at the tiny tower's, for the
    module's runs."""
    cfg = BeatsConfig(**TINY_BEATS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(taudio, "BeatsConfig", lambda: cfg)
        mp.setitem(tconfig.AUDIO_ENCODER_DIMS, "beats", 64)
        yield cfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import cv2
    import wave

    root = tmp_path_factory.mktemp("captioner_corpus")
    (root / "videos").mkdir()
    (root / "audios").mkdir()
    rng = np.random.default_rng(0)
    annos = []
    for i in range(N):
        out = cv2.VideoWriter(str(root / "videos" / f"c{i}.mp4"),
                              cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (44, 36))
        for _ in range(FRAMES + i):
            out.write(rng.integers(0, 256, (36, 44, 3), dtype=np.uint8))
        out.release()
        w = (rng.standard_normal(int(16000 * (0.9 + 0.1 * i))) * 0.1)
        with wave.open(str(root / "audios" / f"c{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes((w.clip(-1, 1) * 32767).astype(np.int16).tobytes())
        annos.append({"video_id": f"c{i}", "caption": f"clip number {i}"})
    (root / "meta.json").write_text(json.dumps(annos))
    return root


@pytest.fixture(scope="module")
def vast_dir(tmp_path_factory, tiny_beats):
    """A pretrained run's directory of the default VAST model at the tiny
    size: `log/hps.json` (configs/default_model_cfg.json with the tiny
    towers, 16 mel bins x 32 frames) and `ckpt/model_step_7.npz`."""
    root = tmp_path_factory.mktemp("vast")
    with open(os.path.join(ROOT, "configs", "default_model_cfg.json")) as f:
        model_cfg = json.load(f)
    model_cfg.update(
        eva_override=dict(TINY["eva"]), bert_override=dict(TINY["bert"]),
        vision_resolution=28, audio_melbins=MELBINS,
        audio_target_length=TARGET, contra_dim=32, compute_dtype="float32",
        max_vision_sample_num=FRAMES, max_audio_sample_num=3,
        max_caption_len=6, itm_rerank_num=3)
    write_hps(root, model_cfg)
    model = MiCo(tconfig.mico_config_from_dict(model_cfg), device="cpu",
                 seed=11)
    ModelSaver(str(root)).save(7, model)
    return str(root), model


def run_argv(config: str, vast: str, out, val: list) -> list:
    """The captioner's command line: the config, the directory, the data
    paths; the tiny towers and fp32 (the keys `hps.json` does not pass on);
    three captions a clip (`evaluation_mm` reads `run_cfg.generate_nums`,
    as JAX's does)."""
    return ["--config", os.path.join(ROOT, "configs", config),
            "--pretrain_dir", vast, "--output_dir", str(out),
            "--device", "cpu", "--data_cfg.val", json.dumps(val),
            "run_cfg.generate_nums=3",
            "model_cfg.eva_override=" + json.dumps(TINY["eva"]),
            "model_cfg.bert_override=" + json.dumps(TINY["bert"]),
            "model_cfg.vision_resolution=28", "model_cfg.contra_dim=32",
            "model_cfg.compute_dtype=float32", "model_cfg.max_caption_len=6",
            "model_cfg.itm_rerank_num=3"]


def val_item(config: str, corpus, **over) -> list:
    """The config's own val set with the corpus's paths, B 4."""
    with open(os.path.join(ROOT, "configs", config)) as f:
        item = json.load(f)["data_cfg"]["val"][0]
    item.update(txt=str(corpus / "meta.json"), batch_size=4, n_workers=2)
    for key, sub in (("audio", "audios"), ("vision", "videos")):
        if key in item:
            item[key] = str(corpus / sub)
    item.update(over)
    return [item]


def spy(monkeypatch):
    """The loaded model and the inputs each tower pass saw."""
    seen = {"audio": [], "vision": []}
    load = trun.mico_from_jax

    def mico_from_jax(*a, **kw):
        seen["model"] = load(*a, **kw)
        return seen["model"]
    monkeypatch.setattr(trun, "mico_from_jax", mico_from_jax)
    for name, key in (("forward_audio_encoder", "audio"),
                      ("forward_vision_encoder", "vision")):
        fn = getattr(tmico, name)

        def wrapped(model, x, *a, _fn=fn, _key=key, **kw):
            seen[_key].append(tuple(x.shape))
            return _fn(model, x, *a, **kw)
        monkeypatch.setattr(tmico, name, wrapped)
    return seen


@pytest.mark.parametrize("config,task,shape", [
    ("caption-generation-audio.json", "cap%ta", (3, TARGET, MELBINS)),
    ("caption-generation-vision.json", "cap%tv", (FRAMES, 3, 28, 28))])
def test_captioner_config_annotates(tiny_beats, corpus, vast_dir, tmp_path,
                                    monkeypatch, config, task, shape):
    vast, saved = vast_dir
    seen = spy(monkeypatch)
    logs = trun.main(run_argv(config, vast, tmp_path,
                              val_item(config, corpus)))
    assert logs == {f"{task}--yourdata": {"num_annotated": float(N)}}
    with open(tmp_path / f"annotations_step0_{task}--yourdata.json") as f:
        ann = json.load(f)
    sub = task.split("%")[1]
    assert [a["clip_id"] for a in ann] == [f"c{i}" for i in range(N)]
    assert all(len(a[f"{sub}_captions"]) == 3
               and all(isinstance(c, str) for c in a[f"{sub}_captions"])
               for a in ann)
    # the saved weights, the tower included, and the inherited slice size
    got = seen["model"].state_dict()
    assert all(torch.equal(got[k], v) for k, v in saved.state_dict().items())
    kind = "audio" if sub == "ta" else "vision"
    assert seen[kind] and all(s[1:] == shape for s in seen[kind])
    assert sorted(s[0] for s in seen[kind]) == [2, 4]


def test_ret_tva_reranks_over_beats_tokens(tiny_beats, corpus, vast_dir,
                                           tmp_path, monkeypatch):
    """ITM re-rank over vision (8 frames x 5 tokens) + BEATs (3 slices x 2
    tokens) condition tokens through the run entry; metrics in [0, 1]."""
    vast, _ = vast_dir
    config = "caption-generation-vision.json"
    val = val_item(config, corpus, task="ret%tva", audio=str(
        corpus / "audios"), audio_sample_num=3)
    conds = []
    scores = tev.compute_slice_scores

    def compute_slice_scores(model, cfg, cond, *a, **kw):
        conds.append(tuple(cond.shape))
        return scores(model, cfg, cond, *a, **kw)
    monkeypatch.setattr(tev, "compute_slice_scores", compute_slice_scores)
    logs = trun.main(run_argv(config, vast, tmp_path, val)
                     + ["run_cfg.itm_rerank=true"])
    metrics = logs["ret%tva--yourdata"]
    assert {"t2v_r1_va", "t2v_r1_itm_va", "video_r1"} <= set(metrics)
    assert all(0.0 <= v <= 1.0 for v in metrics.values())
    assert conds and set(conds) == {(3, FRAMES * 5 + 3 * 2, 64)}


def test_embed_audio_pools_beats_by_its_token_mean(tmp_path):
    """`EmbeddingPipeline.embed_audio` on a BEATs MiCo gives JAX's
    pipeline's embeddings: BEATs has no CLS token, so both pool by the
    mean of its tokens (the port pooled the first token before)."""
    import dataclasses

    from mico_tpu.models import audio as jaudio
    from mico_tpu.serve import EmbeddingPipeline as JaxPipeline
    from mico_tpu_torch.serve import EmbeddingPipeline
    from torch_port_common import chirp_wav

    jcfg, tcfg = configs()
    kw = dict(audio_encoder_type="beats", audio_melbins=MELBINS,
              audio_target_length=TARGET, max_audio_sample_num=2)
    jcfg = dataclasses.replace(jcfg, audio_override=jaudio.BeatsConfig(
        **TINY_BEATS), **kw)
    tcfg = dataclasses.replace(tcfg, audio_override=BeatsConfig(**TINY_BEATS),
                               **kw)
    params = perturbed_params(jcfg, seed=5)
    paths = []
    for i, seconds in enumerate((0.7, 1.3, 0.4)):
        paths.append(str(tmp_path / f"a{i}.wav"))
        chirp_wav(paths[-1], seconds, seed=i)
    sizes = dict(batch_size=2, io_workers=2, melbins=MELBINS,
                 target_length=TARGET, resize_melbin_num=MELBINS)
    want = JaxPipeline(params, jcfg, **sizes).embed_audio(paths)
    pipe = EmbeddingPipeline(port_model(params, tcfg), tcfg, device="cpu",
                             **sizes)
    got = pipe.embed_audio(paths)
    pipe.close()
    assert got.shape == (3, 32)
    close(got, want, MODEL_TOL)
