"""The port's data engine (`mico_tpu_torch/data/`, the layered config of
`mico_tpu_torch/utils/config_io.py`) against the JAX package's on a corpus
written in the test: cv2 JPEG images and frame directories, 16 kHz WAVs,
PNG depth maps, captions, questions and answers, a corrupt image and a
corrupt frame directory.

For the same corpus and seed the port yields JAX's batches: arrays to 1e-6,
ids, raw text and tokens exactly, through the corrupt-item resample. JAX's
loader decodes an item per worker thread, so with more than one worker the
order of its training draws depends on the threads; the port reads the
items of a batch in index order and decodes ahead on its workers, so its
batches are JAX's one-worker batches for any worker count. Eval loaders
draw only to resample, and are held to JAX's at several workers too.

The port's audio is the shared ViT's (`audio_encoder_type=shared`): the
settings JAX's mapper computes for `beats` (16 kHz, 2**15, Kaldi defaults,
BEATs statistics), which is what JAX is run with here; JAX's mapper raises
for `shared`.
"""

import glob
import io
import json
import os
import sys
import tarfile
import wave as wave_mod

import numpy as np
import pytest
import torch

import mico_tpu.data as jdata
from mico_tpu.data import tokenize_collate as jtok
from mico_tpu.text import BertWordPieceTokenizer as JaxTokenizer
from mico_tpu.utils import config_io as jcfg_io
import mico_tpu_torch.data as tdata
from mico_tpu_torch.data import tokenize_collate as ttok
from mico_tpu_torch.data.build import _world
from mico_tpu_torch.data.mappers import AudioMapper, VisionMapper
from mico_tpu_torch.text import BertWordPieceTokenizer
from mico_tpu_torch.utils import config_io as tcfg_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VOCAB = os.path.join(ROOT, "mico_tpu", "assets", "vocab.txt")
RES = 32
N = 8
PORT_MODEL_CFG = {
    "vision_resolution": RES,
    "vision_encoder_type": "evaclip01_giant",
    "audio_melbins": RES,
    "audio_target_length": RES,
    "audio_encoder_type": "shared",
}
JAX_MODEL_CFG = {**PORT_MODEL_CFG, "audio_encoder_type": "beats"}
ARRAY_TOL = 1e-6


def write_jpg(path, rng, hw=(40, 52)):
    import cv2

    cv2.imwrite(str(path), rng.integers(0, 255, (*hw, 3), dtype=np.uint8))


def write_wav(path, rng, seconds):
    w = (rng.standard_normal(int(16000 * seconds)) * 0.1).clip(-1, 1)
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((w * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("torch_corpus")
    for d in ("img", "frames", "wav", "depth"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    annos = []
    for i in range(N):
        write_jpg(root / "img" / f"s{i}.jpg", rng)
        fdir = root / "frames" / f"s{i}"
        fdir.mkdir()
        for k in range(6):
            write_jpg(fdir / f"{k:03d}.jpg", rng, hw=(36, 44))
        write_wav(root / "wav" / f"s{i}.wav", rng, 0.3 + 0.1 * i)
        cv2.imwrite(str(root / "depth" / f"s{i}.png"),
                    rng.integers(0, 255, (30, 34), dtype=np.uint8))
        anno = {"video_id": f"s{i}",
                "caption": (f"a picture of item {i}" if i % 3 else
                            [f"item {i} first caption", f"second {i}"]),
                "question": f"what is item {i}?",
                "answer": ([str(i), f"number {i}", "item"] if i % 2
                           else f"answer {i}"),
                "question_id": 100 + i,
                "subtitle": f"subtitle words {i}"}
        annos.append(anno)
    # a corrupt image and a frame directory with a corrupt frame: reading
    # them fails, the dataset resamples
    (root / "img" / "bad.jpg").write_bytes(b"not a jpeg")
    (root / "frames" / "bad").mkdir()
    for k in range(6):
        (root / "frames" / "bad" / f"{k:03d}.jpg").write_bytes(b"broken")
    write_wav(root / "wav" / "bad.wav", rng, 0.5)
    annos.insert(3, {"video_id": "bad", "caption": "broken sample",
                     "question": "is it broken?", "answer": "yes",
                     "question_id": 99, "subtitle": "none"})
    (root / "annos.json").write_text(json.dumps(annos))
    return root


def d_cfg(root, fmt="video_frame", audio=True, depth=False, **kw):
    d = {"name": "tiny", "txt": str(root / "annos.json"),
         "vision": str(root / ("frames" if fmt == "video_frame" else "img")),
         "vision_format": fmt, "vision_sample_num": 3, "training": True}
    if audio:
        d.update(audio=str(root / "wav"), audio_sample_num=2)
    if depth:
        d["depth"] = str(root / "depth")
    d.update(kw)
    return d


def assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray) or hasattr(w, "dtype"):
            w = np.asarray(w)
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            assert g.shape == w.shape and g.dtype == w.dtype, k
            np.testing.assert_allclose(g, w, rtol=0, atol=ARRAY_TOL,
                                       err_msg=k)
        else:
            assert g == w, k


def loader_batches(pkg, cfg, model_cfg, n_workers, n=3, train=True):
    ds = pkg.AnnoIndexedDataset(cfg, model_cfg, seed=0)
    sampler = pkg.ShardedSampler(len(ds), shuffle=train, pad=train, seed=0)
    loader = pkg.DataLoader(ds, sampler=sampler, batch_size=3,
                            num_workers=n_workers, drop_last=train)
    out = []
    for batch, _ in zip(loader, range(n)):
        out.append(batch)
    return out


@pytest.mark.parametrize("fmt,transforms,workers", [
    ("video_frame", "none", 1), ("video_frame", "none", 3),
    ("video_frame", "crop_flip", 3), ("image_rawimage", "crop_flip", 2),
    ("image_rawimage", "none", 1)])
def test_train_loader_batches_match_jax(corpus, fmt, transforms, workers):
    """3 training batches (shuffled, padded, drop_last; random frames, crop
    and flip draws, random list answers, the corrupt item resampled) equal
    JAX's one-worker batches, and the tokenized batches equal JAX's
    tokens."""
    cfg = d_cfg(corpus, fmt, depth=True, vision_transforms=transforms)
    want = loader_batches(jdata, cfg, JAX_MODEL_CFG, 1)
    got = loader_batches(tdata, cfg, PORT_MODEL_CFG, workers)
    assert len(got) == len(want) == 3
    jbt = jtok.BatchTokenizer(JaxTokenizer(JAX_VOCAB), max_caption_len=12)
    tbt = ttok.BatchTokenizer(BertWordPieceTokenizer(), max_caption_len=12)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
        assert_batches_equal(tbt(g, "ret%tva_cap%tvas_qa%tv"),
                             jbt(w, "ret%tva_cap%tvas_qa%tv"))
    ids = [i for b in got for i in b["ids"]]
    assert "bad" not in ids


@pytest.mark.parametrize("workers", [1, 4])
def test_val_loader_batches_match_jax(corpus, workers):
    """Eval batches (middle frames, no padding, every sample once, the
    corrupt image resampled), at the same worker count in both."""
    cfg = d_cfg(corpus, "image_rawimage", training=False)
    want = loader_batches(jdata, cfg, JAX_MODEL_CFG, workers, n=4,
                          train=False)
    got = loader_batches(tdata, cfg, PORT_MODEL_CFG, workers, n=4,
                         train=False)
    assert [len(b["ids"]) for b in got] == [3, 3, 3]
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    assert got[1]["question_ids_raw"][0] != 99


def test_val_passes_draw_the_corrupt_items_stand_in_as_jax(corpus):
    """Each pass over one eval dataset draws the corrupt item's stand-in
    anew from the dataset's seeded RNG, in JAX's package as in the port:
    a run's later evaluations and a fresh dataset's first pass score
    different galleries (ROADMAP.md queue 3, PR 22), and both packages
    draw the same sequence."""
    cfg = d_cfg(corpus, "image_rawimage", training=False)

    def passes(pkg, model_cfg, n=3):
        ds = pkg.AnnoIndexedDataset(cfg, model_cfg, seed=0)
        out = []
        for _ in range(n):
            loader = pkg.DataLoader(
                ds, sampler=pkg.ShardedSampler(len(ds), shuffle=False,
                                               pad=False, seed=0),
                batch_size=3, num_workers=1, drop_last=False)
            out.append([i for b in loader for i in b["ids"]])
        return out

    got = passes(tdata, PORT_MODEL_CFG)
    assert got == passes(jdata, JAX_MODEL_CFG)
    fresh = passes(tdata, PORT_MODEL_CFG, n=1)[0]
    assert fresh == got[0]
    assert "bad" not in got[0] and len({tuple(p) for p in got}) > 1


def args_for(corpus, accum=1, n_workers=2):
    return {
        "run_cfg": {"gradient_accumulation_steps": accum, "seed": 0,
                    "num_train_steps": 0, "valid_freq": 2},
        "data_cfg": {
            "train": [
                {**d_cfg(corpus, "video_frame"), "type": "annoindexed",
                 "task": "ret%tva_cap%tva", "batch_size": 4,
                 "n_workers": n_workers, "steps": 5},
                {**d_cfg(corpus, "image_rawimage", audio=False),
                 "name": "img", "type": "annoindexed", "task": "qa%tv",
                 "batch_size": 2, "n_workers": n_workers, "steps": 3}],
            "val": [{**d_cfg(corpus, "image_rawimage", training=False),
                     "type": "annoindexed", "task": "ret%tva",
                     "batch_size": 4, "n_workers": n_workers}],
        },
    }


@pytest.mark.parametrize("accum", [1, 2])
def test_metaloader_matches_jax(corpus, accum):
    """create_train_dataloaders in both packages: the same derived
    num_train_steps and valid_steps, and over 6 draws the same task
    sequence (held within accumulation windows) and the same batches."""
    raw = args_for(corpus, accum)
    jargs = jcfg_io.AttrDict.deep({**raw, "model_cfg": JAX_MODEL_CFG})
    targs = tcfg_io.AttrDict.deep({**raw, "model_cfg": PORT_MODEL_CFG})
    for d in jargs.data_cfg.train:
        d["n_workers"] = 1
    jmeta = jdata.create_train_dataloaders(jargs)
    tmeta = tdata.create_train_dataloaders(targs, device="cpu")
    assert dict(targs.run_cfg) == dict(jargs.run_cfg)
    assert targs.run_cfg.valid_steps == max(1, 8 // 2 - 1)
    tasks = []
    for (jt, jb), (tt, tb), _ in zip(jmeta, tmeta, range(6)):
        assert tt == jt
        tasks.append(tt)
        assert_batches_equal(tb, {k: np.asarray(v) if hasattr(v, "dtype")
                                  else v for k, v in jb.items()})
    assert len(set(tasks)) == 2
    for w in range(0, 6, accum):
        assert len(set(tasks[w:w + accum])) == 1

    jvals = jdata.create_val_dataloaders(jargs)
    tvals = tdata.create_val_dataloaders(targs, device="cpu")
    assert list(tvals) == list(jvals) == ["ret%tva--tiny"]
    for tb, jb in zip(tvals["ret%tva--tiny"], jvals["ret%tva--tiny"]):
        assert_batches_equal(tb, {k: np.asarray(v) if hasattr(v, "dtype")
                                  else v for k, v in jb.items()})


@pytest.mark.parametrize("n,shards,shuffle,pad", [
    (10, 4, False, True), (10, 4, False, False), (10, 3, True, True),
    (11, 2, True, False), (7, 1, True, True)])
def test_sampler_matches_jax(n, shards, shuffle, pad):
    for epoch in (0, 2):
        for i in range(shards):
            j = jdata.ShardedSampler(n, shards, i, shuffle=shuffle, pad=pad,
                                     seed=5)
            t = tdata.ShardedSampler(n, shards, i, shuffle=shuffle, pad=pad,
                                     seed=5)
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert [int(x) for x in t] == [int(x) for x in j]
            assert len(t) == len(j)


def test_shard_stream_matches_jax(tmp_path):
    """Tar shards (stdlib tarfile): the shuffled, resampled stream and the
    collated batch equal JAX's."""
    import cv2

    for s in range(2):
        with tarfile.open(tmp_path / f"shard-{s:03d}.tar", "w") as tf:
            for i in range(5):
                img = np.random.default_rng(10 * s + i).integers(
                    0, 255, size=(40, 40, 3), dtype=np.uint8)
                ok, enc = cv2.imencode(".jpg", img)
                assert ok
                payloads = [("jpg", enc.tobytes()),
                            ("txt", f"caption {s} {i}".encode())]
                if i == 2:      # a sample whose image does not decode
                    payloads[0] = ("jpg", b"broken")
                for suffix, payload in payloads:
                    info = tarfile.TarInfo(f"sample{s}{i}.{suffix}")
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
    cfg = {"name": "shards", "vision": str(tmp_path),
           "vision_format": "image", "txt_format": None, "training": True,
           "shuffle_buffer": 4, "vision_transforms": "crop_flip"}
    jit = iter(jdata.ShardIndexedDataset(cfg, JAX_MODEL_CFG, seed=0))
    tit = iter(tdata.ShardIndexedDataset(cfg, PORT_MODEL_CFG, seed=0))
    for _ in range(12):
        (jp, jc, ji), (tp, tc, ti) = next(jit), next(tit)
        assert (tc, ti) == (jc, ji)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=ARRAY_TOL)
    jb = next(iter(jdata.DataLoader(jdata.ShardIndexedDataset(
        cfg, JAX_MODEL_CFG, seed=1), batch_size=4)))
    tb = next(iter(tdata.DataLoader(tdata.ShardIndexedDataset(
        cfg, PORT_MODEL_CFG, seed=1), batch_size=4)))
    assert_batches_equal(tb, jb)


OVERRIDES = (["run_cfg.num_train_steps=4", "run_cfg.valid_freq=1",
              "model_cfg.audio_encoder_type=shared",
              "--data_cfg.val", '[{"name": "v", "task": "ret%tva"}]',
              "run_cfg.betas=[0.9,0.99]", "model_cfg.max_caption_len=12",
              "run_cfg.output_dir=/somewhere/out"])


@pytest.mark.parametrize("config", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs",
                                                        "*.json"))))
def test_layered_config_matches_jax(config, tmp_path):
    path = os.path.join(ROOT, "configs", config)
    for argv in ((), OVERRIDES):
        got = tcfg_io.load_layered_config(path, argv=argv)
        want = jcfg_io.load_layered_config(path, argv=argv)
        assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    # pretrain_dir inheritance: the global keys and model_cfg.inherit_keys
    pre = tmp_path / "pre"
    (pre / "log").mkdir(parents=True)
    (pre / "log" / "hps.json").write_text(json.dumps({"model_cfg": {
        "vision_encoder_type": "evaclip01_giant", "pool_video": True,
        "audio_melbins": 224, "contra_dim": 256}}))
    argv = ["--pretrain_dir", str(pre), "model_cfg.audio_target_length=224"]
    got = tcfg_io.load_layered_config(path, argv=argv)
    want = jcfg_io.load_layered_config(path, argv=argv)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got.model_cfg.pool_video is True
    # dump_hps writes what load_hps reads
    tcfg_io.dump_hps(got, str(tmp_path / "out"))
    assert tcfg_io.load_hps(str(tmp_path / "out")) == json.loads(
        json.dumps(got))


def test_mappers_refuse_what_is_not_ported(corpus, monkeypatch, capsys):
    """Still refused: an audio tower neither package has, the shared ViT at
    a slice that is not its resolution, and `video_rawvideo` without cv2.
    A container cv2 cannot open is a corrupt sample (None: the dataset
    resamples past it)."""
    with pytest.raises(NotImplementedError, match="clap"):
        AudioMapper(d_cfg(corpus), {**JAX_MODEL_CFG,
                                    "audio_encoder_type": "clap"}, seed=0)
    with pytest.raises(ValueError, match="vision resolution"):
        AudioMapper(d_cfg(corpus), {**PORT_MODEL_CFG, "audio_melbins": 64},
                    seed=0)
    (corpus / "videos").mkdir(exist_ok=True)
    (corpus / "videos" / "s0.mp4").write_bytes(b"\0" * 64)
    m = VisionMapper({**d_cfg(corpus), "vision": str(corpus / "videos"),
                      "vision_format": "video_rawvideo"}, PORT_MODEL_CFG,
                     seed=0)
    assert m.read("s0") is None
    assert "cannot open video" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        m.read("s0")


def stdlib_waveform(path, target_sr=16000):
    """JAX's `load_waveform` on the stdlib WAV reader: the file's rate
    for `target_sr` 0, no resampling."""
    from mico_tpu.media.audio_io import load_wav_stdlib

    wav, sr = load_wav_stdlib(path)
    assert target_sr in (0, sr)
    return wav, sr


@pytest.mark.parametrize("encoder,sr,training", [
    ("beats", 16000, False), ("beats", 16000, True), ("ast", 8000, False),
    ("ast", 16000, True)])
def test_audio_mapper_matches_jax(tmp_path, monkeypatch, encoder, sr,
                                  training):
    """The separate towers' fbank branches (once refused here) against
    JAX's `AudioMapper`: BEATs at 16 kHz, AST at the file's own rate (8
    kHz read as it is), the tower's statistics, the slicing and the chunk
    draws; JAX reads the WAV through the stdlib reader too."""
    import mico_tpu.data.mappers as jmappers

    monkeypatch.setattr(jmappers, "load_waveform", stdlib_waveform)
    rng = np.random.default_rng(sr)
    (tmp_path / "wav").mkdir()
    x = (rng.standard_normal(int(sr * 2.7)) * 0.1).clip(-1, 1)
    with wave_mod.open(str(tmp_path / "wav" / "a.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((x * 32767).astype(np.int16).tobytes())
    d = {"audio": str(tmp_path / "wav"), "audio_sample_num": 3,
         "training": training}
    cfg = {"audio_melbins": 16, "audio_target_length": 32,
           "audio_encoder_type": encoder}
    got = AudioMapper(d, cfg, seed=3).read("a")
    want = jmappers.AudioMapper(d, cfg, seed=3).read("a")
    assert got.shape == want.shape == (3, 32, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    missing = AudioMapper(d, cfg, seed=3).read("absent")
    assert missing.shape == (3, 32, 16) and not missing.any()


@pytest.mark.parametrize("training", [False, True])
def test_rawvideo_mapper_matches_jax(tmp_path, monkeypatch, training):
    """`video_rawvideo` (once refused here) through the port's cv2 route
    against JAX's `VisionMapper` on its cv2 route: the same frames, drawn
    or middle, resized and normalized; the port's eval read decodes ahead
    through the dataset's cache."""
    import cv2

    import mico_tpu.data.mappers as jmappers
    from mico_tpu.media import video_io as jvideo

    from mico_tpu_torch.data.mappers import DecodeCache

    monkeypatch.setattr(jmappers, "read_frames_chw", jvideo._read_frames_cv2)
    rng = np.random.default_rng(1)
    (tmp_path / "videos").mkdir()
    for i, n in enumerate((10, 3, 17)):
        out = cv2.VideoWriter(str(tmp_path / "videos" / f"v{i}.mp4"),
                              cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (44, 36))
        for _ in range(n):
            out.write(rng.integers(0, 256, (36, 44, 3), dtype=np.uint8))
        out.release()
    d = {"vision": str(tmp_path / "videos"), "vision_format":
         "video_rawvideo", "vision_sample_num": 4, "training": training}
    port = VisionMapper(d, PORT_MODEL_CFG, seed=2)
    jax_m = jmappers.VisionMapper(d, PORT_MODEL_CFG, seed=2)
    cache = DecodeCache()
    if not training:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as pool:
            for i in range(3):
                port.prefetch(f"v{i}", pool, cache)
        port.decode = cache
    for i in range(3):
        got, want = port.read(f"v{i}"), jax_m.read(f"v{i}")
        assert got.shape == (4, 3, RES, RES)
        np.testing.assert_allclose(got, want, rtol=0, atol=ARRAY_TOL)
    assert not cache._futures          # every prefetched decode was taken


def test_world_refuses_process_groups():
    assert _world() == (1, 0)
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        # the default group's (world, rank): this process alone
        assert _world() == (1, 0)
    finally:
        torch.distributed.destroy_process_group()


def test_cuda_prefetcher_passes_cpu_batches_through(corpus):
    loader = [("t", {"x": np.ones((2, 3), np.float32), "ids": ["a", "b"]})]
    out = list(tdata.CudaPrefetcher(loader, device="cpu"))
    assert out == loader
    assert len(tdata.CudaPrefetcher(loader, device="cpu")) == 1
