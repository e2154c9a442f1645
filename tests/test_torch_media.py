"""The port's host media path (`mico_tpu_torch/ops/fbank.py`,
`ops/interpolate.py`'s twins, `media/*`) and the pipeline's media entry
points against the JAX package on the same files: PPM/PGM images and
frame directories written here, 16-bit WAVs from a seeded chirp."""

import dataclasses
import random
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.media import audio_io as jax_audio_io
from mico_tpu.media import chunking as jax_chunking
from mico_tpu.media import image_io as jax_image_io
from mico_tpu.media import processors as jax_proc
from mico_tpu.ops import fbank as jax_fbank
from mico_tpu.ops import interpolate as jax_interp
from mico_tpu.serve import EmbeddingPipeline as JaxPipeline
from mico_tpu_torch.media import audio_io, chunking, image_io, processors, \
    video_io
from mico_tpu_torch.ops import fbank, interpolate
from mico_tpu_torch.serve import EmbeddingPipeline

from torch_port_common import (chirp_wav, configs, media_files,
                               perturbed_params, port_model, write_pnm,
                               write_wav)

TOL = dict(rtol=1e-5, atol=1e-5)
ENC = "evaclip01_giant"


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    return root, media_files(str(root), seed=2, size=(37, 50), frames=7,
                             seconds=2.3)


def seeded(*procs, seed=5):
    for p in procs:
        p._rng.seed(seed)
    return procs


# ---------------------------------------------------------------------------
# fbank, interpolation, chunking
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wave():
    rng = np.random.default_rng(0)
    t = np.arange(16000 * 1.5) / 16000
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.shape)
    return (x * 2.0**15).astype(np.float32)


@pytest.mark.parametrize("bins", [64, 128, 224])
def test_fbank_numpy_twin_matches_jax(wave, bins):
    cfg, jcfg = fbank.FbankConfig(num_mel_bins=bins), \
        jax_fbank.FbankConfig(num_mel_bins=bins)
    got = fbank.kaldi_fbank_np(wave, cfg)
    want = jax_fbank.kaldi_fbank_np(wave, jcfg)
    assert got.shape == (fbank.num_frames(len(wave), cfg), bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def fbank_f64(wave: np.ndarray, bins: int) -> np.ndarray:
    """The fbank formula evaluated in float64 on the fp32 matrices."""
    cfg = fbank.FbankConfig(num_mel_bins=bins)
    window, cos, sin, mel = (np.float64(a) for a in fbank._static_matrices(
        tuple(dataclasses.asdict(cfg).items())))
    frames = np.float64(wave)[fbank._frame_index(
        fbank.num_frames(len(wave), cfg), cfg)]
    frames = frames - frames.mean(axis=1, keepdims=True)
    frames = frames - cfg.preemphasis * np.concatenate(
        [frames[:, :1], frames[:, :-1]], axis=1)
    frames = np.pad(frames * window, ((0, 0), (0, 112)))
    power = (frames @ cos) ** 2 + (frames @ sin) ** 2
    return np.log(np.maximum(power @ mel.T, np.finfo(np.float32).eps))


@pytest.mark.parametrize("bins", [64, 224])
def test_fbank_torch_matches_jax(wave, bins):
    """Torch `kaldi_fbank` against JAX's on the same static matrices (equal
    to JAX's exactly). fp32 sums in another order differ most on low-energy
    bins: at 64 bins within 1e-4 of JAX's log-mel; at 224 bins JAX's own two
    versions differ by 1.8e-4 on this wave, so there the port is held to a
    float64 evaluation of the formula, no further from it than JAX is."""
    cfg = fbank.FbankConfig(num_mel_bins=bins)
    jcfg = jax_fbank.FbankConfig(num_mel_bins=bins)
    for a, b in zip(
            fbank._static_matrices(tuple(dataclasses.asdict(cfg).items())),
            jax_fbank._static_matrices(tuple(dataclasses.asdict(jcfg).items()))):
        np.testing.assert_array_equal(a, b)
    got = fbank.kaldi_fbank(torch.from_numpy(wave), cfg)
    assert got.dtype == torch.float32
    got = got.numpy()
    want = np.asarray(jax_fbank.kaldi_fbank(jnp.asarray(wave), jcfg))
    if bins == 64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    exact = fbank_f64(wave, bins)
    jax_err = max(np.abs(want - exact).max(),
                  np.abs(jax_fbank.kaldi_fbank_np(wave, jcfg) - exact).max())
    assert np.abs(got - exact).max() <= jax_err


def test_fbank_edges():
    cfg = fbank.FbankConfig()
    for n in (0, 399, 400, 401, 560, 16000):
        assert fbank.num_frames(n, cfg) == jax_fbank.num_frames(
            n, jax_fbank.FbankConfig())
    with pytest.raises(ValueError):
        fbank.kaldi_fbank_np(np.zeros(100, np.float32))
    with pytest.raises(ValueError):
        fbank.kaldi_fbank(torch.zeros(100))


@pytest.mark.parametrize("out_hw", [(28, 28), (7, 90), (37, 50), (224, 13)])
def test_bilinear_twins_match_jax_exactly(out_hw):
    x = np.random.default_rng(1).random((2, 3, 37, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        interpolate.interp_bilinear_2d_np(x, out_hw),
        jax_interp.interp_bilinear_2d_np(x, out_hw))
    np.testing.assert_array_equal(
        interpolate.resize_bilinear_no_antialias(torch.from_numpy(x),
                                                 out_hw).numpy(),
        np.asarray(jax_interp.resize_bilinear_no_antialias(jnp.asarray(x),
                                                           out_hw)))


@pytest.mark.parametrize("n,k", [(1, 4), (3, 4), (4, 4), (10, 4), (33, 8),
                                 (7, 1)])
def test_chunking_matches_jax(n, k):
    assert chunking.split_chunks(list(range(n)), k) == \
        jax_chunking.split_chunks(list(range(n)), k)
    assert chunking.sample_chunk_indices(n, k, False) == \
        jax_chunking.sample_chunk_indices(n, k, False)
    assert chunking.sample_chunk_indices(n, k, True, random.Random(9)) == \
        jax_chunking.sample_chunk_indices(n, k, True, random.Random(9))


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------


def test_ppm_and_pgm_reads_equal_cv2(tmp_path):
    """The port's own PPM/PGM reader gives JAX's `cv2` read exactly (a PGM's
    gray copied to three channels; a header comment skipped)."""
    rng = np.random.default_rng(3)
    ppm, pgm = tmp_path / "a.ppm", tmp_path / "b.pgm"
    write_pnm(ppm, rng.integers(0, 256, (21, 34, 3), dtype=np.uint8),
              comment=True)
    write_pnm(pgm, rng.integers(0, 256, (9, 5), dtype=np.uint8))
    for path in (ppm, pgm):
        want = jax_image_io.load_image_chw(str(path))
        rgb = image_io.read_pnm(str(path))
        got = np.ascontiguousarray(rgb.transpose(2, 0, 1)).astype(
            np.float32) / 255.0
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(image_io.load_image_chw(str(path)),
                                      want)


def test_image_readers_fall_back_in_order(tmp_path, monkeypatch, media):
    """Without cv2 and PIL a PPM still decodes (the same pixels); any other
    format raises IOError naming each reader's reason."""
    _, files = media
    want = image_io.load_image_chw(files["image"])
    jpg = tmp_path / "x.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0 not really a jpeg")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(image_io.load_image_chw(files["image"]),
                                  want)
    with pytest.raises(IOError, match="cv2 is not installed.*PIL is not "
                                      "installed.*PPM/PGM"):
        image_io.load_image_chw(str(jpg))


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_read_matches_jax(tmp_path, channels):
    rng = np.random.default_rng(channels)
    x = rng.integers(-32768, 32767, (4000, channels), dtype=np.int16)
    path = tmp_path / "a.wav"
    write_wav(path, x if channels > 1 else x[:, 0])
    got, sr = audio_io.load_waveform(str(path))
    want, jsr = jax_audio_io.load_waveform(str(path))
    assert sr == jsr == 16000 and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1 / 32768)
    np.testing.assert_array_equal(got, x[:, 0] / np.float32(32768.0))
    np.testing.assert_array_equal(audio_io.load_wav_stdlib(str(path))[0],
                                  jax_audio_io.load_wav_stdlib(str(path))[0])


def test_unported_containers_raise(tmp_path):
    """MP3, Ogg and a junk file raise naming what was found and the libav
    item of ROADMAP.md; a FLAC and an 8 kHz WAV now decode (as JAX's libav
    route: the FLAC exactly, the resampled WAV to its length and 1e-4)."""
    from torch_flac_writer import write_flac

    for name, head, said in (
            ("a.mp3", b"\xff\xfb\x90\x64" + bytes(60), "MP3"),
            ("a.ogg", b"OggS\x00\x02" + bytes(60), "Ogg"),
            ("a.bin", b"\x00 not audio", "unknown container")):
        path = tmp_path / name
        path.write_bytes(head)
        with pytest.raises(IOError, match=f"{said}.*ROADMAP.*libav codecs"):
            audio_io.load_waveform(str(path))
    flac, wav8k = tmp_path / "a.flac", tmp_path / "b.wav"
    pcm = np.random.default_rng(0).integers(-3000, 3000, (5000, 2))
    write_flac(flac, pcm, 44100, 16)
    got, sr = audio_io.load_waveform(str(flac), target_sr=0)
    want, jsr = jax_audio_io.load_waveform(str(flac), target_sr=0)
    assert sr == jsr == 44100
    np.testing.assert_array_equal(got, want)
    chirp_wav(wav8k, 0.5, sr=8000)
    got, sr = audio_io.load_waveform(str(wav8k))
    want, _ = jax_audio_io.load_waveform(str(wav8k))
    assert sr == 8000 and got.shape == want.shape == (8000,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # containers go through cv2 now: a file it cannot open raises IOError
    junk = tmp_path / "clip.mp4"
    junk.write_bytes(b"\x00 not a video")
    for path in (junk, tmp_path / "missing.mp4"):
        with pytest.raises(IOError, match="cannot open video"):
            video_io.video_num_frames(str(path))
        with pytest.raises(IOError, match="cannot open video"):
            video_io.read_frames_chw(str(path), [0, 1])


def write_mp4(path, frames: np.ndarray, fps: float = 10.0) -> None:
    """uint8 (n, H, W, 3) BGR frames as an mp4 (cv2's `mp4v`)."""
    import cv2

    n, h, w, _ = frames.shape
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                          (w, h))
    assert out.isOpened()
    for f in frames:
        out.write(np.ascontiguousarray(f))
    out.release()


@pytest.mark.parametrize("indices", [[0, 1, 2], [9, 3, 3, 0, 11], [5]])
def test_cv2_video_route_matches_jax(tmp_path, indices):
    """The cv2 route (`video_num_frames`, `read_frames_chw`) gives JAX's
    `video_num_frames` and `_read_frames_cv2` exactly on an mp4 written
    here: the frame count, RGB order, /255, repeats and the order of the
    indices, seeks across gaps."""
    from mico_tpu.media import video_io as jax_video_io

    rng = np.random.default_rng(len(indices))
    frames = rng.integers(0, 256, (12, 48, 64, 3), dtype=np.uint8)
    path = str(tmp_path / "clip.mp4")
    write_mp4(path, frames)
    assert video_io.video_num_frames(path) == 12
    assert jax_video_io.video_num_frames(path) == 12
    got = video_io.read_frames_chw(path, indices)
    want = jax_video_io._read_frames_cv2(path, indices)
    assert got.shape == (len(indices), 3, 48, 64) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0.0 <= got.min() and got.max() <= 1.0
    with pytest.raises(IOError, match="failed to read frame 12"):
        video_io.read_frames_chw(path, [1, 12])


def test_ast_reads_the_files_own_rate(tmp_path):
    """`target_sr=0` (JAX's AST branch) keeps the file's rate; another
    rate than the file's resamples as JAX's libswresample route does."""
    path = tmp_path / "a.wav"
    chirp_wav(path, 0.5, sr=8000)
    got, sr = audio_io.load_waveform(str(path), target_sr=0)
    want, jsr = jax_audio_io.load_waveform(str(path), target_sr=0)
    assert sr == jsr == 8000 and got.shape == want.shape == (4000,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1 / 32768)
    got, sr = audio_io.load_waveform(str(path), target_sr=16000)
    want, _ = jax_audio_io.load_waveform(str(path), target_sr=16000)
    assert sr == 8000 and got.shape == want.shape == (8000,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transforms,training", [
    ("none", False), ("crop_flip", True), ("crop_flip", False),
    ("resize_longest_max", False)])
@pytest.mark.parametrize("encoder", [ENC, "swin_base"])
def test_image_processor_matches_jax(media, transforms, training, encoder):
    """Within 1e-5 of JAX's (training draws made equal by seeding both
    generators alike). resize_longest_max's bicubic is `jax.image.resize`'s
    written out in numpy: at 28 px its largest gap here is about 1e-6."""
    _, files = media
    got_p, want_p = seeded(
        processors.ImageProcessor(28, encoder, transforms, training),
        jax_proc.ImageProcessor(28, encoder, transforms, training))
    for _ in range(3):          # successive draws stay in step
        got, want = got_p(files["image"]), want_p(files["image"])
        assert got.shape == want.shape == (1, 3, 28, 28)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size", [(30, 80), (90, 20), (28, 28), (200, 150)])
def test_resize_max_size_matches_jax(size):
    x = np.random.default_rng(4).random((2, 3, *size)).astype(np.float32)
    for r in (28, 64):
        got = processors.resize_max_size(x, r)
        want = jax_proc.resize_max_size(x, r)
        assert got.shape == want.shape == (2, 3, r, r)
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@pytest.mark.parametrize("training", [False, True])
def test_video_processor_frames_match_jax(media, training):
    _, files = media
    got_p, want_p = seeded(
        processors.VideoProcessor(28, ENC, sample_num=4, data_format="frame",
                                  training=training),
        jax_proc.VideoProcessor(28, ENC, sample_num=4, data_format="frame",
                                training=training))
    got, want = got_p(files["video"]), want_p(files["video"])
    assert got.shape == (4, 3, 28, 28)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("geometry", [(28, 28, 28), (64, 50, 28)])
def test_audio_processor_matches_jax(media, training, geometry):
    _, files = media
    melbins, target, resize = geometry
    kw = dict(melbins=melbins, target_length=target, sample_num=3,
              resize_melbin_num=resize, training=training)
    got_p, want_p = seeded(processors.AudioProcessor(**kw),
                           jax_proc.AudioProcessor(**kw))
    got, want = got_p(files["audio"]), want_p(files["audio"])
    assert got.shape == (3, target, resize)
    np.testing.assert_allclose(got, want, **TOL)


def test_failure_contracts(tmp_path, capsys):
    """A failed decode prints and gives None; a missing audio file gives
    zeros, as JAX's processors do."""
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"garbage")
    for got_p, want_p in (
            (processors.ImageProcessor(28, ENC, training=False),
             jax_proc.ImageProcessor(28, ENC, training=False)),
            (processors.VideoProcessor(28, ENC, data_format="frame",
                                       training=False),
             jax_proc.VideoProcessor(28, ENC, data_format="frame",
                                     training=False))):
        assert got_p(str(bad)) is None and want_p(str(bad)) is None
    assert processors.VideoProcessor(28, ENC, training=False)(
        "clip.mp4") is None
    kw = dict(melbins=28, target_length=28, sample_num=2, training=False)
    flac = tmp_path / "a.flac"
    flac.write_bytes(b"fLaC")           # no metadata: a truncated FLAC
    assert processors.AudioProcessor(**kw)(str(flac)) is None
    missing = str(tmp_path / "none.wav")
    got = processors.AudioProcessor(**kw)(missing)
    np.testing.assert_array_equal(got, jax_proc.AudioProcessor(**kw)(missing))
    assert got.shape == (2, 28, 28) and not got.any()
    assert "FLAC: truncated metadata" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the pipeline's media entry points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg, seed=6)
    audio = dict(melbins=28, target_length=28, resize_melbin_num=28)
    jpipe = JaxPipeline(params, jcfg, batch_size=3, io_workers=2, **audio)
    jpipe.video_proc.data_format = "frame"
    tpipe = EmbeddingPipeline(port_model(params, tcfg), tcfg, batch_size=3,
                              io_workers=2, device="cpu", **audio)
    yield jpipe, tpipe
    tpipe.close()


@pytest.fixture(scope="module")
def items(tmp_path_factory):
    """Five items of each kind under one root; item 3 is an undecodable
    file."""
    root = tmp_path_factory.mktemp("items")
    out = {"image": [], "video": [], "audio": []}
    for i in range(5):
        (root / str(i)).mkdir()
        files = media_files(str(root / str(i)), seed=20 + i, size=(30, 41),
                            frames=5, seconds=1.0 + 0.3 * i)
        for kind in out:
            out[kind].append(files[kind])
    bad = root / "bad.bin"
    bad.write_bytes(b"\x00\x01 garbage")
    for kind in ("image", "audio"):
        out[kind][3] = str(bad)
    out["video"][3] = str(root / "bad_frames")
    (root / "bad_frames").mkdir()
    (root / "bad_frames" / "0.ppm").write_bytes(b"P6 broken")
    return out


@pytest.mark.parametrize("method,kind", [
    ("embed_images", "image"), ("embed_videos", "video"),
    ("embed_depth", "image"), ("embed_audio", "audio")])
def test_pipeline_media_match_jax(pipes, items, method, kind):
    """The port's `embed_*` give JAX's `EmbeddingPipeline`'s embeddings on
    the same files and weights within 1e-5; the undecodable item is a zero
    row with its index in `last_failures`."""
    jpipe, tpipe = pipes
    got = getattr(tpipe, method)(items[kind])
    want = getattr(jpipe, method)(items[kind])
    assert tpipe.last_failures == jpipe.last_failures == [3]
    assert got.shape == (5, 32) and not got[3].any()
    np.testing.assert_allclose(got, want, **TOL)


def test_media_sources_stand_alone():
    """The media modules read no file of the JAX package (its libav
    library included): the one library they load is the port's own
    decoder, built from `mico_tpu_torch/csrc/audio_decode.cpp`."""
    from mico_tpu_torch.ops import _build

    root = Path(processors.__file__).resolve().parent
    for path in root.glob("*.py"):
        text = path.read_text()
        assert "libmico_media" not in text, path
        assert "CDLL(" not in text and "cdll" not in text, path
    lib = Path(audio_io._lib()._name).resolve()
    assert lib.parent == _build.BUILD_DIR.resolve()
    assert lib.name.startswith("libaudio_decode-")
