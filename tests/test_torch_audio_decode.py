"""The port's audio decoder (`mico_tpu_torch/csrc/audio_decode.cpp`, built
with g++ at first use) against JAX's libav decoder
(`mico_tpu.media.audio_io.load_waveform`, libavformat + libswresample) and
against the PCM each file was written from.

FLAC files come from `torch_flac_writer` (libav is the judge that they are
valid); WAV files are assembled here byte by byte. Without resampling the
port equals JAX bit for bit; with it, the length is JAX's and the samples
are within 1e-4 of libswresample's, and the C++ within 1e-6 of its numpy
plain version (`audio_io.resample_plain`)."""

import shutil
import struct

import numpy as np
import pytest

from mico_tpu.media import audio_io as jax_audio_io
from mico_tpu.media import processors as jax_proc
from mico_tpu_torch.media import audio_io, processors
from mico_tpu_torch.ops import _build

from torch_flac_writer import write_flac

RESAMPLE_TOL = 1e-4         # against libswresample (SIMD sums, FMA)
PLAIN_TOL = 1e-6            # the C++ against its numpy plain version
FBANK_TOL = dict(rtol=1e-5, atol=1e-5)   # test_torch_media.py's TOL


def music(n: int, channels: int, bps: int, seed: int) -> np.ndarray:
    """Tones plus noise as (n, channels) integers within `bps` bits."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = np.stack([0.5 * np.sin(2 * np.pi * (220 + 70 * c) * t + c)
                  + 0.05 * rng.standard_normal(n) for c in range(channels)], 1)
    lim = (1 << (bps - 1)) - 1
    return np.clip(np.round(x * lim), -lim - 1, lim).astype(np.int64)


# name: (bps, channels, rate, writer options); 7000 samples each, so every
# file ends in a short block
FLAC_VARIANTS = {
    "fixed_orders_0_to_4": (16, 2, 44100, dict(
        subframes=[("fixed", o) for o in range(5)], block=1152)),
    "lpc_orders_1_to_32": (24, 1, 48000, dict(
        subframes=[("lpc", o) for o in (1, 2, 3, 5, 8, 12, 16, 24, 31, 32)],
        block=576)),
    "lpc_precision_5_and_15": (20, 2, 32000, dict(
        subframes=[("lpc", 8, 5), ("lpc", 12, 15)], block=1024)),
    "constant_and_verbatim": (12, 2, 22050, dict(
        subframes=["verbatim", "constant"], block=192)),
    "rice2_16_partitions": (24, 2, 96000, dict(
        codings=["rice2"], partition_order=4, block=2048)),
    "escape_partitions": (16, 1, 16000, dict(
        subframes=[("fixed", 1)], escape="always", block=1024)),
    "escape_every_other": (8, 2, 8000, dict(
        codings=["rice", "rice2"], escape="alternate", partition_order=3)),
    "channel_assignments_16": (16, 2, 44100, dict(
        assignments=["independent", "left_side", "side_right", "mid_side"],
        block=1024)),
    "channel_assignments_24": (24, 2, 48000, dict(
        assignments=["mid_side", "side_right", "left_side"], block=1152)),
    "wasted_bits": (20, 2, 44100, dict(wasted=True, block=2304)),
    "explicit_8bit_block_khz_rate": (16, 1, 48000, dict(
        block=200, block_code="8bit", rate_code="khz")),
    "explicit_16bit_block_hz_rate": (12, 2, 44100, dict(
        block=1000, block_code="16bit", rate_code="hz")),
    "tens_of_hz_rate_streaminfo_depth": (16, 1, 22050, dict(
        rate_code="tens", depth_code="streaminfo")),
    "rate_from_streaminfo": (16, 2, 16001, dict(rate_code="streaminfo")),
    "metadata_blocks": (16, 2, 44100, dict(
        metadata=["padding", "seektable", "vorbis_comment"])),
    "variable_blocking": (16, 2, 44100, dict(variable=True, block=1000)),
    "utf8_six_byte_frame_numbers": (16, 1, 44100, dict(
        first_number=1 << 30, block=512)),
    "depth_4": (4, 2, 8000, dict(subframes=[("fixed", 2), "verbatim"])),
    "depth_10": (10, 1, 11025, dict(subframes=[("lpc", 4), ("fixed", 3)])),
    "depth_23_three_channels": (23, 3, 44100, dict(block=1152)),
}


def flac_variant(tmp_path, name):
    bps, channels, rate, kw = FLAC_VARIANTS[name]
    pcm = music(7000, channels, bps, seed=len(name))
    if name == "wasted_bits":
        pcm = (pcm >> 3) << 3
    if name == "constant_and_verbatim":
        pcm[192:384] = 5                 # a CONSTANT frame in each channel
    if name == "escape_partitions":
        pcm[2048:3072] = -7              # zero residuals: 0 raw bits
    path = tmp_path / f"{name}.flac"
    write_flac(path, pcm, rate, bps, **kw)
    want = (pcm[:, 0].astype(np.float64) / 2 ** (bps - 1)).astype(np.float32)
    return str(path), want, rate


@pytest.mark.parametrize("name", sorted(FLAC_VARIANTS))
def test_flac_variant_equals_pcm_and_jax(tmp_path, name):
    path, want, rate = flac_variant(tmp_path, name)
    got, sr = audio_io.load_waveform(path, target_sr=0)
    jax_got, jsr = jax_audio_io.load_waveform(path, 0)
    assert sr == jsr == rate and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_got)
    same, _ = audio_io.load_waveform(path, target_sr=rate)   # no resampling
    np.testing.assert_array_equal(same, want)


def test_flac_seven_byte_sample_numbers(tmp_path):
    """Variable blocking from sample 2^35 needs 7-byte UTF-8 numbers. libav
    decodes no sample of such a stream (it reads the first number as the
    stream's start), so here the written PCM is the only judge."""
    pcm = music(5000, 2, 16, seed=7)
    path = tmp_path / "far.flac"
    write_flac(path, pcm, 44100, 16, variable=True, first_number=1 << 35)
    got, sr = audio_io.load_waveform(str(path), target_sr=0)
    assert sr == 44100
    np.testing.assert_array_equal(got, (pcm[:, 0] / 2.0**15).astype(np.float32))


def test_flac_eight_bit_constant_frame(tmp_path):
    """An 8-bit mono CONSTANT frame with a 1-byte frame number is 10 bytes,
    which libav's FLAC parser drops, so here too the PCM is the judge."""
    pcm = music(1000, 1, 8, seed=3)
    pcm[192:384] = -3
    path = tmp_path / "c8.flac"
    write_flac(path, pcm, 8000, 8, subframes=["verbatim", "constant"],
               block=192)
    got, _ = audio_io.load_waveform(str(path), target_sr=0)
    np.testing.assert_array_equal(got, (pcm[:, 0] / 128.0).astype(np.float32))


def corrupted(tmp_path, how: str) -> str:
    pcm = music(6000, 2, 16, seed=11)
    path = tmp_path / f"{how}.flac"
    write_flac(path, pcm, 44100, 16, block=1024)
    data = bytearray(path.read_bytes())
    second = data.index(b"\xff\xf8", len(data) // 3)   # a later frame sync
    if how == "bad_crc16":
        data[second - 40] ^= 0x10        # a residual bit of the frame before
    elif how == "bad_crc8":
        data[second + 2] ^= 0x01         # the next frame's header
    elif how == "cut_in_frame":
        data = data[:second - 7]
    elif how == "cut_at_frame":
        data = data[:second]
    path.write_bytes(bytes(data))
    return str(path)


@pytest.mark.parametrize("how, said", [
    ("bad_crc16", "CRC-16 mismatch"), ("bad_crc8", "CRC-8 mismatch"),
    ("cut_in_frame", "truncated"), ("cut_at_frame", "truncated")])
def test_corrupt_flac_raises(tmp_path, how, said):
    path = corrupted(tmp_path, how)
    with pytest.raises(IOError, match=said):
        audio_io.load_waveform(path)
    with pytest.raises(IOError, match=said):
        audio_io.load_waveform(path, target_sr=0)


def wav_bytes(data: bytes, channels: int, rate: int, bits: int, tag: int = 1,
              extensible: bool = False, chunks=(), size=None) -> bytes:
    """A RIFF/WAVE file: fmt (plain or WAVE_FORMAT_EXTENSIBLE with the
    sub-format `tag`), the extra `chunks` ((id, payload), odd sizes padded),
    then data with its size field (`size` overrides it)."""
    width = (bits + 7) // 8
    if extensible:
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, channels, rate,
                          rate * channels * width, channels * width, bits,
                          22, bits, 0)
        fmt += struct.pack("<I", tag) + bytes.fromhex("000010008000"
                                                      "00aa00389b71")
    else:
        fmt = struct.pack("<HHIIHH", tag, channels, rate,
                          rate * channels * width, channels * width, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    for cid, payload in chunks:
        body += cid + struct.pack("<I", len(payload)) + payload
        body += b"\x00" * (len(payload) % 2)
    body += b"data" + struct.pack("<I", len(data) if size is None else size)
    return b"RIFF" + struct.pack("<I", len(body) + len(data)) + body + data


def wav_case(kind: str, n: int = 3001, channels: int = 3):
    """(data bytes, bits, format tag, channel 0 as JAX's decoder gives it)."""
    rng = np.random.default_rng(len(kind))
    if kind == "u8":
        x = rng.integers(0, 256, (n, channels)).astype(np.uint8)
        return x.tobytes(), 8, 1, (x[:, 0].astype(np.float32) - 128) / 128
    if kind == "s16":
        x = rng.integers(-32768, 32768, (n, channels)).astype("<i2")
        return x.tobytes(), 16, 1, x[:, 0] / np.float32(32768)
    if kind == "s24":
        x = rng.integers(-2**23, 2**23, (n, channels)).astype(np.int64)
        raw = np.stack([(x >> (8 * k)) & 0xFF for k in range(3)], -1)
        return (raw.astype(np.uint8).tobytes(), 24, 1,
                (x[:, 0] / 2.0**23).astype(np.float32))
    if kind == "s32":
        x = rng.integers(-2**31, 2**31, (n, channels)).astype("<i4")
        return x.tobytes(), 32, 1, x[:, 0].astype(np.float32) / np.float32(2**31)
    dtype = "<f4" if kind == "f32" else "<f8"
    x = (rng.standard_normal((n, channels)) * 0.3).astype(dtype)
    return x.tobytes(), 32 if kind == "f32" else 64, 3, x[:, 0].astype(np.float32)


@pytest.mark.parametrize("layout", ["plain", "extensible", "odd_chunks",
                                    "size_0", "size_ffffffff"])
@pytest.mark.parametrize("kind", ["u8", "s16", "s24", "s32", "f32", "f64"])
def test_wav_widths_equal_pcm_and_jax(tmp_path, kind, layout):
    data, bits, tag, want = wav_case(kind)
    chunks = ((b"LIST", b"INFOabc"), (b"fact", b"\x01\x02\x03\x04")) \
        if layout == "odd_chunks" else ()
    size = {"size_0": 0, "size_ffffffff": 0xFFFFFFFF}.get(layout)
    path = tmp_path / "a.wav"
    path.write_bytes(wav_bytes(data, 3, 22050, bits, tag,
                               extensible=layout == "extensible",
                               chunks=chunks, size=size))
    got, sr = audio_io.load_waveform(str(path), target_sr=0)
    jax_got, jsr = jax_audio_io.load_waveform(str(path), 0)
    assert sr == jsr == 22050
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_got)


def signal_f32(kind: str, rate: int, seconds: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(rate)
    t = np.arange(int(seconds * rate)) / rate
    if kind == "noise":
        x = rng.uniform(-1.0, 1.0, t.shape)
    else:
        x = np.sin(2 * np.pi * (100 + 0.45 * rate / 2 * t) * t)
    return x.astype(np.float32)


RATES = [8000, 11025, 22050, 32000, 44100, 48000, 96000, 16001]


@pytest.mark.parametrize("kind", ["noise", "chirp"])
@pytest.mark.parametrize("rate", RATES)
def test_resampling_to_16k_matches_libswresample(tmp_path, rate, kind):
    x = signal_f32(kind, rate)
    path = tmp_path / "x.wav"
    path.write_bytes(wav_bytes(x.astype("<f4").tobytes(), 1, rate, 32, 3))
    got, sr = audio_io.load_waveform(str(path), 16000)
    want, jsr = jax_audio_io.load_waveform(str(path), 16000)
    assert sr == jsr == rate and got.dtype == np.float32
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RESAMPLE_TOL
    np.testing.assert_array_equal(audio_io.resample(x, rate, 16000), got)
    plain = audio_io.resample_plain(x, rate, 16000)
    assert plain.shape == got.shape
    assert np.abs(plain - got).max() <= PLAIN_TOL


@pytest.mark.parametrize("n", [1, 20, 31, 32, 33, 64, 99, 100, 101, 250])
@pytest.mark.parametrize("rate", [8000, 48000, 16001])
def test_short_inputs_match_libswresample(tmp_path, rate, n):
    """The library holds inputs of up to one filter length until its flush,
    then extends them by reflection; shorter still gives nothing."""
    x = signal_f32("noise", rate)[:n]
    path = tmp_path / "x.wav"
    path.write_bytes(wav_bytes(x.astype("<f4").tobytes(), 1, rate, 32, 3))
    got, _ = audio_io.load_waveform(str(path), 16000)
    want, _ = jax_audio_io.load_waveform(str(path), 16000)
    assert got.shape == want.shape
    if want.size:
        assert np.abs(got - want).max() <= RESAMPLE_TOL
    plain = audio_io.resample_plain(x, rate, 16000)
    assert plain.shape == got.shape
    if plain.size:
        assert np.abs(plain - got).max() <= PLAIN_TOL


@pytest.mark.parametrize("src, dst", [(44100, 22050), (16000, 44100),
                                      (22050, 22050), (48000, 8000)])
def test_resampler_plain_version(src, dst):
    x = signal_f32("chirp", src, 0.5)
    got = audio_io.resample(x, src, dst)
    plain = audio_io.resample_plain(x, src, dst)
    assert got.shape == plain.shape
    assert np.abs(got - plain).max() <= PLAIN_TOL
    if src == dst:
        np.testing.assert_array_equal(got, x)
    assert audio_io.resample(np.zeros(0, np.float32), src, dst).size == 0


def test_impulse_response_has_no_delay(tmp_path):
    """An impulse of 0.5 at t = 0, 22050 -> 16000 Hz: out[0] is the centre
    tap, about 0.5 * 0.97 * 16000 / 22050, with no delay before it."""
    x = np.zeros(22050, np.float32)
    x[0] = 0.5
    path = tmp_path / "imp.wav"
    path.write_bytes(wav_bytes(x.astype("<f4").tobytes(), 1, 22050, 32, 3))
    got, _ = audio_io.load_waveform(str(path), 16000)
    want, _ = jax_audio_io.load_waveform(str(path), 16000)
    assert abs(float(got[0]) - 0.3519) < 5e-5
    assert np.abs(got - want).max() <= RESAMPLE_TOL
    assert np.argmax(np.abs(got)) == 0


@pytest.mark.parametrize("head, said", [
    (b"ID3\x04\x00\x00\x00\x00\x00\x00" + b"\xff\xfb\x90\x00" * 8, "MP3"),
    (b"\xff\xfb\x90\x64" + bytes(60), "MP3"),
    (b"OggS\x00\x02" + bytes(60), "Ogg"),
    (b"\x00\x00\x00\x20ftypM4A \x00\x00\x02\x00" + bytes(40), "MP4/M4A"),
    (b"\xff\xf1\x50\x80" + bytes(60), "AAC"),
    (b"\x00 not audio at all", "unknown container, first bytes 00 20 6e")])
def test_unsupported_containers_raise_by_name(tmp_path, head, said):
    path = tmp_path / "x.bin"
    path.write_bytes(head)
    with pytest.raises(IOError, match=f"{said}.*need libav.*libav codecs"):
        audio_io.load_waveform(str(path))


def test_missing_file_and_bad_wav_raise(tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        audio_io.load_waveform(str(tmp_path / "none.flac"))
    path = tmp_path / "alaw.wav"
    path.write_bytes(wav_bytes(b"\x00" * 64, 1, 8000, 8, tag=6))
    with pytest.raises(IOError, match="codec tag 0x0006.*libav"):
        audio_io.load_waveform(str(path))


def test_host_build_raises_and_never_falls_back(tmp_path, monkeypatch):
    """A failed g++ build raises with the compiler's output, a missing g++
    raises, the library's name follows the source, and the host source
    stays out of the CUDA kernels' set and hash."""
    assert "audio_decode" not in {p.stem for p in _build.CSRC.glob("*.cu")}
    lib = _build.build_host("audio_decode")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith(
        "libaudio_decode-")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    hash_before = _build.sources_hash()
    (csrc / "other.cpp").write_text("int g() { return 1; }\n")
    assert _build.sources_hash() == hash_before
    build = _build.build_host.__wrapped__
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"
                                           "(.|\\n)*error"):
        build("broken")
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build("other")


def test_decoder_error_is_not_caught_by_a_fallback(tmp_path, monkeypatch):
    """load_waveform goes through the native library alone: when it cannot
    be loaded, a plain 16-bit WAV does not decode another way."""
    path = tmp_path / "a.wav"
    data, bits, tag, _ = wav_case("s16", 100, 1)
    path.write_bytes(wav_bytes(data, 1, 16000, bits, tag))

    def no_library(stem):
        raise RuntimeError("g++ not found")
    monkeypatch.setattr(_build, "load_host", no_library)
    audio_io._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            audio_io.load_waveform(str(path))
    finally:
        monkeypatch.undo()
        audio_io._lib.cache_clear()
    assert audio_io.load_waveform(str(path))[0].shape == (100,)


@pytest.fixture(scope="module")
def audio_files(tmp_path_factory):
    """A 44.1 kHz stereo 16-bit FLAC and a 22.05 kHz WAV, 1.3 s each."""
    root = tmp_path_factory.mktemp("audio")
    flac = root / "a.flac"
    write_flac(flac, music(int(1.3 * 44100), 2, 16, seed=5), 44100, 16,
               assignments=["mid_side", "left_side"])
    wav = root / "b.wav"
    x = music(int(1.3 * 22050), 1, 16, seed=6)[:, 0]
    wav.write_bytes(wav_bytes(x.astype("<i2").tobytes(), 1, 22050, 16))
    return {"flac": str(flac), "wav": str(wav)}


@pytest.mark.parametrize("which", ["flac", "wav"])
@pytest.mark.parametrize("geometry", [(28, 28, 28), (64, 50, 28)])
def test_audio_processor_matches_jax(audio_files, which, geometry):
    melbins, target, resize = geometry
    kw = dict(melbins=melbins, target_length=target, sample_num=3,
              resize_melbin_num=resize, training=False)
    got = processors.AudioProcessor(**kw)(audio_files[which])
    want = jax_proc.AudioProcessor(**kw)(audio_files[which])
    assert got.shape == (3, target, resize)
    np.testing.assert_allclose(got, want, **FBANK_TOL)


@pytest.mark.parametrize("which", ["flac", "wav"])
@pytest.mark.parametrize("encoder", ["ast", "beats"])
def test_encoder_fbank_matches_the_jax_mapper(audio_files, which, encoder):
    """The data mappers' fbank (`encoder_fbank`) against JAX's
    `AudioMapper._fbank`: AST at the file's own rate, BEATs at 16 kHz."""
    from mico_tpu.data.mappers import AudioMapper

    mapper = AudioMapper({"audio": "", "audio_sample_num": 2},
                         {"audio_melbins": 64, "audio_encoder_type": encoder})
    got = processors.encoder_fbank(audio_files[which], encoder, 64)
    want = mapper._fbank(audio_files[which])
    assert got.shape == want.shape and got.shape[1] == 64
    np.testing.assert_allclose(got, want, **FBANK_TOL)


@pytest.fixture(scope="module")
def pipes():
    from mico_tpu.serve import EmbeddingPipeline as JaxPipeline
    from mico_tpu_torch.serve import EmbeddingPipeline

    from torch_port_common import configs, perturbed_params, port_model

    jcfg, tcfg = configs()
    params = perturbed_params(jcfg, seed=8)
    audio = dict(melbins=28, target_length=28, resize_melbin_num=28)
    jpipe = JaxPipeline(params, jcfg, batch_size=2, io_workers=2, **audio)
    tpipe = EmbeddingPipeline(port_model(params, tcfg), tcfg, batch_size=2,
                              io_workers=2, device="cpu", **audio)
    yield jpipe, tpipe
    tpipe.close()


def test_embed_audio_on_flac_and_22k_wav_matches_jax(pipes, audio_files):
    """The slice end to end at the tiny fp32 config: `embed_audio` decodes
    a 44.1 kHz stereo FLAC and a 22.05 kHz WAV, resamples both to 16 kHz
    and embeds them as JAX's pipeline does on the same files and
    weights."""
    from torch_port_common import MODEL_TOL

    jpipe, tpipe = pipes
    paths = [audio_files["flac"], audio_files["wav"]]
    got = tpipe.embed_audio(paths)
    want = jpipe.embed_audio(paths)
    assert tpipe.last_failures == jpipe.last_failures == []
    assert got.shape == want.shape == (2, 32)
    np.testing.assert_allclose(got, want, **MODEL_TOL)
