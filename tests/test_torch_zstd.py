"""The port's hand-written zstd decoder (`mico_tpu_torch/csrc/zstd_decode.cpp`
through `mico_tpu_torch/train/zstd.py`) against `zstandard`, an
independent encoder that only the tests use.

  - A corpus at levels -5 to 19 decodes byte for byte and, read by a
    header parser here (independent of the decoder), reaches every block
    type, every literals mode and every sequence table mode.
  - hypothesis draws inputs (random bytes, repeated text, float32 and bf16
    arrays, empty input) at levels -5 to 19, with and without checksums
    and content sizes, as concatenated frames with skippable frames.
  - Truncated frames, flipped bytes, bad checksums and a bad OCDBT CRC
    raise IOError, in a subprocess, so a crash fails the test and not the
    worker.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mico_tpu_torch.train import zstd

zs = pytest.importorskip("zstandard")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = (-5, 1, 3, 9, 19)


def _le(b) -> int:
    return int.from_bytes(bytes(b), "little")


def _literals_block(b: bytes):
    """(literals mode, (LL, OF, ML) table modes or ()) of a compressed
    block, from its headers alone (RFC 8878 3.1.1.3)."""
    kind, fmt = b[0] & 3, (b[0] >> 2) & 3
    if kind < 2:
        head = {0: 1, 2: 1, 1: 2, 3: 3}[fmt]
        regen = (b[0] >> 3 if head == 1 else (b[0] >> 4) + (b[1] << 4)
                 + ((b[2] << 12) if head == 3 else 0))
        size = head + (regen if kind == 0 else 1)
        mode = ("raw", "rle")[kind]
    else:
        head = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
        bits = {0: 10, 1: 10, 2: 14, 3: 18}[fmt]
        size = head + ((_le(b[:head]) >> (4 + bits)) & ((1 << bits) - 1))
        mode = (("huffman", "treeless")[kind - 2]
                + ("-1stream" if fmt == 0 else "-4streams"))
    q = b[size:]
    if q[0] == 0:
        return mode, ()
    m = q[1 if q[0] < 128 else 2 if q[0] < 255 else 3]
    return mode, (m >> 6, (m >> 4) & 3, (m >> 2) & 3)


def block_modes(data: bytes) -> list:
    """(block or literals mode, table modes) of every block of the frames
    in `data`."""
    out, pos = [], 0
    while pos < len(data):
        if _le(data[pos:pos + 4]) & 0xFFFFFFF0 == 0x184D2A50:
            pos += 8 + _le(data[pos + 4:pos + 8])
            continue
        fhd = data[pos + 4]
        single = (fhd >> 5) & 1
        p = (pos + 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3]
             + (1 if single else 0, 2, 4, 8)[fhd >> 6])
        while True:
            bh = _le(data[p:p + 3])
            p += 3
            last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
            out.append(_literals_block(data[p:p + size]) if kind == 2
                       else (("raw block", "rle block")[kind], ()))
            p += 1 if kind == 1 else size
            if last:
                break
        pos = p + (4 if fhd & 4 else 0)
    return out


def corpus() -> dict:
    rng = np.random.default_rng(0)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"a",
             b"lazy", b"dog", b"orbax"]
    return {
        "empty": b"",
        "random": rng.bytes(300_000),
        "zeros": bytes(300_000),
        "text": b" ".join(rng.choice(words, 60_000)),
        "float32": rng.standard_normal(100_000).astype(np.float32).tobytes(),
        "bf16": (rng.standard_normal(200_000).astype(np.float32)
                 .view(np.uint32) >> 16).astype(np.uint16).tobytes(),
        "quantized": rng.integers(-8, 8, 200_000).astype(np.float32)
        .tobytes(),
        "repeats": rng.bytes(200) * 500,
    }


def test_corpus_decodes_and_reaches_every_mode():
    seen = set()
    for name, data in corpus().items():
        for level in LEVELS:
            for checksum in (False, True):
                frame = zs.ZstdCompressor(
                    level=level, write_checksum=checksum).compress(data)
                assert zstd.decompress(frame) == data, (name, level)
                assert zstd.decompress(frame, expected_size=len(data)) == \
                    data, (name, level)
                for mode, tables in block_modes(frame):
                    seen.add(mode)
                    seen.update(("table", m) for m in tables)
    assert seen >= {"raw block", "rle block", "raw", "rle",
                    "huffman-1stream", "huffman-4streams",
                    "treeless-1stream", "treeless-4streams",
                    ("table", 0), ("table", 1), ("table", 2), ("table", 3)}


def test_large_window_and_threads():
    """A long-range frame (window 2^27) and many frames decoded at once on
    a pool of threads, each straight into its own buffer."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal(1 << 20).astype(np.float32).tobytes()
    data = base + rng.bytes(1000) + base           # a match 4 MiB back
    params = zs.ZstdCompressionParameters.from_level(
        19, window_log=27, enable_ldm=True)
    frame = zs.ZstdCompressor(compression_params=params).compress(data)
    assert zstd.decompress(frame) == data
    jobs, want = [], []
    for i in range(12):
        d = rng.integers(0, 4, 50_000 + 997 * i, dtype=np.uint8).tobytes()
        want.append(d)
        jobs.append((zs.ZstdCompressor(level=LEVELS[i % 5]).compress(d),
                     np.empty(len(d), np.uint8)))
    zstd.decompress_many(jobs, threads=4)
    assert [j[1].tobytes() for j in jobs] == want


def test_stored_frames_and_checksums():
    rng = np.random.default_rng(2)
    for n in (0, 1, zstd.BLOCK_MAX - 1, zstd.BLOCK_MAX,
              3 * zstd.BLOCK_MAX + 5):
        data = rng.bytes(n)
        frame = zstd.frame_stored(data)
        assert len(frame) == zstd.stored_size([n])
        assert zs.ZstdDecompressor().decompress(frame) == data
        assert zstd.decompress(frame) == data
    assert zstd.crc32c(b"123456789") == 0xE3069283    # the check value
    assert zstd.crc32c(b"") == 0


def test_dictionary_frames_raise():
    """A frame that names a dictionary (orbax writes none) is refused with
    IOError; dictionary id 0 means none."""
    block = (3 << 3 | 1).to_bytes(3, "little") + b"abc"  # last, raw, 3 bytes
    magic = 0xFD2FB528.to_bytes(4, "little")
    plain = magic + bytes([0x20, 3]) + block       # single segment, size 3
    assert zstd.decompress(plain) == b"abc"
    assert zstd.decompress(magic + bytes([0x21, 0, 3]) + block) == b"abc"
    with pytest.raises(IOError, match="dictionary"):
        zstd.decompress(magic + bytes([0x21, 7, 3]) + block)


payloads = st.one_of(
    st.binary(max_size=4096),
    st.builds(lambda w, n: w * n, st.binary(min_size=1, max_size=40),
              st.integers(1, 3000)),
    st.builds(lambda seed, n: np.random.default_rng(seed).standard_normal(n)
              .astype(np.float32).tobytes(), st.integers(0, 2 ** 32 - 1),
              st.integers(0, 20_000)),
    st.builds(lambda seed, n: (np.random.default_rng(seed).standard_normal(n)
                               .astype(np.float32).view(np.uint32) >> 16)
              .astype(np.uint16).tobytes(), st.integers(0, 2 ** 32 - 1),
              st.integers(0, 40_000)),
)
frames = st.tuples(payloads, st.integers(-5, 19), st.booleans(),
                   st.booleans())


@settings(max_examples=150, deadline=None, database=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(st.lists(frames, min_size=1, max_size=3),
       st.lists(st.binary(max_size=64), max_size=2))
def test_decoder_equals_zstandard(parts, skipped):
    data, want = b"", b""
    for i, (payload, level, checksum, size) in enumerate(parts):
        data += zs.ZstdCompressor(level=level, write_checksum=checksum,
                                  write_content_size=size).compress(payload)
        want += payload
        if i < len(skipped):                 # a skippable frame between
            data += (0x184D2A50 + i).to_bytes(4, "little") + len(
                skipped[i]).to_bytes(4, "little") + skipped[i]
    assert zstd.decompress(data) == want
    out = np.empty(len(want), np.uint8)
    zstd.decompress_into(data, out)
    assert out.tobytes() == want


CORRUPT = textwrap.dedent("""
    import os, sys
    import numpy as np
    import zstandard as zs
    sys.path.insert(0, {root!r})
    from mico_tpu_torch.train import ocdbt, zstd

    def outcome(data, size=None):
        try:
            zstd.decompress(data, expected_size=size)
            return "ok"
        except IOError as e:
            return "IOError"

    rng = np.random.default_rng(3)
    text = b" ".join(rng.choice([b"alpha", b"beta", b"gamma", b"delta"],
                                4000))
    data = text + rng.standard_normal(4000).astype(np.float32).tobytes()
    for level in (-5, 1, 19):
        frame = zs.ZstdCompressor(level=level, write_checksum=True,
                                  write_content_size=False).compress(data)
        for cut in range(0, len(frame), max(1, len(frame) // 200)):
            print("truncated", outcome(frame[:cut]))
        print("checksum", outcome(frame[:-4] + bytes(
            b ^ 0xFF for b in frame[-4:])))
        for at in range(6, len(frame) - 4, max(1, len(frame) // 300)):
            bad = bytearray(frame)
            bad[at] ^= 1 << (at % 8)
            print("flipped", outcome(bytes(bad)))
    for i in range(1500):      # any damage: an answer or IOError, no crash
        frame = zs.ZstdCompressor(level=int(rng.integers(-5, 10))).compress(
            data[:int(rng.integers(1, len(data)))])
        bad = bytearray(frame)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        print("fuzz", outcome(bytes(bad)))
        print("fuzz", outcome(bytes(bad[:int(rng.integers(0, len(bad)))])))
    root = sys.argv[1]
    w = ocdbt.Writer(root)
    w.put("k", b"v" * 2000)
    w.commit()
    path = os.path.join(root, ocdbt.MANIFEST)
    good = open(path, "rb").read()
    open(path, "wb").write(good[:-1] + bytes([good[-1] ^ 1]))
    try:
        ocdbt.Reader(root)
        print("ocdbt-crc ok")
    except IOError:
        print("ocdbt-crc IOError")
""")


def test_corrupted_input_raises_ioerror(tmp_path):
    script = tmp_path / "corrupt.py"
    script.write_text(CORRUPT.format(root=ROOT))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path / "db")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [line.split() for line in proc.stdout.splitlines()]
    kinds = {}
    for kind, result in lines:
        kinds.setdefault(kind, []).append(result)
    for kind in ("truncated", "checksum", "flipped", "ocdbt-crc"):
        assert kinds[kind] and set(kinds[kind]) == {"IOError"}, kind
    assert len(kinds["fuzz"]) == 3000
