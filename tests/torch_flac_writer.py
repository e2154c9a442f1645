"""A small FLAC encoder for the audio decoder's tests (no tests of its own).

`write_flac` writes integer PCM as FLAC with the coding chosen by the
caller, so one file can carry every construct a decoder must read:
CONSTANT, VERBATIM, FIXED (orders 0-4) and LPC (orders 1-32) subframes,
wasted bits, Rice / Rice2 / escaped residual partitions (0 raw bits
included), the four channel assignments, table and explicit block sizes and
sample rates, a short last block, fixed or variable blocking (UTF-8 frame
or sample numbers of 1 to 7 bytes) and PADDING, SEEKTABLE and
VORBIS_COMMENT blocks. Per-frame choices cycle through the given lists.
Bits are packed with numpy, a frame at a time.
"""

from __future__ import annotations

import itertools
import struct

import numpy as np

TABLE_BLOCKS = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
                1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14,
                32768: 15}
TABLE_RATES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
               24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
TABLE_DEPTHS = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


_CRC16 = []
for _i in range(256):
    _c = _i << 8
    for _ in range(8):
        _c = ((_c << 1) ^ 0x8005) & 0xFFFF if _c & 0x8000 else (_c << 1) & 0xFFFF
    _CRC16.append(_c)


def _crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16[(c >> 8) ^ b]
    return c


class _Bits:
    """(value, width) fields, MSB first, packed at the end."""

    def __init__(self):
        self.vals, self.widths = [], []

    def put(self, value, width: int) -> None:
        if width:
            self.vals.append(np.asarray([int(value) & ((1 << width) - 1)],
                                        np.uint64))
            self.widths.append(np.asarray([width], np.int64))

    def put_many(self, values: np.ndarray, widths) -> None:
        values = np.asarray(values, np.int64)
        widths = np.broadcast_to(np.asarray(widths, np.int64), values.shape)
        keep = widths > 0
        mask = (np.uint64(1) << widths[keep].astype(np.uint64)) - np.uint64(1)
        self.vals.append(values[keep].astype(np.uint64) & mask)
        self.widths.append(widths[keep])

    def tobytes(self) -> bytes:
        vals = np.concatenate(self.vals) if self.vals else np.zeros(0, np.uint64)
        widths = np.concatenate(self.widths) if self.widths else np.zeros(0, np.int64)
        total = int(widths.sum())
        pad = (-total) % 8
        ends = np.cumsum(widths)
        bits = np.zeros(total + pad, np.uint8)
        for w in np.unique(widths):
            sel = widths == w
            shifts = np.arange(w - 1, -1, -1, dtype=np.uint64)
            b = (vals[sel][:, None] >> shifts[None, :]) & np.uint64(1)
            pos = (ends[sel] - w)[:, None] + np.arange(w)[None, :]
            bits[pos] = b.astype(np.uint8)
        return np.packbits(bits).tobytes()


def _utf8(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for nbytes, lead in ((2, 0xC0), (3, 0xE0), (4, 0xF0), (5, 0xF8),
                         (6, 0xFC), (7, 0xFE)):
        if n < 1 << (6 * (nbytes - 1) + (7 - nbytes if nbytes < 7 else 0)):
            break
    out = []
    for _ in range(nbytes - 1):
        out.append(0x80 | (n & 0x3F))
        n >>= 6
    return bytes([lead | n] + out[::-1])


def _signed_width(r: np.ndarray) -> int:
    """Bits of the narrowest two's complement field holding every r."""
    if not r.size or not r.any():
        return 0
    hi = int(max(r.max(), -r.min() - 1))
    return hi.bit_length() + 1


def _residual(bits: _Bits, r: np.ndarray, block: int, order: int,
              coding: str, porder: int, escape: str) -> None:
    method = 0 if coding == "rice" else 1
    pbits, esc, kmax = (4, 15, 14) if method == 0 else (5, 31, 30)
    while porder and (block % (1 << porder) or (block >> porder) < order):
        porder -= 1
    bits.put(method, 2)
    bits.put(porder, 4)
    size = block >> porder
    u = np.where(r >= 0, 2 * r, -2 * r - 1).astype(np.int64)
    lo = 0
    for part in range(1 << porder):
        hi = (part + 1) * size - order
        seg, useg = r[lo:hi], u[lo:hi]
        mean = float(useg.mean()) if useg.size else 0.0
        k = min(max(int(np.log2(mean)) if mean >= 1 else 0, 0), kmax)
        forced = escape == "always" or (escape == "alternate" and part % 2)
        if forced or (useg.size and int((useg >> k).max()) + 1 + k > 60):
            raw = _signed_width(seg)
            bits.put(esc, pbits)
            bits.put(raw, 5)
            bits.put_many(seg, raw)
        else:
            bits.put(k, pbits)
            q = useg >> k
            # q zeros, a one, then the k low bits: one field of q + 1 + k
            bits.put_many((np.int64(1) << k) | (useg & ((1 << k) - 1)),
                          q + 1 + k)
        lo = hi


def _lpc_coefs(s: np.ndarray, order: int, precision: int):
    """Least-squares predictor, quantised to `precision` bits and a shift."""
    x = s.astype(np.float64)
    rows = np.stack([x[order - 1 - j:len(x) - 1 - j] for j in range(order)], 1)
    c = np.linalg.lstsq(rows, x[order:], rcond=None)[0] if len(x) > 2 * order \
        else np.zeros(order)
    cmax = float(np.abs(c).max()) if c.size else 0.0
    shift = 15
    while shift > 0 and cmax * (1 << shift) >= (1 << (precision - 1)) - 1:
        shift -= 1
    q = np.clip(np.round(c * (1 << shift)), -(1 << (precision - 1)),
                (1 << (precision - 1)) - 1).astype(np.int64)
    return q, shift


def _subframe(bits: _Bits, s: np.ndarray, bps: int, kind, coding: str,
              porder: int, escape: str, wasted: bool) -> None:
    s = np.asarray(s, np.int64)
    w = 0
    if wasted and s.any():
        while w < bps - 1 and not (s & ((1 << (w + 1)) - 1)).any():
            w += 1
    s = s >> w
    bps -= w
    name = kind if isinstance(kind, str) else kind[0]
    if name == "constant" and not (s == s[0]).all():
        name = "verbatim"
    if name in ("fixed", "lpc") and kind[1] >= len(s):   # a short last block
        name = "verbatim"
    code = {"constant": 0, "verbatim": 1}.get(name)
    if name == "fixed":
        code = 8 + kind[1]
    elif name == "lpc":
        code = 31 + kind[1]
    bits.put(0, 1)
    bits.put(code, 6)
    if w:
        bits.put(1, 1)
        bits.put(1, w)          # w - 1 zeros, then a one
    else:
        bits.put(0, 1)
    block = len(s)
    if name == "constant":
        bits.put(s[0], bps)
        return
    if name == "verbatim":
        bits.put_many(s, bps)
        return
    order = kind[1]
    bits.put_many(s[:order], bps)
    if name == "fixed":
        pred = np.zeros(block - order, np.int64)
        taps = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}
        for j, c in enumerate(taps[order]):
            pred += c * s[order - 1 - j:block - 1 - j]
    else:
        precision = kind[2] if len(kind) > 2 else 12
        coefs, shift = _lpc_coefs(s, order, precision)
        bits.put(precision - 1, 4)
        bits.put(shift, 5)
        bits.put_many(coefs, precision)
        acc = np.zeros(block - order, np.int64)
        for j, c in enumerate(coefs):
            acc += int(c) * s[order - 1 - j:block - 1 - j]
        pred = acc >> shift
    _residual(bits, s[order:] - pred, block, order, coding, porder, escape)


def _channels(frame: np.ndarray, assignment: str):
    """(assignment code, [(samples, extra bit)] per channel)."""
    if assignment == "independent" or frame.shape[1] != 2:
        return frame.shape[1] - 1, [(frame[:, c], 0)
                                    for c in range(frame.shape[1])]
    left, right = frame[:, 0], frame[:, 1]
    side = left - right
    if assignment == "left_side":
        return 8, [(left, 0), (side, 1)]
    if assignment == "side_right":
        return 9, [(side, 1), (right, 0)]
    return 10, [((left + right) >> 1, 0), (side, 1)]


def _metadata(kind: str, total: int, block: int) -> tuple:
    if kind == "padding":
        return 1, bytes(37)
    if kind == "seektable":
        point = struct.pack(">QQH", 0, 0, block)
        return 3, point + struct.pack(">QQH", 0xFFFFFFFFFFFFFFFF, 0, 0)
    if kind == "vorbis_comment":
        vendor = b"torch_flac_writer"
        tags = [b"TITLE=decoder test", b"ENCODER=numpy"]
        body = struct.pack("<I", len(vendor)) + vendor
        body += struct.pack("<I", len(tags))
        for t in tags:
            body += struct.pack("<I", len(t)) + t
        return 4, body
    raise ValueError(kind)


def write_flac(path, pcm: np.ndarray, sr: int, bps: int, *, block: int = 4096,
               subframes=(("lpc", 8),), assignments=("independent",),
               codings=("rice",), partition_order: int = 2,
               escape: str = "never", wasted: bool = False,
               metadata=(), block_code: str = "table",
               rate_code: str = "table", depth_code: str = "table",
               variable: bool = False, first_number: int = 0) -> None:
    """Integer `pcm` ((n,) or (n, channels), each within `bps` bits signed)
    as a FLAC file. `subframes` items: "constant", "verbatim", ("fixed",
    order), ("lpc", order[, precision]); `assignments`: "independent",
    "left_side", "side_right", "mid_side"; `codings`: "rice", "rice2";
    `escape`: "never", "always", "alternate" (every other partition);
    `block_code`: "table" (explicit where the size has no code), "8bit",
    "16bit"; `rate_code`: "table", "streaminfo", "khz", "hz", "tens";
    `depth_code`: "table", "streaminfo"; `first_number`: the first frame
    (or, `variable`, sample) number, to reach long UTF-8 codes."""
    pcm = np.asarray(pcm, np.int64)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, nch = pcm.shape
    lim = 1 << (bps - 1)
    assert pcm.min() >= -lim and pcm.max() < lim, "samples exceed bps"
    info = struct.pack(">HH", block, block) + bytes(6)
    packed = (sr << 44) | ((nch - 1) << 41) | ((bps - 1) << 36) | n
    info += packed.to_bytes(8, "big") + bytes(16)
    blocks = [(0, info)] + [_metadata(m, n, block) for m in metadata]
    out = bytearray(b"fLaC")
    for i, (kind, body) in enumerate(blocks):
        last = 0x80 if i == len(blocks) - 1 else 0
        out += bytes([last | kind]) + len(body).to_bytes(3, "big") + body
    cycle = zip(itertools.cycle(subframes), itertools.cycle(assignments),
                itertools.cycle(codings))
    for index, (start, (kind, assignment, coding)) in enumerate(
            zip(range(0, n, block), cycle)):
        frame = pcm[start:start + block]
        size = len(frame)
        head = _Bits()
        head.put(0x7FFC, 15)
        head.put(int(variable), 1)
        if block_code == "table" and size in TABLE_BLOCKS:
            bcode, extra = TABLE_BLOCKS[size], None
        elif block_code == "8bit" or (block_code == "table" and size <= 256):
            bcode, extra = 6, (size - 1, 8)
        else:
            bcode, extra = 7, (size - 1, 16)
        if rate_code == "table" and sr in TABLE_RATES:
            rcode, rextra = TABLE_RATES[sr], None
        elif rate_code == "khz":
            rcode, rextra = 12, (sr // 1000, 8)
        elif rate_code == "hz":
            rcode, rextra = 13, (sr, 16)
        elif rate_code == "tens":
            rcode, rextra = 14, (sr // 10, 16)
        else:
            rcode, rextra = 0, None
        acode, chans = _channels(frame, assignment)
        head.put(bcode, 4)
        head.put(rcode, 4)
        head.put(acode, 4)
        head.put(TABLE_DEPTHS.get(bps, 0) if depth_code == "table" else 0, 3)
        head.put(0, 1)
        header = bytearray(head.tobytes())
        header += _utf8(first_number + (start if variable else index))
        tail = _Bits()
        if extra:
            tail.put(*extra)
        if rextra:
            tail.put(*rextra)
        header += tail.tobytes()
        header.append(_crc8(bytes(header)))
        body = _Bits()
        for samples, more in chans:
            _subframe(body, samples, bps + more, kind, coding,
                      partition_order, escape, wasted)
        frame_bytes = bytes(header) + body.tobytes()
        out += frame_bytes + _crc16(frame_bytes).to_bytes(2, "big")
    with open(path, "wb") as f:
        f.write(out)
