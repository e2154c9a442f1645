"""zstd frames on the host, through the port's own decoder.

`.orbax` checkpoints keep their OCDBT nodes and zarr chunks as zstd frames
(`ocdbt.py`, `orbax_format.py`). The port uses no zstd library: frames are
decoded by `mico_tpu_torch/csrc/zstd_decode.cpp` (RFC 8878, written by
hand), which `g++` builds at first use (`ops/_build.build_host`) and ctypes
loads; a ctypes call releases the GIL. Writing needs no encoder: a frame of
stored (Raw) blocks is a valid zstd frame that every decoder reads, and
`frame_stored` makes one. A malformed, truncated or corrupted frame raises
`IOError` naming what was read.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
from typing import Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch

BLOCK_MAX = 128 * 1024          # a zstd block's largest size
ALLOC_LIMIT = 1 << 34           # the most a frame of unknown size gives
_MAGIC = b"\x28\xb5\x2f\xfd"
# frame header of `frame_stored`: content size in 8 bytes (FCS flag 3), not
# single-segment, window 2^17 (a block's 128 KiB), no checksum, no dictionary
_HEADER = _MAGIC + bytes([0xC0, 7 << 3])

_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from mico_tpu_torch.ops import _build

    lib = _build.load_host("zstd_decode")
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.mico_zstd_decompress_alloc.argtypes = [
        vp, size_t, size_t, ctypes.POINTER(_U8P), ctypes.POINTER(size_t)]
    lib.mico_zstd_decompress_alloc.restype = ctypes.c_int
    lib.mico_zstd_free.argtypes = [_U8P]
    lib.mico_zstd_decompress_many.argtypes = [
        ctypes.c_int, ctypes.POINTER(vp), ctypes.POINTER(size_t),
        ctypes.POINTER(vp), ctypes.POINTER(size_t), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, size_t]
    lib.mico_zstd_decompress_many.restype = ctypes.c_int
    lib.mico_zstd_error.argtypes = []
    lib.mico_zstd_error.restype = ctypes.c_char_p
    lib.mico_crc32c.argtypes = [vp, size_t, ctypes.c_uint32]
    lib.mico_crc32c.restype = ctypes.c_uint32
    return lib


def _source(data) -> Tuple[int, int, object]:
    """(address, length, owner) of a bytes-like object, read only."""
    a = (np.frombuffer(data, dtype=np.uint8) if len(data)
         else np.zeros(1, np.uint8))
    return a.ctypes.data, len(data), a


def _destination(out) -> Tuple[int, int]:
    """(address, bytes) of a writable C-contiguous numpy array or CPU
    tensor."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("decompress_into takes a contiguous CPU tensor")
        return out.data_ptr(), out.numel() * out.element_size()
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("decompress_into takes a writable C-contiguous array")
    return out.ctypes.data, out.nbytes


def _raise(what: str, message: str):
    raise IOError(f"{what}: {message}" if what else message)


def decompress(data, expected_size: int = None, what: str = "") -> bytes:
    """The bytes of every frame in `data` (concatenated; skippable frames
    skipped). With `expected_size`, anything else decoded raises."""
    if expected_size is not None:
        out = np.empty(int(expected_size), np.uint8)
        decompress_many([(data, out)], threads=1, what=[what])
        return out.tobytes()
    lib = _lib()
    src, n, keep = _source(data)
    buf, size = _U8P(), ctypes.c_size_t()
    rc = lib.mico_zstd_decompress_alloc(src, n, ALLOC_LIMIT,
                                        ctypes.byref(buf), ctypes.byref(size))
    del keep
    if rc:
        _raise(what, lib.mico_zstd_error().decode())
    try:
        return ctypes.string_at(buf, size.value) if size.value else b""
    finally:
        lib.mico_zstd_free(buf)


def decompress_into(data, out, what: str = "") -> None:
    """Decode `data` straight into `out` (a numpy array or a CPU tensor,
    pinned or not), which it must fill exactly."""
    decompress_many([(data, out)], threads=1, what=[what])


def decompress_many(jobs: Sequence[tuple], threads: int = None,
                    what: Sequence[str] = None) -> None:
    """Each (data, out) of `jobs` decoded into its `out`, which it must fill
    exactly, on a pool of `threads` host threads (default: the host's
    cores). `what[i]` names job i in an error."""
    if not jobs:
        return
    lib = _lib()
    n = len(jobs)
    srcs, src_lens = (ctypes.c_void_p * n)(), (ctypes.c_size_t * n)()
    dsts, dst_lens = (ctypes.c_void_p * n)(), (ctypes.c_size_t * n)()
    keep = []
    for i, (data, out) in enumerate(jobs):
        src, size, owner = _source(data)
        keep.append(owner)
        srcs[i], src_lens[i] = src, size
        dsts[i], dst_lens[i] = _destination(out)
    threads = min(n, threads or os.cpu_count() or 1)
    failed, err = ctypes.c_int(-1), ctypes.create_string_buffer(512)
    rc = lib.mico_zstd_decompress_many(n, srcs, src_lens, dsts, dst_lens,
                                       threads, ctypes.byref(failed), err,
                                       len(err))
    if rc:
        i = failed.value
        _raise(what[i] if what else f"chunk {i}", err.value.decode())


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of `data`, continuing from `crc`."""
    src, n, keep = _source(data)
    return int(_lib().mico_crc32c(src, n, crc))


def stored_parts(pieces: Iterable, total: int) -> Iterator[bytes]:
    """A zstd frame of `total` bytes, given as `pieces` (bytes-like, in
    order), as the header and each Raw block's header and bytes: the file
    form of `frame_stored`, written as the pieces arrive."""
    yield _HEADER + struct.pack("<Q", total)
    done = 0
    for piece in pieces:
        view = memoryview(piece).cast("B")
        for at in range(0, len(view), BLOCK_MAX):
            block = view[at:at + BLOCK_MAX]
            done += len(block)
            if done > total:
                raise ValueError(f"stored frame: more than {total} bytes")
            yield struct.pack("<I", (len(block) << 3) | (done == total))[:3]
            yield block
    if done != total:
        raise ValueError(f"stored frame: {done} of {total} bytes")
    if total == 0:
        yield b"\x01\x00\x00"          # one empty last block


def stored_size(lengths: Iterable[int]) -> int:
    """The bytes of `stored_parts` over pieces of these lengths."""
    lengths = list(lengths)
    blocks = sum(-(-n // BLOCK_MAX) for n in lengths) or 1
    return len(_HEADER) + 8 + 3 * blocks + sum(lengths)


def frame_stored(data) -> bytes:
    """`data` as one zstd frame of Raw blocks of at most 128 KiB, with its
    content size: what any zstd decoder reads back as `data`."""
    return b"".join(bytes(p) for p in stored_parts([data], len(data)))
