"""OCDBT key-value databases on a local directory, read and written in
plain Python (the store under an `.orbax` checkpoint; `orbax_format.py`
keeps its zarr arrays in it).

The layout is tensorstore's OCDBT format as orbax 0.11 writes it:

  - Every file (the manifest, a b-tree node) is an envelope: a 4-byte magic
    (big-endian; `0c db 3a 2a` manifest, `0c db 20 de` b-tree node), the
    file's length as uint64 LE, varints for the format version (0) and the
    body's compression (0 none, 1 zstd), the body, then CRC-32C (LE) of all
    that precedes it. Nodes may sit at an offset inside a data file.
  - The manifest (`manifest.ocdbt`) holds the config (uuid, manifest kind,
    max inline value bytes, max decoded node bytes, version tree arity,
    compression and its zstd level as int32 LE), a data file table, the
    newest versions inline (generation, root height, root location, key
    count, tree bytes, indirect bytes, commit time) and references to
    version-tree nodes for older ones. The newest version is always inline.
  - A data file table is varint-coded: the count, each path's prefix shared
    with the previous path, each suffix's length, each base path's length,
    then the suffixes. A file is `<base path><relative path>` under the
    database's directory (a merged orbax database names the per-process
    databases' files, `ocdbt.process_<i>/d/<id>`).
  - A b-tree node holds its height, a data file table and its entries'
    keys prefix-compressed (shared prefix lengths, suffix lengths, under an
    interior node each child's common prefix length, then the suffixes).
    A leaf gives each value's length and kind (0 inline, 1 indirect), the
    indirect values' file ids then offsets, then the inline bytes. An
    interior node gives each child's file id, offset, length, key count,
    tree bytes and indirect bytes; a child's keys omit its common prefix.

Varints are LEB128. A file whose envelope, CRC or structure is wrong raises
`IOError` naming it. `Writer` writes a one-version database (one leaf node,
values above the inline limit in one data file) that tensorstore reads.
"""

from __future__ import annotations

import mmap
import os
import queue
import struct
import threading
import time
import uuid as _uuid
from typing import Dict, Iterable, List, Sequence

from mico_tpu_torch.train import zstd

MANIFEST = "manifest.ocdbt"
MAGIC_MANIFEST = 0x0CDB3A2A
MAGIC_NODE = 0x0CDB20DE
MAX_INLINE = 1024               # orbax's max_inline_value_bytes
MAX_NODE_BYTES = 100_000_000    # orbax's max_decoded_node_bytes
# pieces gathered into one writev: a network filesystem (the card machine's
# is 9p) pays a round trip a call, and a stored zstd frame is a 3-byte
# header before every 128 KiB block
_IOV_MAX = min(os.sysconf("SC_IOV_MAX"), 1024) if hasattr(
    os, "sysconf") else 1024
_BATCH_BYTES = 64 << 20
_MISSING = (1 << 64) - 1        # an empty tree's root offset and length


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


class _Reader:
    """A cursor over a decoded body; running past its end raises."""

    def __init__(self, data: bytes, what: str):
        self.data, self.at, self.what = data, 0, what

    def fail(self, msg: str):
        raise IOError(f"{self.what}: {msg}")

    def raw(self, n: int) -> bytes:
        if n < 0 or self.at + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def u8(self) -> int:
        return self.raw(1)[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            byte = self.u8()
            v |= (byte & 0x7F) << shift
            if byte < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("a varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def unwrap(data: bytes, magic: int, what: str) -> bytes:
    """An envelope's body, decompressed, after its magic, length and CRC-32C
    are checked."""
    if len(data) < 17:
        raise IOError(f"{what}: too short for an OCDBT file")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise IOError(f"{what}: magic {got:08x}, expected {magic:08x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise IOError(f"{what}: its header says {length} bytes, it has "
                      f"{len(data)}")
    crc = struct.unpack("<I", data[-4:])[0]
    if zstd.crc32c(memoryview(data)[:-4]) != crc:
        raise IOError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.at = 12
    version, method = r.varint(), r.varint()
    if version != 0:
        raise IOError(f"{what}: OCDBT format version {version}")
    body = data[r.at:-4]
    if method == 0:
        return bytes(body)
    if method == 1:
        return zstd.decompress(body, what=what)
    raise IOError(f"{what}: compression method {method}")


def wrap(body: bytes, magic: int) -> bytes:
    """`body` in an uncompressed envelope."""
    head = _varint(0) + _varint(0)
    length = 4 + 8 + len(head) + len(body) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return data + struct.pack("<I", zstd.crc32c(data))


def _file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix, base = r.varints(n), r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base[i] > prefix[i] + suffix[i]:
            r.fail("a malformed data file table")
        prev = prev[:prefix[i]] + r.raw(suffix[i])
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, interior: bool):
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("a malformed key")
        prev = prev[:prefix[i]] + r.raw(suffix[i])
        keys.append(prev)
    return keys, common


class Reader:
    """The newest version of the database under `root`: `keys()`,
    `get(key)`, `get_many(keys)`. The b-tree is walked once, when opened;
    values are read when asked for."""

    def __init__(self, root: str):
        self.root = root
        what = os.path.join(root, MANIFEST)
        try:
            with open(what, "rb") as f:
                body = unwrap(f.read(), MAGIC_MANIFEST, what)
        except FileNotFoundError:
            raise IOError(f"{what}: no OCDBT manifest") from None
        r = _Reader(body, what)
        r.raw(16)                                   # the database's uuid
        kind = r.varint()
        if kind != 0:
            r.fail("a numbered manifest (only the single kind is read)")
        self.max_inline = r.varint()
        r.varint()                                  # max decoded node bytes
        r.u8()                                      # version tree arity log2
        if r.varint() == 1:
            r.raw(4)                                # the zstd level
        files = _file_table(r)
        n = r.varint()
        if n == 0:
            r.fail("no version")
        generation = r.varints(n)
        height = [r.u8() for _ in range(n)]
        fid, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                            # counts and byte totals
        r.raw(8 * n)                                # commit times
        newest = max(range(n), key=lambda i: generation[i])
        self.generation = generation[newest]
        # value locations: key -> bytes (inline) or (path, offset, length)
        self._values: Dict[bytes, object] = {}
        if offset[newest] != _MISSING:
            self._node(self._path(files, fid[newest], r), offset[newest],
                       length[newest], height[newest], b"")

    def _path(self, files, i, r) -> str:
        if i >= len(files):
            r.fail(f"data file id {i} of {len(files)}")
        return os.path.join(self.root, files[i])

    def _node(self, path: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{path} @ {offset}"
        with open(path, "rb") as f:
            f.seek(offset)
            body = unwrap(f.read(length), MAGIC_NODE, what)
        r = _Reader(body, what)
        if r.u8() != height:
            r.fail("its height differs from its parent's record")
        files = _file_table(r)
        keys, common = _keys(r, interior=height > 0)
        n = len(keys)
        if height == 0:
            size = r.varints(n)
            kind = [r.u8() for _ in range(n)]
            ind = [i for i in range(n) if kind[i] == 1]
            if any(k > 1 for k in kind):
                r.fail("a value kind other than inline or indirect")
            fid, off = r.varints(len(ind)), r.varints(len(ind))
            for j, i in enumerate(ind):
                self._values[prefix + keys[i]] = (
                    self._path(files, fid[j], r), off[j], size[i])
            for i in range(n):
                if kind[i] == 0:
                    self._values[prefix + keys[i]] = r.raw(size[i])
        else:
            fid, off, length_ = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)
            children = [(self._path(files, fid[i], r), off[i], length_[i],
                         prefix + keys[i][:common[i]]) for i in range(n)]
        if r.at != len(body):
            r.fail(f"{len(body) - r.at} bytes after its entries")
        if height > 0:
            for path_, off_, len_, pre in children:
                self._node(path_, off_, len_, height - 1, pre)

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def get(self, key: str) -> bytes:
        return bytes(self.get_many([key])[key])

    def get_many(self, keys: Sequence[str]) -> Dict[str, memoryview]:
        """{key: its value}: inline values as they are, indirect ones as
        memoryviews of a read-only map of their data file (each file is
        mapped once, whatever the number of values in it)."""
        out, by_file = {}, {}
        for k in keys:
            v = self._values.get(k.encode())
            if v is None:
                raise KeyError(f"{self.root}: no key {k!r}")
            if isinstance(v, tuple):
                by_file.setdefault(v[0], []).append((k, v[1], v[2]))
            else:
                out[k] = memoryview(v)
        for path, spans in by_file.items():
            with open(path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                      if size else b"")
            view = memoryview(mm)
            for k, off, n in spans:
                if off + n > size:
                    raise IOError(f"{path}: value {k!r} at {off}+{n} runs "
                                  f"past the file's {size} bytes")
                out[k] = view[off:off + n]
        return out


def _table_bytes(paths: Sequence[str]) -> bytes:
    out = [_varint(len(paths))]
    prev = b""
    enc = [p.encode() for p in paths]
    shared = []
    for p in enc:
        n = 0
        while n < min(len(p), len(prev)) and p[n] == prev[n]:
            n += 1
        shared.append(n)
        prev = p
    out += [_varint(n) for n in shared[1:]]
    out += [_varint(len(p) - n) for p, n in zip(enc, shared)]
    out += [_varint(0) for _ in enc]                  # base paths: none
    out += [p[n:] for p, n in zip(enc, shared)]
    return b"".join(out)


def _key_bytes(keys: Sequence[bytes]) -> bytes:
    shared, prev = [], b""
    for k in keys:
        n = 0
        while n < min(len(k), len(prev)) and k[n] == prev[n]:
            n += 1
        shared.append(n)
        prev = k
    return b"".join([_varint(len(keys))]
                    + [_varint(n) for n in shared[1:]]
                    + [_varint(len(k) - n) for k, n in zip(keys, shared)]
                    + [k[n:] for k, n in zip(keys, shared)])


class Writer:
    """A new one-version database under `root` (which must not hold one):
    `put(key, value)` or `put_parts(key, parts, size)` for each key, then
    `commit()`. Values above `MAX_INLINE` bytes go, in the order given, to
    one data file (`d/<id>`) that a writer thread fills while the caller
    makes the next value; the b-tree is one leaf node in a file of its own,
    and the manifest is written last. Bodies are stored uncompressed
    (envelope compression 0, which tensorstore reads)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "d"), exist_ok=True)
        self._data_name = f"d/{_uuid.uuid4().hex}"
        self._data = open(os.path.join(root, self._data_name), "wb",
                          buffering=0)
        self._size = 0
        self._values: Dict[bytes, object] = {}
        self._work: "queue.Queue" = queue.Queue(maxsize=2)
        self._failed: List[BaseException] = []
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        """The writer thread: each queued value's pieces into the data file,
        in order; after a failure it only empties the queue."""
        while True:
            item = self._work.get()
            if item is None:
                return
            if self._failed:
                continue
            key, parts, size = item
            try:
                n, batch, nbytes = 0, [], 0
                for p in parts:
                    batch.append(p)
                    nbytes += len(p)
                    if len(batch) == _IOV_MAX or nbytes >= _BATCH_BYTES:
                        n += self._writev(batch)
                        batch, nbytes = [], 0
                n += self._writev(batch)
                if n != size:
                    raise ValueError(f"{key}: {n} bytes, said {size}")
            except BaseException as e:  # noqa: BLE001 — raised by the caller
                self._failed.append(e)

    def _writev(self, pieces: list) -> int:
        """All of `pieces`, in order, in as few system calls as the kernel
        takes; → their bytes."""
        views = [memoryview(p).cast("B") for p in pieces if len(p)]
        total = sum(len(v) for v in views)
        fd = self._data.fileno()
        while views:
            done = os.writev(fd, views)
            while views and done >= len(views[0]):
                done -= len(views[0])
                views.pop(0)
            if views and done:
                views[0] = views[0][done:]
        return total

    def _join(self) -> None:
        if self._thread.is_alive():
            self._work.put(None)
            self._thread.join()
        self._data.close()

    def put(self, key: str, value: bytes) -> None:
        self.put_parts(key, [value], len(value))

    def put_parts(self, key: str, parts: Iterable, size: int) -> None:
        """The value of `key` given as byte pieces of `size` bytes in all,
        written to the data file as they come (inline when small)."""
        k = key.encode()
        if k in self._values:
            raise KeyError(f"{self.root}: key {key!r} written twice")
        if size <= MAX_INLINE:
            value = b"".join(bytes(p) for p in parts)
            if len(value) != size:
                raise ValueError(f"{key}: {len(value)} bytes, said {size}")
            self._values[k] = value
            return
        if self._failed:
            raise self._failed[0]
        self._values[k] = (self._size, size)
        self._size += size
        self._work.put((key, parts, size))

    def commit(self) -> None:
        self._join()
        if self._failed:
            raise self._failed[0]
        keys = sorted(self._values)
        files = [self._data_name]
        inline = [self._values[k] for k in keys
                  if not isinstance(self._values[k], tuple)]
        indirect = [self._values[k] for k in keys
                    if isinstance(self._values[k], tuple)]
        sizes = [len(v) if not isinstance(v, tuple) else v[1]
                 for v in (self._values[k] for k in keys)]
        body = b"".join(
            [bytes([0]), _table_bytes(files), _key_bytes(keys)]
            + [_varint(s) for s in sizes]
            + [bytes([isinstance(self._values[k], tuple)]) for k in keys]
            + [_varint(0) for _ in indirect]
            + [_varint(off) for off, _ in indirect] + inline)
        if len(body) > MAX_NODE_BYTES:
            raise ValueError(f"{self.root}: a b-tree node of {len(body)} "
                             f"bytes (at most {MAX_NODE_BYTES})")
        node = wrap(body, MAGIC_NODE)
        node_name = f"d/{_uuid.uuid4().hex}"
        with open(os.path.join(self.root, node_name), "wb") as f:
            f.write(node)
        config = (_uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE)
                  + _varint(MAX_NODE_BYTES) + bytes([4]) + _varint(0))
        version = b"".join([
            _varint(1), _varint(1), bytes([0]),     # one version, generation 1
            _varint(0), _varint(0), _varint(len(node)),     # its root node
            _varint(len(keys)), _varint(len(node)),
            _varint(sum(n for _, n in indirect)),
            struct.pack("<Q", time.time_ns()),
            _varint(0)])                            # no version-tree nodes
        manifest = wrap(config + _table_bytes([node_name]) + version,
                        MAGIC_MANIFEST)
        with open(os.path.join(self.root, MANIFEST), "wb") as f:
            f.write(manifest)

    def abort(self) -> None:
        self._join()
