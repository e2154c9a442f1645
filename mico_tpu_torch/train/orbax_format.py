"""`.orbax` checkpoints: zarr v2 arrays on an OCDBT store and orbax's
tree metadata, read and written without orbax, tensorstore or JAX.

What orbax 0.11's `StandardCheckpointHandler` writes (and `write_tree`
writes the same way):

  - `_METADATA` (JSON): `tree_metadata`, one entry per leaf keyed by the
    repr of its key tuple, with `key_metadata` (each key and its
    `key_type`: 1 a sequence index, 2 a dict key) and `value_metadata`;
    `use_ocdbt` true, `use_zarr3` false.
  - `_CHECKPOINT_METADATA`, `_sharding` (each leaf's sharding, keyed by the
    base64 of its name) and `array_metadatas/process_0` (JSON). The port
    writes no `_sharding`: a sharding names devices of the host that wrote
    it, and JAX's restore without a target refuses a device it does not
    have ("Device ... was not found in jax.local_devices()"), while without
    the file it restores host arrays on any host.
  - An OCDBT database (`ocdbt.py`) whose keys are `<name>/.zarray` (the
    array's zarr v2 metadata) and `<name>/<i>.<j>...` (a chunk; `0` for a
    scalar), where `<name>` joins the leaf's keys with ".". Each chunk is a
    whole chunk (edge chunks padded) in one zstd frame.

`Checkpoint(path).read(name, region)` decodes only the chunks that overlap
`region`, on the host's threads, and a chunk that lies whole in the
output is decoded straight into it. bfloat16 comes back as
`torch.bfloat16`, through a uint16 view.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import time
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from mico_tpu_torch.train import ocdbt, zstd

TMP_SUFFIX = ".orbax-checkpoint-tmp"    # orbax's atomicity.TMP_DIR_SUFFIX
CHUNK_BYTES = 64 << 20      # the largest chunk `write_tree` writes (dim 0 cut)
ZSTD_COMPRESSOR = {"id": "zstd", "level": 1}
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")

# zarr v2 dtype -> (numpy storage dtype, torch dtype)
DTYPES = {
    "<f4": (np.float32, torch.float32),
    "<f2": (np.float16, torch.float16),
    "bfloat16": (np.uint16, torch.bfloat16),
    "<i4": (np.int32, torch.int32),
    "<i8": (np.int64, torch.int64),
    "<u4": (np.uint32, torch.uint32),
    "|b1": (np.bool_, torch.bool),
}
TORCH_DTYPES = {t: z for z, (_, t) in DTYPES.items()}


class ZArray:
    """A `.zarray` the reader accepts: C order, no filters, no compressor
    or zstd, the "." separator and a dtype of `DTYPES`; anything else
    raises naming the key."""

    def __init__(self, name: str, key: str, raw: bytes):
        try:
            meta = json.loads(bytes(raw))
        except ValueError as e:
            raise IOError(f"{key}: not JSON ({e})") from None

        def need(cond, what):
            if not cond:
                raise IOError(f"{key}: {what} is not read by the port")

        need(meta.get("zarr_format") == 2,
             f"zarr_format {meta.get('zarr_format')}")
        need(meta.get("order", "C") == "C", f"order {meta.get('order')}")
        need(not meta.get("filters"), f"filters {meta.get('filters')}")
        need(meta.get("dimension_separator", ".") == ".",
             f"dimension_separator {meta.get('dimension_separator')}")
        comp = meta.get("compressor")
        need(comp is None or comp.get("id") == "zstd", f"compressor {comp}")
        need(meta.get("dtype") in DTYPES, f"dtype {meta.get('dtype')}")
        self.name, self.key = name, key
        self.shape = tuple(int(n) for n in meta["shape"])
        self.chunks = tuple(int(n) for n in meta["chunks"])
        need(len(self.chunks) == len(self.shape) and all(self.chunks),
             f"chunks {self.chunks} of shape {self.shape}")
        self.dtype = meta["dtype"]
        self.np_dtype = np.dtype(DTYPES[self.dtype][0])
        self.torch_dtype = DTYPES[self.dtype][1]
        self.compressed = comp is not None
        fill = meta.get("fill_value")
        self.fill = 0 if fill is None else (
            float(fill) if isinstance(fill, str) else fill)
        self.chunk_bytes = math.prod(self.chunks) * self.np_dtype.itemsize

    def grid(self) -> Tuple[int, ...]:
        return tuple(-(-n // c) for n, c in zip(self.shape, self.chunks))


def _box(region, shape) -> Tuple[Tuple[int, int], ...]:
    """A region (None, or a tuple of slices with step 1, one a dimension)
    as (start, stop) pairs inside `shape`."""
    if region is None:
        return tuple((0, n) for n in shape)
    if len(region) != len(shape):
        raise ValueError(f"region {region} for shape {shape}")
    out = []
    for s, n in zip(region, shape):
        start, stop, step = s.indices(n)
        if step != 1 or stop < start:
            raise ValueError(f"region {region}: slices of step 1 only")
        out.append((start, stop))
    return tuple(out)


class Checkpoint:
    """An `.orbax` directory, opened for reading. `names()` are its leaves'
    names ("a.b.0.c"), `keys_of(name)` their key paths, `read(name,
    region)` an array. `decoded` lists every chunk key decoded, in order:
    the read counter that shows a region read touched only its chunks."""

    def __init__(self, path: str):
        self.path = path
        try:
            with open(os.path.join(path, "_METADATA")) as f:
                meta = json.load(f)
        except FileNotFoundError:
            raise IOError(f"{path}: no _METADATA (not an orbax "
                          f"checkpoint)") from None
        if not meta.get("use_ocdbt", False):
            raise IOError(f"{path}: not an OCDBT checkpoint "
                          f"(use_ocdbt false is not read by the port)")
        if meta.get("use_zarr3", False):
            raise IOError(f"{path}: zarr v3 arrays are not read by the port")
        self._keys: Dict[str, Tuple] = {}
        for entry in meta["tree_metadata"].values():
            keys = tuple((k["key"], int(k["key_type"]))
                         for k in entry["key_metadata"])
            self._keys[".".join(k for k, _ in keys)] = keys
        self.store = ocdbt.Reader(path)
        self._arrays: Dict[str, ZArray] = {}
        self.decoded: List[str] = []

    def names(self) -> List[str]:
        return list(self._keys)

    def keys_of(self, name: str) -> Tuple:
        """((key, key_type), ...) of a leaf: key_type 1 a sequence index,
        2 a dict key."""
        return self._keys[name]

    def array(self, name: str) -> ZArray:
        if name not in self._arrays:
            key = f"{name}/.zarray"
            if key not in self.store:
                raise IOError(f"{self.path}: no array {key}")
            self._arrays[name] = ZArray(name, f"{self.path}/{key}",
                                        self.store.get(key))
        return self._arrays[name]

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.array(name).shape

    def read(self, name: str, region=None) -> torch.Tensor:
        """The leaf `name`, or its `region` (slices of step 1), as a CPU
        tensor. Only the chunks that overlap the region are decoded, on the
        host's threads; a chunk that lies whole in the output is decoded
        straight into it."""
        a = self.array(name)
        box = _box(region, a.shape)
        shape = tuple(e - s for s, e in box)
        out = torch.empty(shape, dtype=a.torch_dtype)
        host = out.view(torch.int16).numpy().view(np.uint16) if (
            a.torch_dtype == torch.bfloat16) else out.numpy()
        if 0 in shape:
            return out
        grid = itertools.product(*(range(s // c, -(-e // c))
                                   for (s, e), c in zip(box, a.chunks)))
        self._chunks(a, list(grid), host, box)
        return out

    def _chunks(self, a: ZArray, chunks: list, host: np.ndarray,
                box) -> None:
        """Decode the chunks (grid indices) into `host`, the region `box`."""
        keys = [f"{a.name}/{'.'.join(map(str, c)) if c else '0'}"
                for c in chunks]
        values = self.store.get_many([k for k in keys if k in self.store])
        jobs, what, copies = [], [], []
        flat = host.reshape(-1)
        row = math.prod(host.shape[1:])
        for c, key in zip(chunks, keys):
            lo = [i * n for i, n in zip(c, a.chunks)]
            hi = [min(l + n, s) for l, n, s in zip(lo, a.chunks, a.shape)]
            inter = [(max(l, bs), min(h, be))
                     for l, h, (bs, be) in zip(lo, hi, box)]
            dst = tuple(slice(s - bs, e - bs)
                        for (s, e), (bs, _) in zip(inter, box))
            if key not in values:                   # never written: fill
                host[dst] = a.fill
                continue
            self.decoded.append(key)
            # whole (not an edge chunk), whole in the region, and as wide
            # as the region: its bytes are rows of the output
            direct = host.ndim == 0 or (
                all(h - l == n for l, h, n in zip(lo, hi, a.chunks))
                and inter[0] == (lo[0], hi[0])
                and all(b == (l, h) for b, l, h in zip(box[1:], lo[1:],
                                                      hi[1:])))
            if direct:
                start = (lo[0] - box[0][0]) * row if host.ndim else 0
                n = a.chunk_bytes // a.np_dtype.itemsize
                target = flat[start:start + n]
            else:
                target = np.empty(a.chunks, a.np_dtype)
                copies.append((dst, target,
                               tuple(slice(s - l, e - l) for (s, e), l in
                                     zip(inter, lo))))
            jobs.append((values[key], target.reshape(-1).view(np.uint8)))
            what.append(f"{self.path}/{key}")
        if not a.compressed:
            for (data, dst), w in zip(jobs, what):
                if len(data) != dst.nbytes:
                    raise IOError(f"{w}: {len(data)} bytes, a chunk has "
                                  f"{dst.nbytes}")
                dst[:] = np.frombuffer(data, np.uint8)
        else:
            zstd.decompress_many(jobs, what=what)
        for dst, chunk, src in copies:
            host[dst] = chunk[src]


def unflatten(items: Sequence[Tuple[Tuple, object]]):
    """Nested dicts and lists from ((key, key_type), ...) paths and their
    values."""
    root: Dict = {}
    for keys, value in items:
        node = root
        for k, _ in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1][0]] = value

    def fix(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v, path + (k,)) for k, v in node.items()}
        if types.get(path) == 1:
            return [out[k] for k in sorted(out, key=int)]
        return out

    types: Dict[Tuple, int] = {}
    for keys, _ in items:
        for i, (k, t) in enumerate(keys):
            types[tuple(x for x, _ in keys[:i])] = t
    return fix(root, ())


def load_tree(path: str):
    """The whole tree of an `.orbax` checkpoint: nested dicts, and lists
    where a key is a sequence index, of CPU tensors."""
    ckpt = Checkpoint(path)
    items = [(ckpt.keys_of(n), ckpt.read(n)) for n in ckpt.names()]
    return unflatten(items)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _tensor_bytes(t: torch.Tensor) -> memoryview:
    """A tensor's bytes in host memory, in its own dtype."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return memoryview(t.numpy()).cast("B")


def _sort_key(keys: Tuple) -> Tuple:
    """JAX's flattening order: dict keys as strings, indices as numbers."""
    return tuple((0, int(k), "") if t == 1 else (1, 0, str(k))
                 for k, t in keys)


def chunk_rows(shape: Sequence[int], itemsize: int, stacked: bool) -> int:
    """Rows of dim 0 a chunk holds: one for a leaf stacked over depth (a
    block's row, so a pipeline stage decodes only its own blocks), else as
    many as fit in `CHUNK_BYTES`."""
    if not shape:
        return 0
    if stacked:
        return 1
    row = math.prod(shape[1:]) * itemsize
    return max(1, min(shape[0], CHUNK_BYTES // max(row, 1)))


def write_tree(path: str, leaves: Iterable[Tuple[Tuple, list, bool]]) -> str:
    """Write the `.orbax` checkpoint of `path` as orbax 0.11 writes one
    (without `_sharding`), a leaf at a time, into
    `<path>.orbax-checkpoint-tmp` (orbax's name of an uncommitted save,
    which resume skips); → that directory, which the caller renames into
    place (`checkpoints.ModelSaver`). `leaves` gives (keys, rows,
    stacked): keys ((key, key_type), ...), rows the leaf's tensors
    (stacked on a new dim 0 when `stacked`, else one tensor), each leaf in
    its own dtype. Chunks cut dim 0 (`chunk_rows`) and are stored zstd
    frames."""
    tmp = path + TMP_SUFFIX
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    t0 = time.time_ns()
    store = ocdbt.Writer(tmp)
    entries = []
    try:
        for keys, rows, stacked in leaves:
            name = ".".join(str(k) for k, _ in keys)
            first = rows[0]
            if first.dtype not in TORCH_DTYPES:
                raise ValueError(f"{name}: dtype {first.dtype} has no zarr "
                                 f"dtype here")
            shape = ((len(rows),) if stacked else ()) + tuple(first.shape)
            itemsize = first.element_size()
            per = chunk_rows(shape, itemsize, stacked)
            chunks = (per,) + shape[1:] if shape else ()
            zarray = {"chunks": list(chunks), "compressor": ZSTD_COMPRESSOR,
                      "dimension_separator": ".",
                      "dtype": TORCH_DTYPES[first.dtype], "fill_value": None,
                      "filters": None, "order": "C", "shape": list(shape),
                      "zarr_format": 2}
            store.put(f"{name}/.zarray", json.dumps(
                zarray, sort_keys=True, separators=(",", ":")).encode())
            _write_chunks(store, name, rows, stacked, shape, per, itemsize)
            entries.append((keys, name, list(chunks)))
        store.commit()
        entries.sort(key=lambda e: _sort_key(e[0]))
        meta = {"tree_metadata": {
            repr(tuple(str(k) for k, _ in keys)): {
                "key_metadata": [{"key": str(k), "key_type": t}
                                 for k, t in keys],
                "value_metadata": {"value_type": "jax.Array",
                                   "skip_deserialize": False,
                                   "write_shape": chunks}}
            for keys, _, chunks in entries},
            "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
        _write_json(tmp, "_METADATA", meta)
        os.makedirs(os.path.join(tmp, "array_metadatas"))
        _write_json(tmp, "array_metadatas/process_0", {"array_metadatas": [
            {"array_metadata": {"param_name": name, "write_shape": chunks,
                                "chunk_shape": chunks, "ext_metadata": None}}
            for _, name, chunks in entries]})
        _write_json(tmp, "_CHECKPOINT_METADATA", {
            "item_handlers": HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": t0,
            "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})
    except BaseException:
        store.abort()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return tmp


def _write_json(root: str, name: str, obj) -> None:
    with open(os.path.join(root, name), "w") as f:
        json.dump(obj, f)


def _write_chunks(store: ocdbt.Writer, name: str, rows: list, stacked: bool,
                  shape: Tuple, per: int, itemsize: int) -> None:
    """Each chunk of a leaf as one stored zstd frame, from the rows as they
    reach the host (an edge chunk padded with zeros to its whole shape)."""
    if not shape:
        data = _tensor_bytes(rows[0])
        store.put_parts(f"{name}/0", zstd.stored_parts([data], len(data)),
                        zstd.stored_size([len(data)]))
        return
    row_bytes = math.prod(shape[1:]) * itemsize
    size = per * row_bytes
    for c in range(-(-shape[0] // per)) if shape[0] else []:
        lo, hi = c * per, min((c + 1) * per, shape[0])
        if stacked:
            pieces = [_tensor_bytes(r) for r in rows[lo:hi]]
        else:
            pieces = [_tensor_bytes(rows[0][lo:hi])]
        pad = size - (hi - lo) * row_bytes
        if pad:
            pieces.append(bytes(pad))
        key = f"{name}/{'.'.join(['%d' % c] + ['0'] * (len(shape) - 1))}"
        store.put_parts(key, zstd.stored_parts(pieces, size),
                        zstd.stored_size(len(memoryview(p).cast("B"))
                                         for p in pieces))
