"""Checkpoint save, resume and load (counterpart of
`mico_tpu/train/checkpoints.py`).

Save side (`ModelSaver`, the reference contract data/utils/save.py:9-41,
build_model.py:106-124): `ckpt/model_step_N.npz` (+ the optimizer's
`optimizer_step_N.npz`) under the output dir, `best_<metric>.npz`
snapshots, and resume from the newest committed step.
  - The model file is the JAX package's flat npz layout (`flatten_pytree`:
    `a/b/c` keys, the depth axis stacked, fp32), so either package reads
    the other's model files. It is written leaf by leaf from the card (one
    block's rows at a time), never as a whole host copy.
  - `backend="orbax"` writes `.orbax` directories instead, as JAX's orbax
    backend does (`orbax_format.py`: zarr arrays on an OCDBT store, each
    leaf in its own dtype), which JAX's `load_checkpoint_path`,
    `load_latest_opt_state` and `resume_latest_sharded` read.
  - A save writes `<name>-tmp` (a `.orbax` directory
    `<name>.orbax-checkpoint-tmp`, orbax's name), renames it into place to
    commit, and only then deletes the previous step's files; the JAX
    package deletes first (`checkpoints.py:142-151`), which can lose every
    committed checkpoint when a save is killed.
  - The optimizer file is the JAX package's layout too: the optax
    state's leaves by position (`{str(i): leaf}`, checkpoints.py:165-172;
    `jax_optimizer_leaves` rebuilds their order from the parameter names):
    the update counts, AdamW's μ and ν per group with the depth axis
    stacked, and under `accum_steps` > 1 `optax.MultiSteps`' window (its
    running mean of the gradients). JAX's `load_latest_opt_state` reads
    it, and the port reads JAX's.
  - Across processes every rank calls `save` and rank 0 alone writes (also
    for `.orbax`, where JAX's ranks write their own shards):
    ZeRO-1's slices of the moments are gathered over the data group, a
    tensor-parallel leaf's parts over the model group, a pipeline stage's
    blocks broadcast from their stage in depth order, and an open window's
    gradients averaged over the data group, leaf by leaf, so each file is
    the one a one-process run on the global batch writes, and a run
    resumes at any (data, model) or stage count (each rank takes its part
    as it loads). A barrier puts every rank past the commit before the
    previous step is removed.

Load side (`load_from_pretrained_dir`, as the reference inference entry,
inference_demo.py:14-116, data/utils/build_model.py:65-103): `log/hps.json`
for the config, then the newest HF-trainer `checkpoint-N/pytorch_model*.bin`,
or else the newest `ckpt/model_step_N`: a PyTorch `.pt` state_dict
(converted by `models.mico.mico_from_torch`, with the legacy-key surgery,
the embedding resizes and an audit of the keys it did not read) or a
native `.npz` or `.orbax` tree. Resume fills a built model leaf by leaf
(`load_model_npz`, `load_model_orbax`); from `.orbax` each rank decodes only
the chunks of its own region: its tensor-parallel part, its ZeRO-1 slice of
the moments and its pipeline stage's blocks.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import pickle
import queue
import re
import shutil
import threading
import zipfile
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from mico_tpu_torch.config import MiCoConfig, mico_config_from_dict
from mico_tpu_torch.parallel import collectives
from mico_tpu_torch.parallel import pipeline_parallel as pp
from mico_tpu_torch.parallel.tensor_parallel import (gather_leaf, local_part,
                                                     model_axis_of, shard,
                                                     splits_of,
                                                     whole_state_dict)
from mico_tpu_torch.train import orbax_format
from mico_tpu_torch.utils.config_io import load_hps
from mico_tpu_torch.utils.logger import LOGGER

SEP = "/"
BACKENDS = ("npz", "orbax")


def unflatten_pytree(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# what a pickled numpy array may name: the array's own reconstruction
_ARRAY_PICKLE = {(m, n) for m in ("numpy.core.multiarray",
                                  "numpy._core.multiarray")
                 for n in ("_reconstruct", "scalar")} | {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer")}


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays, dicts and lists, and refuses any other
    class a pickle names (an npz member may be any pickle)."""

    def find_class(self, module, name):
        if (module, name) in _ARRAY_PICKLE:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name}: an npz member here holds numpy arrays only")


def npz_member(z, key: str):
    """A member of an open npz: its array, or, for an object member, the
    list it holds. The JAX package's `save_pytree_npz` writes a list of
    per-block dicts (a CLIP tower's blocks, an audio tower's layers, a Swin
    tower's stages with their lists of blocks) as an object array, which `np.savez` pickles and `np.load` refuses without
    `allow_pickle`; it is read here by `_ArrayUnpickler`, which builds
    nothing but arrays, dicts and lists."""
    try:
        return z[key]
    except ValueError:
        with z.zip.open(key + ".npy") as f:
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            _, _, dtype = read_header(f)
            if not dtype.hasobject:
                raise
            return _ArrayUnpickler(f).load().tolist()


def load_pytree_npz(path: str):
    with np.load(path) as z:
        return unflatten_pytree({k: npz_member(z, k) for k in z.files})


def load_checkpoint_path(path: str):
    """A native model checkpoint by extension: a `.orbax` directory (its
    leaves CPU tensors, bf16 as bf16, lists as lists) or a `.npz`."""
    if path.endswith(".orbax"):
        return orbax_format.load_tree(path)
    return load_pytree_npz(path)


def _latest_step(ckpt_dir: str, prefix: str):
    steps = []
    for p in glob.glob(os.path.join(ckpt_dir, f"{prefix}_step_*")):
        if p.endswith("-tmp"):
            # uncommitted scratch of an interrupted save, never a candidate
            continue
        m = re.search(rf"{prefix}_step_(\d+)", os.path.basename(p))
        if m:
            steps.append((int(m.group(1)), p))
    return max(steps) if steps else (None, None)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.pt`/`.bin` state_dict (unwrapping a `"state_dict"` entry), its
    tensors on the CPU. Tensor data is memory-mapped where the file's
    format allows, so it is read as the converter touches it."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except RuntimeError:            # a legacy (non-zip) file cannot be mapped
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def _hf_trainer_state_dict(pretrain_dir: str):
    """HuggingFace-trainer layout: `checkpoint-N/pytorch_model.bin`, possibly
    sharded as `pytorch_model-0000i-of-0000n.bin` (reference
    data/utils/build_model.py:65-88). The merged state dict, or None when
    the layout is absent."""
    steps = []
    for d in os.listdir(pretrain_dir) if os.path.isdir(pretrain_dir) else []:
        if d.startswith("checkpoint-") and d.split("-")[-1].isdigit():
            steps.append(int(d.split("-")[-1]))
    if not steps:
        return None
    cdir = os.path.join(pretrain_dir, f"checkpoint-{max(steps)}")
    single = os.path.join(cdir, "pytorch_model.bin")
    shards = sorted(glob.glob(os.path.join(cdir, "pytorch_model-*.bin")))
    if os.path.exists(single):
        LOGGER.info("load_from_pretrained: %s", single)
        return load_torch_state_dict(single)
    if shards:
        merged: Dict[str, torch.Tensor] = {}
        for s in shards:
            LOGGER.info("load_from_pretrained shard: %s", s)
            merged.update(load_torch_state_dict(s))
        return merged
    return None


def _fit_frame_tables(params: dict, cfg: MiCoConfig) -> MiCoConfig:
    """`cfg` with each `max_<m>_sample_num` at the length of the native
    tree's frame-embedding table. JAX places such a tree as it is and
    resizes a table to a sample's frame count when it runs
    (`mico.py:320-326`, as the port's `frame_embedding` does), so a
    captioner whose datasets give another count than the pretrained run's
    loads the table unchanged."""
    over = {}
    for m in ("vision", "audio", "depth"):
        table = params.get(f"{m}_frame_embedding")
        if table is not None:
            over[f"max_{m}_sample_num"] = int(np.shape(table)[1])
    return dataclasses.replace(cfg, **over)


def load_from_pretrained_dir(
    pretrain_dir: str,
    video_resolution: int = 224,
    config_overrides: Optional[dict] = None,
    return_modal: str = "full",
    consumed: Optional[set] = None,
) -> Tuple[dict, MiCoConfig]:
    """→ (params tree, MiCoConfig) of a released-layout directory; place
    the tree with `convert.mico_from_jax`.

    return_modal (inference_demo.py:99-112): 'full' = the whole tree;
    'uni' = just the shared vision tower's subtree; 'text' = just BERT's.
    consumed: optional set that collects the checkpoint keys the converter
    read (after the legacy remap); keys it did not read are logged as a
    warning either way."""
    from mico_tpu_torch.models.mico import mico_from_torch, remap_legacy_keys

    hps = load_hps(pretrain_dir)
    model_cfg = dict(hps.get("model_cfg", hps))
    model_cfg["vision_resolution"] = video_resolution
    if config_overrides:
        model_cfg.update(config_overrides)
    cfg = mico_config_from_dict(model_cfg)

    def finish(params):
        if return_modal == "uni":
            return params["vision_encoder"], cfg
        if return_modal == "text":
            return params["bert"], cfg
        return params, cfg

    def convert_with_audit(sd):
        read = set() if consumed is None else consumed
        params = mico_from_torch(sd, cfg, consumed=read)
        leftover = sorted(set(remap_legacy_keys(sd)) - read)
        if leftover:
            LOGGER.warning(
                "checkpoint keys NOT consumed by the converter (%d): %s%s",
                len(leftover), leftover[:8], " ..." if len(leftover) > 8 else "")
        return params

    hf_sd = _hf_trainer_state_dict(pretrain_dir)
    if hf_sd is not None:
        return finish(convert_with_audit(hf_sd))

    ckpt_dir = os.path.join(pretrain_dir, "ckpt")
    _, path = _latest_step(ckpt_dir, "model")
    if path is None:
        raise FileNotFoundError(f"no model_step_* checkpoint in {ckpt_dir}")
    LOGGER.info("load_from_pretrained: %s", path)
    if path.endswith((".npz", ".orbax")):
        params = load_checkpoint_path(path)
        cfg = _fit_frame_tables(params, cfg)
        return finish(params)
    return finish(convert_with_audit(load_torch_state_dict(path)))


# ---------------------------------------------------------------------------
# save side: streamed npz files, ModelSaver, resume
# ---------------------------------------------------------------------------

def _host_dtype(t: torch.Tensor) -> np.dtype:
    """The npz dtype of a tensor: fp32 for every floating dtype (numpy has
    no bfloat16; the widening is exact), the tensor's own otherwise."""
    if t.is_floating_point():
        return np.dtype(np.float32)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def _host_bytes(t: torch.Tensor) -> memoryview:
    """A tensor's bytes in host memory (fp32 for a floating tensor)."""
    t = t.detach()
    if t.is_floating_point():
        t = t.float()
    return memoryview(t.cpu().contiguous().numpy()).cast("B")


def write_npz(path: str, leaves: Iterable[Tuple[str, list, bool]]) -> None:
    """A `.npz` (numpy's zip of `.npy` members, uncompressed, as
    `np.savez` writes it) of (key, rows, stacked) triples: the member `key`
    is the rows stacked on a new first axis when `stacked`, else the one
    tensor of a one-element list. Each row goes from its device to
    the host on its own while a writer thread puts the previous one in the
    file, so the host holds two rows at a time."""
    work: "queue.Queue" = queue.Queue(maxsize=2)
    failed = []

    def writer():
        zf = f = None
        try:
            zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                                 allowZip64=True)
            while True:
                kind, item = work.get()
                if kind == "end":
                    break
                if failed:               # drain until the producer stops
                    continue
                try:
                    if kind == "open":
                        key, header = item
                        f = zf.open(key + ".npy", "w", force_zip64=True)
                        np.lib.format.write_array_header_2_0(f, header)
                    elif kind == "data":
                        f.write(item)
                    else:
                        f.close()
                        f = None
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    failed.append(e)
        finally:
            for handle in (f, zf):
                try:
                    if handle is not None:
                        handle.close()
                except BaseException as e:  # noqa: BLE001
                    failed.append(e)

    thread = threading.Thread(target=writer, daemon=True)
    thread.start()
    try:
        for key, rows, stacked in leaves:
            if failed:
                break
            shape = ((len(rows),) + tuple(rows[0].shape) if stacked
                     else tuple(rows[0].shape))
            work.put(("open", (key, {
                "descr": np.lib.format.dtype_to_descr(_host_dtype(rows[0])),
                "fortran_order": False, "shape": shape})))
            for r in rows:
                work.put(("data", _host_bytes(r)))
            work.put(("close", None))
    finally:
        work.put(("end", None))
        thread.join()
    if failed:
        raise failed[0]


def model_leaves(model):
    """(JAX flat key, rows, stacked) of a port model, one leaf at a time:
    the JAX package's npz layout. A model sharded over the model axis is
    gathered whole first, its fused qkv rebuilt as [q | k | v]; a staged
    model's blocks are broadcast from their stages a leaf at a time
    (collective: every rank of the model group iterates it whole)."""
    from mico_tpu_torch.convert import jax_leaves

    sd = whole_state_dict(model)
    if pp.stage_axis_of(model) is None:
        yield from jax_leaves(sd, model.cfg)
        return
    twins = pp.remote_names(model)
    names = {k: k for k in pp.whole_entries(model, sd)}
    for path, rows, stacked in jax_leaves(names, model.cfg):
        yield path, [pp.fetch(model, k, sd, twins) for k in rows], stacked


def _list_leaves(prefix: str, node):
    """(state_dict key, array) of every leaf under a pickled list member:
    list items by index and dict items by key, nested as deep as they go
    (a Swin tower's stages hold lists of blocks); None leaves skipped."""
    items = (enumerate(node) if isinstance(node, list) else node.items())
    for k, v in items:
        if isinstance(v, (list, dict)):
            yield from _list_leaves(f"{prefix}.{k}", v)
        elif v is not None:
            yield f"{prefix}.{k}", v


def load_model_npz(path: str, model) -> None:
    """Copy a model checkpoint in the JAX package's npz layout (the port's
    file, or one the JAX package wrote) into the parameters of `model`,
    leaf by leaf (cast to each parameter's dtype on its device); a staged
    model takes its stage's blocks. Raises on a leaf with no parameter, a
    parameter with no leaf, and a shape that differs."""
    sd = model.state_dict()
    remote = pp.remote_names(model)
    filled = set()
    with np.load(path) as z:
        for key in z.files:
            arr = npz_member(z, key)
            group, _, name = key.rpartition(SEP)
            stacked = _block_rows(key, model)
            if isinstance(arr, list):    # JAX's pickled list of blocks
                targets = list(_list_leaves(key.replace(SEP, "."), arr))
            elif stacked:
                targets = [(f"{group.replace(SEP, '.')}.{i}.{name}", arr[i])
                           for i in range(arr.shape[0])]
            else:
                targets = [(key.replace(SEP, "."), arr)]
            for k, a in targets:
                if k in remote:
                    continue            # another pipeline stage's block
                if k not in sd:
                    raise KeyError(f"{path}: leaf {key} has no parameter {k}")
                a = local_part(model, k, torch.from_numpy(np.asarray(a)))
                if tuple(sd[k].shape) != tuple(a.shape):
                    raise ValueError(f"{path}: {k} {a.shape} vs "
                                     f"{tuple(sd[k].shape)}")
                with torch.no_grad():
                    sd[k].copy_(a)
                filled.add(k)
            del arr, targets, a          # one leaf on the host at a time
    missing = sorted(set(sd) - filled)
    if missing:
        raise KeyError(f"{path}: parameters with no leaf: {missing[:8]}")


def _block_rows(key: str, model) -> bool:
    """Whether a JAX flat key is a leaf stacked over depth."""
    group = key.rpartition(SEP)[0]
    return group == "bert/layers" or (group == "vision_encoder/blocks"
                                      and model.cfg.is_eva)


def _part_select(split, axis, length: int) -> Optional[torch.Tensor]:
    """The indices along its split dimension of a model-axis rank's part
    of a leaf `length` long there (None: the whole leaf)."""
    if split is None or axis is None or axis.size == 1:
        return None
    return shard(torch.arange(length), (split[0], 0), axis)


def _read_rows(ckpt, name: str, rows: Optional[list], select: dict):
    """(row or None, tensor) of a leaf of `ckpt`: the rows `rows` of a
    stacked leaf (None: the leaf is not stacked), each cut to `select`
    ({dimension of the row: indices}). One region read covers every row
    and index asked for, so only the chunks under it are decoded."""
    shape = ckpt.shape(name)
    inner = shape[1:] if rows is not None else shape
    region = [slice(min(rows), max(rows) + 1)] if rows is not None else []
    for d, n in enumerate(inner):
        idx = select.get(d)
        region.append(slice(0, n) if idx is None
                      else slice(int(idx.min()), int(idx.max()) + 1))
    got = ckpt.read(name, tuple(region))
    for d, idx in select.items():
        if idx is None:
            continue
        dim = d + (rows is not None)
        rel = idx - int(idx.min())
        if not torch.equal(rel, torch.arange(len(rel))):
            got = got.index_select(dim, rel)
    if rows is None:
        yield None, got
        return
    for r in rows:
        yield r, got[r - min(rows)]


def load_model_orbax(path: str, model) -> None:
    """Copy a `.orbax` model checkpoint (JAX's or the port's) into the
    parameters of `model`, leaf by leaf, as `load_model_npz` does: a stacked
    leaf is split into its blocks and a list of blocks taken by index. Each
    rank reads only its region: a tensor-parallel rank its part of each
    split leaf, a pipeline stage its own blocks (another stage's are never
    decoded). Raises as `load_model_npz` does."""
    sd = model.state_dict()
    remote = pp.remote_names(model)
    splits, axis = splits_of(model), model_axis_of(model)
    ckpt = orbax_format.Checkpoint(path)
    filled = set()
    for name in ckpt.names():
        key = SEP.join(str(k) for k, _ in ckpt.keys_of(name))
        group, _, leaf = key.rpartition(SEP)
        stacked = _block_rows(key, model)
        if stacked:
            targets = {i: f"{group.replace(SEP, '.')}.{i}.{leaf}"
                       for i in range(ckpt.shape(name)[0])}
        else:
            targets = {None: key.replace(SEP, ".")}
        targets = {i: k for i, k in targets.items() if k not in remote}
        if not targets:
            continue                    # another pipeline stage's blocks
        for k in targets.values():
            if k not in sd:
                raise KeyError(f"{path}: leaf {key} has no parameter {k}")
        first = next(iter(targets.values()))
        select = {}
        if first in splits:
            (kind, dim), length = splits[first]
            select[dim] = _part_select((kind, dim), axis, length)
        rows = sorted(targets) if stacked else None
        for i, a in _read_rows(ckpt, name, rows, select):
            k = targets[i]
            if tuple(sd[k].shape) != tuple(a.shape):
                raise ValueError(f"{path}: {k} {tuple(a.shape)} vs "
                                 f"{tuple(sd[k].shape)}")
            with torch.no_grad():
                sd[k].copy_(a)
            filled.add(k)
    missing = sorted(set(sd) - filled)
    if missing:
        raise KeyError(f"{path}: parameters with no leaf: {missing[:8]}")


def _commit(tmp: str, final: str) -> None:
    if os.path.isdir(final):                # a best `.orbax` replaced
        shutil.rmtree(final)
    os.replace(tmp, final)
    LOGGER.info("checkpoint committed: %s", final)


def _remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    else:
        os.remove(path)
    LOGGER.info("checkpoint removed: %s", path)


def orbax_keys(path: str, lists: bool) -> tuple:
    """orbax's key path of a JAX flat key: a number is a list index
    (key_type 1) in a model tree (`lists`), a dict key (2) otherwise."""
    return tuple((int(p), 1) if lists and p.isdigit() else (p, 2)
                 for p in path.split(SEP))


class ModelSaver:
    """Checkpoints of a port model and its optimizer under
    `<output_dir>/ckpt`: `.npz` files, or `.orbax` directories with
    `backend="orbax"`. Each is written to a temporary name and renamed into
    place; the previous steps' files, of either backend, go only after the
    new ones are committed (`remove_before_ckpt`). Saves are synchronous (`wait` is
    there for the JAX package's callers)."""

    def __init__(self, output_dir: str, remove_before_ckpt: bool = True,
                 backend: str = "npz"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown checkpoint_backend {backend!r}")
        self.ckpt_dir = os.path.join(output_dir, "ckpt")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.remove_before_ckpt = remove_before_ckpt
        self.backend = backend
        self.ext = "." + backend

    def _write(self, name: str, leaves, model_tree: bool) -> str:
        final = os.path.join(self.ckpt_dir, name)
        if self.backend == "orbax":
            return orbax_format.write_tree(final, (
                (orbax_keys(k, model_tree), rows, stacked)
                for k, rows, stacked in leaves)), final
        tmp = final + "-tmp"
        try:
            write_npz(tmp, leaves)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        return tmp, final

    def wait(self) -> None:
        """Nothing to flush: every save has committed when it returns."""

    def save(self, step: int, model, optimizer=None) -> None:
        """Write model_step_<step> (and optimizer_step_<step>), commit the
        optimizer's file then the model's, then delete older steps. Every
        rank of a run calls it (the optimizer's leaves, and a sharded
        model's, are gathered); rank 0 writes."""
        writer = collectives.process_index() == 0
        writes = []
        files = [(f"model_step_{step}{self.ext}", model_leaves(model), True)]
        if optimizer is not None:
            files.append((f"optimizer_step_{step}{self.ext}",
                          optimizer_leaves(optimizer), False))
        for name, leaves, model_tree in files:
            leaves = iter(leaves)
            try:
                if writer:
                    writes.append(self._write(name, leaves, model_tree))
            finally:
                for _ in leaves:        # the other ranks' gathers
                    pass
        for tmp, final in reversed(writes):
            _commit(tmp, final)
        collectives.barrier()
        if self.remove_before_ckpt and writer:
            # either backend's older steps: a run resumed from one backend
            # and saving through the other leaves none behind
            exts = "|".join(re.escape("." + b) for b in BACKENDS)
            for p in glob.glob(os.path.join(self.ckpt_dir, "*_step_*")):
                m = re.fullmatch(rf"(?:model|optimizer)_step_(\d+)(?:{exts})",
                                 os.path.basename(p))
                if m and int(m.group(1)) != step:
                    _remove(p)

    def save_best(self, metric: str, model) -> None:
        """Best-metric snapshot (reference save.py:33-41), replaced in one
        rename (a `.orbax` one in place, as JAX's `force=True`); rank 0
        writes it (every rank calls it)."""
        leaves = iter(model_leaves(model))
        try:
            if collectives.process_index() == 0:
                _commit(*self._write(f"best_{metric}{self.ext}", leaves,
                                     True))
        finally:
            for _ in leaves:            # the other ranks' gathers
                pass
        collectives.barrier()


def optimizer_leaves(optimizer):
    """(key, rows, stacked) of the optimizer file in the JAX package's
    layout, one leaf at a time: `jax_optimizer_leaves`' leaves by position
    (int32 counts; μ, ν and the window's running mean with the depth axis
    stacked). Under a process group every rank iterates it: ZeRO-1's slices
    are gathered whole over the data group, a model-sharded leaf's parts
    over the model group, a pipeline stage's rows broadcast from their
    stage, and the window's gradients averaged over the data group as each
    leaf is reached."""
    counts = {"count": optimizer.count, "schedule": optimizer.count,
              "gradient_step": optimizer.count,
              "mini_step": optimizer.mini_step}
    state = optimizer.torch_optimizer.state
    index = {name: i for i, name in enumerate(optimizer.names)}
    group, axis = optimizer.group, optimizer.stage_axis

    def whole(name, v):
        if name not in optimizer.tp_splits:
            return v
        return gather_leaf(v, *optimizer.tp_splits[name],
                           optimizer.model_axis)

    def local(kind, name):
        """This stage's whole tensor of a leaf's row."""
        i = index[name]
        if kind == "acc":
            g = optimizer.params[i].grad
            g = torch.zeros_like(optimizer.params[i]) if g is None else g
            if name in optimizer.summed_names:     # stage 0's, or parts
                g = collectives.all_reduce_sum(g, axis.group)
            if group is not None:
                g = collectives.all_reduce_sum(g, group) / optimizer.world
            return whole(name, g / optimizer.mini_step)
        v = state.get(optimizer.owned[i], {}).get(
            "exp_avg" if kind == "mu" else "exp_avg_sq")
        v = torch.zeros_like(optimizer.owned[i]) if v is None else v
        return whole(name, optimizer.gather(i, v))

    def row(kind, name):
        if kind == "acc" and (optimizer.labels[name] == "frozen"
                              or not optimizer.mini_step):
            shape, _ = optimizer.shapes[name]     # nothing accumulated
            return torch.zeros(shape)
        i = pp.block_index(name)
        if axis is None or i is None:
            return local(kind, name)
        stage = pp.block_stage(
            i, optimizer.model_cfg.vision_tower_config.layers, axis.size)
        if name in optimizer.remote:
            shape, dtype = optimizer.shapes[name]
            like = torch.empty(shape, dtype=dtype,
                               device=optimizer.params[0].device)
            return pp.from_stage(None, like, stage, axis)
        t = local(kind, name)
        return pp.from_stage(t, t, stage, axis)

    for n, (kind, rows) in enumerate(jax_optimizer_leaves(optimizer)):
        if kind in counts:
            yield str(n), [torch.tensor(counts[kind], dtype=torch.int32)], \
                False
            continue
        names = [rows] if isinstance(rows, str) else rows
        yield str(n), [row(kind, name) for name in names], \
            not isinstance(rows, str)


# the groups of the JAX package's `build_optimizer` (train/optim.py:85-129)
# that hold state, in `multi_transform`'s order (sorted by name); "frozen"
# (set_to_zero) has none
_JAX_GROUPS = ("basic", "basic_nd", "new", "new_nd", "vision", "vision_nd")


def _tree_key(path: str):
    """The sort key of a JAX flat path: dict keys sort as strings, list
    indices (a CLIP tower's blocks) as numbers."""
    return tuple(int(p) if p.isdigit() else p for p in path.split(SEP))


def jax_optimizer_leaves(optimizer) -> list:
    """The leaves of the JAX package's optimizer state for `optimizer`'s
    model, in `jax.tree_util.tree_flatten`'s order, as (kind, rows):
    `optax.chain(masked(set_to_zero), clip_by_global_norm,
    multi_transform(groups))` leaves, per group in sorted order, adam's
    count, μ and ν over the group's parameters in tree order, and the
    schedule's count (masked parameters and the empty states have none);
    under `accum_steps` > 1, `optax.MultiSteps` adds its mini_step and
    gradient_step first and the accumulated gradients of every parameter
    last. rows: the port names of a stacked leaf's rows in depth order,
    the one name (a str) of another leaf, None for the counts."""
    from mico_tpu_torch.convert import jax_leaves

    cfg = optimizer.model_cfg
    if cfg is None:
        raise ValueError("the JAX optimizer layout needs the model's config")
    names = {n: n for n in optimizer.labels}
    leaves = sorted(((path, rows if stacked else rows[0])
                     for path, rows, stacked in jax_leaves(names, cfg)),
                    key=lambda pr: _tree_key(pr[0]))
    inner = []
    for group in _JAX_GROUPS:
        mine = [rows for _, rows in leaves
                if optimizer.labels[rows if isinstance(rows, str)
                                    else rows[0]] == group]
        inner += ([("count", None)] + [("mu", rows) for rows in mine]
                  + [("nu", rows) for rows in mine] + [("schedule", None)])
    if optimizer.accum_steps <= 1:
        return inner
    return ([("mini_step", None), ("gradient_step", None)] + inner
            + [("acc", rows) for _, rows in leaves])


def _load_jax_optimizer(path: str, n_leaves: int, scalar, parts,
                        optimizer) -> None:
    """The JAX package's positional optimizer leaves (`{str(i): leaf}`,
    checkpoints.py:165-172) into the port's AdamW: μ, ν and the count per
    parameter, the update count, and an open MultiSteps window as summed
    gradients (its running mean times mini_step). `scalar(i)` is leaf i's
    value; `parts(i, kind, wanted)` gives (row, tensor) for the rows
    `wanted` ((row or None, parameter name) pairs) of leaf i: the model-axis
    part, and for μ and ν this rank's ZeRO-1 slice of it."""
    leaves = jax_optimizer_leaves(optimizer)
    if n_leaves != len(leaves):
        raise ValueError(
            f"{path} holds {n_leaves} leaves; the JAX optimizer state of "
            f"this model and optimizer (accum_steps {optimizer.accum_steps}) "
            f"has {len(leaves)}")
    params = dict(zip(optimizer.names, optimizer.params))
    index = {name: i for i, name in enumerate(optimizer.names)}
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    counts, acc, mini_step = set(), {}, 0
    for i, (kind, rows) in enumerate(leaves):
        if kind in ("count", "schedule", "gradient_step"):
            counts.add(scalar(i))
            continue
        if kind == "mini_step":
            mini_step = scalar(i)
            continue
        rows = [(None, rows)] if isinstance(rows, str) else enumerate(rows)
        wanted = [(r, name) for r, name in rows
                  if not (name in optimizer.remote
                          or (kind == "acc" and name not in params))]
        # (another stage's block; a frozen parameter's window)
        names = dict(wanted)
        for r, t in parts(i, kind, wanted):
            name = names[r]
            p, j = params[name], index[name]
            want = tuple(p.shape) if kind == "acc" else tuple(
                optimizer.owned[j].shape)
            if tuple(t.shape) != want:
                raise ValueError(f"{path}: leaf {i} ({kind} of {name}) has "
                                 f"shape {tuple(t.shape)}, the parameter's "
                                 f"{'' if kind == 'acc' else 'slice '}"
                                 f"{want}")
            t = t.to(p.device, p.dtype).contiguous()
            if kind == "acc":
                acc[name] = t
            else:
                field = "exp_avg" if kind == "mu" else "exp_avg_sq"
                state.setdefault(j, {})[field] = t
    count = max(counts)
    for s in state.values():
        s["step"] = torch.tensor(float(count), dtype=torch.float32)
    sd = optimizer.torch_optimizer.state_dict()
    sd["state"] = state
    optimizer.torch_optimizer.load_state_dict(sd)
    optimizer.count = count
    optimizer.mini_step = mini_step
    for name, p in params.items():
        p.grad = optimizer.window_grad(
            name, acc[name] * mini_step if mini_step and name in acc
            else None)


def _model_part(optimizer, name: str, full: torch.Tensor) -> torch.Tensor:
    """This model-axis rank's part of a file's whole leaf of parameter
    `name` (the leaf itself when the parameter is whole)."""
    if name not in optimizer.tp_splits:
        return full
    return shard(full, optimizer.tp_splits[name][0], optimizer.model_axis)


def load_optimizer_npz(path: str, optimizer) -> None:
    """Restore an optimizer file, the JAX package's positional layout (the
    port's or JAX's), into `optimizer` (its parameters already hold the
    checkpoint's weights)."""
    index = {name: i for i, name in enumerate(optimizer.names)}

    def parts(i, kind, wanted):
        leaf = z[str(i)]
        for r, name in wanted:
            # np.array, not ascontiguousarray: a 0-d leaf stays 0-d
            a = torch.from_numpy(np.array(leaf if r is None else leaf[r]))
            a = _model_part(optimizer, name, a)
            yield r, (a if kind == "acc" or tuple(a.shape) != tuple(
                optimizer.params[index[name]].shape)
                else optimizer.own(index[name], a))

    with np.load(path) as z:
        if not z.files or not all(k.isdigit() for k in z.files):
            raise ValueError(f"{path} is not an optimizer file in the JAX "
                             f"package's positional layout")
        _load_jax_optimizer(path, len(z.files), lambda i: int(z[str(i)]),
                            parts, optimizer)


def load_optimizer_orbax(path: str, optimizer) -> None:
    """`load_optimizer_npz` for a `.orbax` optimizer file (JAX's or the
    port's): each rank reads only its region of each leaf, its model-axis
    part and, for the moments, its ZeRO-1 slice of that part."""
    ckpt = orbax_format.Checkpoint(path)
    names = ckpt.names()
    if not names or not all(n.isdigit() for n in names):
        raise ValueError(f"{path} is not an optimizer file in the JAX "
                         f"package's positional layout")
    index = {name: i for i, name in enumerate(optimizer.names)}

    def parts(i, kind, wanted):
        if not wanted:
            return
        first = wanted[0][1]
        j = index[first]
        inner = tuple(optimizer.params[j].shape)
        select = {}
        if first in optimizer.tp_splits:
            (split, dim), length = optimizer.tp_splits[first]
            select[dim] = _part_select((split, dim), optimizer.model_axis,
                                       length)
        d = optimizer.split_dims[j]
        if kind != "acc" and d is not None:
            base = (select[d] if d in select
                    else torch.arange(inner[d]))
            select[d] = base[torch.arange(len(base)).chunk(
                optimizer.world)[optimizer.rank]]
        rows = None if wanted[0][0] is None else sorted(
            r for r, _ in wanted)
        yield from _read_rows(ckpt, str(i), rows, select)

    _load_jax_optimizer(path, len(names),
                        lambda i: int(ckpt.read(str(i))), parts, optimizer)


def resume_latest(output_dir: str, model) -> int:
    """Load the newest committed `model_step_N` into `model`; → N, or 0
    when there is none."""
    step, path = _latest_step(os.path.join(output_dir, "ckpt"), "model")
    if step is None:
        return 0
    if path.endswith(".orbax"):
        load_model_orbax(path, model)
    else:
        load_model_npz(path, model)
    LOGGER.info("resumed from %s (step %d)", path, step)
    return step


def load_latest_opt_state(output_dir: str, optimizer,
                          step: Optional[int] = None) -> bool:
    """Restore `optimizer_step_<step>` (the newest when `step` is None)
    into `optimizer`; False when that file is absent. Resume passes the
    model's step, so a save cut between its two commits never pairs a
    model with another step's moments."""
    ckpt_dir = os.path.join(output_dir, "ckpt")
    if step is None:
        _, path = _latest_step(ckpt_dir, "optimizer")
    else:
        path = next((p for p in (os.path.join(ckpt_dir, f"optimizer_step_"
                                              f"{step}.{b}") for b in BACKENDS)
                     if os.path.exists(p)), None)
    if not path or not os.path.exists(path):
        return False
    if path.endswith(".orbax"):
        load_optimizer_orbax(path, optimizer)
    else:
        load_optimizer_npz(path, optimizer)
    LOGGER.info("optimizer state from %s (update %d)", path, optimizer.count)
    return True
