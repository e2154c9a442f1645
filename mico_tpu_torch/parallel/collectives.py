"""Collectives of the data-parallel path (counterpart of
`mico_tpu/parallel/collectives.py`), on `torch.distributed`.

JAX's `axis_name` becomes a process group handle: every function takes
`group`, and `group=None` is the one-process identity, as `axis_name=None`
is in JAX (not torch's default group), so the same loss code runs in unit
tests, on one card and across processes. The reference's NCCL wrappers
(data/utils/distributed.py):
  - concat_all_gather (no grad)      → all_gather_no_grad
  - GatherLayer/all_gather_with_grad → all_gather_concat (its backward is
    the reduce-scatter sum, the VJP of JAX's `lax.all_gather`)
  - dist.get_rank()                  → data_axis_index
  - all_gather_list / any_broadcast  → gather_objects / broadcast_object
  - ddp_allgather (pad to max)       → gather_variable_batch
Tensors go through the collective on their own device: NCCL takes CUDA
tensors, gloo CPU and CUDA tensors alike (every collective called here
runs under gloo on CUDA tensors in torch 2.11), so nothing is staged
through the host. The point-to-point `send`/`recv` of the pipeline's hops
are the exception: gloo's take host memory alone, so under gloo a card
tensor is staged through pinned host memory (under NCCL it stays on the
card). The host-side object collectives (`process_allgather`,
`gather_objects`, `broadcast_object`) run over the default group on the
device its backend needs.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def data_axis_index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def data_axis_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """(b, ...) on every rank → (world·b, ...), rank-major; no gradient."""
    if group is None:
        return x
    n = data_axis_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """(world·b, ...) on every rank → the sum over ranks of this rank's
    (b, ...) block."""
    if group is None:
        return x
    n = data_axis_size(group)
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def _staged(x: torch.Tensor, group) -> bool:
    """A point-to-point op of `x` goes through host memory: gloo sends and
    receives host memory alone (its TCP transport hands a card tensor's
    device pointer to `writev`, which fails with EFAULT, and the process
    aborts), NCCL the card's."""
    return x.is_cuda and dist.get_backend(group) != "nccl"


def send(x: torch.Tensor, dst: int, group):
    """Start sending `x` to global rank `dst` of `group`; → the handle to
    `wait()` on before `x` (or its staging copy) may change. Under gloo a
    card tensor is copied to pinned host memory first."""
    if _staged(x, group):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return _Sent(dist.isend(host, dst, group=group), host)
    x = x.contiguous()
    return _Sent(dist.isend(x, dst, group=group), x)


class _Sent:
    """A started send and the tensor it reads (kept alive until it ends)."""

    __slots__ = ("work", "tensor")

    def __init__(self, work, tensor):
        self.work, self.tensor = work, tensor

    def wait(self) -> None:
        self.work.wait()
        self.tensor = None


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor shaped, typed and placed as `like`, received from global
    rank `src` of `group` (through pinned host memory under gloo for a
    card tensor)."""
    out = torch.empty_like(like, memory_format=torch.contiguous_format)
    if _staged(out, group):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.recv(host, src, group=group)
        return out.copy_(host)
    dist.recv(out, src, group=group)
    return out


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """x of global rank `src` on every rank of `group`, in place (x must
    be contiguous); gloo broadcasts a card tensor itself."""
    dist.broadcast(x, src, group=group)
    return x


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks (a new tensor; `x` is left as it is)."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGatherConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_tensor(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_tensor(g, ctx.group), None


def all_gather_concat(x: torch.Tensor, group) -> torch.Tensor:
    """Gather along the batch axis with gradients flowing back to every
    rank's rows: the backward sums each rank's cotangent of this rank's
    rows (reduce-scatter)."""
    if group is None:
        return x
    return _AllGatherConcat.apply(x, group)


def all_gather_no_grad(x: torch.Tensor, group) -> torch.Tensor:
    return all_gather_tensor(x.detach(), group)


def gather_variable_batch(x: torch.Tensor, group, max_batch: int):
    """Per-rank VARIABLE batch sizes by pad-to-max and a mask (reference
    ddp_allgather pads to the max length then trims; JAX pads to a static
    bound the caller passes). x: (b, ...) with b ≤ max_batch →
    ((world·max_batch, ...) with gradient, (world·max_batch,) bool mask)."""
    b = x.shape[0]
    pad = x.new_zeros((max_batch - b,) + tuple(x.shape[1:]))
    xp = torch.cat([x, pad])
    valid = torch.arange(max_batch, device=x.device) < b
    return all_gather_concat(xp, group), all_gather_no_grad(valid, group)


# ---------------------------------------------------------------------------
# host-side (multi-process) equivalents of the reference's pickled-object
# collectives (data/utils/distributed.py:70-128 all_gather_list /
# any_broadcast): between steps, for evaluation and checkpoints
# ---------------------------------------------------------------------------


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _wire_device() -> torch.device:
    """The device the default group's backend reduces on."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(x_local) -> np.ndarray:
    """One identically-shaped numpy array per process → (process_count,
    *shape) on every process."""
    x_local = np.asarray(x_local)
    if not _initialized():
        return x_local[None]
    t = torch.from_numpy(np.ascontiguousarray(x_local)[None])
    out = all_gather_tensor(t.to(_wire_device()), dist.group.WORLD)
    return out.cpu().numpy()


def gather_objects(obj) -> list:
    """Every process's picklable object, in rank order (reference
    all_gather_list); [obj] without a process group. Two phases, as the
    reference's length-prefixed codec (distributed.py:70-92): the lengths,
    then the payloads padded to the longest."""
    if not _initialized():
        return [obj]
    blob = np.frombuffer(pickle.dumps(obj), np.uint8)
    lens = process_allgather(np.int64(len(blob))).reshape(-1)
    buf = np.zeros((int(lens.max()),), np.uint8)
    buf[: len(blob)] = blob
    gathered = process_allgather(buf)
    return [pickle.loads(row[: int(n)].tobytes())
            for row, n in zip(gathered, lens)]


def broadcast_object(obj, src: int = 0):
    """Process `src`'s picklable object on every process (reference
    any_broadcast): the length, then the payload."""
    if not _initialized():
        return obj
    dev = _wire_device()
    blob = (np.frombuffer(pickle.dumps(obj), np.uint8)
            if dist.get_rank() == src else np.zeros(0, np.uint8))
    n = torch.tensor([len(blob)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
    if dist.get_rank() == src:
        buf.copy_(torch.from_numpy(blob.copy()))
    dist.broadcast(buf, src)
    return pickle.loads(buf.cpu().numpy().tobytes())


def barrier() -> None:
    """Every process reaches this point before any leaves it."""
    if _initialized():
        dist.barrier()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


# the model axis's size of the run's mesh (`mesh.create_mesh` sets it):
# the processes of one data index are `MODEL_PARALLEL[0]` adjacent ranks
MODEL_PARALLEL = [1]


def data_shard() -> tuple:
    """(data-axis size, this process's data index) of the run's mesh: the
    loaders' shards and the evaluations' (rank r has data index r // model,
    JAX's `reshape(data, model)`)."""
    m = MODEL_PARALLEL[0]
    return process_count() // m, process_index() // m


def data_shards(per_process: list) -> list:
    """Of one entry per process in rank order (`gather_objects`), those of
    model index 0, one per data index: the ranks of a model group hold the
    same rows and give the same results."""
    return per_process[::MODEL_PARALLEL[0]]


def data_group() -> Optional[object]:
    """The default group once a process group is initialised (at any
    world size, so one process under torchrun runs its collectives), else
    None."""
    return dist.group.WORLD if _initialized() else None
