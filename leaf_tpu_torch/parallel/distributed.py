"""Multi-rank coordination and collectives on `torch.distributed` (port
of `leaf_tpu/parallel/distributed.py`, with `mesh.py::local_batch_slice`).

One process drives one card; the drivers' ranks run data parallelism, as
the JAX package's one `data` mesh axis does (a (data, model) grid with
tensor parallelism is `parallel.sharding`'s).  `init_distributed_device` joins
the ranks from the environment: the variables PyTorch's launcher sets
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) or
SLURM's (`SLURM_PROCID`, `SLURM_NTASKS`, `SLURM_LOCALID`, with the
launcher's address and port).  With none set it is one process, no
process group, and every function below is the identity of one rank.
The backend follows the device: NCCL for CUDA (rank r on
`cuda:LOCAL_RANK`), gloo for the CPU.

The host-side helpers are the JAX module's: `is_master`,
`broadcast_object` (the resume path), `global_max_int32` (the fused
step's bucket widths and anchor-cache branch, agreed across ranks),
`all_gather_object`.  The tensor collectives stand for what GSPMD and
`lax` gave the JAX package:

  * `all_reduce_mean_`: the mean of the gradients across ranks (the
    GSPMD gradient psum), in place;
  * `pmean`: the mean of a logged value;
  * `all_gather`: `lax.all_gather(..., tiled=True)`, differentiable; its
    backward sums every rank's gradient and keeps this rank's rows (the
    transpose, a reduce-scatter);
  * `neighbour_exchange`: one `lax.ppermute` hop of the SigLIP ring,
    differentiable; its backward sends the gradient back the other way.

`all_reduce_mean_`, `pmean` and `global_max_int32` take an optional
process group (None: every rank): on a (data, model) grid of ranks
(`parallel.sharding`) the gradient mean, the logged loss and the fused
step's agreement run over the data group alone.

A loss that gathers features is each rank's own loss, and its backward
gives each rank the gradient of the sum of the ranks' losses through its
rows; `all_reduce_mean_` then makes the update the gradient of their mean,
which is what the JAX package's `pmean`'d loss differentiates to.

Where the backend cannot take a CUDA tensor for a collective (gloo has
CUDA paths for all-reduce and broadcast only), the tensor goes through
the host.  That is decided by the backend the process group reports,
never by catching a failure; no collective falls back to another.
"""
from __future__ import annotations

import logging
import os
import socket
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

LOG = logging.getLogger(__name__)

# collectives that a backend runs on CUDA tensors in place; the rest go
# through the host there
_CUDA_NATIVE = {"nccl": {"all_reduce", "broadcast", "all_gather",
                         "reduce_scatter", "send_recv"},
                "gloo": {"all_reduce", "broadcast"}}


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def world_size(group=None) -> int:
    """The number of ranks of `group` (None: every rank); 1 without a
    process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_master() -> bool:
    return rank() == 0


def group():
    """The process group a loss gathers over: None on one rank, where
    every loss is its one-card code."""
    return dist.group.WORLD if world_size() > 1 else None


def init_distributed_device(device="cuda",
                            backend: Optional[str] = None) -> dict:
    """Join the ranks the environment names, or stay one process.

    Returns {'world_size', 'rank', 'local_rank', 'device'}.  On CUDA a
    device without an index becomes `cuda:LOCAL_RANK` and is made the
    current one.  `backend` overrides the device's (gloo puts two ranks
    on one card, which NCCL refuses).  A process group that is already
    up is kept, so a driver may be called twice in one process."""
    device = torch.device(device)
    world = _env_int("WORLD_SIZE", "SLURM_NTASKS")
    if world is None and not dist.is_initialized():
        return {"world_size": 1, "rank": 0, "local_rank": 0,
                "device": device}
    rank_ = _env_int("RANK", "SLURM_PROCID")
    local_rank = _env_int("LOCAL_RANK", "SLURM_LOCALID")
    if rank_ is None:
        rank_ = 0 if world == 1 else None
    if rank_ is None:
        raise ValueError("WORLD_SIZE is set but neither RANK nor "
                         "SLURM_PROCID names this process's rank")
    if local_rank is None:
        local_rank = rank_
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not (addr and port):
            if world > 1:
                raise ValueError(
                    f"a {world}-rank run needs MASTER_ADDR and MASTER_PORT "
                    "(the launcher sets them; under SLURM export them)")
            addr, port = "localhost", str(_free_port())
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                world_size=world, rank=rank_)
        LOG.info("joined %d-rank group as rank %d (%s, %s)", world, rank_,
                 backend, device)
    return {"world_size": world_size(), "rank": rank(),
            "local_rank": local_rank, "device": device}


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def _native(op: str, tensor: torch.Tensor) -> bool:
    """Whether the backend runs `op` on this tensor where it lies."""
    if not tensor.is_cuda:
        return True
    return op in _CUDA_NATIVE.get(dist.get_backend(), set())


def _scalar_device() -> torch.device:
    """Where a host value rides a collective: NCCL takes CUDA tensors
    only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_object(obj: Any, root: int = 0) -> Any:
    """A picklable object from `root` to every rank."""
    if world_size() == 1:
        return obj
    box = [obj if rank() == root else None]
    dist.broadcast_object_list(box, src=root, device=_scalar_device())
    return box[0]


def all_gather_object(obj: Any) -> list:
    """A picklable object from every rank, in rank order."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def global_max_int32(values, group=None) -> np.ndarray:
    """Elementwise max of a small int32 vector across the ranks of `group`
    (one all-reduce; the identity on one rank).  The fused step's
    per-batch agreement on bucket widths and on the anchor-cache branch,
    so that every rank slices to the same width and takes the same phase
    1."""
    vals = np.asarray(values, np.int32)
    if world_size(group) == 1:
        return vals
    t = torch.from_numpy(vals.astype(np.int64)).to(_scalar_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.cpu().numpy().astype(np.int32)


def local_batch_slice(global_batch: int,
                      process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """This rank's slice of a globally indexed batch (equal-batch
    rounding)."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


# -- tensor collectives --------------------------------------------------

def _all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    if _native("all_reduce", t):
        dist.all_reduce(t, group=group)
        return t
    host = t.cpu()
    dist.all_reduce(host, group=group)
    return t.copy_(host)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean across the ranks of `group`, in
    place: one all-reduce per dtype over the tensors flattened together.
    Every rank ends with the same bits."""
    world = world_size(group)
    if world == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_])
        _all_reduce_sum_(flat, group).div_(world)
        offset = 0
        for t in group_:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def pmean(value: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of a (logged, not differentiated) value across the ranks
    of `group`; the value itself on one rank."""
    world = world_size(group)
    if world == 1:
        return value
    out = value.detach().clone()
    return _all_reduce_sum_(out, group).div_(world)


def _gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] from every rank -> [world * B, ...], in rank order."""
    world = world_size()
    if _native("all_gather", x):
        if dist.get_backend() == "nccl":
            out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x.contiguous())
            return out
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)
    host = x.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(parts, host)
    return torch.cat(parts).to(x.device)


def _reduce_scatter_rows(g: torch.Tensor) -> torch.Tensor:
    """[world * B, ...] on every rank -> the sum over ranks of this rank's
    B rows."""
    world, r = world_size(), rank()
    b = g.shape[0] // world
    if dist.get_backend() == "nccl":
        out = g.new_empty((b,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous())
        return out
    total = _all_reduce_sum_(g.contiguous().clone())
    return total[r * b:(r + 1) * b]


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        return _gather_rows(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_rows(grad)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """`lax.all_gather(x, tiled=True)`: every rank's rows in rank order,
    differentiable (each rank's gradient is the sum over ranks of the
    gradient of its rows).  `x` itself on one rank."""
    if world_size() == 1:
        return x
    return _AllGather.apply(x)


@torch.no_grad()
def all_gather_no_grad(x: torch.Tensor) -> torch.Tensor:
    """`all_gather` of a value that carries no gradient."""
    if world_size() == 1:
        return x
    return _gather_rows(x)


def _exchange(x: torch.Tensor, to: int, source: int) -> torch.Tensor:
    """Send `x` to rank `to` and receive a tensor of its shape from rank
    `source`."""
    x = x.contiguous()
    if _native("send_recv", x):
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, to),
               dist.P2POp(dist.irecv, out, source)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    host = x.detach().cpu()
    out = torch.empty_like(host)
    reqs = [dist.isend(host, to), dist.irecv(out, source)]
    for req in reqs:
        req.wait()
    return out.to(x.device)


class _NeighbourExchange(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, to, source):
        ctx.to, ctx.source = to, source
        return _exchange(x, to, source)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.source, ctx.to), None, None


def neighbour_exchange(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """One `lax.ppermute` hop with the permutation i -> i + shift: this
    rank sends `x` to rank + shift and returns what rank - shift sent
    (mod the world).  Differentiable; `x` itself on one rank."""
    world = world_size()
    if world == 1:
        return x
    r = rank()
    return _NeighbourExchange.apply(x, (r + shift) % world,
                                    (r - shift) % world)


def ranks_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor whose leading dimension is the global
    batch (`local_batch_slice`); `x` itself on one rank."""
    if world_size() == 1:
        return x
    return x[local_batch_slice(x.shape[0])]

