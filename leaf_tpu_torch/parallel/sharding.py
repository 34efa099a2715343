"""Tensor parallelism over a (data, model) grid of ranks (port of
`leaf_tpu/parallel/sharding.py`, with `mesh.py::create_mesh`).

The JAX package's 2-D mesh `("data", "model")` is a grid of ranks here:
world = data x model, rank r at (r // model, r % model), as
`Mesh(devices.reshape(data, model))` lays the devices out.  Each rank
joins two process groups (`torch.distributed.new_group`): its data group
(the ranks of its model index, which split the batch) and its model group
(the ranks of its data index, which split the weights and see the same
rows).  A dimension of one rank has no group; a dimension of every rank
is the whole world.

`param_split` is `clip_param_spec` on the port's parameter names: the
Megatron split over `model` of the stacked blocks (`blocks.<i>.`,
`cross_blocks.<i>.`), column-parallel `qkv_w` and `fc_w` with their
biases, row-parallel `out_w` and `proj_w`, a vocab-split
`token_embedding`, and every other tensor replicated, the blocks-less
`attn`/`mlp` subtrees too (SigLIP's MAP head, the timm heads).  It gives
the dimension a tensor is split along, or None.  `qkv_w`/`qkv_b` are split
by heads: a rank keeps its heads' q, k and v (each third of the fused
columns split in order), where JAX's `P(None, None, "model")` cuts the
fused columns into contiguous pieces and lets GSPMD reshard around them;
the function computed is the same.

`shard_module` puts a `TextTower` on the grid: each split parameter is
replaced by this rank's shard, and the tower's blocks and token lookup
run the tensor-parallel forward (`block_forward`, `embed_tokens`).  A
block cannot be the fused block's one C call, which ends in its residual:
each rank runs `ln_1` (LayerNorm kernel), its qkv columns (`gemm_bias`,
the block's GEMM kernel), `packed_attention` on its H / model heads, its
rows of `out_w` (`gemm_bias`, no bias), the all-reduce over the model
group, then `out_b` once and the residual; the MLP runs its column-split
`fc` with the activation, its row-split `proj`, the all-reduce, `proj_b`
and the residual.  Two autograd functions carry Megatron's pair:
`copy_to_model` (identity forward, all-reduce backward) where a
column-split GEMM takes a replicated input, and `reduce_from_model`
(all-reduce forward, identity backward) where a row-split GEMM's partial
products meet.  The vocab-split lookup takes its own rows, zeroes the
others and all-reduces.

Outside the rank, tensors are whole and in the JAX layout: a sharded
module's `state_dict()` gathers every split tensor over the model group
(every rank of the group must call it), and `load_state_dict` takes whole
tensors and keeps this rank's shard, so that checkpoints and the OpenCLIP
export load on one rank and in the JAX package (`shard_tensor` and
`unshard_tensor`, the two directions on one tensor).

The optimizer (`train.optim`, given the grid) averages the gradients over
the data group only and computes the clip's global norm as optax does on
global arrays: split tensors' squared norms summed over the model group,
replicated ones counted once.  AdamW is elementwise, so each rank updates
its shards alone.  No driver reaches tensor parallelism, in the JAX
package as here (`--mesh-shape` names the data dimension only): it is an
API.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from leaf_tpu_torch.parallel import distributed as D

# collections whose parameters the JAX package stacks on a layer axis, and
# which the port un-stacks into `<key>.<i>.` (`interop.params_from_jax`,
# `coca_interop.coca_params_from_jax`)
_STACKS = ("blocks", "cross_blocks")
_COLUMN = ("qkv_w", "fc_w")
_ROW = ("out_w", "proj_w")
_COLUMN_BIAS = ("qkv_b", "fc_b")


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """A (data, model) grid of ranks and this rank's place on it.
    `data_group`/`model_group` are None where the dimension is every rank
    (the default group) and where it is one rank (no collective)."""
    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    def data_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        if self.data > 1:
            D.all_reduce_mean_(tensors, self.data_group)

    def model_sum_(self, t: torch.Tensor) -> torch.Tensor:
        if self.model > 1:
            D._all_reduce_sum_(t, self.model_group)
        return t

    def data_pmean(self, value: torch.Tensor) -> torch.Tensor:
        return D.pmean(value, self.data_group) if self.data > 1 else value

    def data_max_int32(self, values) -> np.ndarray:
        if self.data > 1:
            return D.global_max_int32(values, self.data_group)
        return np.asarray(values, np.int32)


def create_grid(shape: Optional[Sequence[int]] = None) -> Grid:
    """The grid of `shape` = (data, model) over every rank (default: data
    = the number of ranks, model = 1, as `create_mesh`'s default).  Every
    rank calls it, in the same order as its other collectives: it creates
    every group of both dimensions."""
    world, rank = D.world_size(), D.rank()
    shape = tuple(shape) if shape is not None else (world, 1)
    if len(shape) != 2 or shape[0] * shape[1] != world or min(shape) < 1:
        raise ValueError(f"a (data, model) grid of {shape} does not cover "
                         f"{world} ranks")
    data, model = shape
    grid = {"data_group": None, "model_group": None}
    if 1 < model < world:
        # every rank creates every group (torch.distributed's rule)
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                grid["model_group"] = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                grid["data_group"] = g
    return Grid(data, model, rank // model, rank % model, **grid)


# ---------------------------------------------------------------------------
# The split rules
# ---------------------------------------------------------------------------

def _stacked(keys: List[str]) -> bool:
    return any(k in _STACKS and i + 1 < len(keys) - 1
               and keys[i + 1].isdigit() for i, k in enumerate(keys))


def param_split(name: str, ndim: int) -> Optional[int]:
    """The dimension along which the tensor-parallel grid splits the
    parameter `name` (a dotted state-dict name) of `ndim` dimensions, or
    None where every rank holds it whole: `clip_param_spec`'s decisions
    on the port's names, whose stacked blocks have lost the layer axis."""
    keys = name.split(".")
    leaf = keys[-1]
    stacked = _stacked(keys)
    jax_ndim = ndim + 1 if stacked else ndim
    jax_dim = None
    if "attn" in keys or "mlp" in keys:
        # the Megatron specs hold for the stacked layout only; a subtree
        # without the layer axis (a MAP head, a timm head) is replicated
        if leaf in _COLUMN and jax_ndim == 3:
            jax_dim = 2
        elif leaf in _ROW and jax_ndim == 3:
            jax_dim = 1
        elif leaf in _COLUMN_BIAS and jax_ndim == 2:
            jax_dim = 1
    elif leaf == "token_embedding" and jax_ndim == 2:
        jax_dim = 0
    if jax_dim is None:
        return None
    return jax_dim - 1 if stacked else jax_dim


def _by_thirds(name: str) -> bool:
    """qkv tensors are split by heads: each third (q, k, v) in order."""
    return name.split(".")[-1] in ("qkv_w", "qkv_b")


def shard_tensor(name: str, t: torch.Tensor, model: int,
                 model_index: int) -> torch.Tensor:
    """Rank `model_index`'s shard of the whole tensor `t` (a copy,
    contiguous); `t` itself where `name` is replicated."""
    dim = param_split(name, t.dim())
    if dim is None or model == 1:
        return t
    parts = t.chunk(3, dim) if _by_thirds(name) else (t,)
    out = []
    for p in parts:
        if p.shape[dim] % model:
            raise ValueError(f"{name}: {tuple(t.shape)} does not split "
                             f"into {model} along dimension {dim}")
        out.append(p.chunk(model, dim)[model_index])
    return torch.cat(out, dim).contiguous()


def unshard_tensor(name: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole tensor from every model rank's shard, in rank order."""
    dim = param_split(name, shards[0].dim())
    if dim is None or len(shards) == 1:
        return shards[0]
    if not _by_thirds(name):
        return torch.cat(list(shards), dim)
    thirds = [s.chunk(3, dim) for s in shards]
    return torch.cat([torch.cat([t[i] for t in thirds], dim)
                      for i in range(3)], dim)


# ---------------------------------------------------------------------------
# Megatron's pair of collectives
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.model_sum_(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        return grid.model_sum_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The input of a column-split GEMM: the identity forward; backward,
    the sum of the model ranks' gradients (each saw its own columns)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, grid)


def reduce_from_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The output of a row-split GEMM: the sum over the model ranks'
    partial products; backward, the identity."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return grid.model_sum_(x.contiguous().clone())
    return _ReduceFromModel.apply(x, grid)


# ---------------------------------------------------------------------------
# The tensor-parallel text tower
# ---------------------------------------------------------------------------

def block_forward(block, x: torch.Tensor, packed) -> torch.Tensor:
    """A `layers.ResidualBlock` on its shards (the module docstring)."""
    from leaf_tpu_torch.ops.packed_attention import gemm_bias, packed_attention
    grid = block.tp
    if packed is None:
        raise NotImplementedError(
            "a tensor-parallel block runs packed rows only (the CLIP text "
            "tower's)")
    R, L, D_ = x.shape
    attn = {k: v.to(x.dtype) for k, v in block.attn.items()}
    h = copy_to_model(block.ln_1(x), grid)
    qkv = gemm_bias(h, attn["qkv_w"], attn["qkv_b"])
    o = packed_attention(qkv, block.n_heads // grid.model, packed[0],
                         packed[1])
    y = reduce_from_model(gemm_bias(o, attn["out_w"]), grid)
    x = x + (y + attn["out_b"])
    m = block.mlp
    h = copy_to_model(block.ln_2(x), grid)
    a = m.act(h @ m.fc_w.to(x.dtype) + m.fc_b.to(x.dtype))
    y = reduce_from_model(a @ m.proj_w.to(x.dtype), grid)
    return x + (y + m.proj_b.to(x.dtype))


def embed_tokens(tower, tokens: torch.Tensor) -> torch.Tensor:
    """The vocab-split lookup: this rank's rows of the embedding, zeros
    for the ids outside them, summed over the model group."""
    grid = tower.tp
    w = tower.token_embedding
    n = w.shape[0]
    ids = tokens.long() - grid.model_index * n
    inside = ((ids >= 0) & (ids < n))[..., None]
    e = w[ids.clamp(0, n - 1)].to(tower.dtype)
    return reduce_from_model(torch.where(inside, e, torch.zeros_like(e)),
                             grid)


def _split_names(module) -> List[str]:
    return [n for n, p in module.named_parameters()
            if param_split(n, p.dim()) is not None]


def _whole_state(module, sd: dict, prefix: str, local_metadata) -> None:
    """state_dict hook of a sharded tower: every split tensor gathered
    over the model group and made whole."""
    grid = module.tp
    for name in _split_names(module):
        key = prefix + name
        if key not in sd:
            continue
        shard = sd[key].contiguous()
        if shard.is_cuda and dist.get_backend() != "nccl":
            parts = [torch.empty_like(shard, device="cpu")
                     for _ in range(grid.model)]
            dist.all_gather(parts, shard.cpu(), group=grid.model_group)
            parts = [q.to(shard.device) for q in parts]
        else:
            parts = [torch.empty_like(shard) for _ in range(grid.model)]
            dist.all_gather(parts, shard, group=grid.model_group)
        sd[key] = unshard_tensor(name, parts)


def _shard_state(module, sd, prefix, local_metadata, strict, missing,
                 unexpected, errors) -> None:
    """load_state_dict pre-hook of a sharded tower: whole tensors become
    this rank's shards."""
    grid = module.tp
    params = dict(module.named_parameters())
    for name in _split_names(module):
        key = prefix + name
        if key in sd and sd[key].shape != params[name].shape:
            sd[key] = shard_tensor(name, sd[key], grid.model,
                                   grid.model_index)


def shard_module(tower, grid: Grid):
    """Put a `clip.TextTower` on `grid` in place and return it: each split
    parameter becomes this rank's shard, the blocks and the token lookup
    run their tensor-parallel forward, and `state_dict`/`load_state_dict`
    see whole tensors.  A grid of model 1 leaves the tower as it is.  Its
    optimizer takes the grid too (`train.optim.make_optimizer`)."""
    from leaf_tpu_torch.models.clip import TextTower
    if not isinstance(tower, TextTower):
        raise NotImplementedError(
            "tensor parallelism runs the CLIP text tower (the fused LEAF "
            f"step's), not a {type(tower).__name__}: no JAX trainer "
            "reaches it elsewhere")
    if grid.model == 1:
        return tower
    if tower.cfg.heads % grid.model:
        raise ValueError(f"{tower.cfg.heads} heads do not split over "
                         f"{grid.model} model ranks")
    for name in _split_names(tower):
        path, _, leaf = name.rpartition(".")
        owner = tower.get_submodule(path) if path else tower
        p = getattr(owner, leaf) if not isinstance(
            owner, torch.nn.ParameterDict) else owner[leaf]
        shard = torch.nn.Parameter(
            shard_tensor(name, p.detach(), grid.model, grid.model_index),
            requires_grad=p.requires_grad)
        if isinstance(owner, torch.nn.ParameterDict):
            owner[leaf] = shard
        else:
            setattr(owner, leaf, shard)
    tower.tp = grid
    for block in tower.blocks:
        block.tp = grid
    tower._register_state_dict_hook(_whole_state)
    tower._register_load_state_dict_pre_hook(_shard_state, with_module=True)
    return tower


def split_norm_sq(tensors: Sequence[torch.Tensor], split: Sequence[bool],
                  grid: Grid) -> torch.Tensor:
    """The squared global norm of `tensors` as of the whole tensors: the
    shards' (`split`) squares summed over the model group, the replicated
    tensors' counted once."""
    def sq(ts):
        if not ts:
            return torch.zeros((), device=tensors[0].device)
        return torch.stack(torch._foreach_norm(ts)).square().sum()

    total = sq([t.float() for t, s in zip(tensors, split) if not s])
    part = sq([t.float() for t, s in zip(tensors, split) if s])
    return total + grid.model_sum_(part.reshape(1)).reshape(())
