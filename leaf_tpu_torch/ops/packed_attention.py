"""Packed attention, LayerNorm and the fused attention block (port of
`leaf_tpu/ops/packed_attention.py`).

Three ops, each a hand-written CUDA kernel (`csrc/`) beside its plain
PyTorch version:

  * `packed_attention(qkv, n_heads, group_len, causal)`: block-diagonal
    (optionally causal) multi-head attention on the fused, token-major
    qkv `[R, L, 3D] -> [R, L, D]`.  Rows hold `L // group_len`
    independent sequences; attention never crosses a `group_len`
    boundary.  Kernel: `csrc/packed_attention.cu`; plain version:
    `_reference`.
  * `fused_attention_block(p, x, n_heads, group_len, causal, ln_eps)`:
    `x + out_proj(packed_attention(qkv_proj(ln_1(x))))`, the Hopper
    counterpart of the Pallas `_block_kernel`.  One C call
    (`leaf_fused_block` of `csrc/fused_block.cu`) launches LayerNorm, the
    qkv GEMM, the packed-attention kernel and the out-projection GEMM in
    order on the current stream; the wrapper allocates the output and one
    scratch buffer for the three intermediates.  The GEMMs are bound by
    the tensor cores: bf16 runs on `wgmma` fed by TMA (persistent
    128 x {256, 192, 128} tiles picked from the shape), fp32 on TF32
    `wgmma` with split operands (3xTF32: three TF32 products per fp32
    product, fp32 accuracy) fed by a `cp.async` ring.  Plain version:
    `_block_reference`.
  * `layer_norm(x, scale, bias, eps)`: fp32-statistics LayerNorm over the
    last dimension, the block's first stage on its own (`leaf_layer_norm`
    of `csrc/layer_norm.cu`), for every other LayerNorm of the towers
    (`layers.LayerNorm`).  Bound by memory: a row is read once in aligned
    16-byte pieces (its head and tail, where it has them, in words), kept
    in registers by 4 to 256 threads and written once.
    `layer_norm_plan` mirrors the kernel's choice in Python.  Plain
    version: `_layer_norm_reference`.
  * `gemm_bias(a, w, bias)`: `a @ w (+ bias)`, the block's GEMM kernel on
    its own (`leaf_gemm_bias` of `csrc/fused_block.cu`), for the
    tensor-parallel block (`parallel.sharding`), which cannot end in the
    fused block's residual: a rank's qkv columns and its rows of the
    out-projection, whose partial products are summed across the ranks
    before the bias.  Plain version: `_gemm_bias_reference`.

The packed-attention kernel runs on the tensor cores in both dtypes
(`csrc/attention_mma.cuh`, shared with flash attention's bf16 body):
bf16 products directly, float32 ones as three TF32 products of operands
split into hi + lo (3xTF32), which keeps fp32 accuracy where one TF32
pass would not.  `tile_schedule` below mirrors its schedule in Python for
the CPU tests (fp32 blocks stage fewer keys whole: its rows take twice
the bytes), `kernel_schedule` asks the built library for it, and
`staged_bytes` gives a plan's shared memory.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.  There
is no size gate and no fallback.  Each op counts its kernel launches in
an integer attribute (`packed_attention.launches`,
`fused_attention_block.launches`, `layer_norm.launches`,
`gemm_bias.launches`); the fused block runs the packed-attention kernel,
so it counts there too, and its own LayerNorm and GEMM stages count under
the block, not under `layer_norm` or `gemm_bias`.

Each CUDA path is a `torch.autograd.Function` whose backward runs hand
kernels and cuBLAS products, never a plain version:

  * `packed_attention`: the training forward asks the packed kernel for
    each query's log-sum-exp (fp32 `[R, H, L]`, beside the output; serving
    asks for none) and saves it; the backward, `csrc/attention_backward.cu`,
    runs two kernels (dQ with each query's delta, then dK and dV) from qkv,
    the saved output, its log-sum-exp and the output's gradient to dqkv in
    the fused token-major layout, each block staging the other operand
    whole in 64-row chunks whose copies overlap the products (a ring of two
    past 352 bf16 or 144 fp32 rows), each warp's own 16 rows held in
    registers; `backward_schedule` mirrors its plan;
  * `layer_norm`: `csrc/layer_norm_backward.cu`, dx by row streams (4 to 16
    threads, or 1 to 8 warps, a row, the rows in registers, the next row's
    loads issued before the current row is reduced), the parameters'
    gradients summed in registers over a stream's rows, as one partial row
    a block, then by a second pass over 8-column slices (skipped where the
    input's gradient alone is asked for); `layer_norm_backward_plan`
    mirrors its plan;
  * `fused_attention_block`: saves its inputs alone, as the JAX `_block_fwd`
    does, and recomputes ln_1, the qkv projection and the attention (with
    its log-sum-exp) by the forward kernels (`_launch_block_recompute`),
    then takes the
    out-projection's and the qkv projection's gradients as cuBLAS products
    (`_mm`), dqkv by the attention backward and dx by the LayerNorm
    backward, each only where `ctx.needs_input_grad` asks (PGD through a
    frozen tower runs no weight product);
  * `gemm_bias`: `g w^T`, `a^T g` and the column sums of g, as asked.

Their plain versions, `_packed_attention_backward_reference` and
`_layer_norm_backward_reference`, are explicit formulas beside the
kernels for the tests and `chip_smoke.py`.  Each backward counts its
launches (`packed_attention.backward_launches`,
`layer_norm.backward_launches`, `fused_attention_block.backward_launches`,
the block's one count covering its recomputation, whose forward kernels
count under the block and not under their ops); every plain version
counts its calls on a CUDA tensor in `PLAIN_ON_CUDA`, which a training
path on the card leaves at 0.  On the CPU the ops run their plain
forward versions, with autograd through them.

The three ops are also registered as `torch.library` custom ops,
`torch.ops.leaf_tpu_torch.{packed_attention, fused_attention_block,
layer_norm}`, each with a fake (shape) implementation and a flop formula
(`torch.utils.flop_counter`).  Inside `with dispatcher():` the public ops
go through them, so that `torch.export` records each as one node of the
graph (an exported model needs `import leaf_tpu_torch.ops` to load) and
`FlopCounterMode` sees them; a ctypes call is invisible to both.  The
registered implementation dispatches by device as the public op does,
and counts its launches the same way.  Outside the context, eager calls
skip the dispatcher, whose overhead the small shapes would feel; the
custom ops have no autograd formula, so the context is for inference.
"""
from __future__ import annotations

import contextlib
from typing import Mapping, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from leaf_tpu_torch.ops import build

_NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DType

# calls of a plain version on a CUDA tensor: the comparisons of `chip_smoke.py`
# make them on purpose; a training or serving path on the card makes none
PLAIN_ON_CUDA = {"calls": 0}


def _note_plain(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        PLAIN_ON_CUDA["calls"] += 1


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def block_mask(L: int, group_len: int, causal: bool,
               device=None) -> torch.Tensor:
    """Boolean [L, L]: key j is visible to query i (same `group_len`
    block, and j <= i when causal)."""
    ids = torch.arange(L, device=device)
    mask = ids[:, None] // group_len == ids[None, :] // group_len
    if causal:
        mask &= ids[None, :] <= ids[:, None]
    return mask


def _key_range(q0: int, q1: int, L: int, group_len: int, causal: bool):
    """Keys [k0, k1) that queries [q0, q1) of one row may attend to."""
    k0 = q0 // group_len * group_len
    k1 = min(((q1 - 1) // group_len + 1) * group_len, L)
    return k0, min(k1, q1) if causal else k1


TILE = 16             # queries a warp owns
MAX_WARPS = 8         # warps (query tiles) per block
ONLINE_CHUNK = 64     # keys per pass of the online softmax, and per ring stage
# most key rows a block stages at once: what fits 232,448 bytes of shared
# memory beside the query tile at a head width of 128
MAX_WHOLE_CHUNK = {torch.bfloat16: 352, torch.float32: 144}
ROW_PAD = {torch.bfloat16: 8, torch.float32: 4}   # elements past a staged row
SMEM_LIMIT = 232_448  # dynamic shared memory of a block on sm_90


def tile_schedule(L: int, group_len: int, causal: bool,
                  allow_exact: bool = True, dtype=torch.bfloat16):
    """The tensor-core kernel's schedule for one row of L tokens in
    `dtype`, as `csrc/attention_mma.cuh` computes it (`make_plan` on the
    host, the key passes in `attention_kernel`).

    Returns `(plan, tiles)`.  `plan`: warps (16-query tiles) per block,
    blocks per (row, head), keys per staged chunk, stages (1: a block
    copies its whole key range at once, at most `MAX_WHOLE_CHUNK[dtype]`
    rows; 2: a ring of 64-key stages), and whether the exact two-pass
    softmax runs (every tile's keys fit in `nt` * 8 logit columns; flash
    attention passes `allow_exact=False`) or the online one.  `tiles`: for
    each 16-query tile `(q0, q1, spans)`, `spans` the `[lo, hi)` key
    ranges, in steps of 16 keys and at most `nt` * 8 wide, that the tile's
    warp computes logits for, one per pass."""
    n_tiles = -(-L // TILE)
    blocks = -(-n_tiles // MAX_WARPS)
    warps = -(-n_tiles // blocks)
    ranges = []      # (block key range, tile, tile key range)
    for bq0 in range(0, L, warps * TILE):
        bq1 = min(bq0 + warps * TILE, L)
        bk = _key_range(bq0, bq1, L, group_len, causal)
        for wq0 in range(bq0, bq1, TILE):
            wq1 = min(wq0 + TILE, bq1)
            ranges.append((bk, (wq0, wq1),
                           _key_range(wq0, wq1, L, group_len, causal)))
    span = max(bk1 - bk0 for (bk0, bk1), _, _ in ranges)
    steps = max(-(-(wk1 - bk0 - ((wk0 - bk0) & ~15)) // 16)
                for (bk0, _), _, (wk0, wk1) in ranges)
    whole = (span + 15) & ~15
    stages = 1 if whole <= MAX_WHOLE_CHUNK[dtype] else 2
    chunk = whole if stages == 1 else ONLINE_CHUNK
    exact = allow_exact and steps <= 5 and stages == 1
    nt = (2 if steps <= 1 else 10) if exact else ONLINE_CHUNK // 8
    plan = {"warps": warps, "blocks": blocks, "chunk": chunk,
            "stages": stages, "exact": exact, "nt": nt}
    tiles = []
    for (bk0, bk1), (wq0, wq1), (wk0, wk1) in ranges:
        spans = []
        for cs in range(bk0, bk1, chunk):
            lo, hi = max(wk0, cs) - cs, min(wk1, cs + chunk) - cs
            for k in range(lo & ~15, hi, 8 * nt):
                k_end = min(hi, k + 8 * nt)
                spans.append((cs + k, cs + k + 16 * -(-(k_end - k) // 16)))
        tiles.append((wq0, wq1, spans))
    return plan, tiles


def staged_bytes(plan: Mapping, head_dim: int, dtype) -> int:
    """Shared memory of one block under `plan` (`tile_schedule`'s) at
    `head_dim`, as `launch_variant` sizes it: the query tile and the
    staged K and V chunks, rows of the head width rounded up to 32 plus
    `ROW_PAD[dtype]` elements."""
    row = (-(-head_dim // 32) * 32 + ROW_PAD[dtype]) * dtype.itemsize
    return row * (plan["warps"] * TILE + 2 * plan["stages"] * plan["chunk"])


def kernel_schedule(L: int, group_len: int, causal: bool,
                    allow_exact: bool = True, dtype=torch.bfloat16):
    """What `tile_schedule` mirrors, from the built library itself
    (`leaf_attention_schedule`: `make_plan` and `list_passes` of
    `csrc/attention_mma.cuh`, run on the host), in the same form.  Needs
    the CUDA toolkit, not a card; `chip_smoke.py` holds the two equal."""
    import ctypes
    cap = 4 * (-(-L // TILE)) * (-(-L // TILE) + 1)
    plan, passes = (ctypes.c_int * 6)(), (ctypes.c_int * (3 * cap))()
    n = build.library().leaf_attention_schedule(
        L, group_len, int(causal), int(allow_exact), _DTYPE_CODES[dtype],
        plan, passes, cap)
    if n < 0:
        raise RuntimeError(f"leaf_attention_schedule({L}, {group_len}, "
                           f"{causal}, {allow_exact}, {dtype}) returned {n}")
    warps, blocks, chunk, stages, nt, exact = plan
    tiles = [(q0, min(q0 + TILE, L), []) for q0 in range(0, L, TILE)]
    for t, lo, hi in zip(*(passes[i:3 * n:3] for i in range(3))):
        tiles[t][2].append((lo, hi))
    return ({"warps": warps, "blocks": blocks, "chunk": chunk,
             "stages": stages, "exact": bool(exact), "nt": nt}, tiles)


LN_THREADS = 256   # threads of a LayerNorm block
LN_ROW_REGS = 64   # 32-bit registers of row data a LayerNorm thread may hold
LN_VARIANTS = ("rows", "registers", "global")


def layer_norm_plan(D: int, dtype, aligned: bool = True) -> dict:
    """The LayerNorm kernel's plan for rows of D elements of `dtype`, as
    `make_plan` in `csrc/layer_norm.cu` computes it; `aligned`: x, the
    output, scale and bias all on 16-byte boundaries (what the op's
    checks and allocations give).

    A row moves in aligned 16-byte pieces (`unit`); where its bytes are no
    whole number of pieces, its head and tail (the bytes before its first
    16-byte boundary and after its last piece) move in `edge`-byte units
    (4, or 2 for bf16 rows of odd width).  `threads` a row, `per`: pieces
    a thread holds as compiled, `rows` a block of `LN_THREADS`.
    `variant`: "rows" (whole pieces, D <= 1024, 32 or more pieces: a warp
    a row), "registers" (the row in the registers of 4 or 8 threads when
    it is fewer than 32 whole pieces, else of 1 to 8 warps, at most
    `LN_ROW_REGS` registers of it a thread) or "global" (rows wider than a
    block's registers, or unaligned pointers: three passes over the row in
    device memory, element by element)."""
    es = dtype.itemsize
    nbytes = D * es
    pieces = nbytes // 16
    cap = LN_ROW_REGS // 4
    edge = 0 if nbytes % 16 == 0 else 4 if nbytes % 4 == 0 else es
    warps = 1
    while warps < LN_THREADS // 32 and -(-pieces // (32 * warps)) > cap:
        warps *= 2
    need = -(-pieces // (32 * warps))
    unit = 16
    if not aligned or need > cap:
        variant, unit, edge, threads, per = "global", es, 0, 32, 0
    elif edge == 0 and pieces >= 32 and D <= 1024:
        variant, threads, per = "rows", 32, 1024 // (32 * (16 // es))
    elif edge == 0 and pieces < 32:
        variant, threads, per = "registers", 4 if pieces <= 16 else 8, 4
    else:
        variant, threads, per = "registers", 32 * warps, 8 if need <= 8 else 16
    return {"variant": variant, "unit": unit, "edge": edge,
            "threads": threads, "per": per, "rows": LN_THREADS // threads}


def kernel_layer_norm_plan(D: int, dtype, aligned: bool = True) -> dict:
    """What `layer_norm_plan` mirrors, from the built library itself
    (`leaf_layer_norm_plan`, run on the host).  Needs the CUDA toolkit,
    not a card; `chip_smoke.py` holds the two equal."""
    import ctypes
    plan = (ctypes.c_int * 6)()
    build.check(build.library().leaf_layer_norm_plan(
        D, _DTYPE_CODES[dtype], int(aligned), plan), "leaf_layer_norm_plan")
    variant, unit, edge, threads, per, rows = plan
    return {"variant": LN_VARIANTS[variant], "unit": unit, "edge": edge,
            "threads": threads, "per": per, "rows": rows}


MAX_HEAD_DIM = 128    # the widest head both attention kernels take
BWD_MAX_WARPS = 6     # 16-row tiles (warps) of an attention backward block
BWD_CHUNK = 64        # rows of an attention backward block's staged chunk


def _query_range(k0: int, k1: int, L: int, group_len: int, causal: bool):
    """Queries [i0, i1) of one row that attend to keys [k0, k1)."""
    i0 = k0 // group_len * group_len
    i1 = min(((k1 - 1) // group_len + 1) * group_len, L)
    return (max(i0, k0) if causal else i0), i1


def backward_schedule(L: int, group_len: int, causal: bool,
                      dtype=torch.bfloat16, max_whole: int = 0) -> dict:
    """The attention backward kernels' plan for one row of L tokens in
    `dtype`, as `leaf_attention_backward_schedule` in
    `csrc/attention_backward.cu` computes it.  Both kernels split the row
    into 16-row tiles, a warp each, and the tiles into the fewest blocks
    of at most `BWD_MAX_WARPS`, evenly: `warps` a block, `blocks` a (row,
    head).  `dq`: each dQ block's `(q0, q1, k0, k1)`, its queries and the
    keys they see; `dkv`: each dK/dV block's `(k0, k1, i0, i1)`, its keys
    and the queries that see them.  A block stages that range of the other
    operand in `BWD_CHUNK`-row chunks: whole where the kernel's widest
    range, rounded up to 16, is at most `MAX_WHOLE_CHUNK[dtype]` (or
    `max_whole`, where that is positive and lower): `dq_whole` /
    `dkv_whole` rows, else 0: a ring of two chunks."""
    limit = MAX_WHOLE_CHUNK[dtype]
    if 0 < max_whole < limit:
        limit = max_whole
    tiles = -(-L // TILE)
    blocks = -(-tiles // BWD_MAX_WARPS)
    warps = -(-tiles // blocks)
    dq, dkv = [], []
    for a0 in range(0, L, warps * TILE):
        a1 = min(a0 + warps * TILE, L)
        dq.append((a0, a1, *_key_range(a0, a1, L, group_len, causal)))
        dkv.append((a0, a1, *_query_range(a0, a1, L, group_len, causal)))

    def whole(ranges):
        rows = (max(b1 - b0 for _, _, b0, b1 in ranges) + 15) & ~15
        return rows if rows <= limit else 0
    return {"warps": warps, "blocks": blocks, "chunk": BWD_CHUNK,
            "dq_whole": whole(dq), "dkv_whole": whole(dkv), "dq": dq,
            "dkv": dkv}


def kernel_backward_schedule(L: int, group_len: int, causal: bool,
                             dtype=torch.bfloat16,
                             max_whole: int = 0) -> dict:
    """What `backward_schedule` mirrors, from the built library itself.
    Needs the CUDA toolkit, not a card; `chip_smoke.py` holds the two
    equal."""
    import ctypes
    cap = 8 * -(-L // TILE)
    plan, ranges = (ctypes.c_int * 4)(), (ctypes.c_int * cap)()
    n = build.library().leaf_attention_backward_schedule(
        L, group_len, int(causal), _DTYPE_CODES[dtype], max_whole, plan,
        ranges, cap)
    if n < 0:
        raise RuntimeError(f"leaf_attention_backward_schedule({L}, "
                           f"{group_len}, {causal}, {dtype}) returned {n}")
    quads = [tuple(ranges[4 * b:4 * b + 4]) for b in range(2 * n)]
    warps, blocks, dq_whole, dkv_whole = plan
    return {"warps": warps, "blocks": blocks, "chunk": BWD_CHUNK,
            "dq_whole": dq_whole, "dkv_whole": dkv_whole, "dq": quads[:n],
            "dkv": quads[n:]}


LN_BWD_MAX_BLOCKS = 264      # blocks of the LayerNorm backward's first kernel
LN_BWD_MAX_ROW_BYTES = 32_768  # the widest row it takes: 8 pieces a thread
LN_BWD_PIECES = 6            # pieces a lane of a warp-a-row plan, at most
_LN_BWD_KEYS = ("threads", "per", "edge", "rows", "blocks")


def layer_norm_backward_plan(M: int, D: int, dtype=torch.bfloat16) -> dict:
    """The LayerNorm backward kernel's plan for M rows of D elements of
    `dtype`, as `make_plan` in `csrc/layer_norm_backward.cu` computes it.
    A row moves in 16-byte pieces, its head and tail (where its bytes are
    no whole number of pieces) in `edge`-byte units (4, or 2 in bf16 rows
    of odd width; 0: none).  `threads` a row: 4, 8 or 16 where the row is
    at most 64 whole pieces, else the fewest warps (up to 8) that hold it
    at `LN_BWD_PIECES` pieces a lane; `per`: pieces a thread as compiled
    (4, 5, 6 or 8; 0: the row is wider than `LN_BWD_MAX_ROW_BYTES`);
    `rows`: row streams a block of `LN_THREADS`; `blocks`: at most
    `LN_BWD_MAX_BLOCKS`, each writing one row of the parameters' partial
    sums."""
    nbytes = D * dtype.itemsize
    pieces = nbytes // 16
    edge = 0 if nbytes % 16 == 0 else 4 if nbytes % 4 == 0 else dtype.itemsize
    if nbytes > LN_BWD_MAX_ROW_BYTES:
        threads, per = LN_THREADS, 0
    elif edge == 0 and pieces <= 64:
        threads, per = 4 if pieces <= 16 else 8 if pieces <= 32 else 16, 4
    else:
        warps = 1
        while (warps < LN_THREADS // 32
               and -(-pieces // (32 * warps)) > LN_BWD_PIECES):
            warps *= 2
        threads = 32 * warps
        need = -(-pieces // threads)
        per = (4 if need <= 4 else 5 if need <= 5 and edge != 2
               else 6 if need <= 6 else 8)
    rows = LN_THREADS // threads
    return dict(zip(_LN_BWD_KEYS, (threads, per, edge, rows,
                                   min(-(-M // rows), LN_BWD_MAX_BLOCKS))))


def kernel_layer_norm_backward_plan(M: int, D: int,
                                    dtype=torch.bfloat16) -> dict:
    """What `layer_norm_backward_plan` mirrors, from the built library
    (`leaf_layer_norm_backward_plan`, run on the host)."""
    import ctypes
    plan = (ctypes.c_int * 5)()
    build.check(build.library().leaf_layer_norm_backward_plan(
        M, D, _DTYPE_CODES[dtype], plan), "leaf_layer_norm_backward_plan")
    return dict(zip(_LN_BWD_KEYS, plan))


def _reference(qkv: torch.Tensor, n_heads: int, group_len: int,
               causal: bool, with_lse: bool = False):
    """Token-major attention with the block-diagonal semantics (numerics of
    `layers.attention`): fp32 logits and softmax, probabilities in the
    input dtype, PV accumulated in fp32.  `with_lse`: also each query's
    log-sum-exp of its masked logits, fp32 `[R, H, L]`, what the backward
    takes (the kernel's training forward writes it)."""
    _note_plain(qkv)
    R, L, threeD = qkv.shape
    D = threeD // 3
    hd = D // n_heads
    q, k, v = (t.reshape(R, L, n_heads, hd) for t in qkv.split(D, dim=-1))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    s = s.masked_fill(~block_mask(L, group_len, causal, qkv.device), _NEG)
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    o = o.to(qkv.dtype).reshape(R, L, D)
    return (o, torch.logsumexp(s, dim=-1)) if with_lse else o


def _layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics and parameters, cast back to x's
    dtype (the numerics of the LayerNorm kernel)."""
    _note_plain(x)
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def _gemm_bias_reference(a: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor],
                         residual: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """`(residual +) a @ w + bias` at the GEMM kernel's rounding points:
    the product and the bias (none where None) summed in fp32 and rounded
    once, the residual added as a sum of two values of the dtype."""
    _note_plain(a)
    y = a.float() @ w.float()
    y = (y if bias is None else y + bias.float()).to(a.dtype)
    return y if residual is None else residual + y


def _block_reference(p: Mapping, x: torch.Tensor, n_heads: int,
                     group_len: int, causal: bool,
                     ln_eps: float) -> torch.Tensor:
    """Plain fused block (same numerics as `layers.ResidualBlock`'s
    attention half); the test oracle."""
    _note_plain(x)
    R, L, D = x.shape
    a = p["attn"]

    def linear(t, w, b):   # t @ w + b, bias added before the product's rounding
        return torch.addmm(b.to(x.dtype), t.reshape(R * L, -1),
                           w.to(x.dtype)).reshape(R, L, -1)

    h = _layer_norm_reference(x, p["ln_1"]["scale"], p["ln_1"]["bias"],
                              ln_eps)
    qkv = linear(h, a["qkv_w"], a["qkv_b"])
    o = _reference(qkv, n_heads, group_len, causal)
    return x + linear(o, a["out_w"], a["out_b"])


def _packed_attention_backward_reference(
        qkv: torch.Tensor, out: torch.Tensor, lse: Optional[torch.Tensor],
        dout: torch.Tensor, n_heads: int, group_len: int,
        causal: bool) -> torch.Tensor:
    """The gradient of `packed_attention` at qkv `[R, L, 3D]`, given its
    output `out` and the output's gradient `dout` `[R, L, D]` (one dtype),
    as explicit formulas at the backward kernel's rounding points: fp32
    logits, probabilities and sums; delta = rowsum(dout * out); dP = dout
    v^T and the probabilities that multiply dout rounded to the dtype, as
    the autograd of `_reference` rounds them.  `lse`: the rows' fp32
    log-sum-exp `[R, H, L]` (the forward's, as the kernel takes it), or
    None to take it from qkv.  Returns dqkv `[R, L, 3D]` in the dtype."""
    _note_plain(qkv)
    R, L, threeD = qkv.shape
    D = threeD // 3
    hd = D // n_heads
    scale = hd ** -0.5

    def heads(t):     # [R, L, D] -> [R, H, L, hd], fp32
        return t.reshape(R, L, n_heads, hd).transpose(1, 2).float()

    q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
    do, o = heads(dout), heads(out)
    s = (q @ k.transpose(-1, -2)) * scale
    s = s.masked_fill(~block_mask(L, group_len, causal, qkv.device), _NEG)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])         # masked pairs: exactly 0
    delta = (do * o).sum(-1, keepdim=True)
    dp = (do @ v.transpose(-1, -2)).to(qkv.dtype).float()
    ds = p * (dp - delta) * scale
    grads = (ds @ k, ds.transpose(-1, -2) @ q,
             p.to(qkv.dtype).float().transpose(-1, -2) @ do)
    return torch.cat([t.transpose(1, 2).reshape(R, L, D) for t in grads],
                     dim=-1).to(qkv.dtype)


def _layer_norm_backward_reference(x: torch.Tensor, scale: torch.Tensor,
                                   bias: torch.Tensor, eps: float,
                                   dy: torch.Tensor):
    """`(dx, dscale, dbias)` of `_layer_norm_reference` at x `[..., D]` for
    the output's gradient dy, as explicit formulas in fp32 with the
    kernel's statistics: x^ = (x - mean) rstd, g = dy scale, dx = rstd (g
    - mean(g) - x^ mean(g x^)) in x's dtype; dscale = sum dy x^ and dbias
    = sum dy over the rows, fp32 `[D]` (bias takes no part)."""
    _note_plain(x)
    D = x.shape[-1]
    x32, dy32 = x.reshape(-1, D).float(), dy.reshape(-1, D).float()
    mu = x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mu).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (x32 - mu) * rstd
    g = dy32 * scale.float()
    dx = rstd * (g - g.mean(dim=-1, keepdim=True)
                 - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    return (dx.to(x.dtype).reshape(x.shape), (dy32 * xhat).sum(0),
            dy32.sum(0))


# ---------------------------------------------------------------------------
# Argument checks (both paths) and kernel launchers (CUDA only)
# ---------------------------------------------------------------------------

def _check_tensor(name: str, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_activation(name: str, t, width_factor: int, n_heads: int,
                      group_len: int) -> None:
    if not isinstance(t, torch.Tensor) or t.dim() != 3:
        raise ValueError(f"{name}: expected a 3-D tensor [R, L, {width_factor}D]")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype}; the kernels take "
                        "float32 or bfloat16")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.shape[-1] % width_factor or (t.shape[-1] // width_factor) % n_heads:
        raise ValueError(f"{name}: width {t.shape[-1]} does not split into "
                         f"{width_factor} x {n_heads} heads")
    if group_len < 1:
        raise ValueError(f"group_len must be >= 1, got {group_len}")
    head_dim = t.shape[-1] // width_factor // n_heads
    if t.dtype == torch.bfloat16 and head_dim % 8:
        raise ValueError(f"{name}: head width {head_dim}; the bfloat16 kernel "
                         "copies rows in 16-byte pieces and takes a multiple "
                         "of 8")
    _check_tensor(name, t, t.dtype, t.shape, t.device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _packed_attention_kernel(qkv: torch.Tensor, n_heads: int,
                             group_len: int, causal: bool,
                             with_lse: bool = False):
    """The packed-attention kernel's launch, uncounted (its callers count
    it: the op, or the block's backward).  `with_lse`: the kernel also
    writes each query's log-sum-exp, fp32 `[R, H, L]`, for the backward,
    and the launch returns `(out, lse)`; serving asks for none."""
    R, L, threeD = qkv.shape
    D = threeD // 3
    hd = D // n_heads
    out = torch.empty((R, L, D), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((R, n_heads, L), dtype=torch.float32,
                       device=qkv.device) if with_lse else None)
    build.check(build.library().leaf_packed_attention(
        qkv.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        _DTYPE_CODES[qkv.dtype], R, L, n_heads, hd, group_len, int(causal),
        hd ** -0.5, qkv.device.index, _stream(qkv)), "packed_attention kernel")
    return (out, lse) if with_lse else out


def _launch_packed_attention(qkv: torch.Tensor, n_heads: int, group_len: int,
                             causal: bool, with_lse: bool = False):
    out = _packed_attention_kernel(qkv, n_heads, group_len, causal, with_lse)
    packed_attention.launches += 1
    return out


def _launch_packed_attention_backward(qkv: torch.Tensor, out: torch.Tensor,
                                      lse: torch.Tensor, dout: torch.Tensor,
                                      n_heads: int, group_len: int,
                                      causal: bool,
                                      max_whole: int = 0) -> torch.Tensor:
    """dqkv from qkv, the forward's output, its log-sum-exp (fp32 `[R, H,
    L]`, the training forward's) and the output's gradient: one C call
    (`leaf_packed_attention_backward`) for the dQ and the dK/dV kernels,
    with an fp32 scratch of each query's delta.  `max_whole` lowers the
    rows a block stages whole (`backward_schedule`; 0: the dtype's
    limit)."""
    R, L, threeD = qkv.shape
    D = threeD // 3
    hd = D // n_heads
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"packed_attention backward: head width {hd}; the "
                         f"kernel takes at most {MAX_HEAD_DIM}")
    _check_tensor("out", out, qkv.dtype, (R, L, D), qkv.device)
    _check_tensor("lse", lse, torch.float32, (R, n_heads, L), qkv.device)
    _check_tensor("dout", dout, qkv.dtype, (R, L, D), qkv.device)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((R, n_heads, L), dtype=torch.float32,
                        device=qkv.device)
    build.check(build.library().leaf_packed_attention_backward(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
        dqkv.data_ptr(), delta.data_ptr(), _DTYPE_CODES[qkv.dtype], R, L,
        n_heads, hd, group_len, int(causal), hd ** -0.5, max_whole,
        qkv.device.index, _stream(qkv)), "packed_attention backward kernels")
    packed_attention.backward_launches += 1
    return dqkv


def _launch_gemm_bias(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      residual: Optional[torch.Tensor] = None,
                      tile_n: int = 0) -> torch.Tensor:
    """The block's GEMM kernel alone, `(residual +) a @ w + bias` on CUDA
    tensors `[M, K]`, `[K, N]`, `[N]` (`[M, N]`) of one dtype; `tile_n`
    forces the bf16 tile width (256, 192 or 128; 0: picked from the
    shape).  The towers reach the kernel through `fused_attention_block`
    and, under tensor parallelism, `gemm_bias`; `chip_smoke.py` and the
    profiler call it here."""
    (M, K), N = a.shape, w.shape[1]
    _check_tensor("a", a, a.dtype, (M, K), a.device)
    _check_tensor("w", w, a.dtype, (K, N), a.device)
    _check_tensor("bias", bias, a.dtype, (N,), a.device)
    if residual is not None:
        _check_tensor("residual", residual, a.dtype, (M, N), a.device)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    build.check(build.library().leaf_gemm_bias_tile(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[a.dtype], M, N, K, tile_n, a.device.index, _stream(a)),
        "GEMM + bias kernel")
    return out


_ZERO_BIAS = {}


def _zero_bias(n: int, like: torch.Tensor) -> torch.Tensor:
    """A zero bias [n] in `like`'s dtype and device (the kernel takes a
    bias; adding zeros to the fp32 accumulator leaves it as it is)."""
    key = (n, like.dtype, like.device)
    if key not in _ZERO_BIAS:
        _ZERO_BIAS[key] = torch.zeros(n, dtype=like.dtype, device=like.device)
    return _ZERO_BIAS[key]


def _launch_gemm(a: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    """`gemm_bias`'s launch: counted, `bias` None as zeros."""
    out = _launch_gemm_bias(a, w, _zero_bias(w.shape[1], a)
                            if bias is None else bias)
    gemm_bias.launches += 1
    return out


def _launch_fused_block(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                        n_heads: int, group_len: int, causal: bool,
                        ln_eps: float) -> torch.Tensor:
    """One C call for the block's four kernels; `h`, `qkv` and `attn` are
    views of one scratch allocation."""
    R, L, D = x.shape
    n = R * L * D
    scratch = torch.empty(5 * n, dtype=x.dtype, device=x.device)
    h, qkv, attn = scratch[:n], scratch[n:4 * n], scratch[4 * n:]
    out = torch.empty_like(x)
    build.check(build.library().leaf_fused_block(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        qkv_w.data_ptr(), qkv_b.data_ptr(), out_w.data_ptr(),
        out_b.data_ptr(), h.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[x.dtype], R, L, D, n_heads, group_len,
        int(causal), ln_eps, (D // n_heads) ** -0.5, x.device.index,
        _stream(x)), "fused attention block kernels")
    fused_attention_block.launches += 1
    packed_attention.launches += 1
    return out


def _layer_norm_kernel(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The LayerNorm kernel's launch on a non-empty x, uncounted."""
    out = torch.empty_like(x)
    D = x.shape[-1]
    build.check(build.library().leaf_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[x.dtype], x.numel() // D, D, eps, x.device.index,
        _stream(x)), "LayerNorm kernel")
    return out


def _launch_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float) -> torch.Tensor:
    if not x.numel():
        return torch.empty_like(x)
    out = _layer_norm_kernel(x, scale, bias, eps)
    layer_norm.launches += 1
    return out


def _launch_layer_norm_backward(x: torch.Tensor, scale: torch.Tensor,
                                dy: torch.Tensor, eps: float, params: bool):
    """`(dx, dscale, dbias)` of the LayerNorm at x for the output's gradient
    dy (x's dtype and shape); `params` False: the input's gradient alone
    (dscale and dbias None, no partial sums, one kernel)."""
    _check_tensor("dy", dy, x.dtype, x.shape, x.device)
    D = x.shape[-1]
    M = x.numel() // D
    if not M:
        zeros = torch.zeros(D, dtype=torch.float32, device=x.device)
        return torch.empty_like(x), *((zeros, zeros.clone()) if params
                                      else (None, None))
    plan = layer_norm_backward_plan(M, D, x.dtype)
    if not plan["per"]:
        raise ValueError(f"layer_norm backward: rows of {D} elements; the "
                         "kernel takes at most "
                         f"{LN_BWD_MAX_ROW_BYTES // x.dtype.itemsize}")
    dx = torch.empty_like(x)
    dscale = dbias = partials = None
    if params:
        dscale, dbias = (torch.empty(D, dtype=torch.float32, device=x.device)
                         for _ in range(2))
        partials = torch.empty((2, plan["blocks"], D), dtype=torch.float32,
                               device=x.device)
    build.check(build.library().leaf_layer_norm_backward(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        *(None if t is None else t.data_ptr()
          for t in (dscale, dbias, partials)),
        _DTYPE_CODES[x.dtype], M, D, eps, x.device.index, _stream(x)),
        "LayerNorm backward kernel")
    layer_norm.backward_launches += 1
    return dx, dscale, dbias


def _launch_block_recompute(x, ln_scale, ln_bias, qkv_w, qkv_b, n_heads: int,
                            group_len: int, causal: bool, ln_eps: float):
    """The fused block's intermediates for its backward, by the forward
    kernels: `h = ln_1(x)` (LayerNorm kernel), `qkv = h @ qkv_w + qkv_b`
    (GEMM kernel), the attention output `o` and its log-sum-exp `lse`
    (packed kernel, asked for it), counted once as the block's
    backward."""
    R, L, D = x.shape
    h = _layer_norm_kernel(x, ln_scale, ln_bias, ln_eps)
    qkv = _launch_gemm_bias(h.reshape(R * L, D), qkv_w, qkv_b)
    qkv = qkv.reshape(R, L, 3 * D)
    o, lse = _packed_attention_kernel(qkv, n_heads, group_len, causal,
                                      with_lse=True)
    fused_attention_block.backward_launches += 1
    return h, qkv, o, lse


# ---------------------------------------------------------------------------
# Autograd wrappers: kernel forward, kernel and cuBLAS backward
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product of the backwards: cuBLAS through `torch.matmul`, in the
    operands' dtype (fp32 sums; true fp32 while TF32 is off), as the JAX
    package leaves these products to XLA's VJP."""
    return torch.matmul(a, b)


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, n_heads, group_len, causal):
        out, lse = _launch_packed_attention(qkv, n_heads, group_len, causal,
                                            with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (n_heads, group_len, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        return (_launch_packed_attention_backward(qkv, out, lse,
                                                  g.contiguous(), *ctx.args),
                None, None, None)


_BLOCK_KEYS = (("ln_1", "scale"), ("ln_1", "bias"), ("attn", "qkv_w"),
               ("attn", "qkv_b"), ("attn", "out_w"), ("attn", "out_b"))


def _block_backward(need, g, x, ln_scale, ln_bias, qkv_w, qkv_b, out_w,
                    out_b, n_heads: int, group_len: int, causal: bool,
                    ln_eps: float) -> list:
    """The gradients of `x + out_proj(attention(qkv_proj(ln_1(x))))` for the
    inputs `need` asks for (x, then `_BLOCK_KEYS`' six), None for the
    others: the intermediates recomputed by the forward kernels, then
    dW_out = o^T g, db_out = sum g, do = g W_out^T, dqkv by the attention
    backward, dW_qkv = h^T dqkv, db_qkv = sum dqkv, dh = dqkv W_qkv^T, and
    dx = g + the LayerNorm backward of dh."""
    R, L, D = x.shape
    M = R * L
    need_x, need_ls, need_lb, need_qw, need_qb, need_ow, need_ob = need
    need_ln = need_x or need_ls or need_lb
    need_qkv = need_ln or need_qw or need_qb
    g2 = g.reshape(M, D)
    grads = [None] * 7
    if need_ob:
        grads[6] = g2.sum(0)
    if not (need_qkv or need_ow):
        return grads
    h, qkv, o, lse = _launch_block_recompute(x, ln_scale, ln_bias, qkv_w,
                                             qkv_b, n_heads, group_len,
                                             causal, ln_eps)
    if need_ow:
        grads[5] = _mm(o.reshape(M, D).t(), g2)
    if not need_qkv:
        return grads
    do = _mm(g2, out_w.t()).reshape(R, L, D)
    dqkv = _launch_packed_attention_backward(qkv, o, lse, do, n_heads,
                                             group_len, causal
                                             ).reshape(M, 3 * D)
    if need_qw:
        grads[3] = _mm(h.reshape(M, D).t(), dqkv)
    if need_qb:
        grads[4] = dqkv.sum(0)
    if need_ln:
        dh = _mm(dqkv, qkv_w.t()).reshape(R, L, D)
        dx, dls, dlb = _launch_layer_norm_backward(x, ln_scale, dh, ln_eps,
                                                   need_ls or need_lb)
        grads[0] = g + dx if need_x else None
        grads[1] = dls if need_ls else None
        grads[2] = dlb if need_lb else None
    return grads


class _FusedAttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                n_heads, group_len, causal, ln_eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b)
        ctx.args = (n_heads, group_len, causal, ln_eps)
        return _launch_fused_block(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w,
                                   out_b, n_heads, group_len, causal, ln_eps)

    @staticmethod
    def backward(ctx, g):
        grads = _block_backward(ctx.needs_input_grad[:7], g.contiguous(),
                                *ctx.saved_tensors, *ctx.args)
        return (*grads, None, None, None, None)


def _gemm_bias_backward(need, a: torch.Tensor, w: torch.Tensor,
                        g: torch.Tensor) -> list:
    """`(da, dw, dbias)` of `a @ w + bias` for the inputs `need` asks for:
    `g w^T`, `a^T g` and the column sums of g, None for the others."""
    return [_mm(g, w.t()) if need[0] else None,
            _mm(a.t(), g) if need[1] else None,
            g.sum(0) if need[2] else None]


class _GemmBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, bias):
        ctx.save_for_backward(a, w)
        return _launch_gemm(a, w, bias)

    @staticmethod
    def backward(ctx, g):
        return tuple(_gemm_bias_backward(ctx.needs_input_grad, *ctx.saved_tensors,
                                         g.contiguous()))


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch_layer_norm(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dscale, dbias = _launch_layer_norm_backward(
            x, scale, g.contiguous(), ctx.eps, need[1] or need[2])
        return (dx if need[0] else None, dscale if need[1] else None,
                dbias if need[2] else None, None)


def _needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on these inputs.  Where it would
    not (serving, the attack's scoring encodes), the ops launch their
    kernels directly: `Function.apply` costs more host time than a small
    kernel takes."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# Public ops
# ---------------------------------------------------------------------------

_ROUTE = {"dispatcher": False}


@contextlib.contextmanager
def dispatcher():
    """Route the public ops through their registered custom ops (for
    `torch.export` and `FlopCounterMode`) while the context is open."""
    saved = _ROUTE["dispatcher"]
    _ROUTE["dispatcher"] = True
    try:
        yield
    finally:
        _ROUTE["dispatcher"] = saved


def packed_attention(qkv: torch.Tensor, n_heads: int, group_len: int,
                     causal: bool = True) -> torch.Tensor:
    """Block-diagonal MHA.  qkv `[R, L, 3D]` token-major (the fused qkv
    projection's output, bias added) -> `[R, L, D]`; `group_len == L` is
    ordinary (causal) attention."""
    if _ROUTE["dispatcher"]:
        return torch.ops.leaf_tpu_torch.packed_attention(qkv, n_heads,
                                                         group_len, causal)
    return _packed_attention(qkv, n_heads, group_len, causal)


def _packed_attention(qkv: torch.Tensor, n_heads: int, group_len: int,
                      causal: bool) -> torch.Tensor:
    _check_activation("qkv", qkv, 3, n_heads, group_len)
    if qkv.device.type == "cpu":
        return _reference(qkv, n_heads, group_len, causal)
    if not _needs_grad(qkv):
        return _launch_packed_attention(qkv, n_heads, group_len, causal)
    return _PackedAttention.apply(qkv, n_heads, group_len, causal)


packed_attention.launches = 0
packed_attention.backward_launches = 0


def fused_attention_block(p: Mapping, x: torch.Tensor, n_heads: int,
                          group_len: int, causal: bool = True,
                          ln_eps: float = 1e-5) -> torch.Tensor:
    """`x + out_proj(packed_attention(qkv_proj(ln_1(x))))`.

    p: a residual block's `{"ln_1": {"scale", "bias"}, "attn": {"qkv_w",
    "qkv_b", "out_w", "out_b"}}`, the JAX layout (`qkv_w` is `[D, 3D]`,
    `y = x @ w`).  LayerNorm parameters are float32; the other weights
    are in x's dtype (the model casts them once).  x `[R, L, D]`
    token-major packed rows."""
    if _ROUTE["dispatcher"]:
        return torch.ops.leaf_tpu_torch.fused_attention_block(
            x, *(p[group][key] for group, key in _BLOCK_KEYS), n_heads,
            group_len, causal, ln_eps)
    return _fused_attention_block(p, x, n_heads, group_len, causal, ln_eps)


def _fused_attention_block(p: Mapping, x: torch.Tensor, n_heads: int,
                           group_len: int, causal: bool,
                           ln_eps: float) -> torch.Tensor:
    _check_activation("x", x, 1, n_heads, group_len)
    D = x.shape[-1]
    wdt = x.dtype
    specs = ((torch.float32, (D,)), (torch.float32, (D,)),
             (wdt, (D, 3 * D)), (wdt, (3 * D,)), (wdt, (D, D)), (wdt, (D,)))
    ts = [p[group][key] for group, key in _BLOCK_KEYS]
    for (group, key), t, (dtype, shape) in zip(_BLOCK_KEYS, ts, specs):
        _check_tensor(f"{group}.{key}", t, dtype, shape, x.device)
    if x.device.type == "cpu":
        return _block_reference(p, x, n_heads, group_len, causal, ln_eps)
    if not _needs_grad(x, *ts):
        return _launch_fused_block(x, *ts, n_heads, group_len, causal, ln_eps)
    return _FusedAttentionBlock.apply(x, *ts, n_heads, group_len, causal,
                                      ln_eps)


fused_attention_block.launches = 0
fused_attention_block.backward_launches = 0


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dimension with fp32 statistics, cast back
    to x's dtype.  x: any leading shape, last dimension D, contiguous,
    float32 or bfloat16; `scale` and `bias`: float32 `[D]`."""
    if _ROUTE["dispatcher"]:
        return torch.ops.leaf_tpu_torch.layer_norm(x, scale, bias, eps)
    return _layer_norm(x, scale, bias, eps)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dim() < 1:
        raise ValueError("x: expected a tensor [..., D]")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x: dtype {x.dtype}; the kernel takes float32 or "
                        "bfloat16")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x: unsupported device {x.device}")
    _check_tensor("x", x, x.dtype, x.shape, x.device)
    for name, t in (("scale", scale), ("bias", bias)):
        _check_tensor(name, t, torch.float32, x.shape[-1:], x.device)
    if x.device.type == "cpu":
        return _layer_norm_reference(x, scale, bias, eps)
    if not _needs_grad(x, scale, bias):
        return _launch_layer_norm(x, scale, bias, eps)
    return _LayerNorm.apply(x, scale, bias, eps)


layer_norm.launches = 0
layer_norm.backward_launches = 0


def gemm_bias(a: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`a @ w (+ bias)`: a `[..., K]` (contiguous), w `[K, N]`, bias `[N]`
    or None, all of one dtype (float32 or bfloat16); the product and the
    bias summed in fp32 and rounded once."""
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"a: dtype {a.dtype}; the kernel takes float32 or "
                        "bfloat16")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a: unsupported device {a.device}")
    K, N = w.shape
    _check_tensor("a", a, a.dtype, a.shape[:-1] + (K,), a.device)
    a2 = a.reshape(-1, K)
    if a.device.type == "cpu":
        _check_tensor("w", w, a.dtype, (K, N), a.device)
        if bias is not None:
            _check_tensor("bias", bias, a.dtype, (N,), a.device)
        out = _gemm_bias_reference(a2, w, bias)
    elif not _needs_grad(a, w, *(() if bias is None else (bias,))):
        out = _launch_gemm(a2, w, bias)
    else:
        out = _GemmBias.apply(a2, w, bias)
    return out.reshape(a.shape[:-1] + (N,))


gemm_bias.launches = 0


# ---------------------------------------------------------------------------
# Custom ops: what `torch.export` records and `FlopCounterMode` counts
# ---------------------------------------------------------------------------

@torch.library.custom_op("leaf_tpu_torch::packed_attention", mutates_args=())
def _packed_attention_op(qkv: torch.Tensor, n_heads: int, group_len: int,
                         causal: bool) -> torch.Tensor:
    return _packed_attention(qkv, n_heads, group_len, causal)


@_packed_attention_op.register_fake
def _(qkv, n_heads, group_len, causal):
    R, L, threeD = qkv.shape
    return qkv.new_empty((R, L, threeD // 3))


@torch.library.custom_op("leaf_tpu_torch::fused_attention_block",
                         mutates_args=())
def _fused_attention_block_op(
        x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
        qkv_w: torch.Tensor, qkv_b: torch.Tensor, out_w: torch.Tensor,
        out_b: torch.Tensor, n_heads: int, group_len: int, causal: bool,
        ln_eps: float) -> torch.Tensor:
    p = {"ln_1": {"scale": ln_scale, "bias": ln_bias},
         "attn": {"qkv_w": qkv_w, "qkv_b": qkv_b, "out_w": out_w,
                  "out_b": out_b}}
    return _fused_attention_block(p, x, n_heads, group_len, causal, ln_eps)


@_fused_attention_block_op.register_fake
def _(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, n_heads, group_len,
      causal, ln_eps):
    return torch.empty_like(x)


@torch.library.custom_op("leaf_tpu_torch::layer_norm", mutates_args=())
def _layer_norm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    return _layer_norm(x, scale, bias, eps)


@_layer_norm_op.register_fake
def _(x, scale, bias, eps):
    return torch.empty_like(x)


# Each formula counts what the op's plain version computes under
# `FlopCounterMode`: its matrix products, 2 operations a multiply-add,
# over every (query, key) pair of the row, the masked ones included, as
# `_reference` computes them all; elementwise work (softmax, LayerNorm,
# bias adds) counts nothing, as `FlopCounterMode` counts none of it.

def _attention_flops(R: int, L: int, D: int) -> int:
    return 2 * (2 * R * L * L * D)       # Q K^T and P V over all heads


@register_flop_formula(torch.ops.leaf_tpu_torch.packed_attention)
def _(qkv_shape, n_heads, group_len, causal, out_shape=None, **kwargs):
    R, L, threeD = qkv_shape
    return _attention_flops(R, L, threeD // 3)


@register_flop_formula(torch.ops.leaf_tpu_torch.fused_attention_block)
def _(x_shape, *args, out_shape=None, **kwargs):
    R, L, D = x_shape
    gemms = 2 * R * L * D * (3 * D) + 2 * R * L * D * D
    return gemms + _attention_flops(R, L, D)


@register_flop_formula(torch.ops.leaf_tpu_torch.layer_norm)
def _(x_shape, *args, out_shape=None, **kwargs):
    return 0
