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
    scratch buffer for the three intermediates.  The bf16 GEMMs are bound
    by the tensor cores and run on `wgmma` fed by TMA (persistent
    128 x {256, 192, 128} tiles picked from the shape); fp32 keeps scalar
    FMAs.  Plain version: `_block_reference`.
  * `layer_norm(x, scale, bias, eps)`: fp32-statistics LayerNorm over the
    last dimension, the block's first stage on its own (`leaf_layer_norm`),
    for every other LayerNorm of the towers (`layers.LayerNorm`).  Bound
    by memory: a warp reads its row once in 16-byte pieces, keeps it in
    registers and writes it once.  Plain version: `_layer_norm_reference`.

The packed-attention kernel has two bodies: bf16 runs on the tensor cores
(`csrc/attention_mma.cuh`, shared with flash attention; `tile_schedule`
below mirrors its schedule in Python for the CPU tests, `kernel_schedule`
asks the built library for it), float32 keeps scalar FMAs, since
the tensor cores would round it to TF32.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.  There
is no size gate and no fallback.  Each op counts its kernel launches in
an integer attribute (`packed_attention.launches`,
`fused_attention_block.launches`, `layer_norm.launches`); the fused
block runs the packed-attention kernel, so it counts there too, and its
own LayerNorm stage counts under the block, not under `layer_norm`.

Each CUDA path is a `torch.autograd.Function` whose backward recomputes
through the plain version, like the JAX `custom_vjp`s.  Serving never
differentiates; the backward is there for the training slices.

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
MAX_WHOLE_CHUNK = 352  # most rows a block stages at once


def tile_schedule(L: int, group_len: int, causal: bool,
                  allow_exact: bool = True):
    """The bf16 kernel's schedule for one row of L tokens, as
    `csrc/attention_mma.cuh` computes it (`make_plan` on the host, the
    key passes in `attention_kernel`).

    Returns `(plan, tiles)`.  `plan`: warps (16-query tiles) per block,
    blocks per (row, head), keys per staged chunk, stages (1: a block
    copies its whole key range at once; 2: a ring of 64-key stages), and
    whether the exact two-pass softmax runs (every tile's keys fit in
    `nt` * 8 logit columns; flash attention passes `allow_exact=False`)
    or the online one.  `tiles`: for each 16-query tile `(q0, q1, spans)`,
    `spans` the `[lo, hi)` key ranges, in steps of 16 keys and at most
    `nt` * 8 wide, that the tile's warp computes logits for, one per
    pass."""
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
    stages = 1 if whole <= MAX_WHOLE_CHUNK else 2
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


def kernel_schedule(L: int, group_len: int, causal: bool,
                    allow_exact: bool = True):
    """What `tile_schedule` mirrors, from the built library itself
    (`leaf_attention_schedule`: `make_plan` and `list_passes` of
    `csrc/attention_mma.cuh`, run on the host), in the same form.  Needs
    the CUDA toolkit, not a card; `chip_smoke.py` holds the two equal."""
    import ctypes
    cap = 4 * (-(-L // TILE)) * (-(-L // TILE) + 1)
    plan, passes = (ctypes.c_int * 6)(), (ctypes.c_int * (3 * cap))()
    n = build.library().leaf_attention_schedule(
        L, group_len, int(causal), int(allow_exact), plan, passes, cap)
    if n < 0:
        raise RuntimeError(f"leaf_attention_schedule({L}, {group_len}, "
                           f"{causal}, {allow_exact}) returned {n}")
    warps, blocks, chunk, stages, nt, exact = plan
    tiles = [(q0, min(q0 + TILE, L), []) for q0 in range(0, L, TILE)]
    for t, lo, hi in zip(*(passes[i:3 * n:3] for i in range(3))):
        tiles[t][2].append((lo, hi))
    return ({"warps": warps, "blocks": blocks, "chunk": chunk,
             "stages": stages, "exact": bool(exact), "nt": nt}, tiles)


def _reference(qkv: torch.Tensor, n_heads: int, group_len: int,
               causal: bool) -> torch.Tensor:
    """Token-major attention with the block-diagonal semantics (numerics of
    `layers.attention`): fp32 logits and softmax, probabilities in the
    input dtype, PV accumulated in fp32."""
    R, L, threeD = qkv.shape
    D = threeD // 3
    hd = D // n_heads
    q, k, v = (t.reshape(R, L, n_heads, hd) for t in qkv.split(D, dim=-1))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    s = s.masked_fill(~block_mask(L, group_len, causal, qkv.device), _NEG)
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o.to(qkv.dtype).reshape(R, L, D)


def _layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics and parameters, cast back to x's
    dtype (the numerics of the LayerNorm kernel)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def _gemm_bias_reference(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         residual: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """`(residual +) a @ w + bias` at the GEMM kernel's rounding points:
    the product and the bias summed in fp32 and rounded once, the residual
    added as a sum of two values of the dtype."""
    y = (a.float() @ w.float() + bias.float()).to(a.dtype)
    return y if residual is None else residual + y


def _block_reference(p: Mapping, x: torch.Tensor, n_heads: int,
                     group_len: int, causal: bool,
                     ln_eps: float) -> torch.Tensor:
    """Plain fused block (same numerics as `layers.ResidualBlock`'s
    attention half); backward recompute and test oracle."""
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


def _launch_packed_attention(qkv: torch.Tensor, n_heads: int, group_len: int,
                             causal: bool) -> torch.Tensor:
    R, L, threeD = qkv.shape
    D = threeD // 3
    hd = D // n_heads
    out = torch.empty((R, L, D), dtype=qkv.dtype, device=qkv.device)
    build.check(build.library().leaf_packed_attention(
        qkv.data_ptr(), out.data_ptr(), _DTYPE_CODES[qkv.dtype], R, L,
        n_heads, hd, group_len, int(causal), hd ** -0.5, qkv.device.index,
        _stream(qkv)), "packed_attention kernel")
    packed_attention.launches += 1
    return out


def _launch_gemm_bias(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      residual: Optional[torch.Tensor] = None,
                      tile_n: int = 0) -> torch.Tensor:
    """The block's GEMM kernel alone, `(residual +) a @ w + bias` on CUDA
    tensors `[M, K]`, `[K, N]`, `[N]` (`[M, N]`) of one dtype; `tile_n`
    forces the bf16 tile width (256, 192 or 128; 0: picked from the
    shape).  For `chip_smoke.py` and the profiler: the towers reach the
    kernel through `fused_attention_block` only."""
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


def _launch_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float) -> torch.Tensor:
    out = torch.empty_like(x)
    D = x.shape[-1]
    if x.numel():
        build.check(build.library().leaf_layer_norm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], x.numel() // D, D, eps, x.device.index,
            _stream(x)), "LayerNorm kernel")
        layer_norm.launches += 1
    return out


# ---------------------------------------------------------------------------
# Autograd wrappers: kernel forward, backward through the plain version
# ---------------------------------------------------------------------------

def _recompute_inputs(ctx) -> list:
    """The saved tensor inputs, detached, each requiring a gradient where
    the caller needs one (a frozen tower's weights do not: PGD asks for
    the input's gradient alone)."""
    return [t.detach().requires_grad_(need) for t, need in
            zip(ctx.saved_tensors, ctx.needs_input_grad)]


def _input_grads(ctx, out, ts, g) -> list:
    """Gradients of `out` (recomputed from `ts`) for the inputs that need
    one, None for the others."""
    need = [t for t in ts if t.requires_grad]
    grads = iter(torch.autograd.grad(out, need, g) if need else ())
    return [next(grads) if t.requires_grad else None for t in ts]


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, n_heads, group_len, causal):
        ctx.save_for_backward(qkv)
        ctx.args = (n_heads, group_len, causal)
        return _launch_packed_attention(qkv, n_heads, group_len, causal)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            t = qkv.detach().requires_grad_()
            out = _reference(t, *ctx.args)
        (gq,) = torch.autograd.grad(out, t, g)
        return gq, None, None, None


_BLOCK_KEYS = (("ln_1", "scale"), ("ln_1", "bias"), ("attn", "qkv_w"),
               ("attn", "qkv_b"), ("attn", "out_w"), ("attn", "out_b"))


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
        with torch.enable_grad():
            ts = _recompute_inputs(ctx)
            p = {"ln_1": {}, "attn": {}}
            for (group, key), t in zip(_BLOCK_KEYS, ts[1:]):
                p[group][key] = t
            out = _block_reference(p, ts[0], *ctx.args)
        return (*_input_grads(ctx, out, ts, g), None, None, None, None)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _launch_layer_norm(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ts = _recompute_inputs(ctx)
            out = _layer_norm_reference(*ts, ctx.eps)
        return (*_input_grads(ctx, out, ts, g), None)


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
