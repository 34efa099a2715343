"""Packed attention and the fused attention block (port of
`leaf_tpu/ops/packed_attention.py`).

Two ops, each a hand-written CUDA kernel (`csrc/`) beside its plain
PyTorch version:

  * `packed_attention(qkv, n_heads, group_len, causal)`: block-diagonal
    (optionally causal) multi-head attention on the fused, token-major
    qkv `[R, L, 3D] -> [R, L, D]`.  Rows hold `L // group_len`
    independent sequences; attention never crosses a `group_len`
    boundary.  Kernel: `csrc/packed_attention.cu`; plain version:
    `_reference`.
  * `fused_attention_block(p, x, n_heads, group_len, causal, ln_eps)`:
    `x + out_proj(packed_attention(qkv_proj(ln_1(x))))`.  Kernels: the
    LayerNorm and GEMM kernels of `csrc/fused_block.cu` around the
    packed-attention kernel, launched in order on the current stream;
    plain version: `_block_reference`.

The packed-attention kernel has two bodies: bf16 runs on the tensor cores
(`csrc/attention_mma.cuh`, shared with flash attention; `tile_schedule`
below mirrors its schedule in Python for the CPU tests, `kernel_schedule`
asks the built library for it), float32 keeps scalar FMAs, since
the tensor cores would round it to TF32.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.  There
is no size gate and no fallback.  Each op counts its kernel launches in
an integer attribute, `packed_attention.launches` and
`fused_attention_block.launches`; the fused block's attention stage goes
through the packed-attention launcher, so it counts there too.

Each CUDA path is a `torch.autograd.Function` whose backward recomputes
through the plain version, like the JAX `custom_vjp`s.  Serving never
differentiates; the backward is there for the training slices.
"""
from __future__ import annotations

from typing import Mapping

import torch

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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics and parameters, cast back to x's
    dtype (the numerics of the LayerNorm kernel; `layers.LayerNorm` uses
    it too)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


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

    h = layer_norm(x, p["ln_1"]["scale"], p["ln_1"]["bias"], ln_eps)
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


def _launch_fused_block(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                        n_heads: int, group_len: int, causal: bool,
                        ln_eps: float) -> torch.Tensor:
    lib = build.library()
    R, L, D = x.shape
    M, code = R * L, _DTYPE_CODES[x.dtype]
    dev, stream = x.device.index, _stream(x)
    h = torch.empty_like(x)
    build.check(lib.leaf_layer_norm(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), h.data_ptr(),
        code, M, D, ln_eps, dev, stream), "fused block: LayerNorm kernel")
    qkv = torch.empty((R, L, 3 * D), dtype=x.dtype, device=x.device)
    build.check(lib.leaf_gemm_bias(
        h.data_ptr(), qkv_w.data_ptr(), qkv_b.data_ptr(), None,
        qkv.data_ptr(), code, M, 3 * D, D, dev, stream),
        "fused block: qkv GEMM kernel")
    attn = _launch_packed_attention(qkv, n_heads, group_len, causal)
    out = torch.empty_like(x)
    build.check(lib.leaf_gemm_bias(
        attn.data_ptr(), out_w.data_ptr(), out_b.data_ptr(), x.data_ptr(),
        out.data_ptr(), code, M, D, D, dev, stream),
        "fused block: out-projection GEMM kernel")
    fused_attention_block.launches += 1
    return out


# ---------------------------------------------------------------------------
# Autograd wrappers: kernel forward, backward through the plain version
# ---------------------------------------------------------------------------

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
            ts = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            p = {"ln_1": {}, "attn": {}}
            for (group, key), t in zip(_BLOCK_KEYS, ts[1:]):
                p[group][key] = t
            out = _block_reference(p, ts[0], *ctx.args)
        grads = torch.autograd.grad(out, ts, g)
        return (*grads, None, None, None, None)


# ---------------------------------------------------------------------------
# Public ops
# ---------------------------------------------------------------------------

def packed_attention(qkv: torch.Tensor, n_heads: int, group_len: int,
                     causal: bool = True) -> torch.Tensor:
    """Block-diagonal MHA.  qkv `[R, L, 3D]` token-major (the fused qkv
    projection's output, bias added) -> `[R, L, D]`; `group_len == L` is
    ordinary (causal) attention."""
    _check_activation("qkv", qkv, 3, n_heads, group_len)
    if qkv.device.type == "cpu":
        return _reference(qkv, n_heads, group_len, causal)
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
    return _FusedAttentionBlock.apply(x, *ts, n_heads, group_len, causal,
                                      ln_eps)


fused_attention_block.launches = 0
