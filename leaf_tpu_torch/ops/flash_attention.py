"""Flash attention (port of `leaf_tpu/ops/flash_attention.py`).

`flash_attention(q, k, v, sm_scale, causal)`: fused QK^T -> softmax -> V
on `[B, H, S, d]`, and `mha_with_flash(qkv, n_heads, causal)`, its
wrapper for a fused token-major qkv `[B, S, 3D]`.  As in the JAX package
the op is opt-in: the towers run the packed-attention kernels, and
nothing in the package calls this one.

The hand-written CUDA kernel is `csrc/flash_attention.cu`: an online
softmax over tiles of keys that writes only the `[S, d]` output of each
(batch, head).  Its products run on the tensor cores in both dtypes
(`csrc/attention_mma.cuh`, shared with packed attention): bfloat16
directly, float32 as three TF32 products of operands split into hi + lo
(3xTF32), which keeps fp32 accuracy.  It reads q, k and v through their
strides, so the head views of a fused qkv are not copied.  The plain
PyTorch version beside it, `_reference`, materialises the fp32 logits
(the JAX package's `_reference_attention`).
Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain version, CUDA tensors launch the kernel or raise.  The kernel
takes float32 or bfloat16 and any head width that is a multiple of 8 up
to 128.  `flash_attention.launches` counts kernel launches.

Where autograd would record the op, the CUDA path is a
`torch.autograd.Function` whose backward recomputes through the plain
version (no `[S, S]` tensor is kept between forward and backward), like
the JAX `custom_vjp`; where it would not, the kernel launches directly
(`Function.apply` costs more host time than a small kernel takes).  The
TPU tuning arguments (`block_q`, `block_kv`, `interpret`) have no
counterpart here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from leaf_tpu_torch.ops import build
from leaf_tpu_torch.ops.packed_attention import (_DTYPE_CODES, _needs_grad,
                                                  _stream)

MAX_HEAD_DIM = 128


def _reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               sm_scale: float, causal: bool) -> torch.Tensor:
    """Plain attention: fp32 logits and softmax, probabilities rounded to
    the input dtype, then PV."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        S = q.shape[2]
        hidden = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(hidden, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name}: expected a 4-D tensor [B, H, S, d]")
    shape, dtype, device = q.shape, q.dtype, q.device
    for name, t in (("k", k), ("v", v)):
        if t.shape != shape or t.dtype != dtype or t.device != device:
            raise ValueError(
                f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}; q is "
                f"{tuple(shape)} {dtype} on {device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype}; the kernel takes float32 or "
                        "bfloat16")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    d = q.shape[-1]
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head width {d}: the kernel takes a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")
    if 0 in q.shape:
        raise ValueError(f"empty input {tuple(q.shape)}")


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """t itself if the kernel can read it in place: dense head width,
    rows of every (batch, head, token) on 16-byte boundaries; else a
    contiguous copy."""
    sb, sh, ss, sd = t.stride()
    if sd != 1 or (sb | sh | ss) * t.element_size() % 16:
        t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError("q, k, v: data must be 16-byte aligned")
    return t


@functools.lru_cache(maxsize=64)
def _strides(strides: tuple):
    """The (batch, head, token) strides of q, k, v and out as the array
    the kernel reads (building one costs more host time than a small
    kernel takes, and a caller repeats its shapes)."""
    return (ctypes.c_longlong * 12)(*strides)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            sm_scale: float, causal: bool) -> torch.Tensor:
    B, H, S, d = q.shape
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    # the output takes q's order of heads and tokens, so that the head
    # views of a token-major qkv give a token-major output
    if q.stride(2) > q.stride(1):
        out = torch.empty((B, S, H, d), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
    else:
        out = torch.empty((B, H, S, d), dtype=q.dtype, device=q.device)
    strides = _strides(q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
                       + out.stride()[:3])
    build.check(build.library().leaf_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        _DTYPE_CODES[q.dtype], B, H, S, d, int(causal), sm_scale,
        q.device.index, _stream(q)), "flash_attention kernel")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        ctx.save_for_backward(q, k, v)
        ctx.args = (sm_scale, causal)
        return _launch(q, k, v, sm_scale, causal)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ts = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = _reference(*ts, *ctx.args)
        return (*torch.autograd.grad(out, ts, g), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention; q, k, v `[B, H, S, d]` -> `[B, H, S, d]`.
    `sm_scale` defaults to `d ** -0.5`."""
    _check(q, k, v)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        return _reference(q, k, v, scale, causal)
    return _kernel_op(q, k, v, scale, causal)


def _kernel_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               sm_scale: float, causal: bool) -> torch.Tensor:
    """The kernel's path (CUDA tensors): launched directly where autograd
    records nothing, else through `_FlashAttention`."""
    if not _needs_grad(q, k, v):
        return _launch(q, k, v, sm_scale, causal)
    return _FlashAttention.apply(q, k, v, sm_scale, causal)


flash_attention.launches = 0


def mha_with_flash(qkv: torch.Tensor, n_heads: int,
                   causal: bool = False) -> torch.Tensor:
    """Fused qkv `[B, S, 3D]` -> `[B, S, D]` through `flash_attention`
    (heads split out and merged back here)."""
    if not isinstance(qkv, torch.Tensor) or qkv.dim() != 3:
        raise ValueError("qkv: expected a 3-D tensor [B, S, 3D]")
    B, S, threeD = qkv.shape
    if threeD % 3 or (threeD // 3) % n_heads:
        raise ValueError(f"qkv: width {threeD} does not split into 3 x "
                         f"{n_heads} heads")
    D = threeD // 3
    q, k, v = (t.reshape(B, S, n_heads, D // n_heads).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    out = flash_attention(q, k, v, causal=causal)
    return out.transpose(1, 2).reshape(B, S, D)
