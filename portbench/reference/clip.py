"""Plain PyTorch CLIP towers in OpenCLIP's layout, the FARE and TextFARE
losses, FARE's momentum PGD and AdamW: the reference that each run's
output is judged against.

Everything computes in float32 with TF32 off (`strict_fp32`).  With
`fp8=True` every matrix product instead takes its two operands rounded to
float8 e4m3 under a per-tensor scale (the largest magnitude maps to 448),
and the gradient flowing back into a product is rounded to e5m2 the same
way: the control, the precision one step below the configuration's bf16.

Follows OpenCLIP's `Transformer` / `VisionTransformer` / `TextTransformer`
(pre-LN residual blocks, `nn.MultiheadAttention`'s packed in-projection,
QuickGELU or exact GELU, the causal mask and the EOT pool of the text
tower, the class-token pool of the vision tower).  Departures: attention
is written out (softmax in float32); the patch embedding is the
convolution as a matrix product over (3, p, p) patches.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def strict_fp32():
    """float32 products stay float32 (no TF32) inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Tower:
    """A tower's forward over a dict of OpenCLIP tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], heads: int,
                 quick_gelu: bool, fp8: bool = False, prefix: str = ""):
        self.p = params
        self.heads = heads
        self.quick_gelu = quick_gelu
        self.fp8 = fp8
        self.prefix = prefix
        self.layers = len({k.split(".resblocks.")[1].split(".")[0]
                           for k in params if ".resblocks." in k})

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(w)

    def linear(self, x, name):
        weight, bias = self.p[name + ".weight"], self.p[name + ".bias"]
        return self.mm(x, weight.t()) + bias

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"],
                            self.p[name + ".bias"], 1e-5)

    def act(self, x):
        return x * torch.sigmoid(1.702 * x) if self.quick_gelu else F.gelu(x)

    def attention(self, x, name, causal: bool):
        B, S, D = x.shape
        H = self.heads
        qkv = self.mm(x, self.p[name + ".in_proj_weight"].t()) \
            + self.p[name + ".in_proj_bias"]
        q, k, v = (t.reshape(B, S, H, D // H).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        logits = self.mm(q, k.transpose(-1, -2)) / math.sqrt(D // H)
        if causal:
            mask = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
            logits = logits.masked_fill(mask, float("-inf"))
        out = self.mm(torch.softmax(logits, dim=-1), v)
        out = out.transpose(1, 2).reshape(B, S, D)
        return self.linear(out, name + ".out_proj")

    def blocks(self, x, causal: bool):
        for i in range(self.layers):
            b = f"{self.prefix}transformer.resblocks.{i}"
            x = x + self.attention(self.ln(x, b + ".ln_1"), b + ".attn",
                                   causal)
            h = self.act(self.linear(self.ln(x, b + ".ln_2"), b + ".mlp.c_fc"))
            x = x + self.linear(h, b + ".mlp.c_proj")
        return x


class TextTower(Tower):
    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token rows [B, S] (zero padded after EOT) -> features [B, E]."""
        S = tokens.shape[1]
        x = self.p["token_embedding.weight"][tokens]
        x = x + self.p["positional_embedding"][:S]
        x = self.ln(self.blocks(x, causal=True), "ln_final")
        eot = tokens.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return self.mm(x, self.p["text_projection"])

    def encode_rows(self, tokens: torch.Tensor, chunk: int = 1024
                    ) -> torch.Tensor:
        """`encode` over [N, 77] rows in chunks of rows of similar length,
        each cut to its longest row (the causal mask keeps a row's EOT
        features independent of the padding after it)."""
        needs = tokens.argmax(dim=-1)
        order = torch.argsort(needs)
        out = []
        for lo in range(0, tokens.shape[0], chunk):
            idx = order[lo:lo + chunk]
            need = int(needs[idx].max()) + 1
            out.append(self.encode(tokens[idx, :need]))
        feats = torch.cat(out)
        return feats[torch.argsort(order)]


class VisionTower(Tower):
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images in [0, 1] -> features [B, E]."""
        mean = torch.tensor(OPENAI_MEAN, device=images.device)
        std = torch.tensor(OPENAI_STD, device=images.device)
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        w = self.p["visual.conv1.weight"]
        D, _, P, _ = w.shape
        B, _, H, W = x.shape
        patches = x.reshape(B, 3, H // P, P, W // P, P) \
            .permute(0, 2, 4, 1, 3, 5).reshape(B, (H // P) * (W // P), -1)
        x = self.mm(patches, w.reshape(D, -1).t())
        cls = self.p["visual.class_embedding"].expand(B, 1, D)
        x = torch.cat([cls, x], dim=1) + self.p["visual.positional_embedding"]
        x = self.ln(x, "visual.ln_pre")
        x = self.ln(self.blocks(x, causal=False), "visual.ln_post")
        return self.mm(x[:, 0], self.p["visual.proj"])


def sq_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row: the squared distance of two feature rows (FARE's and
    TextFARE's l2 objective)."""
    return (a - b).square().sum(-1)


def pgd_linf(loss_fn, images: torch.Tensor, start: torch.Tensor, eps: float,
             step: float, iterations: int, momentum: float = 0.9
             ) -> torch.Tensor:
    """FARE's PGD (Schlarmann et al. 2024): the gradient's sign, a
    momentum over normalised gradients normalised again, a step, the
    projection onto the eps-ball and the [0, 1] box."""
    delta = start.clone()
    velocity = torch.zeros_like(images)
    for _ in range(iterations):
        d = delta.detach().requires_grad_(True)
        grad, = torch.autograd.grad(loss_fn(images + d), d)
        grad = torch.nan_to_num(grad, nan=0.0).sign()
        velocity = (momentum * velocity + grad).sign()
        delta = (delta + step * velocity).clamp(-eps, eps)
        delta = (images + delta).clamp(0.0, 1.0) - images
    return (images + delta).detach()


class AdamW:
    """torch.optim.AdamW's update, written out: decoupled decay
    p *= 1 - lr * wd, then p -= lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: Dict[str, torch.Tensor], betas, eps: float,
                 decay: Dict[str, float]):
        self.params = params
        self.b1, self.b2 = betas
        self.eps = eps
        self.decay = decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1 - lr * self.decay[k])
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt().add_(self.eps)
            p.addcdiv_(self.m[k] / c1, denom, value=-lr)


def grads_of(loss_chunks: Iterable[torch.Tensor],
             params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Sum the gradients of several loss terms (each one chunk of rows,
    already divided by the whole batch's size)."""
    total: Optional[List[torch.Tensor]] = None
    names = list(params)
    for loss in loss_chunks:
        g = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True)
        g = [torch.zeros_like(params[k]) if x is None else x
             for k, x in zip(names, g)]
        total = g if total is None else [a + b for a, b in zip(total, g)]
    return dict(zip(names, total))


def cosine_lr(base: float, warmup: int, steps: int, step: int) -> float:
    """OpenCLIP's schedule: linear warm-up with lr(0) = base / warmup,
    then a cosine to zero at `steps`."""
    if step < warmup:
        return base * (step + 1) / warmup
    e = step - warmup
    return 0.5 * (1 + math.cos(math.pi * e / max(steps - warmup, 1))) * base
