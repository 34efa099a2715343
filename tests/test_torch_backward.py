"""The backward of leaf_tpu_torch's ops against `jax.grad` / `jax.vjp` of
the JAX package's ops.

On the CPU the backward kernels cannot run: what runs here is each one's
plain version (explicit formulas, not autograd; the attention's given the
log-sum-exp of a plain forward that returns it, as the kernels take the
training forward's), the autograd wrappers' composition with their
launchers stood in for by the plain versions, a Python walk of the
attention backward's blocks, warps, chunks and 16-row steps in the
kernels' order, and the Python mirrors of the kernels' plans.  The kernels themselves are
held to these plain versions on the card by `chip_smoke.py` (c).  Inputs
are made with numpy from a seed and handed to both packages.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu_torch.ops import build
from leaf_tpu_torch.ops import packed_attention as tpa

from leaf_tpu.models import layers as jlayers

jpa = importlib.import_module("leaf_tpu.ops.packed_attention")

torch.set_num_threads(2)

# the share of the largest gradient two sides may differ by
GRAD_TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}

# (group_len, groups a row, causal, head width): groups of 8 and 16 in rows
# of 32 to 64 tokens, causal and not, and one group a row
ATTENTION_CASES = [(8, 4, True, 16), (16, 4, True, 32), (16, 2, False, 16),
                   (8, 8, False, 32), (48, 1, False, 16), (37, 1, True, 32)]


def _close_to_largest(got, want, dtype: str, what: str = "") -> None:
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= GRAD_TOLERANCE[dtype] * scale, (what, err, scale)


def _attention_inputs(rng, R, L, H, hd):
    qkv = (rng.standard_normal((R, L, 3 * H * hd)) * 0.5).astype(np.float32)
    dout = rng.standard_normal((R, L, H * hd)).astype(np.float32)
    return qkv, dout


def _jax_attention_vjp(qkv, dout, H, S, causal, dtype):
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda a: jpa.packed_attention(a, H, S, causal,
                                                    interpret=True),
                     jnp.asarray(qkv, jdt))
    (grad,) = vjp(jnp.asarray(dout, jdt))
    return np.asarray(grad, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,G,causal,hd", ATTENTION_CASES)
def test_packed_attention_backward_reference_matches_jax(S, G, causal, hd,
                                                         dtype):
    rng = np.random.default_rng(0)
    R, H = 2, 2
    qkv, dout = _attention_inputs(rng, R, G * S, H, hd)
    tdt = getattr(torch, dtype)
    tq, tdo = (torch.from_numpy(a).to(tdt) for a in (qkv, dout))
    out, lse = tpa._reference(tq, H, S, causal, with_lse=True)
    assert torch.equal(out, tpa._reference(tq, H, S, causal))
    got = tpa._packed_attention_backward_reference(tq, out, lse, tdo, H, S,
                                                   causal)
    assert got.dtype == tdt and got.shape == tq.shape
    want = _jax_attention_vjp(tq.float().numpy(), tdo.float().numpy(), H, S,
                              causal, dtype)
    _close_to_largest(got.float().numpy(), want, dtype)
    # the forward's log-sum-exp: fp32 [R, H, L], that of each query's
    # visible logits, and the same gradient as the one taken from qkv
    assert lse.dtype == torch.float32 and lse.shape == (R, H, G * S)
    q, k = (t.reshape(R, G * S, H, hd).transpose(1, 2).float()
            for t in tq.split(H * hd, dim=-1)[:2])
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    mask = tpa.block_mask(G * S, S, causal)
    want_lse = torch.stack([torch.logsumexp(s[..., i, mask[i]], dim=-1)
                            for i in range(G * S)], dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-6)
    recomputed = tpa._packed_attention_backward_reference(
        tq, out, None, tdo, H, S, causal)
    assert torch.equal(recomputed, got)


LN_SHAPES = [(6, 32), (2, 5, 24), (3, 128), (2, 160), (4, 640)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layer_norm_backward_reference_matches_jax(shape, dtype):
    rng = np.random.default_rng(1)
    D = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    tx, tdy = (torch.from_numpy(a).to(tdt) for a in (x, dy))
    dx, dscale, dbias = tpa._layer_norm_backward_reference(
        tx, torch.from_numpy(scale), torch.from_numpy(bias), 1e-5, tdy)
    assert dx.dtype == tdt and dx.shape == shape
    assert dscale.dtype == dbias.dtype == torch.float32
    _, vjp = jax.vjp(lambda x_, s_, b_: jlayers.layer_norm(
        {"scale": s_, "bias": b_}, x_, 1e-5), jnp.asarray(tx.float().numpy(), jdt),
        jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(tdy.float().numpy(), jdt))
    for got, w, name in zip((dx, dscale, dbias), want, ("x", "scale", "bias")):
        _close_to_largest(got.float().numpy(), w, dtype, name)


# ---------------------------------------------------------------------------
# The autograd wrappers' composition, launchers stood in for by the plain
# versions
# ---------------------------------------------------------------------------

def _plain_recompute(x, s, b, qw, qb, n_heads, group_len, causal, eps):
    R, L, D = x.shape
    h = tpa._layer_norm_reference(x, s, b, eps)
    qkv = tpa._gemm_bias_reference(h.reshape(R * L, D), qw, qb)
    qkv = qkv.reshape(R, L, 3 * D)
    return (h, qkv, *tpa._reference(qkv, n_heads, group_len, causal,
                                    with_lse=True))


def _plain_layer_norm_backward(x, scale, dy, eps, params):
    dx, dscale, dbias = tpa._layer_norm_backward_reference(x, scale, None, eps,
                                                           dy)
    return (dx, dscale, dbias) if params else (dx, None, None)


def _plain_block_launch(x, s, b, qw, qb, ow, ob, h, g, c, eps):
    return tpa._block_reference(
        {"ln_1": {"scale": s, "bias": b},
         "attn": {"qkv_w": qw, "qkv_b": qb, "out_w": ow, "out_b": ob}},
        x, h, g, c, eps)


@pytest.fixture
def plain_launchers(monkeypatch):
    """Every launcher of the autograd wrappers stood in for by its plain
    version, so that the wrappers run on CPU tensors; returns the record of
    the backwards' products (`_mm`: the operands' shapes) and of the
    LayerNorm backward's calls (whether it was asked for the parameters)."""
    record = {"mm": [], "ln_params": []}
    mm = tpa._mm

    def recording_mm(a, b):
        record["mm"].append((tuple(a.shape), tuple(b.shape)))
        return mm(a, b)

    def ln_backward(x, scale, dy, eps, params):
        record["ln_params"].append(params)
        return _plain_layer_norm_backward(x, scale, dy, eps, params)

    monkeypatch.setattr(tpa, "_mm", recording_mm)
    monkeypatch.setattr(tpa, "_launch_fused_block", _plain_block_launch)
    monkeypatch.setattr(tpa, "_launch_block_recompute", _plain_recompute)
    monkeypatch.setattr(tpa, "_launch_layer_norm",
                        lambda x, s, b, eps: tpa._layer_norm_reference(
                            x, s, b, eps))
    monkeypatch.setattr(tpa, "_launch_layer_norm_backward", ln_backward)
    monkeypatch.setattr(tpa, "_launch_packed_attention", tpa._reference)
    monkeypatch.setattr(tpa, "_launch_packed_attention_backward",
                        tpa._packed_attention_backward_reference)
    monkeypatch.setattr(tpa, "_launch_gemm",
                        lambda a, w, b: tpa._gemm_bias_reference(a, w, b))
    return record


def _block_params(rng, D):
    return {"ln_1": {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
                     "bias": (0.1 * rng.standard_normal(D)).astype(np.float32)},
            "attn": {"qkv_w": (rng.standard_normal((D, 3 * D)) * D ** -0.5
                               ).astype(np.float32),
                     "qkv_b": (0.1 * rng.standard_normal(3 * D)).astype(np.float32),
                     "out_w": (rng.standard_normal((D, D)) * D ** -0.5
                               ).astype(np.float32),
                     "out_b": (0.1 * rng.standard_normal(D)).astype(np.float32)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,G,causal", [(8, 4, True), (16, 2, False),
                                        (32, 1, True)])
def test_block_backward_matches_jax(S, G, causal, dtype, plain_launchers):
    """x and all six parameters' gradients of the fused block's autograd
    wrapper (recompute, products, attention and LayerNorm backwards) equal
    `jax.grad` of `fused_attention_block`; a trained block takes four
    weight products and the two input-gradient products."""
    rng = np.random.default_rng(2)
    R, H, hd = 2, 2, 16
    D = H * hd
    x = (rng.standard_normal((R, G * S, D)) * 0.5).astype(np.float32)
    p = _block_params(rng, D)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    # the weights in x's dtype, the LayerNorm's in fp32 (the model's layout)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    leaves = [torch.from_numpy(p[g][k]).to(torch.float32 if g == "ln_1" else tdt)
              .requires_grad_() for g, k in tpa._BLOCK_KEYS]
    tpa._FusedAttentionBlock.apply(tx, *leaves, H, S, causal, 1e-5) \
        .float().sin().sum().backward()
    jp = {g: {k: jnp.asarray(leaf.detach().float().numpy(),
                             jnp.float32 if g == "ln_1" else jdt)
              for (g2, k), leaf in zip(tpa._BLOCK_KEYS, leaves) if g2 == g}
          for g in ("ln_1", "attn")}
    gp, gx = jax.grad(lambda p_, x_: jnp.sum(jnp.sin(jpa.fused_attention_block(
        p_, x_, H, S, causal, 1e-5, interpret=True).astype(jnp.float32))),
        argnums=(0, 1))(jp, jnp.asarray(tx.detach().float().numpy(), jdt))
    _close_to_largest(tx.grad.float().numpy(), gx, dtype, "x")
    for (g, k), leaf in zip(tpa._BLOCK_KEYS, leaves):
        assert leaf.grad.dtype == leaf.dtype
        _close_to_largest(leaf.grad.float().numpy(), gp[g][k], dtype, k)
    M = R * G * S
    assert sorted(plain_launchers["mm"]) == sorted(
        [((D, M), (M, D)), ((M, D), (D, D)), ((D, M), (M, 3 * D)),
         ((M, 3 * D), (3 * D, D))])
    assert plain_launchers["ln_params"] == [True]


def test_frozen_block_runs_no_weight_product(plain_launchers):
    """PGD through a frozen block: the input's gradient alone, from the two
    input-gradient products and a LayerNorm backward that takes no
    parameter sums; the weights keep no gradient."""
    rng = np.random.default_rng(3)
    R, L, H, D = 2, 16, 2, 32
    x = torch.from_numpy((rng.standard_normal((R, L, D)) * 0.5)
                         .astype(np.float32))
    p = _block_params(rng, D)
    leaves = [torch.from_numpy(p[g][k]) for g, k in tpa._BLOCK_KEYS]
    tx = x.clone().requires_grad_()
    tpa._FusedAttentionBlock.apply(tx, *leaves, H, 8, True, 1e-5) \
        .sin().sum().backward()
    assert plain_launchers["mm"] == [((R * L, D), (D, D)),
                                     ((R * L, 3 * D), (3 * D, D))]
    assert plain_launchers["ln_params"] == [False]
    assert all(leaf.grad is None for leaf in leaves)
    ref = x.clone().requires_grad_()
    tp = {"ln_1": dict(zip(("scale", "bias"), leaves[:2])),
          "attn": dict(zip(("qkv_w", "qkv_b", "out_w", "out_b"), leaves[2:]))}
    tpa._block_reference(tp, ref, H, 8, True, 1e-5).sin().sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), ref.grad.numpy(), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("need", ["all", "input", "weights"])
@pytest.mark.parametrize("has_bias", [True, False])
def test_gemm_bias_backward_matches_jax(need, has_bias, plain_launchers):
    """`gemm_bias`'s autograd wrapper (the tensor-parallel block's GEMM):
    `g w^T`, `a^T g` and the column sums of g equal `jax.grad` of `a @ w +
    b`, each taken only where asked."""
    rng = np.random.default_rng(4)
    M, K, N = 12, 16, 24
    a, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((M, K), (K, N), (N,)))
    ta = torch.from_numpy(a).requires_grad_(need != "weights")
    tw = torch.from_numpy(w).requires_grad_(need != "input")
    tb = (torch.from_numpy(b).requires_grad_(need != "input") if has_bias
          else None)
    tpa._GemmBias.apply(ta, tw, tb).sin().sum().backward()
    grads = jax.grad(lambda a_, w_, b_: jnp.sum(jnp.sin(
        a_ @ w_ + (b_ if has_bias else 0))), argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(b))
    for t, want in zip((ta, tw, tb), grads):
        if t is None:
            continue
        if t.requires_grad:
            _close_to_largest(t.grad.numpy(), want, "float32")
        else:
            assert t.grad is None
    assert len(plain_launchers["mm"]) == {"all": 2, "input": 1,
                                          "weights": 1}[need]


def test_layer_norm_wrapper_backward_matches_jax(plain_launchers):
    """The LayerNorm op's autograd wrapper: one backward call, asked for the
    parameters only where they need a gradient."""
    rng = np.random.default_rng(5)
    x, dy = (rng.standard_normal((3, 7, 40)).astype(np.float32)
             for _ in range(2))
    scale = (1 + 0.1 * rng.standard_normal(40)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(40)).astype(np.float32)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, scale, bias)]
    (tpa._LayerNorm.apply(*leaves, 1e-5) * torch.from_numpy(dy)).sum() \
        .backward()
    _, vjp = jax.vjp(lambda x_, s_, b_: jlayers.layer_norm(
        {"scale": s_, "bias": b_}, x_, 1e-5), *map(jnp.asarray, (x, scale, bias)))
    for leaf, want in zip(leaves, vjp(jnp.asarray(dy))):
        _close_to_largest(leaf.grad.numpy(), want, "float32")
    frozen = [torch.from_numpy(x).requires_grad_(), torch.from_numpy(scale),
              torch.from_numpy(bias)]
    tpa._LayerNorm.apply(*frozen, 1e-5).sum().backward()
    assert plain_launchers["ln_params"] == [True, False]
    assert frozen[1].grad is None and frozen[2].grad is None


# ---------------------------------------------------------------------------
# The attention backward's schedule, and its tiles walked in Python
# ---------------------------------------------------------------------------

SCHEDULE_CASES = [(L, g, c) for L, g in ((16, 16), (64, 64), (128, 16),
                                         (128, 64), (96, 48), (77, 77),
                                         (50, 50), (257, 257), (200, 40),
                                         (729, 729), (39, 13), (130, 65),
                                         (65, 65), (129, 129), (257, 64))
                  for c in (False, True)]


@pytest.mark.parametrize("L,group_len,causal", SCHEDULE_CASES)
def test_backward_schedule_covers_every_visible_pair_once(L, group_len,
                                                          causal):
    """Both kernels split the row into 16-row tiles, at most
    `BWD_MAX_WARPS` a block, in the fewest blocks, evenly (no block for a tail tile: a
    257-token row's last token is one warp's tile); a block's range of
    the other operand holds every row that any of its rows meets, so
    each visible pair lands in one dQ block and one dK/dV block; a block
    stages the range whole where the kernel's widest, rounded up to 16,
    fits the dtype's limit (or `max_whole`), else through the ring."""
    mask = tpa.block_mask(L, group_len, causal).numpy()
    tiles = -(-L // tpa.TILE)
    for dtype in (torch.bfloat16, torch.float32):
        for max_whole in (0, 64):
            sched = tpa.backward_schedule(L, group_len, causal, dtype,
                                          max_whole)
            warps, blocks = sched["warps"], sched["blocks"]
            assert blocks == -(-tiles // tpa.BWD_MAX_WARPS), sched
            assert warps <= tpa.BWD_MAX_WARPS and (blocks - 1) * warps < tiles
            assert blocks * warps >= tiles and sched["chunk"] == 64
            limit = min(tpa.MAX_WHOLE_CHUNK[dtype], max_whole or L + 16)
            for kind in ("dq", "dkv"):
                seen = np.zeros((L, L), np.int32)    # [query, key]
                assert [t[0] for t in sched[kind]] == list(
                    range(0, L, warps * tpa.TILE))
                for a0, a1, b0, b1 in sched[kind]:
                    assert 0 < a1 - a0 <= warps * tpa.TILE
                    assert 0 <= b0 < b1 <= L
                    if kind == "dq":
                        seen[a0:a1, b0:b1] += 1
                        need = np.flatnonzero(mask[a0:a1].any(axis=0))
                    else:
                        seen[b0:b1, a0:a1] += 1
                        need = np.flatnonzero(mask[:, a0:a1].any(axis=1))
                    assert need.min() >= b0 and need.max() < b1, (kind, a0)
                assert (seen[mask] == 1).all(), kind
                widest = (max(b1 - b0 for *_, b0, b1 in sched[kind])
                          + 15) & ~15
                whole = sched[f"{kind}_whole"]
                assert whole == (widest if widest <= limit else 0), (
                    kind, dtype, max_whole, whole, widest)


def _walk_backward_tiles(qkv, out, lse, dout, n_heads, group_len, causal):
    """dqkv as the two kernels compute it (in fp32 on the CPU), from the
    forward's log-sum-exp: block by block of `backward_schedule`, warp by
    warp (16 rows), chunk by chunk of 64 rows of the block's range, the
    16-row steps of the chunk from the one that holds the warp's first
    visible row; a step that every row of the tile sees entirely runs
    unmasked, as the kernels' fast path does, with the rows past the end
    left as the kernels leave them (zero in the fragments, never stored).
    The dQ kernel writes delta, the dK/dV kernel reads it.  Holds the
    kernels' tiling and masking, not their arithmetic."""
    R, L, threeD = qkv.shape
    D = threeD // 3
    hd = D // n_heads
    scale = hd ** -0.5
    dt, g = qkv.dtype, group_len
    q, k, v = (t.reshape(R, L, n_heads, hd).transpose(1, 2).float()
               for t in qkv.split(D, dim=-1))
    do, o = (t.reshape(R, L, n_heads, hd).transpose(1, 2).float()
             for t in (dout, out))
    mask = tpa.block_mask(L, g, causal)
    sched = tpa.backward_schedule(L, g, causal, dt)
    T, C = tpa.TILE, sched["chunk"]

    def rows(t, a, b):       # rows [a, b) of [R, H, L, hd], zero past L
        part = t[:, :, a:min(b, L)]
        return torch.nn.functional.pad(part, (0, 0, 0, b - a - part.shape[2]))

    def steps(a0, a1, b0, b1, w0, w1, wb0, wb1, all0, all1):
        """(first row of the 16-row step, whether it runs unmasked) of a
        warp's tile [w0, w1) over its range [wb0, wb1) of [b0, b1)"""
        for cs in range(b0, b1, C):
            ce = min(cs + C, b1)
            lo, hi = max(wb0, cs), min(wb1, ce)
            for r in range((lo - cs) & ~15, hi - cs, T):
                yield cs + r, cs + r >= all0 and cs + r + T <= all1

    delta = torch.zeros(R, n_heads, L)
    dq, dk, dv = (torch.zeros(R, n_heads, L, hd) for _ in range(3))
    for a0, a1, b0, b1 in sched["dq"]:
        for w0 in range(a0, a1, T):
            w1 = min(w0 + T, a1)
            wb0, wb1 = tpa._key_range(w0, w1, L, g, causal)
            all0 = (w1 - 1) // g * g
            all1 = w0 + 1 if causal else min((w0 // g + 1) * g, L)
            qw, dow = rows(q, w0, w0 + T), rows(do, w0, w0 + T)
            dlt = (dow * rows(o, w0, w0 + T)).sum(-1)
            lse2 = rows(lse[..., None], w0, w0 + T)[..., 0]
            delta[:, :, w0:w1] = dlt[:, :, :w1 - w0]
            acc = torch.zeros(R, n_heads, T, hd)
            for c0, full in steps(a0, a1, b0, b1, w0, w1, wb0, wb1, all0,
                                  all1):
                kc, vc = rows(k, c0, c0 + T), rows(v, c0, c0 + T)
                s = (qw @ kc.transpose(-1, -2)) * scale
                p = torch.exp(s - lse2[..., None])
                if not full:
                    vis = torch.zeros(T, T, dtype=torch.bool)
                    vis[:w1 - w0, :min(c0 + T, b1) - c0] = \
                        mask[w0:w1, c0:min(c0 + T, b1)]
                    p = p * vis
                dp = (dow @ vc.transpose(-1, -2)).to(dt).float()
                acc += (p * (dp - dlt[..., None]) * scale) @ kc
            dq[:, :, w0:w1] = acc[:, :, :w1 - w0]
    for a0, a1, b0, b1 in sched["dkv"]:
        for w0 in range(a0, a1, T):
            w1 = min(w0 + T, a1)
            wb0, wb1 = tpa._query_range(w0, w1, L, g, causal)
            all0 = max((w1 - 1) // g * g, w1 - 1 if causal else 0)
            all1 = min((w0 // g + 1) * g, L)
            kw, vw = rows(k, w0, w0 + T), rows(v, w0, w0 + T)
            acc_k, acc_v = (torch.zeros(R, n_heads, T, hd) for _ in range(2))
            for c0, full in steps(a0, a1, b0, b1, w0, w1, wb0, wb1, all0,
                                  all1):
                qc, doc = rows(q, c0, c0 + T), rows(do, c0, c0 + T)
                lse2 = rows(lse[..., None], c0, c0 + T)[..., 0]
                dlt = rows(delta[..., None], c0, c0 + T)[..., 0]
                s = (kw @ qc.transpose(-1, -2)) * scale    # [key, query]
                p = torch.exp(s - lse2[:, :, None, :])
                if not full:
                    vis = torch.zeros(T, T, dtype=torch.bool)
                    vis[:w1 - w0, :min(c0 + T, b1) - c0] = \
                        mask[c0:min(c0 + T, b1), w0:w1].T
                    p = p * vis
                dp = (vw @ doc.transpose(-1, -2)).to(dt).float()
                acc_v += p.to(dt).float() @ doc
                acc_k += (p * (dp - dlt[:, :, None, :]) * scale) @ qc
            dk[:, :, w0:w1] = acc_k[:, :, :w1 - w0]
            dv[:, :, w0:w1] = acc_v[:, :, :w1 - w0]
    return torch.cat([t.transpose(1, 2).reshape(R, L, D) for t in (dq, dk, dv)],
                     dim=-1).to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,group_len,causal", [(128, 16, True), (96, 48, True),
                                                (130, 130, False),
                                                (200, 40, False), (77, 77, True),
                                                (257, 257, False), (65, 65, True),
                                                (129, 43, False)])
def test_backward_tiles_walked_equal_the_plain_backward(L, group_len, causal,
                                                        dtype):
    rng = np.random.default_rng(6)
    R, H, hd = 1, 2, 8
    qkv, dout = _attention_inputs(rng, R, L, H, hd)
    tdt = getattr(torch, dtype)
    tq, tdo = (torch.from_numpy(a).to(tdt) for a in (qkv, dout))
    out, lse = tpa._reference(tq, H, group_len, causal, with_lse=True)
    walked = _walk_backward_tiles(tq, out, lse, tdo, H, group_len, causal)
    plain = tpa._packed_attention_backward_reference(tq, out, lse, tdo, H,
                                                     group_len, causal)
    _close_to_largest(walked.float().numpy(), plain.float().numpy(), dtype)


# the plans of the widths the paths that train give the LayerNorm backward:
# (D, dtype) -> (threads a row, pieces a thread, edge bytes): the towers'
# (512 to 1280; a warp a row from 513 to 1536 bf16), EVA02-L's `mlp.ln`
# (2730: two warps, word edges), the conv stems (128, 160: several threads
# a row), the eval's fp32 rows (1024: two warps)
LN_BWD_WIDTHS = {(128, "bfloat16"): (4, 4, 0), (160, "bfloat16"): (8, 4, 0),
                 (512, "bfloat16"): (16, 4, 0), (640, "bfloat16"): (32, 4, 0),
                 (768, "bfloat16"): (32, 4, 0), (1024, "bfloat16"): (32, 4, 0),
                 (1280, "bfloat16"): (32, 5, 0), (2730, "bfloat16"): (64, 6, 4),
                 (128, "float32"): (8, 4, 0), (160, "float32"): (16, 4, 0),
                 (768, "float32"): (32, 6, 0), (1024, "float32"): (64, 4, 0)}


def test_layer_norm_backward_plan_covers_every_row():
    """At every width of both dtypes a row's threads hold its 16-byte
    pieces (at most `per` a thread, as compiled) and its head and tail
    units (the edge, where its bytes are no whole number of pieces, at
    most 3 words or 7 elements: 32 threads or more); narrow plans (4, 8,
    16 threads) only for rows of whole pieces, at most 64; a warp a row
    for bf16 rows of 65 to 128 pieces (513 to 1024 wide); wider rows on
    the fewest warps at `LN_BWD_PIECES` a lane; rows past
    `LN_BWD_MAX_ROW_BYTES` refused (`per` 0).  The blocks cover the rows
    (at most `LN_BWD_MAX_BLOCKS`, a multiple of 8, so that a stream's rows
    share their 16-byte phase)."""
    assert tpa.LN_BWD_MAX_BLOCKS % 8 == 0
    for dtype in (torch.bfloat16, torch.float32):
        es = dtype.itemsize
        for D in range(1, tpa.LN_BWD_MAX_ROW_BYTES // es + 200):
            plan = tpa.layer_norm_backward_plan(1, D, dtype)
            t, per, edge = plan["threads"], plan["per"], plan["edge"]
            nbytes = D * es
            assert edge == (0 if nbytes % 16 == 0 else
                            4 if nbytes % 4 == 0 else 2), (D, plan)
            assert plan["rows"] * t == tpa.LN_THREADS, (D, plan)
            if nbytes > tpa.LN_BWD_MAX_ROW_BYTES:
                assert per == 0, (D, plan)
                continue
            pieces = nbytes // 16
            assert per in (4, 5, 6, 8) and t * per >= pieces, (D, plan)
            assert per < 8 or t == tpa.LN_THREADS, (D, plan)
            if t < 32:
                assert edge == 0 and pieces <= 64, (D, plan)
            else:
                assert t % 32 == 0 and (edge or pieces > 64), (D, plan)
                assert (t == 32 or -(-pieces // (t // 2))
                        > tpa.LN_BWD_PIECES), (D, plan)
            if dtype == torch.bfloat16 and 512 < D <= 1024 and D % 8 == 0:
                assert t == 32, (D, plan)
    for M in (1, 7, 333, 2048, 2049, 19_712, 32_896, 802_816):
        for D, dtype in ((768, torch.bfloat16), (2730, torch.bfloat16),
                         (128, torch.float32)):
            plan = tpa.layer_norm_backward_plan(M, D, dtype)
            blocks, rows = plan["blocks"], plan["rows"]
            assert 0 < blocks <= tpa.LN_BWD_MAX_BLOCKS, (M, plan)
            assert (blocks - 1) * rows < M, (M, plan)
            assert blocks * rows >= M or blocks == tpa.LN_BWD_MAX_BLOCKS
            if blocks * rows < M:     # streams take several rows
                assert blocks * rows * D * dtype.itemsize % 16 == 0
    for (D, dt), want in LN_BWD_WIDTHS.items():
        plan = tpa.layer_norm_backward_plan(32_896, D, getattr(torch, dt))
        assert (plan["threads"], plan["per"], plan["edge"]) == want, (D, dt)


# ---------------------------------------------------------------------------
# What the backward launchers hand to the C entries, through a stand-in
# library
# ---------------------------------------------------------------------------

class _FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("leaf_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_library(monkeypatch):
    fake = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: fake)
    monkeypatch.setattr(tpa, "_stream", lambda t: 1234)
    for op in (tpa.layer_norm, tpa.fused_attention_block, tpa.packed_attention,
               tpa.gemm_bias):
        monkeypatch.setattr(op, "launches", 0)
        monkeypatch.setattr(op, "backward_launches", 0, raising=False)
    return fake


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_launch_is_one_call(dtype, fake_library):
    """One C call for both kernels, given the forward's log-sum-exp (fp32
    [R, H, L]) and an fp32 delta scratch of the same shape."""
    R, L, H, hd = 2, 24, 3, 16
    qkv = torch.zeros(R, L, 3 * H * hd, dtype=dtype)
    out, dout = (torch.zeros(R, L, H * hd, dtype=dtype) for _ in range(2))
    lse = torch.zeros(R, H, L)
    dqkv = tpa._launch_packed_attention_backward(qkv, out, lse, dout, H, 8,
                                                 True)
    (name, args), = fake_library.calls
    assert name == "leaf_packed_attention_backward"
    assert args[:5] == (qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                        dout.data_ptr(), dqkv.data_ptr())
    assert args[5] not in args[:5]
    assert args[6:13] == (tpa._DTYPE_CODES[dtype], R, L, H, hd, 8, 1)
    assert args[13] == pytest.approx(hd ** -0.5)
    assert args[14:] == (0, None, 1234)
    assert dqkv.shape == qkv.shape and dqkv.dtype == dtype
    assert tpa.packed_attention.backward_launches == 1
    assert tpa.packed_attention.launches == 0
    tpa._launch_packed_attention_backward(qkv, out, lse, dout, H, 8, True,
                                          max_whole=64)
    assert fake_library.calls[-1][1][14] == 64
    with pytest.raises(ValueError, match="dout"):
        tpa._launch_packed_attention_backward(qkv, out, lse, dout[:, :5], H,
                                              8, True)
    with pytest.raises(TypeError, match="out"):
        tpa._launch_packed_attention_backward(qkv, out.half(), lse, dout, H,
                                              8, True)
    with pytest.raises(ValueError, match="lse"):
        tpa._launch_packed_attention_backward(qkv, out, lse[:, :2], dout, H,
                                              8, True)
    with pytest.raises(TypeError, match="lse"):
        tpa._launch_packed_attention_backward(qkv, out, lse.to(dtype).double(),
                                              dout, H, 8, True)
    wide = torch.zeros(1, 4, 3 * 136)
    with pytest.raises(ValueError, match="head width 136"):
        tpa._launch_packed_attention_backward(
            wide, torch.zeros(1, 4, 136), torch.zeros(1, 1, 4),
            torch.zeros(1, 4, 136), 1, 4, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_forward_saves_the_kernels_lse(dtype, fake_library):
    """Serving's launch asks the packed kernel for no log-sum-exp; the
    training forward (`_PackedAttention`) hands it an fp32 [R, H, L]
    buffer, saves it, and its backward passes that buffer to one
    `leaf_packed_attention_backward` call."""
    R, L, H, hd = 2, 24, 3, 16
    qkv = torch.zeros(R, L, 3 * H * hd, dtype=dtype)
    tpa._launch_packed_attention(qkv, H, 8, True)
    (name, args), = fake_library.calls
    assert name == "leaf_packed_attention" and args[2] is None
    assert args[:2] == (qkv.data_ptr(), args[1])
    fake_library.calls.clear()
    t = qkv.clone().requires_grad_()
    out = tpa._PackedAttention.apply(t, H, 8, True)
    (name, args), = fake_library.calls
    assert name == "leaf_packed_attention" and args[2] is not None
    assert args[1] == out.data_ptr() and args[3:11] == (
        tpa._DTYPE_CODES[dtype], R, L, H, hd, 8, 1, args[10])
    saved = out.grad_fn.saved_tensors
    lse = next(x for x in saved if x.data_ptr() == args[2])
    assert lse.dtype == torch.float32 and lse.shape == (R, H, L)
    out.backward(torch.ones_like(out))
    backward = [a for n, a in fake_library.calls
                if n == "leaf_packed_attention_backward"]
    assert len(backward) == 1 and backward[0][2] == lse.data_ptr()
    assert (tpa.packed_attention.launches,
            tpa.packed_attention.backward_launches) == (2, 1)


def test_block_backward_passes_the_recomputed_lse(fake_library):
    """The block's backward asks its recomputing packed launch for the
    log-sum-exp (no launch of its own for it) and hands that buffer to its
    one attention backward call."""
    R, L, D, H = 2, 12, 16, 2
    x = torch.zeros(R, L, D, dtype=torch.bfloat16, requires_grad=True)
    leaves = [torch.ones(D), torch.zeros(D)] + [
        torch.zeros(*shape, dtype=torch.bfloat16)
        for shape in ((D, 3 * D), (3 * D,), (D, D), (D,))]
    out = tpa._FusedAttentionBlock.apply(x, *leaves, H, 6, True, 1e-5)
    fake_library.calls.clear()
    out.backward(torch.ones_like(out))
    names = [n for n, _ in fake_library.calls]
    assert names == ["leaf_layer_norm", "leaf_gemm_bias_tile",
                     "leaf_packed_attention", "leaf_packed_attention_backward",
                     "leaf_layer_norm_backward"]
    forward, backward = (a for n, a in fake_library.calls
                         if n.startswith("leaf_packed_attention"))
    assert forward[2] is not None and backward[2] == forward[2]
    assert backward[:2] == (forward[0], forward[1])
    assert (tpa.fused_attention_block.backward_launches,
            tpa.packed_attention.backward_launches) == (1, 1)


@pytest.mark.parametrize("params", [True, False])
def test_layer_norm_backward_launch_passes_the_plan(params, fake_library):
    """One C call; the partial sums' scratch holds the plan's blocks, and
    none is passed (nor dscale, dbias) for the input's gradient alone."""
    x = torch.zeros(3, 700, 1280, dtype=torch.bfloat16)
    scale = torch.ones(1280)
    dx, dscale, dbias = tpa._launch_layer_norm_backward(x, scale, x.clone(),
                                                        1e-6, params)
    (name, args), = fake_library.calls
    assert name == "leaf_layer_norm_backward"
    assert args[:4] == (x.data_ptr(), scale.data_ptr(), args[2], dx.data_ptr())
    assert args[7:10] == (1, 2100, 1280) and args[10] == pytest.approx(1e-6)
    assert args[11:] == (None, 1234)
    assert tpa.layer_norm.backward_launches == 1
    if params:
        assert args[4:6] == (dscale.data_ptr(), dbias.data_ptr())
        assert args[6] is not None and dscale.shape == dbias.shape == (1280,)
    else:
        assert args[4:7] == (None, None, None)
        assert dscale is None and dbias is None
    with pytest.raises(ValueError, match="at most 8192"):
        tpa._launch_layer_norm_backward(torch.zeros(2, 9000), torch.ones(9000),
                                        torch.zeros(2, 9000), 1e-5, True)


def test_block_recompute_launches_the_forward_kernels(fake_library):
    """The block's backward recomputes ln_1, the qkv projection and the
    attention (its output and log-sum-exp) by three kernel calls, counted
    once as the block's backward and under no forward counter."""
    R, L, D, H = 2, 12, 16, 2
    x = torch.zeros(R, L, D, dtype=torch.bfloat16)
    p = {"ln_1": {"scale": torch.ones(D), "bias": torch.zeros(D)},
         "attn": {"qkv_w": torch.zeros(D, 3 * D, dtype=torch.bfloat16),
                  "qkv_b": torch.zeros(3 * D, dtype=torch.bfloat16)}}
    h, qkv, o, lse = tpa._launch_block_recompute(
        x, p["ln_1"]["scale"], p["ln_1"]["bias"], p["attn"]["qkv_w"],
        p["attn"]["qkv_b"], H, 6, True, 1e-5)
    assert [name for name, _ in fake_library.calls] == [
        "leaf_layer_norm", "leaf_gemm_bias_tile", "leaf_packed_attention"]
    assert (h.shape, qkv.shape, o.shape) == ((R, L, D), (R, L, 3 * D),
                                             (R, L, D))
    assert lse.dtype == torch.float32 and lse.shape == (R, H, L)
    assert fake_library.calls[-1][1][2] == lse.data_ptr()
    assert tpa.fused_attention_block.backward_launches == 1
    assert (tpa.layer_norm.launches, tpa.packed_attention.launches,
            tpa.fused_attention_block.launches) == (0, 0, 0)


def test_cpu_backward_takes_the_plain_path(monkeypatch):
    """On CPU tensors the ops differentiate their plain forward versions:
    no library, no launch, no plain call counted on a card."""
    def no_library():
        raise AssertionError("kernel library used for a CPU tensor")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setitem(tpa.PLAIN_ON_CUDA, "calls", 0)
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(_attention_inputs(rng, 2, 32, 2, 16)[0]) \
        .requires_grad_()
    x = torch.from_numpy(rng.standard_normal((2, 32, 32)).astype(np.float32)) \
        .requires_grad_()
    p = {g: {k: torch.from_numpy(a).requires_grad_() for k, a in d.items()}
         for g, d in _block_params(rng, 32).items()}
    loss = (tpa.packed_attention(qkv, 2, 16, True).sum()
            + tpa.fused_attention_block(p, x, 2, 16, True).sum()
            + tpa.layer_norm(x, p["ln_1"]["scale"], p["ln_1"]["bias"]).sum()
            + tpa.gemm_bias(x, p["attn"]["out_w"], p["attn"]["out_b"]).sum())
    loss.backward()
    assert qkv.grad is not None and x.grad is not None
    assert all(t.grad is not None for d in p.values() for t in d.values())
    assert tpa.PLAIN_ON_CUDA["calls"] == 0
