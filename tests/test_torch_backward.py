"""The backward of leaf_tpu_torch's ops against `jax.grad` / `jax.vjp` of
the JAX package's ops.

On the CPU the backward kernels cannot run: what runs here is each one's
plain version (explicit formulas, not autograd), the autograd wrappers'
composition with their launchers stood in for by the plain versions, a
Python walk of the attention backward's tiles in the kernel's order, and
the Python mirrors of the kernels' schedules.  The kernels themselves are
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
    out = tpa._reference(tq, H, S, causal)
    got = tpa._packed_attention_backward_reference(tq, out, None, tdo, H, S,
                                                   causal)
    assert got.dtype == tdt and got.shape == tq.shape
    want = _jax_attention_vjp(tq.float().numpy(), tdo.float().numpy(), H, S,
                              causal, dtype)
    _close_to_largest(got.float().numpy(), want, dtype)
    # the rows' log-sum-exp handed in (as a saved one would be) gives the
    # same gradient as the one taken from qkv
    q, k = (t.reshape(R, G * S, H, hd).transpose(1, 2).float()
            for t in tq.split(H * hd, dim=-1)[:2])
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    s = s.masked_fill(~tpa.block_mask(G * S, S, causal), tpa._NEG)
    given = tpa._packed_attention_backward_reference(
        tq, out, torch.logsumexp(s, dim=-1), tdo, H, S, causal)
    assert torch.equal(given, got)


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
    return h, qkv, tpa._reference(qkv, n_heads, group_len, causal)


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
    monkeypatch.setattr(
        tpa, "_launch_packed_attention_backward",
        lambda qkv, out, dout, h, g, c:
        tpa._packed_attention_backward_reference(qkv, out, None, dout, h, g,
                                                 c))
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
                                         (729, 729), (39, 13), (130, 65))
                  for c in (False, True)]


@pytest.mark.parametrize("L,group_len,causal", SCHEDULE_CASES)
def test_backward_schedule_covers_every_visible_pair_once(L, group_len,
                                                          causal):
    """Both kernels' tiles partition the row, and the keys (queries) a
    tile visits, in chunks of `BWD_TILE` from its first, hold every key
    (query) that any of its queries (keys) sees: each visible pair lands
    in one dQ block and one dK/dV block."""
    sched = tpa.backward_schedule(L, group_len, causal)
    mask = tpa.block_mask(L, group_len, causal).numpy()
    for kind in ("dq", "dkv"):
        seen = np.zeros((L, L), np.int32)    # [query, key]
        starts = [t[0] for t in sched[kind]]
        assert starts == list(range(0, L, tpa.BWD_TILE))
        for a0, a1, b0, b1 in sched[kind]:
            assert a1 - a0 <= tpa.BWD_TILE and 0 <= b0 < b1 <= L
            if kind == "dq":
                seen[a0:a1, b0:b1] += 1
                rows = mask[a0:a1]
                need = np.flatnonzero(rows.any(axis=0))
            else:
                seen[b0:b1, a0:a1] += 1
                need = np.flatnonzero(mask[:, a0:a1].any(axis=1))
            assert need.min() >= b0 and need.max() < b1, (kind, a0, need)
        assert (seen[mask] == 1).all(), kind


def _walk_backward_tiles(qkv, out, dout, n_heads, group_len, causal):
    """dqkv as the two kernels compute it, tile by tile in their order (in
    fp32 on the CPU): the dQ blocks' online log-sum-exp over 64-key chunks,
    then dS and dQ; the dK/dV blocks' P and dS again from the saved lse and
    delta.  Holds the kernels' tiling and masking, not their arithmetic."""
    R, L, threeD = qkv.shape
    D = threeD // 3
    hd = D // n_heads
    scale = hd ** -0.5
    dt = qkv.dtype
    q, k, v = (t.reshape(R, L, n_heads, hd).transpose(1, 2).float()
               for t in qkv.split(D, dim=-1))
    do, o = (t.reshape(R, L, n_heads, hd).transpose(1, 2).float()
             for t in (dout, out))
    mask = tpa.block_mask(L, group_len, causal)
    sched = tpa.backward_schedule(L, group_len, causal)
    T = sched["tile"]
    lse = torch.empty(R, n_heads, L)
    delta = (do * o).sum(-1)
    dq, dk, dv = (torch.zeros(R, n_heads, L, hd) for _ in range(3))
    for q0, q1, k0, k1 in sched["dq"]:
        m = torch.full((R, n_heads, q1 - q0), -1e30)
        l = torch.zeros(R, n_heads, q1 - q0)
        for kc in range(k0, k1, T):
            ke = min(kc + T, k1)
            s = (q[:, :, q0:q1] @ k[:, :, kc:ke].transpose(-1, -2)) * scale
            vis = mask[q0:q1, kc:ke]
            s = s.masked_fill(~vis, -float("inf"))
            mn = torch.maximum(m, s.max(-1).values)
            l = l * torch.exp(m - mn) + torch.exp(s - mn[..., None]).sum(-1)
            m = mn
        lse[:, :, q0:q1] = m + torch.log(l)
        for kc in range(k0, k1, T):
            ke = min(kc + T, k1)
            s = (q[:, :, q0:q1] @ k[:, :, kc:ke].transpose(-1, -2)) * scale
            vis = mask[q0:q1, kc:ke]
            p = torch.exp(s - lse[:, :, q0:q1, None]) * vis
            dp = (do[:, :, q0:q1] @ v[:, :, kc:ke].transpose(-1, -2)) \
                .to(dt).float()
            ds = p * (dp - delta[:, :, q0:q1, None]) * scale
            dq[:, :, q0:q1] += ds @ k[:, :, kc:ke]
    for k0, k1, i0, i1 in sched["dkv"]:
        for qc in range(i0, i1, T):
            qe = min(qc + T, i1)
            s = (q[:, :, qc:qe] @ k[:, :, k0:k1].transpose(-1, -2)) * scale
            vis = mask[qc:qe, k0:k1]
            p = torch.exp(s - lse[:, :, qc:qe, None]) * vis
            dp = (do[:, :, qc:qe] @ v[:, :, k0:k1].transpose(-1, -2)) \
                .to(dt).float()
            ds = p * (dp - delta[:, :, qc:qe, None]) * scale
            dv[:, :, k0:k1] += p.to(dt).float().transpose(-1, -2) @ do[:, :, qc:qe]
            dk[:, :, k0:k1] += ds.transpose(-1, -2) @ q[:, :, qc:qe]
    return torch.cat([t.transpose(1, 2).reshape(R, L, D) for t in (dq, dk, dv)],
                     dim=-1).to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,group_len,causal", [(128, 16, True), (96, 48, True),
                                                (130, 130, False),
                                                (200, 40, False), (77, 77, True)])
def test_backward_tiles_walked_equal_the_plain_backward(L, group_len, causal,
                                                        dtype):
    rng = np.random.default_rng(6)
    R, H, hd = 1, 2, 8
    qkv, dout = _attention_inputs(rng, R, L, H, hd)
    tdt = getattr(torch, dtype)
    tq, tdo = (torch.from_numpy(a).to(tdt) for a in (qkv, dout))
    out = tpa._reference(tq, H, group_len, causal)
    walked = _walk_backward_tiles(tq, out, tdo, H, group_len, causal)
    plain = tpa._packed_attention_backward_reference(tq, out, None, tdo, H,
                                                     group_len, causal)
    _close_to_largest(walked.float().numpy(), plain.float().numpy(), dtype)


# the widths the paths that train give the LayerNorm backward: the towers'
# (512 to 1280), EVA02-L's `mlp.ln` (2730), the conv stems (128, 160)
LN_BWD_WIDTHS = {128: (32, 4), 160: (32, 8), 512: (64, 8), 640: (96, 8),
                 768: (96, 8), 1024: (128, 8), 1280: (160, 8),
                 2730: (256, 12)}


def test_layer_norm_backward_plan_covers_every_row():
    """At every width a block's threads hold the row (at most `per`
    elements a thread, as compiled), `threads` is a multiple of 32 up to
    `LN_THREADS`; widths past `LN_BWD_MAX_D` are refused (`per` 0); the
    blocks cover the rows, none empty, at most `LN_BWD_MAX_BLOCKS`."""
    for D in range(1, tpa.LN_BWD_MAX_D + 200):
        plan = tpa.layer_norm_backward_plan(1, D)
        t, per = plan["threads"], plan["per"]
        assert t % 32 == 0 and 32 <= t <= tpa.LN_THREADS, (D, plan)
        if D > tpa.LN_BWD_MAX_D:
            assert per == 0, (D, plan)
            continue
        assert per in (4, 8, 12, 32) and t * per >= D, (D, plan)
        assert t * 8 >= D or t == tpa.LN_THREADS, (D, plan)
    for M in (1, 7, 333, 2048, 2049, 19_712, 32_896, 802_816):
        plan = tpa.layer_norm_backward_plan(M, 768)
        blocks, rows = plan["blocks"], plan["rows"]
        assert blocks <= tpa.LN_BWD_MAX_BLOCKS, (M, plan)
        assert blocks * rows >= M > (blocks - 1) * rows, (M, plan)
    for D, (threads, per) in LN_BWD_WIDTHS.items():
        plan = tpa.layer_norm_backward_plan(32_896, D)
        assert (plan["threads"], plan["per"]) == (threads, per), D


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
    R, L, H, hd = 2, 24, 3, 16
    qkv = torch.zeros(R, L, 3 * H * hd, dtype=dtype)
    out, dout = (torch.zeros(R, L, H * hd, dtype=dtype) for _ in range(2))
    dqkv = tpa._launch_packed_attention_backward(qkv, out, dout, H, 8, True)
    (name, args), = fake_library.calls
    assert name == "leaf_packed_attention_backward"
    assert args[:4] == (qkv.data_ptr(), out.data_ptr(), dout.data_ptr(),
                        dqkv.data_ptr())
    assert args[5:12] == (tpa._DTYPE_CODES[dtype], R, L, H, hd, 8, 1)
    assert args[12] == pytest.approx(hd ** -0.5) and args[13:] == (None, 1234)
    assert dqkv.shape == qkv.shape and dqkv.dtype == dtype
    assert tpa.packed_attention.backward_launches == 1
    assert tpa.packed_attention.launches == 0
    with pytest.raises(ValueError, match="dout"):
        tpa._launch_packed_attention_backward(qkv, out, dout[:, :5], H, 8, True)
    with pytest.raises(TypeError, match="out"):
        tpa._launch_packed_attention_backward(qkv, out.half(), dout, H, 8, True)
    wide = torch.zeros(1, 4, 3 * 136)
    with pytest.raises(ValueError, match="head width 136"):
        tpa._launch_packed_attention_backward(
            wide, torch.zeros(1, 4, 136), torch.zeros(1, 4, 136), 1, 4, False)


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
    attention by three kernel calls, counted once as the block's backward
    and under no forward counter."""
    R, L, D, H = 2, 12, 16, 2
    x = torch.zeros(R, L, D, dtype=torch.bfloat16)
    p = {"ln_1": {"scale": torch.ones(D), "bias": torch.zeros(D)},
         "attn": {"qkv_w": torch.zeros(D, 3 * D, dtype=torch.bfloat16),
                  "qkv_b": torch.zeros(3 * D, dtype=torch.bfloat16)}}
    h, qkv, o = tpa._launch_block_recompute(
        x, p["ln_1"]["scale"], p["ln_1"]["bias"], p["attn"]["qkv_w"],
        p["attn"]["qkv_b"], H, 6, True, 1e-5)
    assert [name for name, _ in fake_library.calls] == [
        "leaf_layer_norm", "leaf_gemm_bias_tile", "leaf_packed_attention"]
    assert (h.shape, qkv.shape, o.shape) == ((R, L, D), (R, L, 3 * D),
                                             (R, L, D))
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
