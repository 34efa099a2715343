"""leaf_tpu_torch's flash attention, and the gradients of all three
attention ops, against the JAX package.

On the CPU the port's ops run their plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode and its XLA references, as
`tests/test_flash_attention.py` does.  Inputs are made with numpy from a
seed and handed to both.  The CUDA kernels are held against the plain
versions on the card by `chip_smoke.py`.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu_torch.ops import build
from leaf_tpu_torch.ops import flash_attention as tfa
from leaf_tpu_torch.ops import packed_attention as tpa

# `leaf_tpu.ops` re-exports the functions under the modules' names
jfa = importlib.import_module("leaf_tpu.ops.flash_attention")
jpa = importlib.import_module("leaf_tpu.ops.packed_attention")

torch.set_num_threads(2)

TOLERANCES = {"float32": dict(atol=1e-5, rtol=1e-5),
              "bfloat16": dict(atol=2e-2, rtol=0)}


def _qkv(rng, shape):
    return [(s * rng.standard_normal(shape)).astype(np.float32)
            for s in (1.0, 1.0, 0.5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [16, 77, 130, 257])
def test_flash_attention_matches_jax(S, causal, dtype):
    rng = np.random.default_rng(S)
    B, H, d = 2, 2, 16
    q, k, v = _qkv(rng, (B, H, S, d))
    jq, jk, jv = (jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v))
    kernel = np.asarray(jfa.flash_attention(jq, jk, jv, None, causal, 128,
                                            128, True), np.float32)
    ref = np.asarray(jfa._reference_attention(jq, jk, jv, d ** -0.5, causal),
                     np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(out.float().numpy(), kernel,
                               **TOLERANCES[dtype])
    np.testing.assert_allclose(out.float().numpy(), ref, **TOLERANCES[dtype])


def test_flash_attention_takes_a_scale():
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, (1, 2, 24, 8))
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, True, 128, 128,
        True))
    out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              sm_scale=0.3, causal=True)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,n_heads,D", [(16, 2, 32), (77, 4, 32),
                                         (130, 2, 16)])
def test_mha_with_flash_matches_jax(S, n_heads, D, causal):
    rng = np.random.default_rng(1)
    qkv = (rng.standard_normal((2, S, 3 * D)) * 0.5).astype(np.float32)
    want = np.asarray(jfa.mha_with_flash(jnp.asarray(qkv), n_heads, causal,
                                         interpret=True))
    out = tfa.mha_with_flash(torch.from_numpy(qkv), n_heads, causal)
    assert out.shape == (2, S, D)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [16, 77])
def test_flash_attention_gradients_match_jax(S, causal, monkeypatch):
    """The autograd wrapper (its launch stood in for by the plain version,
    so that it runs on the CPU) gives jax.grad's gradients of q, k, v."""
    monkeypatch.setattr(tfa, "_launch", tfa._reference)
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, (2, 2, S, 8))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa._FlashAttention.apply(*ts, 8 ** -0.5, causal).sin().sum().backward()
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(jfa.flash_attention(
        *a, None, causal, 128, 128, True))), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    # the plain path itself (what a CPU tensor takes) differentiates alike
    ps = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.flash_attention(*ps, causal=causal).sin().sum().backward()
    for t, p in zip(ts, ps):
        np.testing.assert_allclose(p.grad.numpy(), t.grad.numpy(), atol=1e-6)


def test_flash_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_library():
        raise AssertionError("kernel library used for a CPU tensor")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(tfa.flash_attention, "launches", 0)
    q, k, v = (torch.from_numpy(a)
               for a in _qkv(np.random.default_rng(3), (1, 2, 20, 8)))
    assert torch.equal(tfa.flash_attention(q, k, v, causal=True),
                       tfa._reference(q, k, v, 8 ** -0.5, True))
    assert tfa.flash_attention.launches == 0


def test_flash_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="head width"):
        tfa.flash_attention(*(torch.zeros(1, 2, 16, 12),) * 3)
    with pytest.raises(ValueError, match="head width"):
        tfa.flash_attention(*(torch.zeros(1, 2, 16, 136),) * 3)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="4-D"):
        tfa.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="k:"):
        tfa.flash_attention(q, q[:, :, :8], q)
    with pytest.raises(ValueError, match="v:"):
        tfa.flash_attention(q, q, q.bfloat16())
    with pytest.raises(ValueError, match="heads"):
        tfa.mha_with_flash(torch.zeros(2, 16, 96), 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 65, 130, 257, 600])
def test_flash_tile_schedule_visits_what_the_mask_shows(S, causal, dtype):
    """Flash attention runs the online softmax (one group of S keys, passes
    of 64 keys) in both dtypes: every visible pair is visited, no visited
    step is hidden.  A block stages its keys whole up to 352 in bf16 and
    144 in fp32 (fp32 rows take twice the bytes), else through the ring of
    64-key stages."""
    plan, tiles = tpa.tile_schedule(S, S, causal, allow_exact=False,
                                    dtype=dtype)
    assert not plan["exact"] and plan["nt"] == 8
    whole = {torch.float32: 144, torch.bfloat16: 352}[dtype]
    assert plan["stages"] == (1 if S <= whole else 2)
    mask = tpa.block_mask(S, S, causal)
    visited = torch.zeros(S, S, dtype=torch.bool)
    for q0, q1, spans in tiles:
        for lo, hi in spans:
            assert (hi - lo) % 16 == 0 and 0 < hi - lo <= 64
            visited[q0:q1, lo:hi] = True
            for k in range(lo, hi, 16):
                assert mask[q0:q1, k:k + 16].any(), (q0, k)
    assert not (mask & ~visited).any()


@pytest.mark.parametrize("causal", [False, True])
def test_mha_with_flash_hands_on_views(causal, monkeypatch):
    """The head views of the fused qkv reach the plain version as they are
    (no copy), and the result still matches the JAX package's (1e-5: fp32,
    the same arithmetic in another order)."""
    rng = np.random.default_rng(6)
    qkv = (rng.standard_normal((2, 24, 3 * 32)) * 0.5).astype(np.float32)
    t = torch.from_numpy(qkv)
    seen = []
    plain = tfa._reference

    def spy(q, k, v, scale, c):
        seen.extend((q, k, v))
        return plain(q, k, v, scale, c)

    monkeypatch.setattr(tfa, "_reference", spy)
    out = tfa.mha_with_flash(t, 4, causal)
    assert len(seen) == 3
    for i, view in enumerate(seen):
        assert view.shape == (2, 4, 24, 8)
        assert view.stride() == (24 * 96, 8, 96, 1)
        assert view.data_ptr() == t.data_ptr() + 4 * 32 * i
    want = np.asarray(jfa.mha_with_flash(jnp.asarray(qkv), 4, causal,
                                         interpret=True))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)


class _FakeLibrary:
    """Stands in for the kernel library: keeps the launcher's arguments."""

    def __init__(self):
        self.calls = []

    def leaf_flash_attention(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launch_passes_strides(dtype, monkeypatch):
    """What the launcher hands to the kernel: views of a token-major qkv go
    in place with their strides and give a token-major output (so that
    `mha_with_flash` merges the heads without a copy); contiguous inputs
    give a contiguous output; rows off a 16-byte boundary are copied."""
    fake = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: fake)
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    monkeypatch.setattr(tfa.flash_attention, "launches", 0)
    B, S, H, d = 2, 10, 3, 8
    D = H * d
    qkv = torch.zeros(B, S, 3 * D, dtype=dtype)
    q, k, v = (t.reshape(B, S, H, d).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    out = tfa._launch(q, k, v, 0.5, True)
    args = fake.calls[-1]
    esize = qkv.element_size()
    assert args[:3] == (qkv.data_ptr(), qkv.data_ptr() + D * esize,
                        qkv.data_ptr() + 2 * D * esize)
    assert list(args[4]) == [S * 3 * D, d, 3 * D] * 3 + [S * D, d, D]
    assert args[5:12] == (tfa._DTYPE_CODES[dtype], B, H, S, d, 1, 0.5)
    assert out.shape == (B, H, S, d)
    assert out.transpose(1, 2).is_contiguous()

    dense = torch.zeros(B, H, S, d, dtype=dtype)
    out = tfa._launch(dense, dense, dense, 0.5, False)
    assert list(fake.calls[-1][4]) == [H * S * d, S * d, d] * 4
    assert out.is_contiguous()

    # rows that start off a 16-byte boundary cannot be read in place
    odd = torch.zeros(B, H, S, d + 2, dtype=dtype)[..., :d]
    tfa._launch(odd, dense, dense, 0.5, False)
    args = fake.calls[-1]
    assert args[0] != odd.data_ptr()
    assert list(args[4])[:3] == [H * S * d, S * d, d]
    assert tfa.flash_attention.launches == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launches_directly_where_autograd_records_nothing(
        dtype, monkeypatch):
    """The kernel's path: where autograd records nothing (no input needs a
    gradient, or grad mode is off) the op launches without
    `_FlashAttention.apply`; where it records, the output's backward is
    `_FlashAttention`'s.  One launch either way."""
    fake = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: fake)
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    monkeypatch.setattr(tfa.flash_attention, "launches", 0)
    applied = []
    apply = tfa._FlashAttention.apply

    def spy(*args):
        applied.append(args)
        return apply(*args)

    monkeypatch.setattr(tfa._FlashAttention, "apply", spy)
    q, k, v = (torch.zeros(1, 2, 16, 8, dtype=dtype) for _ in range(3))
    out = tfa._kernel_op(q, k, v, 0.5, True)
    assert out.grad_fn is None and not applied
    with torch.no_grad():
        out = tfa._kernel_op(q.requires_grad_(), k, v, 0.5, True)
    assert out.grad_fn is None and not applied
    assert len(fake.calls) == 2 and tfa.flash_attention.launches == 2
    out = tfa._kernel_op(q, k, v, 0.5, True)
    assert len(applied) == 1 and type(out.grad_fn).__name__ == \
        "_FlashAttentionBackward"
    assert len(fake.calls) == 3 and tfa.flash_attention.launches == 3


# ---------------------------------------------------------------------------
# Gradients of the packed ops (autograd wrappers on the CPU, their launches
# stood in for by the plain versions) against jax.grad of the JAX ops in
# interpret mode
# ---------------------------------------------------------------------------

GRAD_CASES = [(8, 4, True), (16, 2, False), (13, 1, True)]   # S, G, causal


def _plain_backward_launchers(monkeypatch):
    """The backwards' launchers stood in for by their plain versions."""
    def recompute(x, s, b, qw, qb, h, g, c, eps):
        R, L, D = x.shape
        hh = tpa._layer_norm_reference(x, s, b, eps)
        qkv = tpa._gemm_bias_reference(hh.reshape(R * L, D), qw, qb)
        qkv = qkv.reshape(R, L, 3 * D)
        return (hh, qkv, *tpa._reference(qkv, h, g, c, with_lse=True))

    def ln_backward(x, scale, dy, eps, params):
        dx, ds, db = tpa._layer_norm_backward_reference(x, scale, None, eps,
                                                        dy)
        return (dx, ds, db) if params else (dx, None, None)

    monkeypatch.setattr(tpa, "_launch_block_recompute", recompute)
    monkeypatch.setattr(tpa, "_launch_layer_norm_backward", ln_backward)
    monkeypatch.setattr(tpa, "_launch_packed_attention_backward",
                        tpa._packed_attention_backward_reference)


@pytest.mark.parametrize("S,G,causal", GRAD_CASES)
def test_packed_attention_gradient_matches_jax(S, G, causal, monkeypatch):
    monkeypatch.setattr(tpa, "_launch_packed_attention", tpa._reference)
    _plain_backward_launchers(monkeypatch)
    rng = np.random.default_rng(4)
    H, hd = 2, 8
    qkv = (rng.standard_normal((2, G * S, 3 * H * hd)) * 0.3).astype(np.float32)
    t = torch.from_numpy(qkv).requires_grad_()
    tpa._PackedAttention.apply(t, H, S, causal).sin().sum().backward()
    want = jax.grad(lambda a: jnp.sum(jnp.sin(jpa.packed_attention(
        a, H, S, causal, interpret=True))))(jnp.asarray(qkv))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("S,G,causal", GRAD_CASES)
def test_fused_block_gradients_match_jax(S, G, causal, monkeypatch):
    def plain_launch(x, s, b, qw, qb, ow, ob, h, g, c, eps):
        return tpa._block_reference(
            {"ln_1": {"scale": s, "bias": b},
             "attn": {"qkv_w": qw, "qkv_b": qb, "out_w": ow, "out_b": ob}},
            x, h, g, c, eps)

    monkeypatch.setattr(tpa, "_launch_fused_block", plain_launch)
    _plain_backward_launchers(monkeypatch)
    rng = np.random.default_rng(5)
    H, D = 2, 16
    x = (rng.standard_normal((2, G * S, D)) * 0.3).astype(np.float32)
    p = {"ln_1": {"scale": 1 + 0.1 * rng.standard_normal(D),
                  "bias": 0.1 * rng.standard_normal(D)},
         "attn": {"qkv_w": 0.2 * rng.standard_normal((D, 3 * D)),
                  "qkv_b": 0.1 * rng.standard_normal(3 * D),
                  "out_w": 0.2 * rng.standard_normal((D, D)),
                  "out_b": 0.1 * rng.standard_normal(D)}}
    p = jax.tree.map(lambda a: a.astype(np.float32), p)
    tx = torch.from_numpy(x).requires_grad_()
    leaves = [torch.from_numpy(p[g][k]).requires_grad_()
              for g, k in tpa._BLOCK_KEYS]
    tpa._FusedAttentionBlock.apply(tx, *leaves, H, S, causal, 1e-5) \
        .sin().sum().backward()
    gp, gx = jax.grad(lambda p_, x_: jnp.sum(jnp.sin(jpa.fused_attention_block(
        p_, x_, H, S, causal, 1e-5, interpret=True))), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    for (g, k), leaf in zip(tpa._BLOCK_KEYS, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gp[g][k]),
                                   atol=1e-4, rtol=1e-4)
