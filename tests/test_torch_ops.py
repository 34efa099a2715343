"""leaf_tpu_torch ops against the JAX package's Pallas kernels.

On the CPU the port's ops run their plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode and its XLA references, as
`tests/test_packed_attention.py` does.  Inputs are made with numpy from
a seed and handed to both.  The CUDA kernels themselves are checked
against these plain versions on the card by `chip_smoke.py`.
"""
import glob
import importlib
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu_torch.ops import build
from leaf_tpu_torch.ops import packed_attention as tpa

from leaf_tpu.models import layers as jlayers
from leaf_tpu_torch.models import layers as tlayers

# `leaf_tpu.ops` re-exports the function under the module's name
jpa = importlib.import_module("leaf_tpu.ops.packed_attention")

torch.set_num_threads(2)

ATTENTION_CASES = [
    (16, 8, True),    # bucket-16 captions, 8 per 128-token row
    (16, 8, False),
    (32, 4, True),
    (77, 1, True),    # one full-context caption per row
    (13, 3, True),    # odd group length
    (33, 1, False),   # odd, non-causal, one group: stands in for vision's 257
]
TOLERANCES = {"float32": dict(atol=1e-5, rtol=1e-5),
              "bfloat16": dict(atol=2e-2, rtol=0)}


def _qkv(rng, R, L, D):
    return (rng.standard_normal((R, L, 3 * D)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,G,causal", ATTENTION_CASES)
def test_packed_attention_matches_jax(S, G, causal, dtype):
    rng = np.random.default_rng(0)
    R, H, hd = 3, 4, 16
    qkv = _qkv(rng, R, G * S, H * hd)
    jq = jnp.asarray(qkv, jnp.dtype(dtype))
    kernel = np.asarray(jpa.packed_attention(jq, H, S, causal, interpret=True),
                        np.float32)
    ref = np.asarray(jpa._reference(jq, H, S, causal), np.float32)
    out = tpa.packed_attention(torch.from_numpy(qkv).to(getattr(torch, dtype)),
                               H, S, causal).float().numpy()
    np.testing.assert_allclose(out, kernel, **TOLERANCES[dtype])
    np.testing.assert_allclose(out, ref, **TOLERANCES[dtype])


# (group_len, groups per row, causal): the shapes `chip_smoke.py` sweeps on
# the card, and the non-causal bucket
SCHEDULE_CASES = [(13, 3, False), (13, 3, True), (16, 8, True), (16, 8, False),
                  (24, 5, True), (32, 4, True), (48, 2, True), (64, 2, True),
                  (77, 1, True), (80, 1, False), (257, 1, False),
                  (257, 1, True), (100, 4, False), (200, 3, False),
                  (401, 1, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,causal", SCHEDULE_CASES)
def test_tile_schedule_visits_what_the_mask_shows(S, G, causal, dtype):
    """The Python mirror of the tensor-core kernel's schedule against
    `block_mask`, in both dtypes: the 16-query tiles partition the row,
    every visible (query, key) pair lies in a key span its tile visits, no
    visited 16-key step is wholly hidden, and a pass holds at most `nt` * 8
    logit columns."""
    L = S * G
    plan, tiles = tpa.tile_schedule(L, S, causal, dtype=dtype)
    mask = tpa.block_mask(L, S, causal)
    assert [(q0, q1) for q0, q1, _ in tiles] == [
        (q0, min(q0 + 16, L)) for q0 in range(0, L, 16)]
    assert plan["warps"] <= tpa.MAX_WARPS
    assert plan["warps"] * plan["blocks"] >= len(tiles)
    visited = torch.zeros(L, L, dtype=torch.bool)
    for q0, q1, spans in tiles:
        assert len(spans) == 1 or not plan["exact"]
        for lo, hi in spans:
            assert (hi - lo) % 16 == 0 and 0 < hi - lo <= 8 * plan["nt"]
            visited[q0:q1, lo:hi] = True
            for k in range(lo, hi, 16):
                assert mask[q0:q1, k:k + 16].any(), (q0, k)
    assert not (mask & ~visited).any()
    # text rows take the exact softmax, longer ones the online one; a block
    # stages the whole key range of its queries while that is at most 352
    # rows in bf16, 144 in fp32
    assert plan["exact"] == (S <= 80)
    block_q = 16 * plan["warps"]
    span = max(int(keys[-1] - keys[0]) + 1 for keys in (
        mask[q0:q0 + block_q].any(0).nonzero().flatten()
        for q0 in range(0, L, block_q)))
    assert plan["stages"] == (1 if span <= tpa.MAX_WHOLE_CHUNK[dtype] else 2)
    assert plan["chunk"] == ((span + 15) // 16 * 16 if plan["stages"] == 1
                             else 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,causal", [(13, 3, True), (77, 1, True),
                                        (257, 1, False), (200, 3, False)])
def test_kernel_schedule_unpacks_what_the_library_writes(S, G, causal, dtype,
                                                         monkeypatch):
    """`kernel_schedule` asks the built library for the schedule of a
    dtype; here a stand-in writes the mirror's answer the way the C entry
    does (six plan fields, then (tile, lo, hi) triples), and the wrapper
    must hand back `tile_schedule`'s form.  The real entry is held to the
    mirror on the card by `chip_smoke.py`."""
    L = S * G
    plan, tiles = tpa.tile_schedule(L, S, causal, dtype=dtype)

    class Library:
        @staticmethod
        def leaf_attention_schedule(L_, group_len, c, allow_exact, code,
                                    plan_out, passes, cap):
            assert (L_, group_len, c, allow_exact, code) == (
                L, S, int(causal), 1, tpa._DTYPE_CODES[dtype])
            fields = ("warps", "blocks", "chunk", "stages", "nt", "exact")
            plan_out[:] = [int(plan[f]) for f in fields]
            flat = [x for t, (_, _, spans) in enumerate(tiles)
                    for lo, hi in spans for x in (t, lo, hi)]
            assert len(flat) // 3 <= cap
            passes[:len(flat)] = flat
            return len(flat) // 3

    monkeypatch.setattr(build, "library", Library)
    assert tpa.kernel_schedule(L, S, causal, dtype=dtype) == (plan, tiles)
    monkeypatch.setattr(Library, "leaf_attention_schedule",
                        staticmethod(lambda *a: -1))
    with pytest.raises(RuntimeError, match="leaf_attention_schedule"):
        tpa.kernel_schedule(L, S, causal, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_plan_fits_shared_memory(dtype):
    """The query tile and the staged K and V chunks of every plan fit the
    232,448 bytes of shared memory a block may take, for heads of 8 to 128
    in steps of 8 and rows up to 730 tokens (SigLIP-384's 729 and one
    more): in one group, causal or not, and in the text buckets' groups.
    `MAX_WHOLE_CHUNK` is the most that fits beside 8 warps' queries at a
    head of 128: 16 rows more would not."""
    for L in range(1, 731):
        for group_len, causal in ((L, False), (L, True), (16, True),
                                  (77, False)):
            plan, _ = tpa.tile_schedule(L, min(group_len, L), causal,
                                        dtype=dtype)
            for head_dim in range(8, 129, 8):
                used = tpa.staged_bytes(plan, head_dim, dtype)
                assert used <= tpa.SMEM_LIMIT, (L, group_len, causal,
                                                head_dim, plan, used)
    whole = tpa.MAX_WHOLE_CHUNK[dtype]
    for chunk, fits in ((whole, True), (whole + 16, False)):
        plan = {"warps": tpa.MAX_WARPS, "stages": 1, "chunk": chunk}
        assert (tpa.staged_bytes(plan, 128, dtype) <= tpa.SMEM_LIMIT) == fits


def _block_params(rng, D):
    p = {"ln_1": {"scale": 1 + 0.1 * rng.standard_normal(D),
                  "bias": 0.1 * rng.standard_normal(D)},
         "attn": {"qkv_w": 0.1 * rng.standard_normal((D, 3 * D)),
                  "qkv_b": 0.1 * rng.standard_normal(3 * D),
                  "out_w": 0.1 * rng.standard_normal((D, D)),
                  "out_b": 0.1 * rng.standard_normal(D)}}
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def _torch_tree(p, dtype=torch.float32):
    return {"ln_1": {k: torch.from_numpy(v) for k, v in p["ln_1"].items()},
            "attn": {k: torch.from_numpy(v).to(dtype)
                     for k, v in p["attn"].items()}}


@pytest.mark.parametrize("S,G,causal", [(16, 8, True), (13, 3, False),
                                        (77, 1, True)])
def test_fused_block_matches_jax(S, G, causal):
    rng = np.random.default_rng(4)
    R, H, hd = 4, 4, 16
    D = H * hd
    x = (rng.standard_normal((R, G * S, D)) * 0.1).astype(np.float32)
    p = _block_params(rng, D)
    jp = jax.tree.map(jnp.asarray, p)
    kernel = np.asarray(jpa.fused_attention_block(
        jp, jnp.asarray(x), H, S, causal, 1e-5, interpret=True))
    ref = np.asarray(jpa._block_reference(jp, jnp.asarray(x), H, S, causal,
                                          1e-5))
    out = tpa.fused_attention_block(_torch_tree(p), torch.from_numpy(x), H, S,
                                    causal, 1e-5).numpy()
    np.testing.assert_allclose(out, kernel, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """A CPU tensor never reaches the kernel library and counts no launch."""
    def no_library():
        raise AssertionError("kernel library used for a CPU tensor")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(tpa.packed_attention, "launches", 0)
    monkeypatch.setattr(tpa.fused_attention_block, "launches", 0)
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(_qkv(rng, 2, 32, 32))
    assert torch.equal(tpa.packed_attention(qkv, 2, 16, True),
                       tpa._reference(qkv, 2, 16, True))
    x = torch.from_numpy((rng.standard_normal((2, 32, 32)) * 0.1)
                         .astype(np.float32))
    p = _torch_tree(_block_params(rng, 32))
    assert torch.equal(tpa.fused_attention_block(p, x, 2, 16, True),
                       tpa._block_reference(p, x, 2, 16, True, 1e-5))
    assert tpa.packed_attention.launches == 0
    assert tpa.fused_attention_block.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(_qkv(rng, 2, 16, 32))
    with pytest.raises(TypeError, match="dtype"):
        tpa.packed_attention(qkv.half(), 2, 16)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.packed_attention(qkv.transpose(0, 1), 2, 16)
    with pytest.raises(ValueError, match="heads"):
        tpa.packed_attention(qkv, 3, 16)
    with pytest.raises(ValueError, match="3-D"):
        tpa.packed_attention(qkv[0], 2, 16)
    # bf16 rows are copied in 16-byte pieces: heads of 4 or 12 are refused,
    # in float32 they pass
    for n_heads, width in ((8, 32), (2, 24)):
        narrow = torch.zeros(2, 16, 3 * width)
        with pytest.raises(ValueError, match="head width"):
            tpa.packed_attention(narrow.bfloat16(), n_heads, 16)
        assert tpa.packed_attention(narrow, n_heads, 16).shape == (2, 16, width)
    with pytest.raises(ValueError, match="head width"):
        tpa.fused_attention_block({}, torch.zeros(2, 16, 32).bfloat16(), 8, 16)
    x = torch.zeros(2, 16, 32)
    p = _torch_tree(_block_params(rng, 32))
    with pytest.raises(TypeError, match="attn.qkv_w"):
        tpa.fused_attention_block(_torch_tree(_block_params(rng, 32),
                                              torch.bfloat16), x, 2, 16)
    p["ln_1"]["scale"] = p["ln_1"]["scale"].bfloat16()
    with pytest.raises(TypeError, match="ln_1.scale"):
        tpa.fused_attention_block(p, x.bfloat16(), 2, 16)
    p = _torch_tree(_block_params(rng, 32))
    p["attn"]["out_w"] = p["attn"]["out_w"][:, :16]
    with pytest.raises(ValueError, match="attn.out_w"):
        tpa.fused_attention_block(p, x, 2, 16)


def _plain_backward_launchers(monkeypatch):
    """The backwards' launchers stood in for by their plain versions: the
    block's recomputation, the attention and LayerNorm backwards."""
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


def test_backward_recomputes_through_plain_version(monkeypatch):
    """The autograd wrappers' gradients equal the JAX custom_vjp's; the
    kernel launches, forward and backward, are stood in for by their plain
    versions so that the wrappers run on the CPU."""
    monkeypatch.setattr(tpa, "_launch_packed_attention", tpa._reference)
    _plain_backward_launchers(monkeypatch)
    rng = np.random.default_rng(3)
    qkv = _qkv(rng, 2, 32, 32)
    t = torch.from_numpy(qkv).requires_grad_()
    tpa._PackedAttention.apply(t, 2, 8, True).sin().sum().backward()
    want = jax.grad(lambda a: jnp.sum(jnp.sin(
        jpa.packed_attention(a, 2, 8, True, interpret=True))))(jnp.asarray(qkv))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)

    monkeypatch.setattr(tpa, "_launch_fused_block",
                        lambda x, s, b, qw, qb, ow, ob, h, g, c, eps:
                        tpa._block_reference(
                            {"ln_1": {"scale": s, "bias": b},
                             "attn": {"qkv_w": qw, "qkv_b": qb, "out_w": ow,
                                      "out_b": ob}}, x, h, g, c, eps))
    D = 16
    x = (rng.standard_normal((2, 32, D)) * 0.1).astype(np.float32)
    p = _block_params(rng, D)
    tx = torch.from_numpy(x).requires_grad_()
    tp = _torch_tree(p)
    leaves = [tp[g][k] for g, k in tpa._BLOCK_KEYS]
    for leaf in leaves:
        leaf.requires_grad_()
    tpa._FusedAttentionBlock.apply(tx, *leaves, 2, 8, True, 1e-5) \
        .sin().sum().backward()
    gp, gx = jax.grad(lambda p_, x_: jnp.sum(jnp.sin(jpa.fused_attention_block(
        p_, x_, 2, 8, True, 1e-5, interpret=True))), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               atol=1e-5, rtol=1e-4)
    for (g, k), leaf in zip(tpa._BLOCK_KEYS, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gp[g][k]),
                                   atol=1e-5, rtol=1e-4)


def test_backward_of_a_frozen_block_gives_the_input_gradient_alone(
        monkeypatch):
    """PGD on a frozen tower: the wrappers' backwards take the input's
    gradient alone (the block two input-gradient products and no weight
    product, each LayerNorm backward no parameter sums), leave the weights
    without a gradient and give the input the one the plain version
    gives."""
    _plain_backward_launchers(monkeypatch)
    asked, products = [], []
    ln_backward, mm = tpa._launch_layer_norm_backward, tpa._mm

    def recording_ln(x, scale, dy, eps, params):
        asked.append(params)
        return ln_backward(x, scale, dy, eps, params)

    def recording_mm(a, b):
        products.append((tuple(a.shape), tuple(b.shape)))
        return mm(a, b)

    monkeypatch.setattr(tpa, "_launch_layer_norm_backward", recording_ln)
    monkeypatch.setattr(tpa, "_mm", recording_mm)
    monkeypatch.setattr(tpa, "_launch_fused_block",
                        lambda x, s, b, qw, qb, ow, ob, h, g, c, eps:
                        tpa._block_reference(
                            {"ln_1": {"scale": s, "bias": b},
                             "attn": {"qkv_w": qw, "qkv_b": qb, "out_w": ow,
                                      "out_b": ob}}, x, h, g, c, eps))
    monkeypatch.setattr(tpa, "_launch_layer_norm",
                        lambda x, s, b, eps: tpa._layer_norm_reference(
                            x, s, b, eps))
    rng = np.random.default_rng(4)
    D = 16
    x = torch.from_numpy((rng.standard_normal((2, 32, D)) * 0.1)
                         .astype(np.float32))
    tp = _torch_tree(_block_params(rng, D))
    leaves = [tp[g][k] for g, k in tpa._BLOCK_KEYS]
    tx = x.clone().requires_grad_()
    out = tpa._FusedAttentionBlock.apply(tx, *leaves, 2, 8, True, 1e-5)
    tpa._LayerNorm.apply(out, leaves[0], leaves[1], 1e-5).sin().sum() \
        .backward()
    ref = x.clone().requires_grad_()
    tpa._layer_norm_reference(tpa._block_reference(tp, ref, 2, 8, True, 1e-5),
                              leaves[0], leaves[1], 1e-5).sin().sum() \
        .backward()
    assert asked == [False, False]   # the LayerNorm op's backward, the block's
    assert products == [((64, D), (D, D)), ((64, 3 * D), (3 * D, D))]
    assert all(leaf.grad is None for leaf in leaves)
    np.testing.assert_allclose(tx.grad.numpy(), ref.grad.numpy(),
                               atol=1e-6, rtol=1e-5)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.find_nvcc()
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "LIBRARY", str(tmp_path / "build" / "lib.so"))
    build.library.cache_clear()
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.library()


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fatal: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "LIBRARY", str(tmp_path / "build" / "lib.so"))
    build.library.cache_clear()
    with pytest.raises(build.KernelBuildError, match="no sm_90a here"):
        build.library()
    assert not list((tmp_path / "build").iterdir())


# ---------------------------------------------------------------------------
# The LayerNorm op
# ---------------------------------------------------------------------------

def _ln_inputs(rng, shape):
    D = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return x, scale, bias


# rows of the widths the kernel's plans take on the card (ConvNeXt's and
# ViTamin's stems, SO400M, ViT-H, Swin's last merge, EVA02-L's `mlp.ln`)
LN_KERNEL_SHAPES = [(3, 128), (2, 160), (2, 1152), (2, 1280), (2, 2048),
                    (3, 2730)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 32), (2, 7, 48), (3, 4, 5, 24), (40,)]
                         + LN_KERNEL_SHAPES)
def test_layer_norm_matches_jax(shape, dtype):
    """fp32 within 1e-6 of the value's size; bf16 within one rounding
    step (2^-8 of the value): both sides round the same fp32 result.

    In bf16 each side's output is its own fp32 result (on the same bf16
    inputs) rounded once, and the two fp32 results agree within 1e-6.  Of
    the thousands of values in a row of the kernel's widths a few fp32
    results land on either side of a bf16 rounding boundary, one step
    (2^-7 of a value just above a power of two) apart: there the bf16
    outputs are held by those two checks alone."""
    x, scale, bias = _ln_inputs(np.random.default_rng(7), shape)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want = np.asarray(jlayers.layer_norm(
        p, jnp.asarray(x, jnp.dtype(dtype)), 1e-5), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    got = tpa.layer_norm(tx, ts, tb, 1e-5)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    if dtype == "bfloat16":
        x16 = tx.float()
        got32 = tpa.layer_norm(x16, ts, tb, 1e-5)
        want32 = np.asarray(jlayers.layer_norm(p, jnp.asarray(x16.numpy()),
                                               1e-5))
        np.testing.assert_allclose(got32.numpy(), want32, atol=1e-6,
                                   rtol=1e-6)
        assert torch.equal(got, got32.bfloat16())
        np.testing.assert_array_equal(
            want, np.asarray(jnp.asarray(want32).astype(jnp.bfloat16),
                             np.float32))
        if shape in LN_KERNEL_SHAPES:
            return
    tol = (dict(atol=1e-6, rtol=1e-6) if dtype == "float32"
           else dict(atol=2.0 ** -9, rtol=2.0 ** -8))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("shape", [(6, 32), (2, 5, 24)])
def test_layer_norm_gradients_match_jax(shape, monkeypatch):
    """The autograd wrapper (kernel launches, forward and backward, stood in
    for by the plain versions) gives `jax.grad`'s gradients for x, scale
    and bias."""
    monkeypatch.setattr(tpa, "_launch_layer_norm", tpa._layer_norm_reference)
    _plain_backward_launchers(monkeypatch)
    x, scale, bias = _ln_inputs(np.random.default_rng(8), shape)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    tpa._LayerNorm.apply(*leaves, 1e-5).sin().sum().backward()
    want = jax.grad(lambda x_, s_, b_: jnp.sum(jnp.sin(jlayers.layer_norm(
        {"scale": s_, "bias": b_}, x_, 1e-5))), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (x, scale, bias)))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-4)


# the widths `chip_smoke.py` times the LayerNorm kernel at: the towers'
# activations (512 to 1280) and the zoo's (SO400M's 1152, ConvNeXt's and
# Swin's 128-channel stems, ViTamin's 160, EVA02-L's `mlp.ln` at 2730, Swin's
# last merge at 2048)
LN_WIDTHS = (128, 160, 512, 640, 768, 1024, 1152, 1280, 2048, 2730)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_plan_covers_every_row(dtype, aligned):
    """`layer_norm_plan` at every width from 1 to 4096: a row's head (the
    bytes before its first 16-byte boundary, whatever the row's place in x),
    its pieces and its tail add up to the row, the edges are whole units
    of `edge` bytes and at most one a thread, the pieces fit the row's
    threads, and a thread holds at most `LN_ROW_REGS` registers of the row.
    Unaligned pointers take the global path; aligned ones never do below
    4096, and the widths the towers give take the register paths."""
    es = dtype.itemsize
    for D in range(1, 4097):
        plan = tpa.layer_norm_plan(D, dtype, aligned)
        assert plan["rows"] * plan["threads"] == tpa.LN_THREADS, (D, plan)
        if not aligned:
            assert plan == {"variant": "global", "unit": es, "edge": 0,
                            "threads": 32, "per": 0, "rows": 8}, (D, plan)
            continue
        assert plan["variant"] != "global" and plan["unit"] == 16, (D, plan)
        assert plan["per"] * 4 <= tpa.LN_ROW_REGS, (D, plan)
        nbytes = D * es
        edge = plan["edge"]
        assert edge == (0 if nbytes % 16 == 0 else 4 if nbytes % 4 == 0
                        else 2), (D, plan)
        for start in range(0, 16 * nbytes, nbytes):   # 16 rows' places
            head = min((16 - start % 16) % 16, nbytes) if edge else 0
            pieces = (nbytes - head) // 16
            tail = nbytes - head - 16 * pieces
            assert pieces <= plan["threads"] * plan["per"], (D, plan)
            if edge:
                assert head % edge == 0 and tail % edge == 0, (D, start)
                assert max(head, tail) // edge <= plan["threads"], (D, plan)
            else:
                assert start % 16 == 0 and tail == 0, (D, start)
        if plan["variant"] == "rows":
            assert edge == 0 and 32 <= nbytes // 16 and D <= 1024
        elif edge == 0 and nbytes // 16 < 32:
            assert plan["threads"] in (4, 8) and plan["per"] == 4, (D, plan)
    for D in LN_WIDTHS:
        assert tpa.layer_norm_plan(D, dtype)["variant"] in (
            "rows", "registers"), D


def test_layer_norm_rejects_what_the_kernel_does_not_take():
    x, scale, bias = (torch.from_numpy(a) for a in
                      _ln_inputs(np.random.default_rng(9), (4, 6, 16)))
    with pytest.raises(TypeError, match="dtype"):
        tpa.layer_norm(x.half(), scale, bias)
    with pytest.raises(TypeError, match="dtype"):
        tpa.layer_norm(x.double(), scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.layer_norm(x.transpose(0, 1), scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.layer_norm(x[:, 0], scale, bias)
    with pytest.raises(ValueError, match=r"\[\.\.\., D\]"):
        tpa.layer_norm(torch.tensor(1.0), scale[:0], bias[:0])
    with pytest.raises(TypeError, match="scale"):
        tpa.layer_norm(x.bfloat16(), scale.bfloat16(), bias)
    with pytest.raises(TypeError, match="bias"):
        tpa.layer_norm(x, scale, bias.double())
    with pytest.raises(ValueError, match="scale"):
        tpa.layer_norm(x, scale[:8], bias)
    with pytest.raises(ValueError, match="bias"):
        tpa.layer_norm(x, scale, bias[None])
    with pytest.raises(TypeError, match="scale"):
        tpa.layer_norm(x, scale.numpy(), bias)
    # an empty batch is no error, and bf16 takes fp32 parameters
    assert tpa.layer_norm(x[:0], scale, bias).shape == (0, 6, 16)
    assert tpa.layer_norm(x.bfloat16(), scale, bias).dtype == torch.bfloat16


def test_layer_norm_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_library():
        raise AssertionError("kernel library used for a CPU tensor")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(tpa.layer_norm, "launches", 0)
    x, scale, bias = (torch.from_numpy(a) for a in
                      _ln_inputs(np.random.default_rng(10), (3, 8, 16)))
    assert torch.equal(tpa.layer_norm(x, scale, bias, 1e-6),
                       tpa._layer_norm_reference(x, scale, bias, 1e-6))
    module = tlayers.LayerNorm(16, eps=1e-6)
    with torch.no_grad():
        module.scale.copy_(scale)
        module.bias.copy_(bias)
    assert torch.equal(module(x), tpa._layer_norm_reference(x, scale, bias, 1e-6))
    assert tpa.layer_norm.launches == 0


# ---------------------------------------------------------------------------
# What the launchers hand to the C entries, through a stand-in library
# ---------------------------------------------------------------------------

class _FakeLibrary:
    """Stands in for the kernel library: keeps (entry, arguments) of every
    call, in order."""

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
    for op in (tpa.layer_norm, tpa.fused_attention_block, tpa.packed_attention):
        monkeypatch.setattr(op, "launches", 0)
    return fake


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_launch_passes_rows_and_width(dtype, fake_library):
    """`LayerNorm.forward` on a card: the autograd wrapper hands the op's
    tensors to `leaf_layer_norm` as they are, M = every leading dimension,
    and counts one launch; an empty batch launches nothing."""
    module = tlayers.LayerNorm(16, eps=1e-6)
    x = torch.zeros(3, 5, 16, dtype=dtype)
    out = tpa._LayerNorm.apply(x, module.scale, module.bias, module.eps)
    assert out.shape == x.shape and out.dtype == dtype and out.is_contiguous()
    (name, args), = fake_library.calls
    assert name == "leaf_layer_norm"
    assert args[:4] == (x.data_ptr(), module.scale.data_ptr(),
                        module.bias.data_ptr(), out.data_ptr())
    assert args[4:7] == (tpa._DTYPE_CODES[dtype], 15, 16)
    assert args[7] == pytest.approx(1e-6) and args[8:] == (None, 1234)
    assert tpa.layer_norm.launches == 1
    assert out.requires_grad   # the parameters' gradients flow through it
    tpa._launch_layer_norm(x[:0], module.scale, module.bias, 1e-6)
    assert len(fake_library.calls) == 1 and tpa.layer_norm.launches == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_launch_is_one_call(dtype, fake_library):
    """`fused_attention_block` on a card: one `leaf_fused_block` call with
    x, the six parameters in `_BLOCK_KEYS` order, three scratch views of
    one allocation (h [M, D], qkv [M, 3D], attn [M, D], back to back), the
    output, then the sizes; both the block and the packed-attention kernel
    it runs count a launch."""
    R, L, D, H = 2, 12, 16, 2
    x = torch.zeros(R, L, D, dtype=dtype)
    p = _torch_tree(_block_params(np.random.default_rng(11), D), dtype)
    ts = [p[g][k] for g, k in tpa._BLOCK_KEYS]
    out = tpa._FusedAttentionBlock.apply(x, *ts, H, 6, True, 1e-5)
    (name, args), = fake_library.calls
    assert name == "leaf_fused_block"
    assert args[:7] == (x.data_ptr(), *(t.data_ptr() for t in ts))
    h, qkv, attn, o = args[7:11]
    esize, M = x.element_size(), R * L
    assert (qkv - h, attn - qkv) == (M * D * esize, 3 * M * D * esize)
    assert o == out.data_ptr() and out.shape == x.shape and out.dtype == dtype
    assert not (h <= o < attn + M * D * esize)   # the output is its own tensor
    assert args[11:18] == (tpa._DTYPE_CODES[dtype], R, L, D, H, 6, 1)
    assert args[18] == pytest.approx(1e-5)
    assert args[19] == pytest.approx((D // H) ** -0.5)
    assert args[20:] == (None, 1234)
    assert tpa.fused_attention_block.launches == 1
    assert tpa.packed_attention.launches == 1
    assert tpa.layer_norm.launches == 0


def test_gemm_bias_launch_passes_the_tile_and_the_residual(fake_library):
    a, w = torch.zeros(10, 16).bfloat16(), torch.zeros(16, 24).bfloat16()
    b, res = torch.zeros(24).bfloat16(), torch.zeros(10, 24).bfloat16()
    out = tpa._launch_gemm_bias(a, w, b)
    out_res = tpa._launch_gemm_bias(a, w, b, res, tile_n=192)
    (n0, first), (n1, second) = fake_library.calls
    assert n0 == n1 == "leaf_gemm_bias_tile"
    assert first == (a.data_ptr(), w.data_ptr(), b.data_ptr(), None,
                     out.data_ptr(), 1, 10, 24, 16, 0, None, 1234)
    assert second[3:5] == (res.data_ptr(), out_res.data_ptr())
    assert second[5:10] == (1, 10, 24, 16, 192)
    assert out.shape == (10, 24) and out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="w"):
        tpa._launch_gemm_bias(a, w.t(), b)
    with pytest.raises(TypeError, match="bias"):
        tpa._launch_gemm_bias(a, w, b.float())
    with pytest.raises(ValueError, match="residual"):
        tpa._launch_gemm_bias(a, w, b, res[:5])


@pytest.mark.parametrize("res", [False, True])
def test_gemm_bias_reference_rounds_where_the_kernel_does(res):
    """Product and bias summed in fp32 and rounded once; the residual added
    as a sum of two bf16 values: what `_block_reference` does with
    `torch.addmm` and `x + ...`."""
    rng = np.random.default_rng(12)
    a, w, b, r = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  .bfloat16() for s in ((9, 16), (16, 8), (8,), (9, 8)))
    got = tpa._gemm_bias_reference(a, w, b, r if res else None)
    want = torch.addmm(b, a, w)
    want = r + want if res else want
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=0, rtol=2.0 ** -7)


def test_declare_names_every_exported_entry():
    """`build._declare` sets the argument types of every `extern "C"`
    function that `csrc/*.cu` defines (an undeclared pointer argument would
    be cut to 32 bits), and of nothing else."""
    exported = set()
    for src in glob.glob(os.path.join(build.CSRC_DIR, "*.cu")):
        with open(src) as f:
            exported |= set(re.findall(
                r'^extern "C" [\w \*]+?\b(leaf_\w+)\(', f.read(), re.M))

    class Entry:
        argtypes = restype = None

    class Library:
        def __init__(self):
            self.entries = {}

        def __getattr__(self, name):
            return self.entries.setdefault(name, Entry())

    lib = Library()
    build._declare(lib)
    assert set(lib.entries) == exported
    assert {"leaf_fused_block", "leaf_gemm_bias", "leaf_gemm_bias_tile",
            "leaf_layer_norm", "leaf_packed_attention"} <= exported
    for name, entry in lib.entries.items():
        assert entry.argtypes and entry.restype is not None, name
    assert len(lib.entries["leaf_fused_block"].argtypes) == 22
    assert len(lib.entries["leaf_gemm_bias_tile"].argtypes) == \
        len(lib.entries["leaf_gemm_bias"].argtypes) + 1
