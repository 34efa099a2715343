"""leaf_tpu_torch's Swin and RelPos-ViT trunks against the JAX package, in
fp32 on the CPU (the JAX side at the conftest's `highest` matmul
precision): the window machinery (relative index, shift mask, partition,
patch-merge order, window clamp), the parts, both tiny towers end to end
from the same seeded numpy weights (carried by `interop.params_from_jax`),
and timm state dicts in both Swin key layouts through both packages'
loaders.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import interop as jinterop
from leaf_tpu.models import relpos_vit as jrelpos
from leaf_tpu.models import swin as jswin
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import relpos_vit as trelpos
from leaf_tpu_torch.models import swin as tswin
from leaf_tpu_torch.models.factory import create_model

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = ("swin-tiny-test", "relpos-tiny-test")


def _np(t):
    return np.asarray(t, np.float32)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _fill(node, rng, path=()):
    """Seeded numpy weights in the shape tree `node`: unit-ish LayerNorm
    scales, small biases, fan-in-scaled weights and bias tables."""
    if isinstance(node, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_fill(v, rng, path + (i,)) for i, v in enumerate(node)]
    shape, name = tuple(node.shape), path[-1]
    n = rng.standard_normal(shape)
    if name == "scale":
        a = 1 + 0.1 * n
    elif len(shape) <= 1 or name == "bias" or name.endswith("_b"):
        a = 0.1 * n
    elif name in ("token_embedding", "positional_embedding"):
        a = 0.02 * n
    elif name == "bias_table":
        a = 0.5 * n
    else:
        core = shape[1:] if "blocks" in path else shape
        a = n / math.sqrt(math.prod(core[:-1]))
    return a.astype(np.float32)


def _seeded(jcfg, seed=0):
    shapes = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0),
                                                    jcfg))
    return _fill(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module", params=NAMES)
def tiny(request):
    jcfg = jconfig.get_model_config(request.param)
    tcfg = tconfig.get_model_config(request.param)
    params = _seeded(jcfg, seed=len(request.param))
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.params_from_jax(params))
    return jcfg, tcfg, params, module.eval()


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["swin_base_patch4_window7_224",
                                  "vit_relpos_medium_patch16_cls_224",
                                  *NAMES])
def test_registry_configs_match_jax(name):
    j, t = jconfig.get_model_config(name), tconfig.get_model_config(name)
    assert type(j.trunk).__name__ == type(t.trunk).__name__
    assert dataclasses.asdict(j.trunk) == dataclasses.asdict(t.trunk)
    for f in ("embed_dim", "quick_gelu", "image_mean", "image_std"):
        assert getattr(j, f) == getattr(t, f), f
    assert dataclasses.asdict(j.text).items() >= dataclasses.asdict(
        t.text).items()


def test_matchers_refuse_other_names_as_jax():
    with pytest.raises(ValueError, match="unsupported swin trunk"):
        tswin.match_swin("swin_large_patch4_window12_384", 640)
    with pytest.raises(ValueError, match="unsupported relpos"):
        trelpos.match_relpos("vit_relpos_base_patch16_224", 512)
    assert tswin.match_swin("vit_base_patch16_224", 512) is None
    spec = tswin.match_swin("swin_base_patch4_window7_224", 640, 256)
    assert spec == tswin.SwinVisionSpec(
        **dataclasses.asdict(jswin.match_swin(
            "swin_base_patch4_window7_224", 640, 256)))


# ---------------------------------------------------------------------------
# Window machinery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 3, 4, 7])
def test_rel_pos_index_matches_jax(w):
    np.testing.assert_array_equal(tswin.rel_pos_index(w),
                                  jswin.rel_pos_index(w))
    assert trelpos.rel_pos_index is tswin.rel_pos_index


@pytest.mark.parametrize("grid,w,shift", [(8, 4, 2), (14, 7, 3),
                                          (56, 7, 3), (28, 7, 3)])
def test_shift_mask_matches_jax(grid, w, shift):
    m = tswin.shift_attn_mask(grid, w, shift)
    np.testing.assert_array_equal(m, jswin.shift_attn_mask(grid, w, shift))
    assert m.min() == -1e9 and (m[0] == 0).all()


def test_window_partition_round_trips_as_jax():
    x = _x(1, 2, 8, 8, 5)
    got = tswin.window_partition(torch.from_numpy(x), 4)
    want = jswin._window_partition(jnp.asarray(x), 4)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    back = tswin.window_reverse(got, 4, 2, 8, 8)
    np.testing.assert_array_equal(back.numpy(), x)


def test_patch_merge_order_matches_jax():
    """The concat order [x00, x10, x01, x11] (row offset fastest), then the
    LayerNorm and the bias-less reduction, as the JAX package's."""
    C = 3
    x = _x(2, 2, 4, 6, C)
    cat = tswin.patch_merge_concat(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(cat[0, 0, 0, :C], x[0, 0, 0])
    np.testing.assert_array_equal(cat[0, 0, 0, C:2 * C], x[0, 1, 0])
    np.testing.assert_array_equal(cat[0, 0, 0, 2 * C:3 * C], x[0, 0, 1])
    np.testing.assert_array_equal(cat[0, 0, 0, 3 * C:], x[0, 1, 1])
    merge = tswin._PatchMerge(C, 1e-5)
    p = {"norm": {"scale": 1 + 0.1 * _x(3, 4 * C), "bias": _x(4, 4 * C)},
         "reduction": _x(5, 4 * C, 2 * C)}
    merge.load_state_dict(tinterop.params_from_jax(p))
    want = jswin._patch_merge(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              1e-5)
    with torch.no_grad():
        got = merge(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_window_clamp_matches_jax():
    """Where the grid is no larger than the window the window is clamped
    to it, unshifted: Swin-B's last stage (7 x 7) and the tiny test's
    second stage; such a stage builds no mask and no shifted block."""
    for name in ("swin_base_patch4_window7_224", "swin-tiny-test"):
        js = jconfig.get_model_config(name).trunk
        ts = tconfig.get_model_config(name).trunk
        for s in range(len(ts.depths)):
            assert ts.stage_window(s) == js.stage_window(s)
            w, g = js.stage_window(s), js.stage_grid(s)
            assert ts.stage_shift(s) == (0 if w >= g else w // 2)
    spec = tconfig.get_model_config("swin_base_patch4_window7_224").trunk
    assert (spec.stage_grid(3), spec.stage_window(3),
            spec.stage_shift(3)) == (7, 7, 0)
    last = tswin._Stage(spec, 3)
    assert last.mask is None and all(b.shift == 0 for b in last.blocks)
    assert [b.shift for b in tswin._Stage(spec, 2).blocks[:4]] == [0, 3, 0, 3]


# ---------------------------------------------------------------------------
# The parts
# ---------------------------------------------------------------------------

def _stage_params(tree, s):
    return jax.tree.map(jnp.asarray, tree["visual"]["stages"][s])


@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_matches_jax(shifted):
    spec = tconfig.get_model_config("swin-tiny-test").trunk
    params = _seeded(jconfig.get_model_config("swin-tiny-test"), seed=7)
    blocks = params["visual"]["stages"][0]["blocks"]
    p = jax.tree.map(lambda a: jnp.asarray(a[1]), blocks["attn"])
    w, g = spec.stage_window(0), spec.stage_grid(0)
    x = _x(8, 2 * (g // w) ** 2, w * w, spec.stage_dim(0))
    index = jswin.rel_pos_index(w)
    mask = (jswin.shift_attn_mask(g, w, w // 2) if shifted else
            np.zeros(((g // w) ** 2, w * w, w * w), np.float32))
    want = jswin._window_attention(p, jnp.asarray(x), spec.heads[0], w,
                                   jnp.asarray(index), jnp.asarray(mask))
    attn = tswin._WindowAttention(spec.stage_dim(0), spec.heads[0], w)
    attn.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in p.items()})
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.from_numpy(index).long(),
                   torch.from_numpy(mask) if shifted else None)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("s", [0, 1])
def test_swin_stage_matches_jax(s):
    """A stage (the entry merge, then plain and shifted blocks) against the
    JAX package's scanned `_stage`."""
    jcfg = jconfig.get_model_config("swin-tiny-test")
    spec = tconfig.get_model_config("swin-tiny-test").trunk
    params = _seeded(jcfg, seed=9)
    C = spec.stage_dim(max(s - 1, 0))
    g = spec.stage_grid(s) * (2 if s else 1)
    x = _x(10, 2, g, g, C)
    want = jswin._stage(_stage_params(params, s), jnp.asarray(x), jcfg.trunk,
                        s)
    stage = tswin._Stage(spec, s)
    sd = {k[len(f"visual.stages.{s}."):]: v for k, v in
          tinterop.params_from_jax(params).items()
          if k.startswith(f"visual.stages.{s}.")}
    stage.load_state_dict(sd)
    with torch.no_grad():
        got = stage(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_swin_shift_mask_is_live():
    """Dropping the shift mask changes the encoding: the shifted path is
    taken."""
    module = tclip.CLIP(tconfig.get_model_config("swin-tiny-test"))
    module.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(11, 2, 32, 32, 3))
    with torch.no_grad():
        base = module.encode_image(x)
        module.visual.stages[0].mask = torch.zeros_like(
            module.visual.stages[0].mask)
        nomask = module.encode_image(x)
    assert (base - nomask).abs().max() > 1e-6


def test_relpos_coords_and_bias_match_jax():
    np.testing.assert_array_equal(trelpos.rel_log_coords(4),
                                  jrelpos.rel_log_coords(4))
    spec = tconfig.get_model_config("relpos-tiny-test").trunk
    params = _seeded(jconfig.get_model_config("relpos-tiny-test"), seed=12)
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      params["visual"]["blocks"]["attn"]["rel_pos"])
    g = spec.grid_size
    coords, index = jrelpos.rel_log_coords(g), jrelpos.rel_pos_index(g)
    want = jrelpos._rel_pos_bias(rp, jnp.asarray(coords), jnp.asarray(index),
                                 spec.heads, jnp.float32)
    mlp = trelpos._RelPosMlp(spec.rel_pos_dim, spec.heads)
    mlp.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in rp.items()})
    with torch.no_grad():
        got = mlp(torch.from_numpy(coords), torch.from_numpy(index).long())
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert (got[:, 0] == 0).all() and (got[:, :, 0] == 0).all()


def test_relpos_block_matches_jax():
    jcfg = jconfig.get_model_config("relpos-tiny-test")
    spec = tconfig.get_model_config("relpos-tiny-test").trunk
    params = _seeded(jcfg, seed=13)
    p = jax.tree.map(lambda a: jnp.asarray(a[1]), params["visual"]["blocks"])
    g = spec.grid_size
    x = _x(14, 2, g * g + 1, spec.width)
    want = jrelpos._block(p, jnp.asarray(x), jcfg.trunk,
                          jnp.asarray(jrelpos.rel_log_coords(g)),
                          jnp.asarray(jrelpos.rel_pos_index(g)))
    block = trelpos._Block(spec)
    sd = tinterop.params_from_jax({"blocks": jax.tree.map(
        np.asarray, params["visual"]["blocks"])})
    block.load_state_dict({k[len("blocks.1."):]: v for k, v in sd.items()
                           if k.startswith("blocks.1.")})
    with torch.no_grad():
        got = block(torch.from_numpy(x),
                    torch.from_numpy(trelpos.rel_log_coords(g)),
                    torch.from_numpy(trelpos.rel_pos_index(g)).long())
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# The towers
# ---------------------------------------------------------------------------

def test_tiny_towers_match_jax(tiny):
    jcfg, tcfg, params, module = tiny
    size = tcfg.vision.image_size
    images = _x(21, 3, size, size, 3)
    tokens = np.random.default_rng(22).integers(
        1, tcfg.text.vocab_size, (4, tcfg.text.context_length)).astype(
        np.int32)
    want_i = jclip.encode_image_model(params, jcfg, jnp.asarray(images))
    want_t = jclip.encode_text(params["text"], jcfg.text, jnp.asarray(tokens))
    with torch.no_grad():
        got_i = module.encode_image(torch.from_numpy(images))
        got_t = module.encode_text(torch.from_numpy(tokens))
        got_n = module.encode_image(torch.from_numpy(images), normalize=True)
    np.testing.assert_allclose(got_i.numpy(), _np(want_i), **TOL)
    np.testing.assert_allclose(got_t.numpy(), _np(want_t), **TOL)
    np.testing.assert_allclose(got_n.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    # no JAX trainer passes remat to a zoo tower (ROADMAP item 11 step 4)
    with pytest.raises(NotImplementedError,
                       match="neither remat nor patch dropout.*JAX package"):
        module.visual.encode_image(torch.from_numpy(images), remat=True)


@pytest.mark.parametrize("name", ["swin_base_patch4_window7_224",
                                  "vit_relpos_medium_patch16_cls_224"])
def test_full_size_configs_build_at_the_jax_shapes(name):
    """The full-size trunk's state dict has the JAX pytree's shapes, leaf
    for leaf (built on the meta device)."""
    jcfg = jconfig.get_model_config(name)
    shapes = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0),
                                                    jcfg))["visual"]
    want = {k: tuple(v.shape) for k, v in tinterop.params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.int8), shapes)).items()}
    with torch.device("meta"):
        module = tclip.CLIP(tconfig.get_model_config(name))
    got = {k[len("visual."):]: tuple(v.shape)
           for k, v in module.state_dict().items() if k.startswith("visual.")}
    assert got == want


# ---------------------------------------------------------------------------
# timm checkpoints
# ---------------------------------------------------------------------------

def _swin_timm_sd(spec, seed, old_layout=False):
    """A seeded timm Swin state dict, the merge filed at the stage entry or
    (the original layout) at the end of the stage before."""
    rng = np.random.default_rng(seed)

    def r(*s, base=0.0):
        return (base + 0.05 * rng.standard_normal(s)).astype(np.float32)

    D, last = spec.embed_dim, spec.stage_dim(len(spec.depths) - 1)
    t = "visual.trunk."
    sd = {t + "patch_embed.proj.weight": r(D, 3, spec.patch_size,
                                           spec.patch_size),
          t + "patch_embed.proj.bias": r(D),
          t + "patch_embed.norm.weight": r(D, base=1),
          t + "patch_embed.norm.bias": r(D),
          t + "norm.weight": r(last, base=1), t + "norm.bias": r(last),
          "visual.head.proj.weight": r(spec.output_dim, last)}
    for s in range(len(spec.depths)):
        C, w = spec.stage_dim(s), spec.stage_window(s)
        Hn = int(C * spec.mlp_ratio)
        for i in range(spec.depths[s]):
            b = f"{t}layers.{s}.blocks.{i}."
            sd.update({
                b + "norm1.weight": r(C, base=1), b + "norm1.bias": r(C),
                b + "norm2.weight": r(C, base=1), b + "norm2.bias": r(C),
                b + "attn.qkv.weight": r(3 * C, C),
                b + "attn.qkv.bias": r(3 * C),
                b + "attn.proj.weight": r(C, C), b + "attn.proj.bias": r(C),
                b + "attn.relative_position_bias_table":
                    r((2 * w - 1) ** 2, spec.heads[s]),
                b + "mlp.fc1.weight": r(Hn, C), b + "mlp.fc1.bias": r(Hn),
                b + "mlp.fc2.weight": r(C, Hn), b + "mlp.fc2.bias": r(C)})
        if s > 0:
            Cin = spec.stage_dim(s - 1)
            ds = f"{t}layers.{s - 1 if old_layout else s}.downsample."
            sd.update({ds + "norm.weight": r(4 * Cin, base=1),
                       ds + "norm.bias": r(4 * Cin),
                       ds + "reduction.weight": r(2 * Cin, 4 * Cin)})
    return sd


def _relpos_timm_sd(spec, seed):
    rng = np.random.default_rng(seed)

    def r(*s, base=0.0):
        return (base + 0.05 * rng.standard_normal(s)).astype(np.float32)

    D, Hn, R = spec.width, spec.mlp_hidden, spec.rel_pos_dim
    t = "visual.trunk."
    sd = {t + "patch_embed.proj.weight": r(D, 3, spec.patch_size,
                                           spec.patch_size),
          t + "patch_embed.proj.bias": r(D), t + "cls_token": r(1, 1, D),
          t + "norm.weight": r(D, base=1), t + "norm.bias": r(D),
          "visual.head.proj.weight": r(spec.output_dim, D),
          "visual.head.proj.bias": r(spec.output_dim)}
    for i in range(spec.layers):
        b = f"{t}blocks.{i}."
        sd.update({
            b + "norm1.weight": r(D, base=1), b + "norm1.bias": r(D),
            b + "norm2.weight": r(D, base=1), b + "norm2.bias": r(D),
            b + "attn.qkv.weight": r(3 * D, D),
            b + "attn.proj.weight": r(D, D), b + "attn.proj.bias": r(D),
            b + "attn.rel_pos.mlp.fc1.weight": r(R, 2),
            b + "attn.rel_pos.mlp.fc1.bias": r(R),
            b + "attn.rel_pos.mlp.fc2.weight": r(spec.heads, R),
            b + "attn.rel_pos.mlp.fc2.bias": r(spec.heads),
            b + "mlp.fc1.weight": r(Hn, D), b + "mlp.fc1.bias": r(Hn),
            b + "mlp.fc2.weight": r(D, Hn), b + "mlp.fc2.bias": r(D)})
    return sd


def _text_sd(cfg, seed):
    """A seeded OpenCLIP text tower state dict under `text.`."""
    rng = np.random.default_rng(seed)

    def r(*s, base=0.0):
        return (base + 0.05 * rng.standard_normal(s)).astype(np.float32)

    D, M = cfg.width, int(cfg.width * cfg.mlp_ratio)
    sd = {"text.token_embedding.weight": r(cfg.vocab_size, D),
          "text.positional_embedding": r(cfg.context_length, D),
          "text.ln_final.weight": r(D, base=1), "text.ln_final.bias": r(D),
          "text.text_projection": r(D, cfg.output_dim),
          "logit_scale": np.float32(2.5)}
    for i in range(cfg.layers):
        b = f"text.transformer.resblocks.{i}."
        sd.update({b + "ln_1.weight": r(D, base=1), b + "ln_1.bias": r(D),
                   b + "attn.in_proj_weight": r(3 * D, D),
                   b + "attn.in_proj_bias": r(3 * D),
                   b + "attn.out_proj.weight": r(D, D),
                   b + "attn.out_proj.bias": r(D),
                   b + "ln_2.weight": r(D, base=1), b + "ln_2.bias": r(D),
                   b + "mlp.c_fc.weight": r(M, D), b + "mlp.c_fc.bias": r(M),
                   b + "mlp.c_proj.weight": r(D, M),
                   b + "mlp.c_proj.bias": r(D)})
    return sd


def test_swin_timm_layouts_load_to_equal_trees():
    """Both timm key layouts give the JAX package's pytree, and each other,
    leaf for leaf."""
    spec = tconfig.get_model_config("swin-tiny-test").trunk
    jspec = jconfig.get_model_config("swin-tiny-test").trunk
    new = tswin.timm_swin_to_params(_swin_timm_sd(spec, 31), spec)
    old = tswin.timm_swin_to_params(_swin_timm_sd(spec, 31, True), spec)
    want = jswin.timm_swin_to_params(_swin_timm_sd(spec, 31, True), jspec)
    for a, b, c in zip(jax.tree.leaves(new), jax.tree.leaves(old),
                       jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _np(c))
    assert jax.tree.structure(new) == jax.tree.structure(want)


@pytest.mark.parametrize("name,old", [("swin-tiny-test", False),
                                      ("swin-tiny-test", True),
                                      ("relpos-tiny-test", False)])
def test_openclip_checkpoints_load_as_in_jax(name, old):
    """An OpenCLIP state dict with a timm Swin or RelPos trunk (the head's
    bias where the weights have one) through the port's
    `openclip_to_params` gives the JAX package's pytree entry for entry,
    and `create_model(pretrained=...)` its features."""
    from leaf_tpu_torch.convert import save_state_dict
    jcfg, tcfg = jconfig.get_model_config(name), tconfig.get_model_config(name)
    trunk = (_swin_timm_sd(tcfg.trunk, 41, old) if name.startswith("swin")
             else _relpos_timm_sd(tcfg.trunk, 42))
    sd = {**trunk, **_text_sd(tcfg.text, 43)}
    jparams = jinterop.openclip_to_params(sd, jcfg)
    got = tinterop.openclip_to_params(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, tcfg)
    want = tinterop.params_from_jax(jax.tree.map(np.asarray, jparams))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = save_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                                for k, v in sd.items()}, d)
        model = create_model(name, pretrained=path, device="cpu")
    images = _x(44, 2, tcfg.vision.image_size, tcfg.vision.image_size, 3)
    want_i = jclip.encode_image_model(jax.tree.map(jnp.asarray, jparams),
                                      jcfg, jnp.asarray(images))
    with torch.no_grad():
        got_i = model.encode_image(images)
    np.testing.assert_allclose(got_i.numpy(), _np(want_i), **TOL)
