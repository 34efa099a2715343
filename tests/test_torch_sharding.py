"""leaf_tpu_torch.parallel.sharding against the JAX package's
`parallel/sharding.py`, on the CPU.

Held: the split rules equal `clip_param_spec` on every leaf of every
registry config with a `*-tiny-test` entry (each JAX leaf traced to the
port's names through the port's interop); JAX's `shard_params` on a
(2, 2) CPU mesh, carried to the port's shards and back, is unchanged, and
every shard but qkv's (split by heads here) is JAX's device shard; the
tensor-parallel ViT-tiny-test text tower on two gloo ranks (a 1 x 2 grid)
gives the one-rank tower's features, input gradients and parameter
gradients (fp32, 1e-5 of their scale), and its `state_dict` is whole.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from leaf_tpu.models import coca as jcoca
from leaf_tpu.models import create_model as jcreate_model
from leaf_tpu.models.coca import COCA_CONFIGS
from leaf_tpu.models.config import list_models
from leaf_tpu.parallel.sharding import clip_param_spec, shard_params
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models.coca_interop import coca_params_from_jax
from leaf_tpu_torch.models.factory import create_model as tcreate_model
from leaf_tpu_torch.parallel import sharding

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "ViT-tiny-test"
TINY = sorted(n for n in list_models() if n.endswith("tiny-test"))


def _to_port(name, tree):
    return (coca_params_from_jax if name in COCA_CONFIGS
            else tinterop.params_from_jax)(tree)


def _jax_axis(spec):
    """The mesh-axis position of "model" in a PartitionSpec, or None."""
    return next((i for i, a in enumerate(spec) if a == "model"), None)


@pytest.mark.parametrize("name", TINY)
def test_split_rules_match_clip_param_spec(name):
    """Each JAX leaf is filled with its own index and carried through the
    port's interop, so every port tensor names the leaf it came from; its
    `param_split` must be the leaf's spec (the layer axis, where the port
    un-stacked it, taken away).  The JAX package caches coca-roberta's HF
    text tower, and one first built inside a trace (`tests/
    test_registry_integrity.py`, in the same worker) holds tracers: the
    cache is emptied first."""
    jcoca._hf_tower_cached.cache_clear()
    params = jax.tree.map(np.asarray, jcreate_model(name).params)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    specs = jax.tree_util.tree_leaves(
        clip_param_spec(params, "model"),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(specs) == len(leaves)
    marked = jax.tree_util.tree_unflatten(treedef, [
        np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    port = _to_port(name, marked)
    names = set(tcreate_model(name, device="cpu").module.state_dict())
    seen, split = set(), 0
    for key, t in port.items():
        assert key in names, key
        ids = torch.unique(t).to(torch.int64).tolist()
        assert len(ids) == 1, (key, ids)
        i = ids[0]
        seen.add(i)
        want = _jax_axis(specs[i])
        if want is not None:
            want -= np.ndim(leaves[i]) - t.dim()   # the un-stacked layer axis
            split += 1
        assert sharding.param_split(key, t.dim()) == want, (key, specs[i])
    assert seen == set(range(len(leaves)))
    # every tower's stacked blocks split (the ViT's, the towers' with
    # blocks), and the text tower's vocabulary
    assert split > 0


@pytest.mark.parametrize("name", [MODEL, "siglip-tiny-test"])
def test_shard_params_round_trip(name):
    """JAX's `shard_params` on a (2, 2) mesh -> whole arrays -> the port's
    shards -> whole again: unchanged.  Each port shard of a split tensor is
    JAX's device shard at the same model index, but for qkv, whose shard
    holds the rank's heads' q, k and v."""
    params = jcreate_model(name).params
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    placed = shard_params(params, mesh, "model")
    whole = _to_port(name, jax.tree.map(np.asarray, placed))
    shards = [{k: sharding.shard_tensor(k, v, 2, m) for k, v in whole.items()}
              for m in range(2)]
    for k, v in whole.items():
        assert torch.equal(sharding.unshard_tensor(k, [s[k] for s in shards]),
                           v), k

    # JAX's device shards, un-stacked the port's way
    jax_shards = []
    for m in range(2):
        dev = mesh.devices[0, m]
        jax_shards.append(_to_port(name, jax.tree.map(
            lambda x: np.asarray(next(s.data for s in x.addressable_shards
                                      if s.device == dev)), placed)))
    checked = 0
    for k, t in whole.items():
        if sharding.param_split(k, t.dim()) is None:
            assert all(torch.equal(s[k], t) for s in jax_shards), k
            continue
        for m in range(2):
            if k.endswith(("qkv_w", "qkv_b")):
                q, kk, v = t.chunk(3, -1)
                want = torch.cat([p.chunk(2, -1)[m] for p in (q, kk, v)], -1)
                assert torch.equal(shards[m][k], want), k
                if k.endswith("qkv_w"):      # (the biases are zeros)
                    assert not torch.equal(shards[m][k], jax_shards[m][k]), k
            else:
                assert torch.equal(shards[m][k], jax_shards[m][k]), k
        checked += 1
    assert checked >= 4 * tconfig.get_model_config(name).text.layers + 1


def test_create_grid_refuses_a_shape_that_misses_the_ranks():
    grid = sharding.create_grid()
    assert (grid.data, grid.model, grid.data_index, grid.model_index) == \
        (1, 1, 0, 0)
    for shape in [(2,), (1, 2), (2, 1, 1)]:
        with pytest.raises(ValueError, match="does not cover"):
            sharding.create_grid(shape)


def test_shard_module_takes_the_text_tower_only():
    model = tclip.CLIP(tconfig.get_model_config(MODEL))
    grid = sharding.Grid(1, 2, 0, 0)
    with pytest.raises(NotImplementedError, match="text tower"):
        sharding.shard_module(model.visual, grid)
    assert sharding.shard_module(model.text, sharding.Grid(1, 1, 0, 0)) \
        is model.text and model.text.tp is None


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_gemm_bias_plain_version(bias):
    """`ops.gemm_bias` on a CPU tensor is its plain version: `a @ w (+
    bias)` over any leading shape, rounded once, with its gradients; no
    launch is counted."""
    from leaf_tpu_torch.ops import packed_attention as pa
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32)) \
        if bias else None
    for t in (a, w) + ((b,) if bias else ()):
        t.requires_grad_(True)
    before = pa.gemm_bias.launches
    out = pa.gemm_bias(a, w, b)
    want = a.detach() @ w.detach() + (b.detach() if bias else 0)
    assert out.shape == (2, 5, 6) and pa.gemm_bias.launches == before
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(),
                               atol=1e-6)
    out.square().sum().backward()
    g = 2 * out.detach()
    np.testing.assert_allclose(a.grad.numpy(), (g @ w.detach().T).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(
        w.grad.numpy(), (a.detach().reshape(-1, 8).T @ g.reshape(-1, 6))
        .numpy(), atol=1e-5)
    if bias:
        np.testing.assert_allclose(b.grad.numpy(),
                                   g.reshape(-1, 6).sum(0).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        pa.gemm_bias(a.detach().transpose(0, 1), w.detach())


# the tensor-parallel text tower on two gloo ranks (a 1 x 2 grid)
WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from leaf_tpu_torch.models import clip as tclip
    from leaf_tpu_torch.models import config as tconfig
    from leaf_tpu_torch.parallel import distributed as D
    from leaf_tpu_torch.parallel import sharding

    root = sys.argv[1]
    D.init_distributed_device("cpu")
    grid = sharding.create_grid((1, 2))
    cfg = tconfig.get_model_config(%(model)r)
    inputs = dict(np.load(root + "/inputs.npz"))
    sd = torch.load(root + "/text.pt")
    tower = tclip.TextTower(cfg.text, cfg.quick_gelu)
    tower.load_state_dict(sd)
    sharding.shard_module(tower, grid)
    out = {"rank": D.rank(), "grid": [grid.data, grid.model,
                                       grid.data_index, grid.model_index],
           "local": {k: list(v.shape) for k, v in tower.named_parameters()}}
    # a whole state dict, equal to the one loaded
    whole = tower.state_dict()
    out["whole"] = all(torch.equal(whole[k], v) for k, v in sd.items()) \\
        and whole.keys() == sd.keys()
    before = [p.detach().clone() for p in tower.parameters()]
    tower.load_state_dict(whole)               # whole in, shards kept
    out["reload"] = all(torch.equal(a, b) for a, b in zip(
        before, tower.parameters()))
    tokens = torch.from_numpy(inputs["tokens"])
    w = torch.from_numpy(inputs["w"])
    embeds = tower.embed_tokens(tokens).detach().requires_grad_(True)
    feats = tower.encode_text_embedding(embeds, tokens)
    packed = tower.encode_text(tokens)       # the lookup's gradient too
    ((feats * w).sum() + (packed * w.flip(0)).sum()).backward()
    out["packed"] = packed.detach().tolist()
    out["feats"] = feats.detach().tolist()
    out["input_grad"] = embeds.grad.tolist()
    grads = {}
    for name, p in tower.named_parameters():
        g = p.grad.contiguous()
        if sharding.param_split(name, g.dim()) is not None:
            parts = [torch.empty_like(g) for _ in range(2)]
            torch.distributed.all_gather(parts, g)
            g = sharding.unshard_tensor(name, parts)
        grads[name] = g.tolist()
    out["grads"] = grads
    json.dump(out, open(root + "/rank%%d.json" %% D.rank(), "w"))
""") % {"repo": REPO, "model": MODEL}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tokens(rng, B, S):
    toks = np.zeros((B, S), np.int64)
    for i in range(B):
        e = int(rng.integers(2, S))
        toks[i, 0] = 49406
        toks[i, 1:e] = rng.integers(1, 49400, size=e - 1)
        toks[i, e] = 49407
    return toks


@pytest.fixture(scope="module")
def tp_tower(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_tower")
    cfg = tconfig.get_model_config(MODEL)
    model = tclip.CLIP(cfg)
    model.load_state_dict(tinterop.params_from_jax(jax.tree.map(
        np.asarray, jcreate_model(MODEL).params)))
    sd = {k[5:]: v for k, v in model.state_dict().items()
          if k.startswith("text.")}
    torch.save(sd, root / "text.pt")
    rng = np.random.default_rng(0)
    inputs = {"tokens": _tokens(rng, 8, 16),
              "w": rng.standard_normal((8, cfg.text.output_dim)).astype(
                  np.float32)}
    np.savez(root / "inputs.npz", **inputs)
    (root / "worker.py").write_text(WORKER)
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        log = open(root / f"rank{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(root / "worker.py"), str(root)],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    for r, p in enumerate(procs):
        p.wait(timeout=300)
        assert p.returncode == 0, (root / f"rank{r}.log").read_text()[-3000:]
    outs = [json.loads((root / f"rank{r}.json").read_text())
            for r in range(2)]

    # the one-rank tower on the same weights and inputs
    tower = model.text
    tokens = torch.from_numpy(inputs["tokens"])
    w = torch.from_numpy(inputs["w"])
    embeds = tower.embed_tokens(tokens).detach().requires_grad_(True)
    feats = tower.encode_text_embedding(embeds, tokens)
    packed = tower.encode_text(tokens)
    ((feats * w).sum() + (packed * w.flip(0)).sum()).backward()
    ref = {"feats": feats.detach(), "input_grad": embeds.grad,
           "packed": packed.detach(),
           "grads": {n: p.grad for n, p in tower.named_parameters()}}
    return sd, outs, ref


def _close(got, want, what):
    got = torch.as_tensor(np.asarray(got, np.float32))
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 1e-5 * max(scale, 1e-30), (what, err, scale)


def test_tp_tower_holds_its_shards(tp_tower):
    sd, outs, _ = tp_tower
    for r, o in enumerate(outs):
        assert o["grid"] == [1, 2, 0, r]
        assert o["whole"] and o["reload"]
        for k, shape in o["local"].items():
            dim = sharding.param_split(k, len(shape))
            want = list(sd[k].shape)
            if dim is not None:
                want[dim] //= 2
            assert shape == want, k


@pytest.mark.parametrize("what", ["feats", "packed", "input_grad"])
def test_tp_tower_matches_one_rank(tp_tower, what):
    _, outs, ref = tp_tower
    for o in outs:
        _close(o[what], ref[what], what)


def test_tp_tower_gradients_match_one_rank(tp_tower):
    _, outs, ref = tp_tower
    for o in outs:
        assert o["grads"].keys() == ref["grads"].keys()
        for name, g in o["grads"].items():
            _close(g, ref["grads"][name], name)
