"""leaf_tpu_torch.parallel.distributed and the contrastive losses on two
ranks (two gloo processes on the CPU, joined by the launcher's variables
set by hand) against the JAX package.

Held: the host helpers (`global_max_int32`, `broadcast_object`,
`all_gather_object`, `local_batch_slice`) to the JAX module's semantics;
the tensor collectives' values and gradients; `clip_loss` (global and
`local_loss`), the SigLIP ring, `coca_loss` and `distill_clip_loss` on two
ranks, loss and input gradients to 1e-5, against the JAX losses under
`shard_map` on a two-device CPU mesh (computed as `tests/test_loss.py`
computes them); at world 1 every function is the identity of one rank;
where a backend runs a collective on a CUDA tensor, and where the tensor
goes through the host.
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
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from leaf_tpu.models import loss as jloss
from leaf_tpu.parallel.mesh import local_batch_slice as jlocal_batch_slice
from leaf_tpu_torch.models import loss as tloss
from leaf_tpu_torch.parallel import distributed

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, D, S, V = 8, 16, 6, 11       # global batch, width, caption length, vocab
SCALE, BIAS = 10.0, -2.0
LOSSES = ["clip", "clip_local", "siglip", "coca", "coca_local", "distill",
          "distill_local"]

WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from leaf_tpu_torch.models import loss as L
    from leaf_tpu_torch.parallel import distributed as D

    inputs = dict(np.load(sys.argv[1]))
    info = D.init_distributed_device("cpu")
    rank, world = info["rank"], info["world_size"]
    rows = D.local_batch_slice(len(inputs["img"]))
    out = {"info": [rank, world]}
    out["max"] = D.global_max_int32([rank, 3 - rank, 7]).tolist()
    out["bcast"] = D.broadcast_object({"from_rank0": True} if rank == 0
                                      else None)
    out["objects"] = D.all_gather_object({"rank": rank, "s": "x" * rank})
    out["slice"] = [rows.start, rows.stop]

    # the tensor collectives: values and gradients
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
    x.requires_grad_(True)
    g = D.all_gather(x)
    (g * torch.arange(12, dtype=torch.float32).reshape(6, 2)).sum().backward()
    out["gather"] = [g.detach().tolist(), x.grad.tolist()]
    y = (torch.ones(2) * (rank + 1)).requires_grad_(True)
    n = D.neighbour_exchange(y)
    (n * (rank + 5)).sum().backward()
    out["exchange"] = [n.detach().tolist(), y.grad.tolist()]
    m = [torch.full((2,), float(rank)), torch.full((3,), 2.0 * rank)]
    D.all_reduce_mean_(m)
    out["mean"] = [t.tolist() for t in m]
    out["pmean"] = float(D.pmean(torch.tensor(float(rank))))

    def t(name):
        return torch.from_numpy(inputs[name][rows]).requires_grad_(True)

    scale = torch.tensor(%(scale)r)
    for name in %(losses)r:
        group, local = D.group(), name.endswith("_local")
        img, txt = t("img"), t("txt")
        grads = [img, txt]
        if name.startswith("clip"):
            loss = L.clip_loss(img, txt, scale, group, local)
        elif name == "siglip":
            loss = L.siglip_loss(img, txt, scale, torch.tensor(%(bias)r),
                                 group=group)
        elif name.startswith("coca"):
            logits = t("logits")
            grads.append(logits)
            c, cap = L.coca_loss(img, txt, logits,
                                 torch.from_numpy(inputs["labels"][rows]),
                                 scale, group=group, local_loss=local)
            loss = c + cap
        else:
            c, d = L.distill_clip_loss(
                img, txt, scale, torch.from_numpy(inputs["t_img"][rows]),
                torch.from_numpy(inputs["t_txt"][rows]),
                torch.tensor(%(scale)r / 2), group=group, local_loss=local)
            loss = c + d
        loss.backward()
        out[name] = {"loss": float(D.pmean(loss.detach())),
                     "grads": [D.all_gather_no_grad(v.grad / world).tolist()
                               for v in grads]}
    with open(os.path.join(os.path.dirname(sys.argv[1]),
                           f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
""") % {"repo": REPO, "scale": SCALE, "bias": BIAS, "losses": LOSSES}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, [rank 0's outputs, rank 1's]) of two gloo ranks."""
    root = tmp_path_factory.mktemp("distributed")
    rng = np.random.default_rng(0)
    labels = rng.integers(1, V, size=(B, S))
    labels[:, -2:] = 0                       # pad
    inputs = {"img": _unit(rng, B, D), "txt": _unit(rng, B, D),
              "t_img": _unit(rng, B, D), "t_txt": _unit(rng, B, D),
              "logits": rng.standard_normal((B, S, V)).astype(np.float32),
              "labels": labels}
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
            [sys.executable, str(root / "worker.py"),
             str(root / "inputs.npz")], stdout=log, stderr=subprocess.STDOUT,
            env=env))
    for r, p in enumerate(procs):
        p.wait(timeout=300)
        assert p.returncode == 0, (root / f"rank{r}.log").read_text()[-3000:]
    return inputs, [json.loads((root / f"rank{r}.json").read_text())
                    for r in range(2)]


def test_host_helpers_follow_the_jax_semantics(ranks):
    """`global_max_int32` is the elementwise max over ranks; the object
    helpers carry rank 0's object and every rank's in rank order;
    `local_batch_slice` is the JAX mesh module's."""
    _, outs = ranks
    for r, out in enumerate(outs):
        assert out["info"] == [r, 2]
        assert out["max"] == np.max([[0, 3, 7], [1, 2, 7]], axis=0).tolist()
        assert out["bcast"] == {"from_rank0": True}
        assert out["objects"] == [{"rank": 0, "s": ""},
                                  {"rank": 1, "s": "x"}]
        want = jlocal_batch_slice(B, r, 2)
        assert out["slice"] == [want.start, want.stop]
    for n, pc in ((10, 3), (7, 2), (4, 4)):
        for pi in range(pc):
            assert distributed.local_batch_slice(n, pi, pc) == \
                jlocal_batch_slice(n, pi, pc)


def test_tensor_collectives(ranks):
    """`all_gather` stacks the ranks' rows in rank order and its backward
    sums the ranks' gradients of a rank's rows (`lax.all_gather`'s
    transpose); `neighbour_exchange` receives rank - 1's tensor and sends
    the gradient back; the means are over ranks."""
    _, outs = ranks
    xs = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
          for r in range(2)]
    w = np.arange(12, dtype=np.float32).reshape(6, 2)
    for r, out in enumerate(outs):
        gathered, grad = out["gather"]
        np.testing.assert_array_equal(gathered, np.concatenate(xs))
        np.testing.assert_array_equal(grad, 2 * w[3 * r:3 * r + 3])
        received, grad = out["exchange"]
        assert received == [2.0 - r] * 2          # from the other rank
        assert grad == [5.0 + (1 - r)] * 2        # the receiver's weight
        assert out["mean"] == [[0.5, 0.5], [1.0, 1.0, 1.0]]
        assert out["pmean"] == 0.5


def _jax_loss(name, inputs):
    """The JAX loss of `name` under `shard_map` over a two-device mesh
    (the rows split as the ranks split them), and its gradients with
    respect to the differentiated inputs."""
    local = name.endswith("_local")
    kind = name.split("_")[0]
    diff = ["img", "txt"] + (["logits"] if kind == "coca" else [])
    fixed = {"coca": ["labels"], "distill": ["t_img", "t_txt"]}.get(kind, [])

    def per_shard(*args):
        kw = dict(zip(diff + fixed, args))
        if kind == "clip":
            return jloss.clip_loss(kw["img"], kw["txt"], SCALE, "data", local)
        if kind == "siglip":
            return jloss.siglip_loss(kw["img"], kw["txt"], SCALE, BIAS,
                                     "data")
        if kind == "coca":
            c, cap = jloss.coca_loss(kw["img"], kw["txt"], kw["logits"],
                                     kw["labels"], SCALE, axis_name="data",
                                     local_loss=local)
            return c + cap
        c, d = jloss.distill_clip_loss(kw["img"], kw["txt"], SCALE,
                                       kw["t_img"], kw["t_txt"], SCALE / 2,
                                       "data", local)
        return c + d

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    sharded = jax.shard_map(per_shard, mesh=mesh, in_specs=P("data"),
                            out_specs=P())
    held = [jnp.asarray(inputs[n]) for n in fixed]

    def total(*args):
        return sharded(*args, *held)

    arrays = [jnp.asarray(inputs[n]) for n in diff]
    loss, grads = jax.jit(jax.value_and_grad(
        total, argnums=tuple(range(len(diff)))))(*arrays)
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax_under_shard_map(ranks, name):
    """Each loss on two ranks: the mean over ranks of the rank's loss is
    JAX's `pmean`'d loss, and each rank's input gradient over the world
    (the optimizer's mean divides it out) is JAX's gradient of its rows,
    to 1e-5."""
    inputs, outs = ranks
    want_loss, want_grads = _jax_loss(name, inputs)
    for out in outs:
        got = out[name]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        for g, w in zip(got["grads"], want_grads):
            # to 1e-5 of the gradient's scale
            np.testing.assert_allclose(np.asarray(g, np.float32), w,
                                       rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


def test_world_one_is_one_rank():
    """Without the launcher's variables no process group starts, and every
    collective is the identity of one rank; each loss is its one-card
    code."""
    info = distributed.init_distributed_device("cpu")
    assert info == {"world_size": 1, "rank": 0, "local_rank": 0,
                    "device": torch.device("cpu")}
    assert distributed.group() is None and distributed.is_master()
    x = torch.randn(3, 2)
    assert distributed.all_gather(x) is x
    assert distributed.neighbour_exchange(x) is x
    assert distributed.pmean(x) is x
    assert distributed.broadcast_object("o") == "o"
    assert distributed.all_gather_object("o") == ["o"]
    np.testing.assert_array_equal(distributed.global_max_int32([3, 1]),
                                  [3, 1])
    before = x.clone()
    distributed.all_reduce_mean_([x])
    assert torch.equal(x, before)
    img, txt = torch.randn(4, 8), torch.randn(4, 8)
    s = torch.tensor(10.0)
    assert torch.equal(tloss.clip_loss(img, txt, s, None, True),
                       tloss.clip_loss(img, txt, s))
    assert torch.equal(tloss.clip_loss(img, txt, s),
                       tloss.symmetric_cross_entropy(s * img @ txt.T))


class _CudaLike:
    is_cuda = True


@pytest.mark.parametrize("backend,native", [
    ("nccl", {"all_reduce", "broadcast", "all_gather", "reduce_scatter",
              "send_recv"}),
    ("gloo", {"all_reduce", "broadcast"})])
def test_host_staging_follows_the_backend(monkeypatch, backend, native):
    """A CUDA tensor goes through the host exactly where the backend has
    no CUDA path for the collective (gloo: all but all-reduce and
    broadcast); a CPU tensor never does."""
    monkeypatch.setattr(distributed.dist, "get_backend", lambda: backend)
    for op in ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
               "send_recv"):
        assert distributed._native(op, _CudaLike()) == (op in native), op
        assert distributed._native(op, torch.zeros(1))


def test_module_imports_no_jax():
    """The module and the trainers that use it load nothing of the JAX
    package (the card machine has no `jax`)."""
    code = ("import sys\n"
            "import leaf_tpu_torch.parallel.distributed\n"
            "import leaf_tpu_torch.train.contrastive_driver\n"
            "import leaf_tpu_torch.train.fare_driver\n"
            "bad = [m for m in sys.modules if m == 'jax'\n"
            "       or m.startswith(('jax.', 'leaf_tpu.'))]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env)
