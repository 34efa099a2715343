"""leaf_tpu_torch's trainers on two ranks (two gloo processes on the CPU)
against the JAX package's two-process runs, in fp32 at ViT-tiny-test.

Three jobs run side by side, each pair of processes joined by hand (the
launcher's variables for the port's ranks, `jax.distributed.initialize`
for the JAX processes, one CPU device each, a free port):

  * the JAX package's two processes (`tests/test_multihost.py`'s worker
    flows, copied): the fused LEAF step over three steps (anchors missed,
    every rank hits, one rank misses), the LEAF driver with `--use_charmer`
    for one epoch and a resume to two, the contrastive driver on tar shards
    (InfoNCE, `--local-loss`, `--siglip`) and with `--accum-freq 2` on the
    synthetic pairs, and the fused step on `--bucket-by-length` shards;
  * the port's two ranks on the same flows, plus a FARE step, the
    feature-cache step on explicit arrays;
  * each trainer at world 1 under the launcher's variables, and without
    them.

Held: losses to rtol 1e-4; parameters under ROADMAP's Adam rule (lr 1e-4,
the attention's key bias to 3 lr) against JAX and bit for bit across ranks;
probe widths, phase-1 branches and batches' word sets identical; the
master-only files, the resume and `--log-local`; a FARE step on two ranks
against the port's one-process step on the global batch and JAX's step on
a two-device mesh from the same start; world 1 under the variables equal,
bit for bit, to the run without them.
"""
import csv
import io
import json
import os
import pickle
import socket
import subprocess
import sys
import tarfile
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

import jax
from jax.sharding import Mesh

from leaf_tpu.models import create_model as jcreate_model
from leaf_tpu.train import contrastive as jcon
from leaf_tpu.train import fare as jfare
from leaf_tpu.train.optim import make_optimizer as jmake_optimizer
from leaf_tpu.train.step import TrainState
from leaf_tpu_torch.convert import params_to_openclip, save_state_dict
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models.factory import get_tokenizer
from leaf_tpu_torch.parallel import sharding
from leaf_tpu_torch.train import fare as tfare
from leaf_tpu_torch.train.params import check_mesh_shape

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "ViT-tiny-test"
LR = 1e-4
EPS = 8 / 255
CAPTIONS = ["a photo of a cat", "a red car on the street",
            "two dogs running in a park", "an old man reading",
            "a bowl of soup", "boats on a river at dusk",
            "a child with a kite", "snow on the mountains"]
LEAF_FLAGS = ["--model", MODEL, "--dataset-type", "synthetic",
              "--train-num-samples", "8", "--batch-size", "4", "--rho", "3",
              "--use_charmer", "--warmup", "1", "--lr", str(LR),
              "--zeroshot-frequency", "0", "--log-every-n-steps", "1"]
CLIP_FLAGS = ["--model", MODEL, "--dataset-type", "webdataset",
              "--train-num-samples", "16", "--batch-size", "4", "--workers",
              "1", "--lr", str(LR), "--warmup", "1", "--log-every-n-steps",
              "1", "--epochs", "1"]
CLIP_VARIANTS = {"infonce": [], "local": ["--local-loss"],
                 "siglip": ["--siglip"]}
ACCUM_FLAGS = ["--model", MODEL, "--dataset-type", "synthetic",
               "--train-num-samples", "16", "--batch-size", "4",
               "--accum-freq", "2", "--lr", str(LR), "--warmup", "1",
               "--epochs", "1"]

# the JAX package's two processes: tests/test_multihost.py's worker flows
JAX_WORKER = textwrap.dedent("""
    import os, sys, json, pickle
    proc_id = int(sys.argv[1]); port = sys.argv[2]; spec = json.load(
        open(sys.argv[3])); job = sys.argv[4]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    jax.distributed.initialize(f"localhost:{port}", 2, proc_id)
    import numpy as np
    import jax.numpy as jnp
    sys.path.insert(0, %(repo)r)
    from jax.sharding import Mesh
    from leaf_tpu.data.wds import WdsConfig, WdsDataset
    from leaf_tpu.models import create_model
    from leaf_tpu.parallel.mesh import replicate
    from leaf_tpu.tokenizer import get_tokenizer
    from leaf_tpu.train.fused import FusedLeafStep
    from leaf_tpu.train.optim import make_optimizer
    from leaf_tpu.train.schedules import cosine_lr
    from leaf_tpu.train.step import TrainState
    import leaf_tpu.train.driver as driver
    import leaf_tpu.train.contrastive_driver as cd

    out = {}
    host = lambda tree: jax.tree.map(
        lambda x: np.asarray(x.addressable_data(0)), tree)
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    model = create_model(%(model)r)
    tok = get_tokenizer()

    def fused_run(batches, seed):
        tx = make_optimizer(cosine_lr(%(lr)r, 1, 100), weight_decay=1e-4)
        params = replicate(model.params["text"], mesh)
        frozen = replicate(jax.tree.map(np.asarray, model.params["text"]),
                           mesh)
        state = TrainState.create(jax.tree.map(jnp.copy, params), tx)
        fused = FusedLeafStep(model.cfg, tx, tok, rho=4, mesh=mesh)
        widths, branches = [], []
        _p1, _p1c = fused.phase1, fused.phase1_cached
        def p1(frozen_t, train_t, clean_t, probes):
            widths.append(int(probes.shape[-1])); branches.append("full")
            return _p1(frozen_t, train_t, clean_t, probes)
        def p1c(train_t, probes, anch):
            widths.append(int(probes.shape[-1])); branches.append("cached")
            return _p1c(train_t, probes, anch)
        fused.phase1, fused.phase1_cached = p1, p1c
        rng = np.random.default_rng(seed + proc_id)
        losses = []
        for texts in batches:
            state, info = fused(state, frozen, texts, rng)
            losses.append(float(info["metrics"]["loss"]))
        return {"losses": losses, "widths": widths, "branches": branches,
                "params": host(state.text_params)}

    ALL = [f"a photo of object number {i} on a table" for i in range(8)]
    local = ALL[proc_id * 4:(proc_id + 1) * 4]
    fresh = [f"an unseen fresh caption number {i}" for i in range(4)]
    if job == "leaf":
        out["fused"] = fused_run([local, local, local if proc_id == 0
                                  else fresh], 7)

    cfg = WdsConfig(urls=spec["bucket_tars"], batch_size=4, is_train=True,
                    num_samples=16, seed=0, text_only=True,
                    bucket_by_length=True,
                    length_fn=lambda t: len(tok.encode(t)) + 2,
                    process_index=proc_id, process_count=2,
                    sample_shuffle_size=8, sample_shuffle_initial=2)
    if job == "leaf":
        batches = [list(texts) for _, texts in WdsDataset(cfg, None)]
        out["bucket"] = dict(fused_run(batches, 11), word_sets=[
            sorted({len(t.split()) for t in b}) for b in batches])
        flags = spec["leaf_flags"] + ["--pretrained", spec["ckpt"], "--logs",
                                      spec["logs"], "--name", "jax",
                                      "--log-local"]
        out1 = driver.main(flags + ["--epochs", "1"])
        out2 = driver.main(flags + ["--epochs", "2", "--resume", "latest"])
        out["driver"] = {"rows1": out1["results"], "rows2": out2["results"],
                         "step": int(out2["state"].step),
                         "params": host(out2["state"].text_params)}
    for name, extra in spec["clip_variants"].items():
        if job != "clip" or name == "local":
            continue
        o = cd.main(spec["clip_flags"] + extra + [
            "--pretrained", spec["ckpt"], "--train-data", spec["pair_tars"],
            "--logs", spec["logs"], "--name", "jax-" + name])
        out["clip-" + name] = {"rows": o["results"],
                               "step": int(o["state"].step),
                               "params": host(o["state"].text_params)}
    if job == "clip":
        o = cd.main(spec["accum_flags"] + ["--pretrained", spec["ckpt"],
                                           "--logs", spec["logs"], "--name",
                                           "jax-accum"])
        out["clip-accum"] = {"rows": o["results"]}
    with open(os.path.join(spec["out"], f"jax_{job}_{proc_id}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
""") % {"repo": REPO, "model": MODEL, "lr": LR}

# the port's ranks on the same flows, and the parts JAX has no process
# run of (FARE, the feature-cache step on explicit arrays)
PORT_WORKER = textwrap.dedent("""
    import copy, json, os, sys
    spec = json.load(open(sys.argv[1]))
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from leaf_tpu_torch.parallel import distributed as D
    from leaf_tpu_torch.data.wds import WdsConfig, WdsDataset
    from leaf_tpu_torch.models import clip as tclip
    from leaf_tpu_torch.models import config as tconfig
    from leaf_tpu_torch.models.factory import get_tokenizer
    from leaf_tpu_torch.train import contrastive as tcon
    from leaf_tpu_torch.train import fare as tfare
    from leaf_tpu_torch.train import fused as tfused
    from leaf_tpu_torch.train import optim as toptim
    from leaf_tpu_torch.train import schedules as tsched
    from leaf_tpu_torch.train import step as tstep
    import leaf_tpu_torch.train.driver as driver
    import leaf_tpu_torch.train.contrastive_driver as cd

    info = D.init_distributed_device("cpu")
    rank = info["rank"]
    out = {"world": info["world_size"]}
    cfg = tconfig.get_model_config(%(model)r)
    full_sd = torch.load(spec["full_sd"])
    tok = get_tokenizer(%(model)r)

    def sd(module):
        return {k: v.detach().clone() for k, v in module.state_dict().items()}

    def fused_run(batches, seed):
        text = tclip.TextTower(cfg.text, cfg.quick_gelu)
        text.load_state_dict({k[5:]: v for k, v in full_sd.items()
                              if k.startswith("text.")})
        frozen = copy.deepcopy(text).requires_grad_(False)
        opt = toptim.make_optimizer(text.named_parameters(),
                                    tsched.cosine_lr(%(lr)r, 1, 100),
                                    weight_decay=1e-4)
        state = tstep.TrainState.create(text, opt)
        fused = tfused.FusedLeafStep(cfg, tok, rho=4, device="cpu")
        widths, branches = [], []
        _p1, _p1c = fused.phase1, fused.phase1_cached
        def p1(frozen_t, train_t, clean_t, probes):
            widths.append(int(probes.shape[-1])); branches.append("full")
            return _p1(frozen_t, train_t, clean_t, probes)
        def p1c(train_t, probes, anch):
            widths.append(int(probes.shape[-1])); branches.append("cached")
            return _p1c(train_t, probes, anch)
        fused.phase1, fused.phase1_cached = p1, p1c
        rng = np.random.default_rng(seed + rank)
        losses = []
        for texts in batches:
            state, i = fused(state, frozen, texts, rng)
            losses.append(float(i["metrics"]["loss"]))
        return {"losses": losses, "widths": widths, "branches": branches,
                "params": sd(text)}

    ALL = [f"a photo of object number {i} on a table" for i in range(8)]
    local = ALL[rank * 4:(rank + 1) * 4]
    fresh = [f"an unseen fresh caption number {i}" for i in range(4)]
    out["fused"] = fused_run([local, local, local if rank == 0 else fresh], 7)

    wcfg = WdsConfig(urls=spec["bucket_tars"], batch_size=4, is_train=True,
                     num_samples=16, seed=0, text_only=True,
                     bucket_by_length=True,
                     length_fn=lambda t: len(tok.encode(t)) + 2,
                     process_index=rank, process_count=2,
                     sample_shuffle_size=8, sample_shuffle_initial=2)
    batches = [list(texts) for _, texts in WdsDataset(wcfg, None)]
    out["bucket"] = dict(fused_run(batches, 11), word_sets=[
        sorted({len(t.split()) for t in b}) for b in batches])

    flags = spec["leaf_flags"] + ["--pretrained", spec["ckpt"], "--logs",
                                  spec["logs"], "--name", "torch",
                                  "--log-local", "--device", "cpu",
                                  "--mesh-shape", "2"]
    out1 = driver.main(flags + ["--epochs", "1"])
    out2 = driver.main(flags + ["--epochs", "2", "--resume", "latest"])
    out["driver"] = {"rows1": out1["results"], "rows2": out2["results"],
                     "step": out2["state"].step,
                     "params": sd(out2["state"].text)}
    for name, extra in spec["clip_variants"].items():
        o = cd.main(spec["clip_flags"] + extra + [
            "--pretrained", spec["ckpt"], "--train-data", spec["pair_tars"],
            "--logs", spec["logs"], "--name", "torch-" + name,
            "--device", "cpu", "--mesh-shape", "2"])
        out["clip-" + name] = {"rows": o["results"], "step": o["state"].step,
                               "params": sd(o["state"].model)}
    o = cd.main(spec["accum_flags"] + ["--pretrained", spec["ckpt"],
                                       "--logs", spec["logs"], "--name",
                                       "torch-accum", "--device", "cpu"])
    out["clip-accum"] = {"rows": o["results"]}

    # the feature-cache step on this rank's columns of the global arrays
    arrays = np.load(spec["accum_arrays"])
    model = tclip.CLIP(cfg)
    model.load_state_dict(full_sd)
    opt = toptim.make_optimizer(model.named_parameters(), lambda s: %(lr)r,
                                weight_decay=0.2)
    state = tcon.ContrastiveState(model, opt)
    step = tcon.make_accum_contrastive_train_step()
    cols = D.local_batch_slice(arrays["images"].shape[1])
    losses = []
    for _ in range(2):
        state, m = step(state, torch.from_numpy(arrays["images"][:, cols]),
                        torch.from_numpy(arrays["tokens"][:, cols]))
        losses.append(float(m["loss"]))
    out["accum_step"] = {"losses": losses, "params": sd(model)}

    # FARE: from JAX's starts, and from the shared generator's draw
    images = np.load(spec["fare_images"])
    rows = D.local_batch_slice(len(images))
    for name, starts in (("fare-jax-starts", np.load(spec["fare_starts"])),
                         ("fare-draw", None)):
        model = tclip.CLIP(cfg)
        model.load_state_dict(full_sd)
        fcfg = tfare.FareConfig(steps=2, warmup=1, lr=%(lr)r, eps=%(eps)r,
                                iterations_adv=2, stepsize_adv=%(eps)r / 2,
                                log_freq=1)
        seen = []
        def batches():
            while True:
                yield images[rows], None
        got = tfare.train_fare(
            model.visual, cfg, fcfg, batches(), seed=5,
            starts=None if starts is None else iter(
                torch.from_numpy(s[rows]) for s in starts),
            on_step=lambda s, m: seen.append((s, m)))
        out[name] = {"metrics": seen, "params": sd(model.visual)}
    torch.save(out, os.path.join(spec["out"], f"torch_{rank}.pt"))
""") % {"repo": REPO, "model": MODEL, "lr": LR, "eps": EPS}

# each trainer at world 1: run under the launcher's variables and without
WORLD1_WORKER = textwrap.dedent("""
    import json, os, sys
    spec = json.load(open(sys.argv[1])); tag = sys.argv[2]
    sys.path.insert(0, %(repo)r)
    import torch
    torch.set_num_threads(1)
    import leaf_tpu_torch.train.driver as driver
    import leaf_tpu_torch.train.contrastive_driver as cd
    import leaf_tpu_torch.train.fare_driver as fd

    def sd(module):
        return {k: v.detach().clone() for k, v in module.state_dict().items()}

    logs = os.path.join(spec["logs"], tag)
    out = {}
    o = driver.main(["--model", %(model)r, "--dataset-type", "synthetic",
                     "--train-num-samples", "8", "--batch-size", "4",
                     "--epochs", "1", "--rho", "4", "--warmup", "1",
                     "--zeroshot-frequency", "0", "--pretrained",
                     spec["ckpt"], "--logs", logs, "--name", "leaf",
                     "--device", "cpu"])
    out["leaf"] = {"rows": o["results"], "params": sd(o["state"].text)}
    o = cd.main(["--model", %(model)r, "--dataset-type", "webdataset",
                 "--train-data", spec["pair_tars"], "--train-num-samples",
                 "8", "--batch-size", "4", "--workers", "1", "--epochs", "1",
                 "--warmup", "1", "--pretrained", spec["ckpt"], "--logs",
                 logs, "--name", "clip", "--device", "cpu"])
    out["contrastive"] = {"rows": o["results"],
                          "params": sd(o["state"].model)}
    o = fd.main(["--model", %(model)r, "--pretrained", spec["ckpt"],
                 "--imagenet-root", spec["fare_folder"], "--steps", "2",
                 "--warmup", "1", "--batch-size", "2", "--iterations-adv",
                 "2", "--precision", "fp32", "--output-dir", logs,
                 "--device", "cpu"])
    out["fare"] = {"loss": o["final_loss"], "params": sd(o["visual"])}
    torch.save(out, os.path.join(spec["out"], f"world1_{tag}.pt"))
""") % {"repo": REPO, "model": MODEL}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def _spawn(argv, env, log):
    """A worker whose output goes to the file `log` (a pipe that nobody
    reads while another worker is waited for could block it, and with it
    the collective its peer waits in)."""
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable] + argv, stdout=f,
                                stderr=subprocess.STDOUT, env=env)
    proc.log = log
    return proc


def _port_ranks(script, args, root, n=2):
    port = str(_free_port())
    return [_spawn([script] + args,
                   _env(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                        MASTER_ADDR="localhost", MASTER_PORT=port),
                   os.path.join(root, f"torch_{r}.log"))
            for r in range(n)]


def _wait(procs, timeout=600):
    for p in procs:
        p.wait(timeout=timeout)
    for p in procs:
        with open(p.log) as f:
            assert p.returncode == 0, f.read()[-4000:]


def _write_pair_shards(root, rng, shards=2, per_shard=8, size=72):
    os.makedirs(root)
    for s in range(shards):
        with tarfile.open(os.path.join(root, f"{s:03d}.tar"), "w") as tf:
            for i in range(per_shard):
                png = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                             dtype=np.uint8)).save(png, "PNG")
                cap = f"{CAPTIONS[i]} number {s * per_shard + i}".encode()
                for ext, payload in (("png", png.getvalue()), ("txt", cap)):
                    info = tarfile.TarInfo(f"s{s}_{i:03d}.{ext}")
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
    return os.path.join(root, "{000..%03d}.tar" % (shards - 1))


def _write_caption_shards(root):
    """tests/test_multihost.py's bucket shards: shard 0 all 2-word
    captions, shard 1 half 2-word, half 30-word."""
    os.makedirs(root)
    for s, lens in {0: [2] * 8, 1: [2, 30] * 4}.items():
        with tarfile.open(os.path.join(root, f"s-{s:03d}.tar"), "w") as tf:
            for i, n_words in enumerate(lens):
                txt = " ".join(["word"] * n_words).encode()
                info = tarfile.TarInfo(f"{s}-{i:04d}.txt")
                info.size = len(txt)
                tf.addfile(info, io.BytesIO(txt))
    return os.path.join(root, "s-{000..001}.tar")


def _fare_config():
    return tfare.FareConfig(steps=2, warmup=1, lr=LR, eps=EPS,
                            iterations_adv=2, stepsize_adv=EPS / 2,
                            log_freq=1)


def _references(jmodel, full_sd, accum, fare_images):
    """The one-process runs the ranks are held to, made while the workers
    run: JAX's feature-cache step on the global arrays, JAX's FARE on a
    two-device mesh, the port's FARE on the global batch."""
    tx = jmake_optimizer(lambda s: LR, weight_decay=0.2)
    state = TrainState.create(jax.tree.map(jax.numpy.copy, jmodel.params),
                              tx)
    step = jcon.make_accum_contrastive_train_step(jmodel.cfg, tx, 2)
    losses = []
    for _ in range(2):
        state, m = step(state, accum["images"], accum["tokens"])
        losses.append(float(m["loss"]))
    refs = {"accum": {"losses": losses, "params": tinterop.params_from_jax(
        jax.tree.map(np.asarray, state.text_params))}}

    def batches():
        while True:
            yield fare_images, None

    cfg = tconfig.get_model_config(MODEL)
    model = tclip.CLIP(cfg)
    model.load_state_dict(full_sd)
    seen = []
    tfare.train_fare(model.visual, cfg, _fare_config(), batches(), seed=5,
                     on_step=lambda s, m: seen.append((s, m)))
    refs["fare-one"] = {"metrics": seen, "params": model.visual.state_dict()}
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    jseen = []
    want = jfare.train_fare(jmodel.params, jmodel.cfg,
                            jfare.FareConfig(**vars(_fare_config())),
                            batches(), seed=5, mesh=mesh,
                            on_step=lambda s, m: jseen.append((s, m)))
    refs["fare-jax"] = {
        "metrics": [(s, {k: float(v) for k, v in m.items()})
                    for s, m in jseen],
        "params": tinterop.params_from_jax({"visual": jax.tree.map(
            np.asarray, want["params"]["visual"])})}
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's outputs: {"jax": [rank 0, rank 1], "torch": [...],
    "world1": {"env": ..., "plain": ...}} and the shared inputs."""
    root = tmp_path_factory.mktemp("multirank")
    jmodel = jcreate_model(MODEL)
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params)))
    ckpt = str(root / "init")
    save_state_dict(params_to_openclip(module.state_dict(), module.cfg),
                    ckpt, "openclip")
    torch.save(module.state_dict(), root / "full_sd.pt")
    get_tokenizer(MODEL)("build the native tokenizer before the workers")

    rng = np.random.default_rng(3)
    fare_images = rng.uniform(0.2, 0.8, (4, 64, 64, 3)).astype(np.float32)
    np.save(root / "fare_images.npy", fare_images)
    key, starts = jax.random.PRNGKey(5), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        starts.append(np.array(
            EPS * (2 * jax.random.uniform(sub, fare_images.shape) - 1)))
    np.save(root / "fare_starts.npy", np.stack(starts))
    tokens = np.asarray(get_tokenizer(MODEL)(CAPTIONS * 2)).reshape(2, 8, -1)
    np.savez(root / "accum.npz",
             images=rng.standard_normal((2, 8, 64, 64, 3)).astype(np.float32),
             tokens=tokens)
    folder = root / "fare_folder"
    for i in range(4):
        d = folder / f"c{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(d / f"{i}.png")
    spec = {"ckpt": ckpt, "full_sd": str(root / "full_sd.pt"),
            "logs": str(root / "logs"), "out": str(root),
            "leaf_flags": LEAF_FLAGS, "clip_flags": CLIP_FLAGS,
            "clip_variants": CLIP_VARIANTS, "accum_flags": ACCUM_FLAGS,
            "pair_tars": _write_pair_shards(str(root / "pairs"), rng),
            "bucket_tars": _write_caption_shards(str(root / "captions")),
            "fare_images": str(root / "fare_images.npy"),
            "fare_starts": str(root / "fare_starts.npy"),
            "accum_arrays": str(root / "accum.npz"),
            "fare_folder": str(folder)}
    (root / "spec.json").write_text(json.dumps(spec))
    scripts = {}
    for name, text in (("jax", JAX_WORKER), ("torch", PORT_WORKER),
                       ("world1", WORLD1_WORKER)):
        scripts[name] = str(root / f"{name}_worker.py")
        with open(scripts[name], "w") as f:
            f.write(text)
    spec_path = str(root / "spec.json")
    # the JAX work in two jobs side by side: the LEAF flows, the
    # contrastive ones
    jax_procs = []
    for job in ("leaf", "clip"):
        jport = str(_free_port())
        jax_procs += [_spawn([scripts["jax"], str(i), jport, spec_path, job],
                             _env(), str(root / f"jax_{job}_{i}.log"))
                      for i in range(2)]
    port_procs = _port_ranks(scripts["torch"], [spec_path], str(root))
    w1_port = str(_free_port())
    world1 = [_spawn([scripts["world1"], spec_path, tag], env,
                     str(root / f"world1_{tag}.log"))
              for tag, env in (
            ("env", _env(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                         MASTER_ADDR="localhost", MASTER_PORT=w1_port)),
            ("plain", _env()))]
    refs = _references(jmodel, module.state_dict(), np.load(root / "accum.npz"),
                       fare_images)
    _wait(port_procs + world1 + jax_procs)
    out = {"root": root, "spec": spec, "refs": refs}
    out["torch"] = [torch.load(root / f"torch_{r}.pt") for r in range(2)]
    out["jax"] = [{}, {}]
    for r in range(2):
        for job in ("leaf", "clip"):
            with open(root / f"jax_{job}_{r}.pkl", "rb") as f:
                out["jax"][r].update(pickle.load(f))
    out["world1"] = {tag: torch.load(root / f"world1_{tag}.pt")
                     for tag in ("env", "plain")}
    return out


def _same_across_ranks(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _params_close(got: dict, want: dict, steps: int, atol: float = 1e-4):
    """Every parameter within `atol`, the attention's key bias within
    3 lr a step (its true gradient is zero: ROADMAP Queue 3)."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        if k.endswith("attn.qkv_b"):
            third = len(w) // 3
            np.testing.assert_allclose(g[third:2 * third], w[third:2 * third],
                                       atol=3 * steps * LR, err_msg=k)
            g, w = np.delete(g, np.s_[third:2 * third]), \
                np.delete(w, np.s_[third:2 * third])
        np.testing.assert_allclose(g, w, atol=atol, err_msg=k)


@pytest.mark.parametrize("part", ["fused", "bucket"])
def test_fused_step_matches_jax_two_processes(runs, part):
    """(c) three fused steps (miss, every rank hits, rank 1 misses) and
    (f) the `--bucket-by-length` shards: the same losses, probe widths,
    phase-1 branches and batches on every rank as JAX's two processes;
    parameters equal across ranks and within Adam's rule of JAX's."""
    t0, t1 = (r[part] for r in runs["torch"])
    j0, j1 = (r[part] for r in runs["jax"])
    assert t0["widths"] == t1["widths"] == j0["widths"] == j1["widths"]
    assert t0["branches"] == t1["branches"] == j0["branches"]
    if part == "fused":
        assert set(t0["widths"]) == {16}
        assert t0["branches"] == ["full", "cached", "full"]
    else:
        assert t0["word_sets"] == j0["word_sets"]
        assert t1["word_sets"] == j1["word_sets"]
        assert all(len(ws) == 1 for ws in t0["word_sets"] + t1["word_sets"])
        assert t0["widths"] == [48 if [30] in (a, b) else 16 for a, b in zip(
            t0["word_sets"], t1["word_sets"])]
    assert t0["losses"] == t1["losses"]
    np.testing.assert_allclose(t0["losses"], j0["losses"], rtol=1e-4)
    _same_across_ranks(t0["params"], t1["params"])
    _params_close(t0["params"], tinterop.params_from_jax(j0["params"]),
                  steps=len(t0["losses"]))


def test_leaf_driver_matches_jax_two_processes(runs):
    """(d) the LEAF driver on two ranks, `--use_charmer`, one epoch then
    `--resume latest` to two: the master's results.csv rows equal JAX's;
    the other rank records none; the step; parameters equal across ranks
    and close to JAX's; `--log-local` logs per rank; the master alone
    wrote the ledgers and checkpoints."""
    t0, t1 = (r["driver"] for r in runs["torch"])
    j0 = runs["jax"][0]["driver"]
    assert t1["rows1"] == t1["rows2"] == []
    assert [int(r["epoch"]) for r in t0["rows2"]] == [0, 1, 2]
    for g, w in zip(t0["rows2"], j0["rows2"]):
        assert int(g["epoch"]) == int(w["epoch"])
        np.testing.assert_allclose(float(g["train_loss"]),
                                   float(w["train_loss"]), rtol=1e-4)
    assert t0["step"] == t1["step"] == j0["step"] == 4
    _same_across_ranks(t0["params"], t1["params"])
    _params_close(t0["params"], tinterop.params_from_jax(j0["params"]), 4)
    run = runs["root"] / "logs" / "torch"
    assert sorted(os.listdir(run)) == [
        "checkpoints", "out_rank0.log", "out_rank1.log", "results.csv",
        "times_True.csv"]
    assert sorted(os.listdir(run / "checkpoints")) == [
        "epoch_0", "epoch_1", "epoch_2", "frozen", "model_epoch_0",
        "model_epoch_1", "model_epoch_2"]
    with open(run / "results.csv", newline="") as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["0", "1", "2"]


@pytest.mark.parametrize("variant", sorted(CLIP_VARIANTS))
def test_contrastive_driver_matches_jax_two_processes(runs, variant):
    """(e) the contrastive driver on two ranks over tar shards (a shard a
    rank): the master's rows equal JAX's, parameters equal across ranks
    and close to JAX's two processes'.  `--local-loss` is held to JAX's
    global InfoNCE run: the JAX package's local loss is the global one, in
    value and gradient (tests/test_loss.py)."""
    t0, t1 = (r["clip-" + variant] for r in runs["torch"])
    j0 = runs["jax"][0]["clip-" + ("infonce" if variant == "local"
                                   else variant)]
    assert t1["rows"] == []
    assert [r["epoch"] for r in t0["rows"]] == [0, 1]
    np.testing.assert_allclose(t0["rows"][1]["train_loss"],
                               j0["rows"][1]["train_loss"], rtol=1e-4)
    assert t0["step"] == t1["step"] == j0["step"] == 2
    _same_across_ranks(t0["params"], t1["params"])
    _params_close(t0["params"], tinterop.params_from_jax(j0["params"]), 2)


def test_feature_cache_step_gathers_the_global_batch(runs):
    """(e) `--accum-freq 2`: on two ranks the feature-cache step computes
    the loss of the global effective batch, as JAX's step does on global
    arrays (one process here, the two ranks' columns together).  The JAX
    package's two-process driver does not: its microbatches go through a
    `device_put` of each process's own array as if it were global, so a
    chunk holds half of each process's rows, and on the synthetic pairs
    it logs ln 8 where the global batch of 2 x 2 x 4 gives ln 16 (ROADMAP
    Queue 3)."""
    want = runs["refs"]["accum"]
    t0, t1 = (r["accum_step"] for r in runs["torch"])
    assert t0["losses"] == t1["losses"]
    np.testing.assert_allclose(t0["losses"], want["losses"], rtol=1e-4)
    _same_across_ranks(t0["params"], t1["params"])
    _params_close(t0["params"], want["params"], 2)
    port = runs["torch"][0]["clip-accum"]["rows"][1]["train_loss"]
    jax_two = runs["jax"][0]["clip-accum"]["rows"][1]["train_loss"]
    np.testing.assert_allclose(port, np.log(16), rtol=1e-5)
    np.testing.assert_allclose(jax_two, np.log(8), rtol=1e-5)


def test_fare_step_on_two_ranks(runs):
    """(g) FARE on two ranks, two steps: from the shared generator's draw,
    equal to the port's one-process run on the global batch; from JAX's
    starts, equal to JAX's FARE on a two-device mesh.  Parameters equal
    across ranks."""
    for name, ref, rtol, atol in (("fare-draw", "fare-one", 1e-5, 1e-5),
                                  ("fare-jax-starts", "fare-jax", 1e-4,
                                   1e-4)):
        want = runs["refs"][ref]
        t0, t1 = (r[name] for r in runs["torch"])
        _same_across_ranks(t0["params"], t1["params"])
        assert [s for s, _ in t0["metrics"]] == [
            s for s, _ in want["metrics"]] == [1, 2]
        for (_, m), (_, mw) in zip(t0["metrics"], want["metrics"]):
            assert sorted(m) == sorted(mw)
            for k in mw:
                np.testing.assert_allclose(m[k], mw[k], rtol=rtol, atol=1e-7,
                                           err_msg=k)
        got = t0["params"]
        if ref == "fare-jax":
            got = {f"visual.{k}": v for k, v in got.items()}
        _params_close(got, want["params"], 2, atol=atol)


@pytest.mark.parametrize("trainer", ["leaf", "contrastive", "fare"])
def test_world_one_under_the_launcher_is_the_plain_run(runs, trainer):
    """(h) each trainer at world 1 under RANK=0 WORLD_SIZE=1 (a gloo
    group of one) equals, bit for bit, the run without the variables."""
    env, plain = (runs["world1"][t][trainer] for t in ("env", "plain"))
    _same_across_ranks(env["params"], plain["params"])
    for k in env:
        if k != "params":
            np.testing.assert_equal(env[k], plain[k], err_msg=k)


@pytest.mark.parametrize("shape,world,ok", [
    (None, 2, True), ("2", 2, True), ("1", 1, True), ("8", 2, False),
    ("2,1", 2, False), ("x", 1, False)])
def test_mesh_shape_is_the_number_of_ranks(shape, world, ok):
    if ok:
        check_mesh_shape(shape, world)
    else:
        with pytest.raises(ValueError, match="mesh-shape"):
            check_mesh_shape(shape, world)


@pytest.mark.parametrize("loader", ["wds", "csv", "imagenet"])
def test_rank_splits_match_jax(loader, tmp_path):
    """(11) each loader the drivers hand the rank and world to splits the
    data across ranks as the JAX package's does: the same shards, rows and
    images a rank, in the same order, over two epochs, for 2 and 3 ranks."""
    from leaf_tpu.data import csv_data as jcsv, imagenet as jimagenet
    from leaf_tpu.data import wds as jwds
    from leaf_tpu_torch.data import csv_data as tcsv, imagenet as timagenet
    from leaf_tpu_torch.data import wds as twds

    rng = np.random.default_rng(5)
    if loader == "wds":
        urls = [str(tmp_path / f"{i:03d}.tar") for i in range(7)]
    else:
        folder = tmp_path / "images"
        rows = []
        for i in range(11):
            d = folder / f"c{i % 3}"
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                            ).save(d / f"{i}.png")
            rows.append(f"{d / f'{i}.png'}\tcaption {i}")
        table = tmp_path / "train.csv"
        table.write_text("filepath\ttitle\n" + "\n".join(rows) + "\n")

    def split(pkg, rank, world):
        if loader == "wds":
            cfg = (jwds if pkg == "jax" else twds).WdsConfig(
                urls=urls, batch_size=2, seed=3, num_samples=14,
                process_index=rank, process_count=world)
            ds = (jwds if pkg == "jax" else twds).WdsDataset(cfg, None)
            return [ds._shards_for_epoch(e) for e in range(2)]
        if loader == "csv":
            ds = (jcsv if pkg == "jax" else tcsv).CsvDataset(
                str(table), lambda img: np.zeros(1), batch_size=2, seed=3,
                shuffle=True, drop_last=True, process_index=rank,
                process_count=world)
            return [[list(t) for _, t in ds] for _ in range(2)]
        ds = (jimagenet if pkg == "jax" else timagenet).ImageFolderDataset(
            str(folder), lambda img: np.zeros(1), batch_size=2,
            subsample_per_class=3, seed=3, shuffle=True, process_index=rank,
            process_count=world)
        return [[np.asarray(y).tolist() for _, y in ds] for _ in range(2)]

    for world in (2, 3):
        seen = []
        for rank in range(world):
            got = split("torch", rank, world)
            assert got == split("jax", rank, world), (world, rank)
            seen.append(got)
        assert len({str(s) for s in seen}) == world     # disjoint ranks


# ---------------------------------------------------------------------------
# The fused LEAF step on a (data 2, model 2) grid of four gloo ranks against
# JAX's FusedLeafStep on a (2, 2) mesh with `shard_params`'d text params:
# two JAX processes of two CPU devices each, a process a row of the mesh,
# as a port data group is a row of the grid
# ---------------------------------------------------------------------------

GRID_LR = 1e-5
GRID_CAPTIONS = [f"a photo of object number {i} on a table" for i in range(8)]
GRID_FRESH = [f"an unseen fresh caption number {i}" for i in range(4)]

JAX_GRID_WORKER = textwrap.dedent("""
    import os, sys, pickle
    proc_id = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    jax.distributed.initialize(f"localhost:{port}", 2, proc_id)
    import numpy as np
    import jax.numpy as jnp
    sys.path.insert(0, %(repo)r)
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh
    from leaf_tpu.models import create_model
    from leaf_tpu.parallel.sharding import shard_params
    from leaf_tpu.tokenizer import get_tokenizer
    from leaf_tpu.train.fused import FusedLeafStep
    from leaf_tpu.train.optim import make_optimizer
    from leaf_tpu.train.schedules import cosine_lr
    from leaf_tpu.train.step import TrainState

    # process p holds row p of the mesh: its data index
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    model = create_model(%(model)r)
    tx = make_optimizer(cosine_lr(%(lr)r, 1, 100), weight_decay=1e-4)
    tp = lambda p: shard_params({"text": p}, mesh, model_axis="model")["text"]
    state = TrainState.create(jax.tree.map(jnp.copy, tp(model.params["text"])),
                              tx)
    frozen = tp(jax.tree.map(np.asarray, model.params["text"]))
    fused = FusedLeafStep(model.cfg, tx, get_tokenizer(), rho=4, mesh=mesh)
    local = %(captions)r[proc_id * 4:(proc_id + 1) * 4]
    rng = np.random.default_rng(7 + proc_id)
    res = {"losses": [], "grad_norms": [], "adv": []}
    for texts in (local, local, local if proc_id == 0 else %(fresh)r):
        state, info = fused(state, frozen, texts, rng)
        res["losses"].append(float(info["metrics"]["loss"]))
        res["grad_norms"].append(float(info["metrics"]["grad_norm"]))
        res["adv"].append(fused.adv_sentences(texts, info))
    res["params"] = jax.tree.map(np.asarray, multihost_utils.process_allgather(
        state.text_params, tiled=True))
    with open(os.path.join(out, f"jax_grid_{proc_id}.pkl"), "wb") as f:
        pickle.dump(res, f)
""") % {"repo": REPO, "model": MODEL, "lr": GRID_LR,
        "captions": GRID_CAPTIONS, "fresh": GRID_FRESH}

PORT_GRID_WORKER = textwrap.dedent("""
    import copy, os, sys
    out = sys.argv[1]
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from leaf_tpu_torch.models import clip as tclip
    from leaf_tpu_torch.models import config as tconfig
    from leaf_tpu_torch.models.factory import get_tokenizer
    from leaf_tpu_torch.parallel import distributed as D
    from leaf_tpu_torch.parallel import sharding
    from leaf_tpu_torch.train import fused as tfused
    from leaf_tpu_torch.train import optim as toptim
    from leaf_tpu_torch.train import schedules as tsched
    from leaf_tpu_torch.train import step as tstep

    D.init_distributed_device("cpu")
    grid = sharding.create_grid((2, 2))
    cfg = tconfig.get_model_config(%(model)r)
    full = torch.load(os.path.join(out, "full_sd.pt"))
    text = tclip.TextTower(cfg.text, cfg.quick_gelu)
    text.load_state_dict({k[5:]: v for k, v in full.items()
                          if k.startswith("text.")})
    frozen = copy.deepcopy(text).requires_grad_(False)
    sharding.shard_module(text, grid)
    sharding.shard_module(frozen, grid)
    opt = toptim.make_optimizer(text.named_parameters(),
                                tsched.cosine_lr(%(lr)r, 1, 100),
                                weight_decay=1e-4, grid=grid)
    state = tstep.TrainState.create(text, opt)
    fused = tfused.FusedLeafStep(cfg, get_tokenizer(%(model)r), rho=4,
                                 device="cpu", grid=grid)
    d = grid.data_index
    local = %(captions)r[d * 4:(d + 1) * 4]
    rng = np.random.default_rng(7 + d)     # one stream a model group
    res = {"grid": [grid.data, grid.model, d, grid.model_index],
           "losses": [], "grad_norms": [], "adv": [],
           "shards": {n: list(p.shape) for n, p in text.named_parameters()}}
    for texts in (local, local, local if d == 0 else %(fresh)r):
        state, info = fused(state, frozen, texts, rng)
        res["losses"].append(float(info["metrics"]["loss"]))
        res["grad_norms"].append(float(info["metrics"]["grad_norm"]))
        res["adv"].append(fused.adv_sentences(texts, info))
    res["params"] = {k: v.clone() for k, v in text.state_dict().items()}
    torch.save(res, os.path.join(out, f"torch_grid_{D.rank()}.pt"))
""") % {"repo": REPO, "model": MODEL, "lr": GRID_LR,
        "captions": GRID_CAPTIONS, "fresh": GRID_FRESH}


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """{"jax": [process 0, process 1], "torch": [rank 0 .. 3]}."""
    root = tmp_path_factory.mktemp("grid")
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, jcreate_model(MODEL).params)))
    torch.save(module.state_dict(), root / "full_sd.pt")
    get_tokenizer(MODEL)("build the native tokenizer before the workers")
    scripts = {}
    for name, text in (("jax", JAX_GRID_WORKER), ("torch", PORT_GRID_WORKER)):
        scripts[name] = str(root / f"{name}_grid_worker.py")
        with open(scripts[name], "w") as f:
            f.write(text)
    jport = str(_free_port())
    procs = [_spawn([scripts["jax"], str(i), jport, str(root)], _env(),
                    str(root / f"jax_grid_{i}.log")) for i in range(2)]
    procs += _port_ranks(scripts["torch"], [str(root)], str(root), n=4)
    _wait(procs)
    out = {"torch": [torch.load(root / f"torch_grid_{r}.pt")
                     for r in range(4)], "jax": []}
    for i in range(2):
        with open(root / f"jax_grid_{i}.pkl", "rb") as f:
            out["jax"].append(pickle.load(f))
    return out


@pytest.mark.parametrize("rank", range(4))
def test_fused_step_on_a_grid_matches_the_jax_mesh(grid_runs, rank):
    """Rank r at (data r // 2, model r % 2) holds its shards, and its three
    steps (anchors missed, every rank hits, data row 1 misses) log JAX's
    losses and gradient norms to 1e-5 and pick JAX's sentences for its data
    row; its whole parameters (gathered by `state_dict`) are JAX's within
    1e-5 of their largest value, the key bias within 3 lr a step (ROADMAP
    Queue 3), and the model group's other rank's bit for bit."""
    got = grid_runs["torch"][rank]
    d, m = divmod(rank, 2)
    want = grid_runs["jax"][d]
    assert got["grid"] == [2, 2, d, m]
    whole = {k: tuple(v.shape) for k, v in got["params"].items()}
    for name, shape in got["shards"].items():
        dim = sharding.param_split(name, len(shape))
        full = list(whole[name])
        if dim is not None:
            full[dim] //= 2
        assert list(shape) == full, name
    assert got["adv"] == want["adv"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-5)
    ref = tinterop.params_from_jax(want["params"])
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    steps = len(got["losses"])
    assert sorted(got["params"]) == sorted(ref)
    for k, w in ref.items():
        g, w = got["params"][k].numpy().copy(), np.asarray(w).copy()
        if k.endswith("attn.qkv_b"):
            kb = np.s_[len(w) // 3:2 * len(w) // 3]
            np.testing.assert_allclose(g[kb], w[kb], atol=3 * steps * GRID_LR,
                                       err_msg=k)
            g[kb] = w[kb] = 0
        np.testing.assert_allclose(g, w, atol=1e-5 * scale, rtol=0,
                                   err_msg=k)
    _same_across_ranks(got["params"], grid_runs["torch"][rank ^ 1]["params"])


# ---------------------------------------------------------------------------
# chip_smoke (v)'s tiny two-rank fused steps, repeated: the ranks' parameters
# equal bit for bit.  The CPU for-loop AdamW took its square root from MKL's
# vector math, whose first call in a process, split over the intra-op
# threads, could leave one thread's share of the token embedding's update at
# ~12 correct bits on one rank; the port's CPU update runs AdamW's fused
# kernel (`optim.adamw_kwargs`).  The workers keep 4 intra-op threads, so
# that the embedding's update is split as it is there.
# ---------------------------------------------------------------------------

REPEAT_WORKER = textwrap.dedent("""
    import copy, hashlib, json, os, sys
    out = sys.argv[1]
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.parallel import distributed as D
    from leaf_tpu_torch.train.fused import FusedLeafStep
    from leaf_tpu_torch.train.optim import make_optimizer
    from leaf_tpu_torch.train.schedules import cosine_lr
    from leaf_tpu_torch.train.step import TrainState

    D.init_distributed_device("cpu")
    rank = D.rank()
    captions = %(captions)r
    local = captions[4 * rank:4 * rank + 4]
    tok = get_tokenizer(%(model)r)
    sqrt_calls = [0]
    plain_sqrt = torch.Tensor.sqrt

    def counted(self, *a, **kw):
        sqrt_calls[0] += 1
        return plain_sqrt(self, *a, **kw)

    res = {"threads": torch.get_num_threads(), "digests": [], "fused": []}
    for rep in range(2):
        model = create_model(%(model)r, precision="fp32", seed=0,
                             device="cpu", master_weights=True)
        text = copy.deepcopy(model.module.text).requires_grad_(True)
        frozen = copy.deepcopy(text).requires_grad_(False)
        opt = make_optimizer(text.named_parameters(),
                             cosine_lr(%(lr)r, 1, 100), weight_decay=1e-4)
        res["fused"].append(bool(opt.adamw.defaults.get("fused")))
        state = TrainState.create(text, opt)
        fused = FusedLeafStep(model.cfg, tok, rho=4, device="cpu")
        rng = np.random.default_rng(7 + rank)
        torch.Tensor.sqrt = counted
        try:
            for texts in (local, local, local if rank == 0 else %(fresh)r):
                state, _ = fused(state, frozen, texts, rng)
        finally:
            torch.Tensor.sqrt = plain_sqrt
        h = hashlib.sha256()
        for k, v in sorted(text.state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().numpy().tobytes())
        res["digests"].append(h.hexdigest())
    res["sqrt_calls"] = sqrt_calls[0]
    json.dump(res, open(os.path.join(out, f"repeat_{rank}.json"), "w"))
""") % {"repo": REPO, "model": MODEL, "lr": LR,
        "captions": GRID_CAPTIONS, "fresh": GRID_FRESH}


def test_tiny_fused_steps_keep_the_ranks_equal(tmp_path):
    """Two pairs of gloo ranks side by side, each process twice (v)'s
    tiny fused steps (anchors missed, every rank hits, rank 1 misses) from
    a fresh tower and optimizer: every rank ends with the same parameters,
    bit for bit, every time; the CPU update runs AdamW's fused kernel and
    calls no `Tensor.sqrt`."""
    (tmp_path / "worker.py").write_text(REPEAT_WORKER)
    get_tokenizer(MODEL)("build the native tokenizer before the workers")
    pairs = []
    for pair in range(2):
        root = tmp_path / f"pair{pair}"
        root.mkdir()
        port = str(_free_port())
        pairs.append((root, [
            _spawn([str(tmp_path / "worker.py"), str(root)],
                   dict(_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                             MASTER_ADDR="localhost", MASTER_PORT=port),
                        OMP_NUM_THREADS="4"),
                   str(root / f"rank{r}.log")) for r in range(2)]))
    _wait([p for _, procs in pairs for p in procs], timeout=300)
    for root, _ in pairs:
        a, b = (json.loads((root / f"repeat_{r}.json").read_text())
                for r in range(2))
        assert a["threads"] == b["threads"] == 4
        assert a["fused"] == b["fused"] == [True] * 2
        assert a["sqrt_calls"] == b["sqrt_calls"] == 0
        assert a["digests"] == b["digests"]
        assert len(set(a["digests"])) == 1       # every repeat the same
