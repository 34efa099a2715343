"""leaf_tpu_torch's trainer (schedules, optimizer, train step, loop and
driver) against the JAX package's, in fp32 on the CPU.

The same JAX-initialised text tower goes through both train steps (the
port's copy by way of `interop.params_from_jax`), with tokens made with
numpy from a seed; the updated JAX parameters come back through
`params_from_jax` to be compared.
"""
import copy
import csv
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.train import optim as joptim
from leaf_tpu.train import schedules as jschedules
from leaf_tpu.train import step as jstep
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models.factory import create_model
from leaf_tpu_torch.train import driver as tdriver
from leaf_tpu_torch.train import optim as toptim
from leaf_tpu_torch.train import params as tparams
from leaf_tpu_torch.train import schedules as tschedules
from leaf_tpu_torch.train import step as tstep

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
TINY_RUN = ["--model", MODEL, "--dataset-type", "synthetic",
            "--train-num-samples", "16", "--batch-size", "4", "--epochs", "1",
            "--rho", "6", "--warmup", "2", "--lr", "1e-4",
            "--zeroshot-frequency", "0", "--log-every-n-steps", "1",
            "--device", "cpu"]


def _pair(seed: int = 0):
    """(JAX config, JAX text params, the port's text tower), same weights."""
    jcfg = jconfig.get_model_config(MODEL)
    params = jclip.init_clip(jax.random.PRNGKey(seed), jcfg)
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jcfg, params["text"], module.text


def _tokens(rng, B, S):
    toks = np.zeros((B, S), np.int32)
    for row in toks:
        e = int(rng.integers(2, S))
        row[0] = 49406
        row[1:e] = rng.integers(1, 49400, size=e - 1)
        row[e] = 49407
    return toks


# ---------------------------------------------------------------------------
# schedules and the decay mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("const", {}), ("cosine", {}),
    ("const-cooldown", dict(cooldown_steps=12, cooldown_power=2.0,
                            cooldown_end_lr=1e-5)),
    ("const-cooldown", dict(cooldown_steps=0)),
])
@pytest.mark.parametrize("warmup", [0, 1, 7])
def test_schedules_match_jax_at_every_step(name, kwargs, warmup):
    want = jschedules.make_scheduler(name, 3e-4, warmup, 40, **kwargs)
    got = tschedules.make_scheduler(name, 3e-4, warmup, 40, **kwargs)
    for step in range(45):
        assert isinstance(got(step), float)
        # the JAX schedule computes in float32, this one in float64
        # (absolute term: fp32 rounding of the 3e-4 peak, for the steps
        # where the cosine is near zero)
        np.testing.assert_allclose(got(step), float(want(step)), rtol=5e-6,
                                   atol=3e-10)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        tschedules.make_scheduler("linear", 1e-3, 0, 10)


def test_decay_groups_match_jax_mask():
    """Every parameter of the whole model lands in the group that
    `weight_decay_mask` gives its JAX path."""
    jcfg = jconfig.get_model_config(MODEL)
    params = jax.tree.map(np.asarray,
                          jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    mask = joptim.weight_decay_mask(params)
    # both trees through the same path -> name mapping
    names = tinterop.params_from_jax(params)
    decays = tinterop.params_from_jax(jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params))
    assert set(names) == set(decays)
    seen = {True: 0, False: 0}
    for name in names:
        want = bool(decays[name].flatten()[0])
        assert toptim.is_decay_param(name) == want, name
        seen[want] += 1
    assert seen[True] and seen[False]

    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    opt = toptim.make_optimizer(module.text.named_parameters(),
                                lambda step: 1e-3, weight_decay=0.3)
    decay, no_decay = opt.adamw.param_groups
    assert decay["weight_decay"] == 0.3 and no_decay["weight_decay"] == 0.0
    by_id = {id(p): n for n, p in module.text.named_parameters()}
    assert all(toptim.is_decay_param(by_id[id(p)]) for p in decay["params"])
    assert not any(toptim.is_decay_param(by_id[id(p)])
                   for p in no_decay["params"])
    assert len(decay["params"]) + len(no_decay["params"]) == len(by_id)


# ---------------------------------------------------------------------------
# the optimizer and the train step against optax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [None, 0.5, 1e3], ids=["noclip", "clip",
                                                        "clip-inactive"])
def test_adamw_updates_match_the_optax_chain(clip):
    """Five updates from the same gradients (unit scale, far above Adam's
    eps): moments, bias correction, masked decoupled decay, schedule and
    clip agree with optax to fp32 rounding."""
    rng = np.random.default_rng(0)
    shapes = {"token_embedding": (7, 4), "ln_final.scale": (4,),
              "blocks.0.attn.qkv_w": (4, 12), "blocks.0.attn.qkv_b": (12,),
              "blocks.0.mlp.fc_w": (4, 8), "text_projection": (4, 3)}
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(5)]
    kw = dict(weight_decay=0.2, beta1=0.9, beta2=0.98, eps=1e-6,
              grad_clip_norm=clip)

    def nest(flat):       # dotted names -> the nested dicts optax's mask reads
        tree = {}
        for name, v in flat.items():
            node = tree
            *parents, leaf = name.split(".")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = jnp.asarray(v)
        return tree

    jsched = jschedules.cosine_lr(1e-2, 2, 8)
    tx = joptim.make_optimizer(lambda s: jnp.asarray(jsched(s)), **kw)
    jparams = nest(init)
    jopt = tx.init(jparams)
    tparams_ = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for n, v in init.items()}
    opt = toptim.make_optimizer(tparams_.items(),
                                tschedules.cosine_lr(1e-2, 2, 8), **kw)
    for step, g in enumerate(grads):
        updates, jopt = tx.update(nest(g), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in tparams_.items():
            p.grad = torch.from_numpy(g[n].copy())
        norm = opt.update(step)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(nest(g))), rtol=1e-6)
    for name, p in tparams_.items():
        jnode = jparams
        for key in name.split("."):
            jnode = jnode[key]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jnode),
                                   atol=2e-6, rtol=1e-5, err_msg=name)


# Adam divides by |g| + 1e-6, so an element whose gradient is near 1e-6 and
# carries the ~1e-8 rounding noise of a sum with cancellation moves by up
# to lr * 1e-2 differently in the two frameworks: at this rate that stays
# inside the 1e-5 the towers are held to.
LR = 1e-4


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "clip"])
def test_three_train_steps_match_jax(clip, remat):
    jcfg, jtext, ttext = _pair()
    rng = np.random.default_rng(0)
    B, S, steps = 8, 16, 3
    batches = [_tokens(rng, B, S) for _ in range(steps)]
    clean = [_tokens(rng, B, S) for _ in range(steps)]
    kw = dict(weight_decay=0.1, beta1=0.9, beta2=0.98, eps=1e-6,
              grad_clip_norm=clip)

    jsched = jschedules.cosine_lr(LR, 2, 10)
    tx = joptim.make_optimizer(lambda s: jnp.asarray(jsched(s)), **kw)
    jstate = jstep.TrainState.create(jax.tree.map(jnp.copy, jtext), tx)
    jtrain = jstep.make_train_step(jcfg, tx, remat=remat, donate=False,
                                   w_fare_text=0.5)
    janchor = jstep.make_anchor_encode(jcfg)

    opt = toptim.make_optimizer(ttext.named_parameters(),
                                tschedules.cosine_lr(LR, 2, 10), **kw)
    tstate = tstep.TrainState.create(ttext, opt)
    ttrain = tstep.make_train_step(remat=remat, w_fare_text=0.5)
    tanchor = tstep.make_anchor_encode()
    frozen = copy.deepcopy(ttext).requires_grad_(False)

    for adv, cl in zip(batches, clean):
        ja = janchor(jtext, jnp.asarray(cl))
        ta = tanchor(frozen, torch.from_numpy(cl))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5,
                                   rtol=1e-4)
        jstate, jm = jtrain(jstate, jnp.asarray(adv), ja)
        tstate, tm = ttrain(tstate, torch.from_numpy(adv), ta)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert tstate.step == steps == int(jstate.step)
    if clip:
        assert float(tm["grad_norm"]) > clip     # the clip was active
    want = tinterop.params_from_jax(
        jax.tree.map(np.asarray, jstate.text_params))
    got = ttext.state_dict()
    assert set(want) == set(got)
    moved = 0.0
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if name.endswith("attn.qkv_b"):
            # softmax does not see a shift of all logits of a row, so the
            # key bias has an exactly zero gradient; what each framework
            # computes there is rounding noise of ~1e-8, which Adam's
            # g / (|g| + eps) turns into updates of up to lr per step.
            # It is held to that bound, the q and v biases to 1e-5.
            third = len(w) // 3
            np.testing.assert_allclose(g[third:2 * third], w[third:2 * third],
                                       atol=steps * LR, rtol=0, err_msg=name)
            g, w = np.delete(g, np.s_[third:2 * third]), \
                np.delete(w, np.s_[third:2 * third])
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
        moved = max(moved, float((got[name] - frozen.state_dict()[name])
                                 .abs().max()))
    assert moved > 2 * LR   # the comparison is not of two untouched towers
    assert all(p.grad is None for p in ttext.parameters())


def test_textfare_loss_matches_jax():
    jcfg, jtext, ttext = _pair(3)
    rng = np.random.default_rng(1)
    tokens = _tokens(rng, 8, 16)
    anchors = rng.standard_normal((8, jcfg.embed_dim)).astype(np.float32)
    for normalize in (False, True):
        want = jstep.textfare_loss(jtext, jcfg, jnp.asarray(tokens),
                                   jnp.asarray(anchors), normalize,
                                   w_fare_text=2.0)
        got = tstep.textfare_loss(ttext, torch.from_numpy(tokens),
                                  torch.from_numpy(anchors), normalize,
                                  w_fare_text=2.0)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


def test_accum_freq_is_not_ported():
    """(The name dates from when accumulation raised.)  `accum_freq` is
    ported: 2 builds an optimizer that accumulates, and a count below 1
    is refused."""
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    opt = toptim.make_optimizer(module.text.named_parameters(),
                                lambda s: 1e-3, accum_freq=2)
    assert opt.accum_freq == 2 and opt.accumulated is None
    with pytest.raises(ValueError, match="accum_freq"):
        toptim.make_optimizer(module.text.named_parameters(),
                              lambda s: 1e-3, accum_freq=0)


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("k", [2, 3])
def test_accum_freq_matches_optax_multisteps(k, clip):
    """2k calls against `optax.MultiSteps(tx, every_k_schedule=k)`: the
    parameters stay unchanged on all calls but every k-th, which applies
    the chain to the mean gradient at the schedule's applied-update
    count; the accumulated mean survives a state_dict round trip."""
    rng = np.random.default_rng(0)
    shapes = {"token_embedding": (7, 4), "ln_final.scale": (4,),
              "blocks.0.attn.qkv_w": (4, 12), "blocks.0.attn.qkv_b": (12,)}
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(2 * k)]
    kw = dict(weight_decay=0.2, beta1=0.9, beta2=0.98, eps=1e-6,
              grad_clip_norm=clip, accum_freq=k)

    def nest(flat):
        tree = {}
        for name, v in flat.items():
            node = tree
            *parents, leaf = name.split(".")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = jnp.asarray(v)
        return tree

    def leaf(tree, name):
        for key in name.split("."):
            tree = tree[key]
        return np.asarray(tree)

    jsched = jschedules.cosine_lr(1e-2, 1, 8)
    tx = joptim.make_optimizer(lambda s: jnp.asarray(jsched(s)), **kw)
    assert isinstance(tx, optax.MultiSteps) or hasattr(tx, "update")
    jparams = nest(init)
    jopt = tx.init(jparams)
    tparams_ = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for n, v in init.items()}
    opt = toptim.make_optimizer(tparams_.items(),
                                tschedules.cosine_lr(1e-2, 1, 8), **kw)
    for step, g in enumerate(grads):
        before = {n: p.detach().clone() for n, p in tparams_.items()}
        updates, jopt = tx.update(nest(g), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in tparams_.items():
            p.grad = torch.from_numpy(g[n].copy())
        norm = opt.update(step)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(nest(g))), rtol=1e-6)
        applied = (step + 1) % k == 0
        for n, p in tparams_.items():
            assert torch.equal(p.detach(), before[n]) != applied, (step, n)
            np.testing.assert_allclose(p.detach().numpy(), leaf(jparams, n),
                                       atol=2e-6, rtol=1e-5, err_msg=n)
            assert p.grad is None
        assert (opt.accumulated is None) == applied
        if not applied:
            names = {id(p): n for n, p in tparams_.items()}
            for a, p in zip(opt.accumulated, opt.parameters()):
                n = names[id(p)]
                np.testing.assert_allclose(
                    a.numpy(), leaf(jopt.acc_grads, n), atol=1e-6, err_msg=n)
            # a save and a load in the middle of an accumulation
            saved = copy.deepcopy(opt.state_dict())
            opt.accumulated = None
            opt.load_state_dict(saved)
            assert opt.accumulated is not None
    assert int(jopt.gradient_step) == 2


def test_clamp_logit_scale():
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    with torch.no_grad():
        module.logit_scale.fill_(9.0)
    tstep.clamp_logit_scale(module)
    np.testing.assert_allclose(float(module.logit_scale.detach()), np.log(100.0),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# fp32 master weights under bf16 compute
# ---------------------------------------------------------------------------

def test_fp32_master_weights_survive_a_bf16_step():
    model = create_model(MODEL, precision="bf16", seed=0, device="cpu",
                         master_weights=True)
    text = model.module.text
    assert text.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in text.parameters())
    # the vision tower stays fp32: the in-training eval runs it in fp32
    assert model.module.visual.proj.dtype == torch.float32
    before = {n: p.detach().clone() for n, p in text.named_parameters()}
    tokens = torch.from_numpy(_tokens(np.random.default_rng(2), 8, 16))
    with torch.no_grad():
        feats = text.encode_text(tokens)
    assert feats.dtype == torch.bfloat16
    opt = toptim.make_optimizer(text.named_parameters(), lambda s: 1e-5,
                                weight_decay=1e-4)
    state = tstep.TrainState.create(text, opt)
    step = tstep.make_train_step()
    state, metrics = step(state, tokens, torch.zeros(8, feats.shape[-1]))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    w0, w1 = before["blocks.0.attn.qkv_w"], text.blocks[0].attn["qkv_w"]
    assert w1.dtype == torch.float32
    delta = (w1.detach() - w0).abs()
    # an AdamW step at lr 1e-5 moves weights by about 1e-5: kept in fp32,
    # lost had the weights been stored in bf16 (spacing ~5e-4 at 0.1)
    assert 0 < float(delta.max()) < 1e-4
    assert float((delta > 0).float().mean()) > 0.9
    same_in_bf16 = (w1.detach().bfloat16() == w0.bfloat16()).float().mean()
    assert float(same_in_bf16) > 0.9
    # the serving factory still rounds the stored weights once
    served = create_model(MODEL, precision="bf16", seed=0, device="cpu")
    assert served.module.text.blocks[0].attn["qkv_w"].dtype == torch.bfloat16
    assert served.module.text.compute_dtype is None
    with torch.no_grad():
        np.testing.assert_array_equal(
            served.module.text.encode_text(tokens).float().numpy(),
            create_model(MODEL, precision="bf16", seed=0, device="cpu",
                         master_weights=True).module.text
            .encode_text(tokens).float().numpy())


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    logs = tmp_path_factory.mktemp("logs")
    out = tdriver.main(TINY_RUN + ["--logs", str(logs), "--name", "run1"])
    return out, os.path.join(str(logs), "run1")


def test_driver_writes_its_ledgers(tiny_run):
    out, run_dir = tiny_run
    assert out["out_dir"] == run_dir
    with open(os.path.join(run_dir, "results.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == tdriver.RESULT_COLUMNS
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert float(rows[0]["train_loss"]) == -1.0
    loss = float(rows[1]["train_loss"])
    assert np.isfinite(loss) and loss > 0
    with open(os.path.join(run_dir, "times_False.csv")) as f:
        times = f.read().split()
    assert times[0] == "0" and len(times) == 1 + 4      # header + 4 steps
    assert all(float(t) > 0 for t in times[1:])
    assert out["state"].step == 4
    assert os.path.exists(os.path.join(run_dir, "out.log"))
    with open(os.path.join(run_dir, "out.log")) as f:
        log = f.read()
    assert log.count("Train Epoch: 0 [") == 4 and "Attack (t):" in log


def test_frozen_anchor_stays_fixed(tiny_run):
    """Training changes only the trainable text tower; the frozen anchor
    copy still holds the initial weights, bit for bit."""
    out, _ = tiny_run
    fresh = create_model(MODEL, seed=0, device="cpu").module.text.state_dict()
    frozen = out["frozen_text"].state_dict()
    trained = out["state"].text.state_dict()
    assert out["state"].text is out["model"].module.text
    assert set(fresh) == set(frozen) == set(trained)
    assert all(torch.equal(frozen[n], fresh[n]) for n in fresh)
    assert not any(p.requires_grad for p in out["frozen_text"].parameters())
    assert max(float((trained[n] - fresh[n]).abs().max()) for n in fresh) > 1e-6


@pytest.mark.parametrize("flags,match", [
    (["--val-data", "x.tar"], "val-data"),
    (["--use_charmer", "--val-data", "x.tar"], "val-data"),
    (["--force-patch-dropout", "0.5"], "force-"),
    (["--copy-codebase"], "copy-codebase"),
    (["--matmul-precision", "highest"], "matmul-precision"),
    (["--image-mean", "0.5", "0.5", "0.5"], "image-"),
    (["--force-image-size", "32"], "force-"),
    (["--image-interpolation", "bilinear"], "image-"),
    (["--image-resize-mode", "longest"], "image-"),
    (["--remote-sync", "/tmp/mirror"], "remote-sync"),
    (["--report-to", "tensorboard"], "report-to"),
    (["--mesh-shape", "2"], "mesh-shape"),
    (["--pretrained", "openai"], "pretrained"),
    (["--profile-dir", "/tmp/trace"], "profile-dir"),
    (["--force-quick-gelu"], "force-"),
])
def test_unported_flags_raise(flags, match, tmp_path):
    # later flags override the tiny run's own
    if match in ("copy-codebase", "matmul-precision", "remote-sync",
                 "report-to", "profile-dir"):
        # ported since these cases were written: the flag is taken and does
        # what the JAX driver does (paths moved under tmp_path)
        flags = [str(tmp_path / "aux" / os.path.basename(f))
                 if f.startswith("/tmp/") else f for f in flags]
        saved = torch.get_float32_matmul_precision()
        try:
            out = tdriver.main(TINY_RUN + ["--logs", str(tmp_path), "--name",
                                           "run"] + flags)
        finally:
            torch.set_float32_matmul_precision(saved)
        run = tmp_path / "run"
        assert [r["epoch"] for r in out["results"]] == [0, 1]
        if match == "copy-codebase":
            assert (run / "code" / "leaf_tpu_torch" / "serve.py").exists()
        elif match == "remote-sync":
            mirror = tmp_path / "aux" / "mirror" / "run"
            assert (mirror / "results.csv").read_text() == \
                (run / "results.csv").read_text()
            assert (mirror / "checkpoints" / "epoch_1" / "state.pt").exists()
        elif match == "report-to":
            if importlib.util.find_spec("tensorboard") is not None:
                assert list(run.glob("events.out.tfevents.*"))
        elif match == "profile-dir":
            # 4 batches: the window of batches 2 to 5 ends with the epoch
            assert os.listdir(tmp_path / "aux" / "trace") == [
                "trace_epoch0_batches2-3.json"]
        return
    if match == "val-data":
        # ported since these cases were written: the flag is taken, and the
        # val eval over a shard that is not there (skipped with a warning,
        # as in the JAX package) gives no metric
        out = tdriver.main(TINY_RUN + ["--logs", str(tmp_path)] + flags)
        assert [r["epoch"] for r in out["results"]] == [0, 1]
        return
    with pytest.raises(NotImplementedError, match=match) as info:
        tdriver.main(TINY_RUN + ["--logs", str(tmp_path)] + flags)
    assert "ROADMAP" in str(info.value)
    assert not os.listdir(tmp_path)      # refused before anything is written


@pytest.mark.parametrize("flags,match", [
    (["--siglip"], "contrastive"),
    (["--aug-cfg", "scale=(0.4,1.0)"], "aug-cfg"),
    (["--no-lock-image"], "locks the vision tower"),
])
def test_driver_keeps_the_hard_errors(flags, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        tdriver.main(TINY_RUN + ["--logs", str(tmp_path)] + flags)


def test_params_default_device_and_hparams():
    ns = tparams.parse_args(["--model", MODEL])
    assert ns.device == "cuda"
    assert (ns.lr, ns.beta1, ns.beta2, ns.eps) == (5e-4, 0.9, 0.98, 1e-6)
    from leaf_tpu.train import params as jparams
    jns = jparams.parse_args(["--model", MODEL])
    ours = vars(ns)
    assert ours.pop("device") == "cuda"
    assert ours == vars(jns)


def test_cuda_is_refused_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdriver.main([a for a in TINY_RUN if a not in ("--device", "cpu")]
                     + ["--logs", str(tmp_path)])


def test_trainer_imports_no_jax():
    """Importing the trainer loads nothing of the JAX package and none of
    the libraries the card machine lacks."""
    code = (
        "import sys\n"
        "import leaf_tpu_torch.train.driver, leaf_tpu_torch.train.loop\n"
        "import leaf_tpu_torch.attacks.text, leaf_tpu_torch.attacks.edits\n"
        "import leaf_tpu_torch.ops.flash_attention\n"
        "import leaf_tpu_torch.data.synthetic, leaf_tpu_torch.utils.results\n"
        "import leaf_tpu_torch.train.fused, leaf_tpu_torch.train.checkpoint\n"
        "import leaf_tpu_torch.convert, leaf_tpu_torch.attacks.constraint\n"
        "import leaf_tpu_torch.tokenizer.native_binding\n"
        "import leaf_tpu_torch.utils.safetensors_io\n"
        "import leaf_tpu_torch.data.wds, leaf_tpu_torch.data.imagenet\n"
        "import leaf_tpu_torch.data.csv_data, leaf_tpu_torch.data.textcls\n"
        "import leaf_tpu_torch.evals.zero_shot, leaf_tpu_torch.evals.textfare\n"
        "import leaf_tpu_torch.attacks.image, leaf_tpu_torch.models.zero_shot\n"
        "import leaf_tpu_torch.benchmark.zeroshot_classification\n"
        "import leaf_tpu_torch.benchmark.zeroshot_retrieval\n"
        "import leaf_tpu_torch.benchmark.image_caption_selection\n"
        "import leaf_tpu_torch.benchmark.linear_probe\n"
        "import leaf_tpu_torch.benchmark.builder\n"
        "import leaf_tpu_torch.benchmark.tv_datasets\n"
        "import leaf_tpu_torch.benchmark.model_collection\n"
        "import leaf_tpu_torch.benchmark.voc2007\n"
        "import leaf_tpu_torch.benchmark.tfds_datasets\n"
        "import leaf_tpu_torch.benchmark.captioning\n"
        "import leaf_tpu_torch.benchmark.cli\n"
        "import leaf_tpu_torch.evals.pez, leaf_tpu_torch.evals.pez_driver\n"
        "import leaf_tpu_torch.evals.pez_metrics\n"
        "import leaf_tpu_torch.evals.clipscore, leaf_tpu_torch.evals.fid\n"
        "import leaf_tpu_torch.evals.text_to_image\n"
        "import leaf_tpu_torch.push_to_hf_hub, leaf_tpu_torch.serve\n"
        "import leaf_tpu_torch.models.export, leaf_tpu_torch.models.quantize\n"
        "import leaf_tpu_torch.utils.file_utils, leaf_tpu_torch.utils.trackers\n"
        "import leaf_tpu_torch.utils.profiler\n"
        "import leaf_tpu_torch.train.contrastive_driver\n"
        "import leaf_tpu_torch.train.fare_driver\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'regex', 'PIL', 'leaf_tpu', "
        "'safetensors', 'orbax', 'nltk', 'datasets', 'h5py', 'sacrebleu', "
        "'pandas', 'transformers', 'diffusers', 'huggingface_hub', "
        "'tensorboard', 'tensorboardX', 'wandb', 'torchvision', 'fsspec'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == "[]", out.stdout
