"""leaf_tpu_torch's tooling against the JAX package's, on the CPU in fp32:
int8 MLP weights, `torch.export` of both encoders through the custom
ops, the model profiler, run-directory mirroring and codebase snapshots,
trackers, the trainers' run-management flags, and serve's `--int8-mlp`
and `--export`.
"""
import collections
import glob
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from leaf_tpu import serve as jserve
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import quantize as jquantize
from leaf_tpu.utils import file_utils as jfile_utils
from leaf_tpu.utils import profiler as jprofiler
from leaf_tpu.utils import trackers as jtrackers
from leaf_tpu_torch import serve as tserve
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import export as texport
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import quantize as tquantize
from leaf_tpu_torch.models.clip import CLIP
from leaf_tpu_torch.models.factory import create_model
from leaf_tpu_torch.ops import packed_attention as ops
from leaf_tpu_torch.train import driver as tdriver
from leaf_tpu_torch.train import params as tparams
from leaf_tpu_torch.utils import file_utils as tfile_utils
from leaf_tpu_torch.utils import profiler as tprofiler
from leaf_tpu_torch.utils import trackers as ttrackers
from tests.test_torch_clip import openclip_state_dict

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
TOL = dict(atol=1e-5, rtol=1e-4)
RUN = ["--model", MODEL, "--dataset-type", "synthetic",
       "--train-num-samples", "16", "--batch-size", "4", "--epochs", "1",
       "--rho", "4", "--warmup", "2", "--lr", "1e-4",
       "--zeroshot-frequency", "0", "--log-every-n-steps", "1",
       "--device", "cpu"]


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the port's fp32 CPU module), the same weights."""
    params = jax.tree.map(np.asarray, jclip.init_clip(
        jax.random.PRNGKey(0), jconfig.get_model_config(MODEL)))
    module = CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(params))
    return params, module.eval()


def _inputs(S=77):
    rng = np.random.default_rng(0)
    tokens = np.zeros((3, S), np.int32)
    for i, e in enumerate((4, 9, S - 1)):
        tokens[i, 0] = 49406
        tokens[i, 1:e] = rng.integers(1, 49400, size=e - 1)
        tokens[i, e] = 49407
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    return tokens, images


# ---------------------------------------------------------------------------
# int8 MLP weights
# ---------------------------------------------------------------------------

def test_quantize_weight_is_bit_equal_to_jax():
    """Scales and int8 values equal JAX's bit for bit, ties (x.5) rounded
    half to even in both, an all-zero column's scale 1."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 64, 96)).astype(np.float32)
    w[:, :, 0] = 0.0
    # exact ties: column amax 127 gives scale 1.0 and values k + 0.5
    w[:, 0, 1] = 127.0
    w[:, 1:9, 1] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, -2.5, 126.5])
    jq, js = jquantize.quantize_weight(jnp.asarray(w))
    for i in range(2):
        q, s = tquantize.quantize_weight(torch.from_numpy(w[i]))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq)[i])
        np.testing.assert_array_equal(s.numpy(), np.asarray(js)[i])
    q, s = tquantize.quantize_weight(torch.from_numpy(w[0]))
    assert q[1:9, 1].tolist() == [0, 2, 2, 0, -2, 4, -2, 126]
    assert float(s[0, 0]) == 1.0
    np.testing.assert_array_equal(
        tquantize.dequantize_weight(q, s).numpy(),
        np.asarray(jquantize.dequantize_weight(jq[0], js[0])))


def test_quantized_model_matches_jax(pair):
    """The port's quantized state_dict equals the JAX quantized pytree's
    (int8 leaves kept by `params_from_jax`); its features equal the JAX
    quantized model's to 1e-5 in fp32, and in bf16 to bf16's tolerance."""
    params, module = pair
    jq = jquantize.quantize_mlp_params(params)
    want_sd = tinterop.params_from_jax(jax.tree.map(np.asarray, jq))
    q = CLIP(tconfig.get_model_config(MODEL))
    q.load_state_dict(module.state_dict())
    tquantize.quantize_mlp_params(q)
    got_sd = q.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        assert got_sd[k].dtype == want_sd[k].dtype, k
        assert torch.equal(got_sd[k], want_sd[k]), k
    assert got_sd["text.blocks.0.mlp.fc_w"].dtype == torch.int8
    assert got_sd["text.blocks.0.mlp.fc_w_scale"].shape == (1, 256)

    cfg = jconfig.get_model_config(MODEL)
    tokens, images = _inputs()
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        m = create_model(MODEL, device="cpu", int8_mlp=True,
                         precision="bf16" if dtype == torch.bfloat16
                         else "fp32")
        m.module.load_state_dict(q.state_dict())
        with torch.no_grad():
            t_txt = m.module.encode_text(torch.from_numpy(tokens)).float()
            t_img = m.module.encode_image(torch.from_numpy(images)).float()
        j_txt = jclip.encode_text(jq["text"], cfg.text, jnp.asarray(tokens),
                                  cfg.quick_gelu, dtype=jdtype)
        j_img = jclip.encode_image_model(jq, cfg, jnp.asarray(images),
                                         dtype=jdtype)
        for a, b in ((t_txt.numpy(), np.asarray(j_txt, np.float32)),
                     (t_img.numpy(), np.asarray(j_img, np.float32))):
            if dtype == torch.float32:
                np.testing.assert_allclose(a, b, **TOL)
            else:
                # bf16: 2e-2, or 2^-6 of the features' size where that is
                # more (two bf16 rounding steps)
                assert np.abs(a - b).max() <= max(
                    2e-2, 2.0 ** -6 * np.abs(b).max())
    assert tquantize.quantized_nbytes(q) < tquantize.quantized_nbytes(module)


@pytest.fixture()
def serve_inputs(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "imgs").mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3))
                        .astype(np.uint8)).save(tmp_path / "imgs" / f"{i}.png")
    (tmp_path / "texts.txt").write_text(
        "a photo of a cat\na stock market rally\nthe match ended\n")
    sd = openclip_state_dict(tconfig.get_model_config(MODEL))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "ckpt.pt")
    return tmp_path


def _serve_args(d, out, extra=()):
    return ["--model", MODEL, "--pretrained", str(d / "ckpt.pt"),
            "--texts", str(d / "texts.txt"), "--images", str(d / "imgs"),
            "--output", str(out), "--batch-size", "2", "--precision",
            "fp32", *extra]


def test_serve_int8_mlp_matches_jax(serve_inputs, caplog):
    d = serve_inputs
    jserve.main(_serve_args(d, d / "jax.npz", ["--int8-mlp"]))
    with caplog.at_level("INFO"):
        tserve.main(_serve_args(d, d / "port.npz",
                                ["--int8-mlp", "--device", "cpu"]))
    want, got = np.load(d / "jax.npz"), np.load(d / "port.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in ("text_features", "image_features", "scores"):
        np.testing.assert_allclose(got[k], want[k], **TOL)
    line = next(r.getMessage() for r in caplog.records
                if r.getMessage().startswith("int8 MLP: params"))
    before, after = (float(x) for x in line.split("params ")[1]
                     .replace(" MiB", "").split(" → "))
    assert after < before


# ---------------------------------------------------------------------------
# torch.export through the custom ops
# ---------------------------------------------------------------------------

def _op_counts(exported):
    return collections.Counter(
        str(n.target) for n in exported.graph.nodes
        if n.op == "call_function")


def test_export_holds_the_custom_ops_and_equals_eager(pair, tmp_path):
    _, module = pair
    model = create_model(MODEL, device="cpu")
    model.module.load_state_dict(module.state_dict())
    tokens, images = _inputs()
    paths = texport.export_model(model, str(tmp_path), batch_size=3,
                                 normalize=True)
    assert [os.path.basename(p) for p in paths] == [
        f"{MODEL}.text.pt2", f"{MODEL}.image.pt2"]
    text, image = (texport.load_exported(p) for p in paths)
    layers = model.cfg.text.layers
    for exported, extra_ln in ((text, 1), (image, 2)):
        counts = _op_counts(exported)
        assert counts["leaf_tpu_torch.fused_attention_block.default"] == layers
        assert counts["leaf_tpu_torch.layer_norm.default"] == layers + extra_ln
        # the plain attention (its einsums) is not in the graph
        assert not any("bmm" in k or "einsum" in k for k in counts)
    with torch.no_grad():
        got_t = text.module()(torch.from_numpy(tokens))
        got_i = image.module()(torch.from_numpy(np.concatenate(
            [images, images[:1]])))
        want_t = model.module.encode_text(torch.from_numpy(tokens), True)
        want_i = model.module.encode_image(torch.from_numpy(images), True)
    torch.testing.assert_close(got_t, want_t, atol=0, rtol=0)
    torch.testing.assert_close(got_i[:2], want_i, atol=0, rtol=0)


def test_dispatcher_route_equals_the_direct_ops(pair):
    """Through the registered custom ops the towers give the same features
    and count the same launches (none on the CPU) as the direct calls."""
    _, module = pair
    tokens, images = (torch.from_numpy(x) for x in _inputs(16))
    with torch.no_grad():
        want = (module.encode_text(tokens), module.encode_image(images))
        with ops.dispatcher():
            got = (module.encode_text(tokens), module.encode_image(images))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not ops._ROUTE["dispatcher"]


def test_serve_export_writes_artifacts_equal_to_its_features(serve_inputs):
    d = serve_inputs
    out = tserve.main(_serve_args(d, d / "f.npz", [
        "--export", str(d / "export"), "--device", "cpu"]))
    text = texport.load_exported(str(d / "export" / f"{MODEL}.text.pt2"))
    from leaf_tpu_torch.tokenizer import get_tokenizer
    toks = np.asarray(get_tokenizer()(list(out["texts"])))[:2]
    with torch.no_grad():
        feats = text.module()(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(feats, out["text_features"][:2], atol=1e-6)


# ---------------------------------------------------------------------------
# the model profiler
# ---------------------------------------------------------------------------

def _block_flops(L, D, mlp):
    return 2 * L * D * 3 * D + 2 * L * D * D + 4 * L * L * D + 4 * L * D * mlp


@pytest.mark.parametrize("name", [MODEL, "ViT-B-32"])
def test_profiler_matches_jax(name):
    """`mparams` equal JAX's exactly.  The operations: XLA's
    `cost_analysis` counts the body of the towers' `lax.scan` over layers
    once, and counts elementwise work that `FlopCounterMode` does not; so
    JAX's figure is the port's with one layer instead of L, plus an
    elementwise share, measured at 10-17% at ViT-tiny-test and 1-3% at
    ViT-B-32 (held to [1.0, 1.2])."""
    want = jprofiler.profile_model(name)
    got = tprofiler.profile_model(name)
    for k in ("model", "image_size", "image_width", "text_width",
              "embed_dim", "mparams", "mparams_image", "mparams_text"):
        assert got[k] == want[k], k
    cfg = tconfig.get_model_config(name)
    for tower, L, tc in (("image", cfg.vision.num_tokens, cfg.vision),
                         ("text", cfg.text.context_length, cfg.text)):
        one_layer = got[f"gflops_{tower}"] * 1e9 - (tc.layers - 1) * \
            _block_flops(L, tc.width, int(tc.width * tc.mlp_ratio))
        assert 1.0 <= want[f"gflops_{tower}"] * 1e9 / one_layer <= 1.2, tower
        assert got[f"gbytes_{tower}"] > 0


def test_custom_op_formulas_count_what_the_plain_versions_compute(pair):
    _, module = pair
    tokens, images = (torch.from_numpy(x) for x in _inputs())
    for fn, x in ((module.encode_text, tokens), (module.encode_image, images)):
        plain, _ = tprofiler._count(fn, x)
        with ops.dispatcher():
            formula, _ = tprofiler._count(fn, x)
        assert formula == plain > 0


def test_profiler_main_writes_csv_and_refuses_coca(tmp_path, capsys):
    rows = tprofiler.main(["--model", f"{MODEL},coca_ViT-B-32", "--results",
                           str(tmp_path / "p.csv"), "--device", "cpu"])
    assert [r["model"] for r in rows] == [MODEL]
    assert "coca_ViT-B-32: FAILED" in capsys.readouterr().out
    assert "item 11" in str(pytest.raises(
        NotImplementedError, tprofiler.profile_model, "coca_ViT-B-32").value)
    with open(tmp_path / "p.csv") as f:
        assert f.readline().startswith("model,image_size")


# ---------------------------------------------------------------------------
# run management: mirroring, codebase snapshots, trackers
# ---------------------------------------------------------------------------

def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("scheme", ["", "file://"])
def test_remote_sync_to_a_local_dir_and_file_url(tmp_path, scheme):
    src = tmp_path / "run"
    (src / "checkpoints" / "epoch_1").mkdir(parents=True)
    (src / "out.log").write_text("a")
    (src / "checkpoints" / "epoch_1" / "state.pt").write_text("b")
    for pkg, dst in ((tfile_utils, tmp_path / "port"),
                     (jfile_utils, tmp_path / "jax")):
        assert pkg.remote_sync(str(src), scheme + str(dst))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") == _tree(src)
    assert (tmp_path / "port" / "out.log").read_text() == "a"
    # a failed target reports False
    (tmp_path / "blocked").write_text("a file, not a directory")
    assert not tfile_utils.remote_sync(str(src), str(tmp_path / "blocked"))


def test_run_mirror_syncs_in_the_background_and_raises_on_failure(tmp_path):
    src = tmp_path / "run"
    src.mkdir()
    (src / "a.txt").write_text("1")
    args = types.SimpleNamespace(remote_sync=str(tmp_path / "remote"),
                                 remote_sync_protocol="fsspec",
                                 remote_sync_frequency=0.05)
    thread = tfile_utils.start_run_mirror(args, str(src), "exp")
    assert (tmp_path / "remote" / "exp" / "a.txt").read_text() == "1"
    (src / "b.txt").write_text("2")
    thread.stop(final_sync=True)
    assert (tmp_path / "remote" / "exp" / "b.txt").read_text() == "2"
    assert tfile_utils.start_run_mirror(
        types.SimpleNamespace(remote_sync=None), str(src), "exp") is None
    (tmp_path / "file").write_text("x")
    args.remote_sync = str(tmp_path / "file")
    with pytest.raises(RuntimeError, match="remote sync"):
        tfile_utils.start_run_mirror(args, str(src), "exp")


def test_copy_codebase_and_its_file_exists_error(tmp_path):
    tfile_utils.copy_codebase(str(tmp_path))
    code = tmp_path / "code" / "leaf_tpu_torch"
    assert (code / "serve.py").exists()
    assert (code / "ops" / "csrc" / "fused_block.cu").exists()
    assert not glob.glob(str(code / "**" / "__pycache__"), recursive=True)
    with pytest.raises(FileExistsError, match="already exists"):
        tfile_utils.copy_codebase(str(tmp_path))


def test_tensorboard_tracker_writes_events(tmp_path):
    pytest.importorskip("tensorboard")
    tracker = ttrackers.create_tracker("tensorboard", str(tmp_path), "run")
    assert isinstance(tracker, ttrackers.TensorBoardTracker)
    tracker.log({"train/loss": 1.5, "skip": "text"}, step=3)
    tracker.finish()
    assert glob.glob(str(tmp_path / "events.out.tfevents.*"))


def test_missing_backends_give_the_jax_no_op_tracker(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)
    for pkg in (ttrackers, jtrackers):
        t = pkg.create_tracker("wandb", "/nonexistent", "run")
        assert type(t).__name__ == "Tracker"
        t.log({"a": 1.0}, step=1)
        t.finish()
    assert sum("wandb unavailable" in r.getMessage()
               for r in caplog.records) == 2
    assert type(ttrackers.create_tracker("", "/x", "r")) is ttrackers.Tracker


def test_matmul_precision_maps_jax_values():
    saved = torch.get_float32_matmul_precision()
    try:
        for value, want in (("default", "medium"), ("high", "high"),
                            ("highest", "highest")):
            tparams.set_matmul_precision(value)
            assert torch.get_float32_matmul_precision() == want
        tparams.set_matmul_precision(None)
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(saved)


# ---------------------------------------------------------------------------
# the LEAF driver's run management
# ---------------------------------------------------------------------------

def test_resume_latest_finds_a_newer_remote_checkpoint(tmp_path):
    """A run mirrored to a remote directory, then resumed with `--resume
    latest` on a machine whose local run directory is empty: the mirror's
    newer checkpoint is the one resumed."""
    remote = str(tmp_path / "remote")
    first = tdriver.main(RUN + ["--logs", str(tmp_path / "a"), "--name",
                                "exp", "--remote-sync", remote])
    assert os.path.exists(os.path.join(remote, "exp", "checkpoints",
                                       "epoch_1", "state.pt"))
    out = tdriver.main(RUN + ["--logs", str(tmp_path / "b"), "--name", "exp",
                              "--remote-sync", remote, "--resume", "latest",
                              "--epochs", "2"])
    assert out["state"].step == 2 * first["state"].step
    assert [r["epoch"] for r in out["results"]] == [2]
    with pytest.raises(ValueError, match="save-most-recent"):
        tdriver.main(RUN + ["--logs", str(tmp_path / "c"), "--remote-sync",
                            remote, "--resume", "latest",
                            "--save-most-recent"])
    assert not os.path.exists(tmp_path / "c")


def test_profile_dir_leaves_a_trace_after_six_batches(tmp_path):
    flags = [f for f in RUN]
    flags[flags.index("--train-num-samples") + 1] = "24"      # 6 batches
    tdriver.main(flags + ["--logs", str(tmp_path), "--name", "p",
                          "--profile-dir", str(tmp_path / "trace")])
    traces = os.listdir(tmp_path / "trace")
    assert traces == ["trace_epoch0_batches2-5.json"]
    assert os.path.getsize(tmp_path / "trace" / traces[0]) > 0
