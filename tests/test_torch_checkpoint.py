"""leaf_tpu_torch's checkpoints, resume, safetensors reader/writer and
OpenCLIP export.

Held here: the save/discover/resolve functions and their errors; a driver
run of 2 epochs equals 1 epoch + `--resume latest --epochs 2` bit for bit
on the CPU; the port's safetensors files against the `safetensors`
package; and the export's round trip through the JAX package
(`leaf_tpu.models.interop`), features within 1e-5.
"""
import csv
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leaf_tpu import convert as jconvert
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import interop as jinterop
from leaf_tpu_torch import convert as tconvert
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models.factory import create_model
from leaf_tpu_torch.tokenizer import get_tokenizer
from leaf_tpu_torch.train import checkpoint as ckpt
from leaf_tpu_torch.train import driver as tdriver
from leaf_tpu_torch.utils import safetensors_io

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
RUN = ["--model", MODEL, "--dataset-type", "synthetic",
       "--train-num-samples", "12", "--batch-size", "4", "--rho", "5",
       "--warmup", "2", "--lr", "1e-4", "--zeroshot-frequency", "0",
       "--log-every-n-steps", "1", "--device", "cpu", "--constrain"]


def _payload(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"text": {"w": torch.randn(3, 4, generator=g),
                     "b": torch.randn(4, generator=g)},
            "optimizer": {"adamw": {"state": {0: {"step": torch.tensor(3.0)}},
                                    "param_groups": [{"lr": 1e-3,
                                                      "betas": (0.9, 0.98)}]},
                          "accumulated": None},
            "step": 7}


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


# ---------------------------------------------------------------------------
# save, discover, resolve
# ---------------------------------------------------------------------------

def test_save_copies_before_it_returns_and_loads_back(tmp_path):
    d = str(tmp_path / "ckpts")
    payload = _payload()
    want = _payload()
    ckpt.save_checkpoint(d, 1, payload)
    payload["text"]["w"].zero_()        # the trainer updates in place
    ckpt.wait_for_checkpoints()
    got = ckpt.load_checkpoint(os.path.join(d, "epoch_1"))
    assert _same(got, want)
    assert sorted(os.listdir(d)) == ["epoch_1"]
    assert os.listdir(os.path.join(d, "epoch_1")) == [ckpt.STATE_FILE]
    # a second save of the same epoch replaces the first
    ckpt.save_checkpoint(d, 1, _payload(1), wait=True)
    assert _same(ckpt.load_checkpoint(os.path.join(d, "epoch_1")), _payload(1))
    assert sorted(os.listdir(d)) == ["epoch_1"]


def test_latest_checkpoint_and_the_latest_sidecar(tmp_path):
    d = str(tmp_path / "ckpts")
    assert ckpt.latest_checkpoint(d) is None
    for epoch in (1, 2, 10):
        ckpt.save_checkpoint(d, epoch, _payload(epoch))
    ckpt.wait_for_checkpoints()
    os.makedirs(os.path.join(d, "model_epoch_11"))      # not a checkpoint
    assert ckpt.latest_checkpoint(d) == (10, os.path.join(d, "epoch_10"))
    ckpt.save_latest(d, 12, _payload(12))
    with open(os.path.join(d, "epoch_latest.epoch")) as f:
        assert f.read() == "12"
    assert ckpt.latest_checkpoint(d) == (12, os.path.join(d, "epoch_latest"))
    assert _same(ckpt.load_checkpoint(os.path.join(d, "epoch_latest")),
                 _payload(12))
    ckpt.save_checkpoint(d, 13, _payload(13), wait=True)
    assert ckpt.latest_checkpoint(d)[0] == 13
    ckpt.save_named(d, "frozen", {"frozen_text": {"w": torch.ones(2)}})
    assert _same(ckpt.load_named(d, "frozen"),
                 {"frozen_text": {"w": torch.ones(2)}})
    assert ckpt.latest_checkpoint(d)[0] == 13


def test_resolve_resume_and_its_errors(tmp_path):
    d = str(tmp_path / "ckpts")
    assert ckpt.resolve_resume(None, d) is None
    assert ckpt.resolve_resume("", d) is None
    assert ckpt.resolve_resume("latest", d) is None     # nothing saved yet
    ckpt.save_checkpoint(d, 3, _payload(), wait=True)
    assert ckpt.resolve_resume("latest", d) == (3, os.path.join(d, "epoch_3"))
    path = os.path.join(d, "epoch_3")
    assert ckpt.resolve_resume(path, "/nowhere") == (3, path)
    assert ckpt.resolve_resume(path + "/", "/nowhere") == (3, path + "/")
    with pytest.raises(ValueError, match="not named epoch_<N>"):
        ckpt.resolve_resume(os.path.join(d, "model_epoch_3"), d)
    with pytest.raises(ValueError, match="epoch_latest.epoch"):
        ckpt.resolve_resume(os.path.join(d, "epoch_latest"), d)
    ckpt.save_latest(d, 5, _payload())
    latest = os.path.join(d, "epoch_latest")
    assert ckpt.resolve_resume(latest, "/nowhere") == (5, latest)
    with open(os.path.join(d, "epoch_latest.epoch"), "w") as f:
        f.write("five")
    with pytest.raises(ValueError, match="sidecar"):
        ckpt.resolve_resume(latest, d)
    with pytest.raises(FileNotFoundError, match="not a checkpoint"):
        ckpt.load_checkpoint(str(tmp_path))


def test_a_failed_write_is_raised_by_the_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises((RuntimeError, OSError)):
        # the checkpoint directory's parent is a file
        ckpt.save_checkpoint(str(blocker / "ckpts"), 1, _payload(), wait=True)
    ckpt.wait_for_checkpoints()         # the failure was consumed


# ---------------------------------------------------------------------------
# the driver: save, resume, export
# ---------------------------------------------------------------------------

def _rows(run_dir):
    with open(os.path.join(run_dir, "results.csv"), newline="") as f:
        return list(csv.DictReader(f))


def test_resume_continues_bit_for_bit(tmp_path):
    """`--epochs 1` then `--resume latest --epochs 2` equals `--epochs 2`
    (constant learning rate after the warm-up, so the schedule does not
    depend on the total): parameters, AdamW moments and steps, the step
    count, and `results.csv` rows not doubled."""
    logs = str(tmp_path)
    flags = RUN + ["--lr-scheduler", "const", "--logs", logs]
    whole = tdriver.main(flags + ["--epochs", "2", "--name", "whole"])
    one = tdriver.main(flags + ["--epochs", "1", "--name", "split"])
    assert one["state"].step == 3
    split_dir = os.path.join(logs, "split")
    ckpts = os.path.join(split_dir, "checkpoints")
    assert sorted(os.listdir(ckpts)) == [
        "epoch_0", "epoch_1", "frozen", "model_epoch_0", "model_epoch_1"]
    assert [r["epoch"] for r in _rows(split_dir)] == ["0", "1"]

    two = tdriver.main(flags + ["--epochs", "2", "--name", "split",
                                "--resume", "latest"])
    assert two["state"].step == whole["state"].step == 6
    for (n, a), b in zip(whole["state"].text.named_parameters(),
                         two["state"].text.parameters()):
        assert torch.equal(a, b), n
    assert _same(whole["state"].optimizer.state_dict(),
                 two["state"].optimizer.state_dict())
    for a, b in zip(whole["frozen_text"].parameters(),
                    two["frozen_text"].parameters()):
        assert torch.equal(a, b)
    rows, want = _rows(split_dir), _rows(os.path.join(logs, "whole"))
    assert [r["epoch"] for r in rows] == ["0", "1", "2"]
    assert [r["train_loss"] for r in rows] == [r["train_loss"] for r in want]
    assert "epoch_2" in os.listdir(ckpts) and "model_epoch_2" in os.listdir(ckpts)
    with open(os.path.join(split_dir, "out.log")) as f:
        assert "resuming from" in f.read()
    # the resumed leg's attack times: one row per step of that leg
    with open(os.path.join(split_dir, "times_False.csv")) as f:
        assert len(f.read().split()) == 1 + 3

    # an explicit path, into another run's directory: the frozen sidecar is
    # found next to the checkpoint and saved again with the new run
    other = tdriver.main(flags + ["--epochs", "2", "--name", "other",
                                  "--resume", os.path.join(ckpts, "epoch_1")])
    for a, b in zip(whole["state"].text.parameters(),
                    other["state"].text.parameters()):
        assert torch.equal(a, b)
    assert os.path.isdir(os.path.join(logs, "other", "checkpoints", "frozen"))
    assert [r["epoch"] for r in _rows(os.path.join(logs, "other"))] == ["2"]


def test_save_flags(tmp_path):
    logs = str(tmp_path)
    tdriver.main(RUN + ["--epochs", "3", "--logs", logs, "--name", "r",
                        "--save-frequency", "2", "--save-most-recent",
                        "--delete-previous-checkpoint"])
    names = sorted(os.listdir(os.path.join(logs, "r", "checkpoints")))
    # epoch 0, 2 (frequency) and 3 (the last) were saved; each save deleted
    # the epoch before it where that existed (3 deleted 2)
    assert names == ["epoch_0", "epoch_3", "epoch_latest",
                     "epoch_latest.epoch", "frozen", "model_epoch_0",
                     "model_epoch_3"]
    assert ckpt.latest_checkpoint(os.path.join(logs, "r", "checkpoints"))[0] == 3


def test_accum_freq_runs_in_the_driver(tmp_path):
    out = tdriver.main(RUN + ["--epochs", "1", "--logs", str(tmp_path),
                              "--name", "acc", "--accum-freq", "2",
                              "--train-num-samples", "16"])
    assert out["state"].step == 4               # 4 batches, 2 updates
    steps = {int(s["step"]) for s in
             out["state"].optimizer.adamw.state_dict()["state"].values()}
    assert steps == {2}
    with open(os.path.join(out["out_dir"], "out.log")) as f:
        log = f.read()
    assert log.count("Train Epoch: 0 [") == 2 and "[16/16 (100%)]" in log


# ---------------------------------------------------------------------------
# safetensors, and the export both ways
# ---------------------------------------------------------------------------

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 5, generator=g),
            "f16": torch.randn(4, generator=g).half(),
            "bf16": torch.randn(2, 3, 2, generator=g).bfloat16(),
            "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "i64": torch.tensor([-(2 ** 40), 7]),
            "scalar": torch.tensor(2.5),
            "empty": torch.zeros(0, 4),
            "transposed": torch.randn(4, 3, generator=g).T}


def test_safetensors_against_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = _tensors()
    ours, theirs = str(tmp_path / "ours.st"), str(tmp_path / "theirs.st")
    safetensors_io.save_file(tensors, ours, metadata={"format": "pt"})
    st.save_file({k: v.contiguous() for k, v in tensors.items()}, theirs)
    for path in (ours, theirs):
        for load in (safetensors_io.load_file, st.load_file):
            got = load(path)
            assert got.keys() == tensors.keys()
            for name, want in tensors.items():
                assert got[name].dtype == want.dtype, (path, name)
                assert got[name].shape == want.shape, (path, name)
                assert torch.equal(got[name], want), (path, name)
    with st.safe_open(ours, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
    # numpy arrays are written too, and loaded tensors are writable
    safetensors_io.save_file({"a": np.arange(4, dtype=np.float32)}, ours)
    got = safetensors_io.load_file(ours)["a"]
    got += 1
    assert got.tolist() == [1.0, 2.0, 3.0, 4.0]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_safetensors_refuses_broken_files(tmp_path):
    path = str(tmp_path / "x.safetensors")
    safetensors_io.save_file({"a": torch.ones(4)}, path)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-4])                       # data cut short
    with pytest.raises(ValueError, match="offsets"):
        safetensors_io.load_file(path)
    with open(path, "wb") as f:
        f.write(raw[:5])
    with pytest.raises(ValueError, match="too short"):
        safetensors_io.load_file(path)
    with open(path, "wb") as f:
        f.write((2 ** 40).to_bytes(8, "little") + raw[8:])
    with pytest.raises(ValueError, match="not credible"):
        safetensors_io.load_file(path)
    with pytest.raises(TypeError, match="no safetensors name"):
        safetensors_io.save_file({"c": torch.ones(2, dtype=torch.complex64)},
                                 path)


def test_the_interop_loader_needs_no_safetensors_package(tmp_path, monkeypatch):
    import sys
    model = create_model(MODEL, seed=1, device="cpu")
    path = tconvert.save_state_dict(
        tconvert.params_to_openclip(model.module.state_dict(), model.cfg),
        str(tmp_path))
    monkeypatch.setitem(sys.modules, "safetensors", None)    # import fails
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    sd = tinterop.load_pretrained(str(tmp_path), model.cfg)
    want = model.module.state_dict()
    assert sd.keys() == want.keys()
    assert all(torch.equal(sd[k], want[k]) for k in want)
    assert path.endswith("open_clip_model.safetensors")
    # the HF format is written too (as `model.safetensors`); an unknown
    # format is refused
    assert tconvert.save_state_dict({}, str(tmp_path), "hf").endswith(
        "model.safetensors")
    with pytest.raises(ValueError, match="unknown format"):
        tconvert.save_state_dict({}, str(tmp_path), "orbax")


def test_export_round_trips_through_the_jax_package(tmp_path):
    """The trainer's `model_epoch_1` export loads in the JAX package and
    gives the port's text and image features within 1e-5; a file written
    by `leaf_tpu.convert.save_state_dict` loads in the port."""
    out = tdriver.main(RUN + ["--epochs", "1", "--logs", str(tmp_path),
                              "--name", "exp"])
    export = os.path.join(out["out_dir"], "checkpoints", "model_epoch_1")
    assert sorted(os.listdir(export)) == ["open_clip_config.json",
                                          "open_clip_model.safetensors"]
    with open(os.path.join(export, "open_clip_config.json")) as f:
        assert json.load(f) == {"model_cfg": {"quick_gelu": False}}
    module = out["model"].module
    tokens = get_tokenizer()(["a photo of a cat", "stocks rally"])[:, :16]
    size = out["cfg"].vision.image_size
    images = np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    with torch.no_grad():
        t_text = module.encode_text(torch.from_numpy(tokens)).numpy()
        t_img = module.encode_image(torch.from_numpy(images)).numpy()

    # port -> JAX
    jcfg = jconfig.get_model_config(MODEL)
    jparams = jinterop.load_pretrained(export, jcfg)
    j_text = np.asarray(jclip.encode_text(jparams["text"], jcfg.text,
                                          jnp.asarray(tokens),
                                          jcfg.quick_gelu))
    j_img = np.asarray(jclip.encode_image_model(jparams, jcfg,
                                                jnp.asarray(images)))
    np.testing.assert_allclose(j_text, t_text, atol=1e-5)
    np.testing.assert_allclose(j_img, t_img, atol=1e-5)
    # the export holds the trained tower, not the initial one
    fresh = create_model(MODEL, seed=0, device="cpu").module
    with torch.no_grad():
        assert np.abs(fresh.encode_text(torch.from_numpy(tokens)).numpy()
                      - t_text).max() > 1e-4

    # the port reads its own export back, bit for bit
    back = tinterop.load_pretrained(export, out["cfg"])
    want = module.state_dict()
    assert all(torch.equal(back[k], want[k]) for k in want)

    # JAX -> port, and the two converters write the same state dict
    jdir = str(tmp_path / "from_jax")
    jsd = jconvert.params_to_openclip(jparams, jcfg)
    jconvert.save_state_dict(jsd, jdir, "openclip")
    again = tinterop.load_pretrained(jdir, out["cfg"])
    assert all(torch.equal(again[k], want[k]) for k in want)
    ours = tconvert.params_to_openclip(want, out["cfg"])
    assert ours.keys() == jsd.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(jsd[k]))
        assert ours[k].is_contiguous()


def test_hf_checkpoint_message_names_no_jax_program(tmp_path):
    """An HF-format checkpoint loads in the port itself, with no JAX program
    to convert it first: a whole one gives the weights it was written from;
    a truncated one fails on the first missing key, and the error names no
    JAX program."""
    model = create_model("ViT-tiny-test", seed=2, device="cpu")
    want = model.module.state_dict()
    hf = tinterop.params_to_hf(want, model.cfg)
    path = str(tmp_path / "model.safetensors")
    safetensors_io.save_file(hf, path)
    got = tinterop.load_pretrained(path, model.cfg)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    safetensors_io.save_file(
        {"text_model.embeddings.token_embedding.weight": torch.zeros(4, 2)},
        path)
    with pytest.raises(KeyError) as info:
        tinterop.load_pretrained(path, model.cfg)
    assert "python -m leaf_tpu.convert" not in str(info.value)
