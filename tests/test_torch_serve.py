"""leaf_tpu_torch.serve against leaf_tpu.serve on one checkpoint, on the
CPU, and the port's import hygiene."""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from leaf_tpu import serve as jserve
from leaf_tpu_torch import serve as tserve
from leaf_tpu_torch.models import config as tconfig
from tests.test_torch_clip import openclip_state_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def inputs(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "imgs").mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3))
                        .astype(np.uint8)).save(
            tmp_path / "imgs" / f"{i}.png")
    (tmp_path / "texts.txt").write_text(
        "a photo of a cat\na stock market rally\nthe match ended\n")
    sd = openclip_state_dict(tconfig.get_model_config("ViT-tiny-test"))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "ckpt.pt")
    return tmp_path


def _args(d, out, batch_size, images=True):
    args = ["--model", "ViT-tiny-test", "--pretrained", str(d / "ckpt.pt"),
            "--texts", str(d / "texts.txt"), "--output", str(out),
            "--batch-size", str(batch_size), "--precision", "fp32"]
    return args + (["--images", str(d / "imgs")] if images else [])


def test_serve_matches_jax(inputs):
    jserve.main(_args(inputs, inputs / "jax.npz", 4))
    tserve.main(_args(inputs, inputs / "port.npz", 4) + ["--device", "cpu"])
    want = np.load(inputs / "jax.npz")
    got = np.load(inputs / "port.npz")
    assert sorted(got.files) == sorted(want.files) == [
        "image_features", "image_paths", "scores", "text_features", "texts"]
    for k in ("texts", "image_paths"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("text_features", "image_features", "scores"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got["text_features"], axis=-1),
                               1.0, rtol=1e-5)

    # the padded final batch must not leak into results: a batch size
    # that divides evenly gives the same features
    tserve.main(_args(inputs, inputs / "even.npz", 3, images=False)
                + ["--device", "cpu"])
    np.testing.assert_allclose(np.load(inputs / "even.npz")["text_features"],
                               got["text_features"], atol=1e-6)


def test_serve_times_every_batch_after_a_separate_warm_up(inputs,
                                                          monkeypatch):
    """The rate divides the texts by the window: every batch is encoded
    inside it, after one warm-up encode outside it (3 texts, batch 1)."""
    from leaf_tpu_torch.models import factory
    events = []
    encode = factory.CLIPModel.encode_text

    def counted(self, tokens, normalize=False):
        events.append("encode")
        return encode(self, tokens, normalize)

    def clock():
        events.append("clock")
        return float(len(events))

    monkeypatch.setattr(factory.CLIPModel, "encode_text", counted)
    monkeypatch.setattr(tserve, "time", types.SimpleNamespace(
        perf_counter=clock))
    tserve.main(_args(inputs, inputs / "t.npz", 1, images=False)
                + ["--device", "cpu"])
    assert events == ["encode", "clock"] + ["encode"] * 3 + ["clock"]


def test_serve_never_falls_back_to_the_cpu(inputs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(_args(inputs, inputs / "x.npz", 4, images=False))
    assert not (inputs / "x.npz").exists()


def test_port_imports_neither_jax_nor_regex_nor_pil():
    code = (
        "import sys\n"
        "import leaf_tpu_torch.serve\n"
        "from leaf_tpu_torch.models.factory import create_model, get_tokenizer\n"
        "m = create_model('ViT-tiny-test', device='cpu')\n"
        "f = m.encode_text(get_tokenizer('ViT-tiny-test')(['a photo of a cat']))\n"
        "assert f.shape == (1, 64), f.shape\n"
        "print(sorted(k for k in ('jax', 'jaxlib', 'regex', 'PIL')\n"
        "             if k in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
