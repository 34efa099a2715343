"""leaf_tpu_torch's PEZ prompt inversion against the JAX package's, in
fp32 on the CPU at ViT-tiny-test.

One set of JAX-initialised weights goes to both packages (the command
lines' by one OpenCLIP checkpoint written from it), and both start from
the initial ids that `jax.random` draws as the JAX function does.  Held:
`nn_project` the JAX projection; 10 `optimize_prompt` steps the JAX ids at
every step (read out of the JAX step with `jax.debug.callback`) and its
similarities to 1e-5, with the tower's weights taking no gradient;
`pez_driver.main` the JAX command line's results for captions and for
image targets, with the JSON config merged under the flags; `pez_metrics`
the JAX metrics on either payload.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from leaf_tpu.evals import pez as jpez
from leaf_tpu.evals import pez_driver as jdriver
from leaf_tpu.evals import pez_metrics as jmetrics
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu_torch.convert import params_to_openclip, save_state_dict
from leaf_tpu_torch.evals import pez as tpez
from leaf_tpu_torch.evals import pez_driver as tdriver
from leaf_tpu_torch.evals import pez_metrics as tmetrics
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"


@pytest.fixture(scope="module")
def pair():
    params = jclip.init_clip(jax.random.PRNGKey(0),
                             jconfig.get_model_config(MODEL))
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, module.eval()


def _jax_init_ids(seed: int, prompt_len: int) -> np.ndarray:
    """The initial ids of the JAX `optimize_prompt` for `seed`."""
    k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(jax.random.randint(k_init, (1, prompt_len), 0,
                                         49408 - 2))


def _jax_steps(monkeypatch, params, target, **kw):
    """The JAX `optimize_prompt`, with the ids its step projects to at
    every step."""
    seen = []
    inner = jpez.nn_project

    def recording(embeds, table):
        projected, idx = inner(embeds, table)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)[0].tolist()),
                           idx)
        return projected, idx

    monkeypatch.setattr(jpez, "nn_project", recording)
    out = jpez.optimize_prompt(params["text"], jconfig.get_model_config(MODEL),
                               target, **kw)
    return out, seen


def test_nn_project_matches_jax(pair):
    params, module = pair
    table = np.asarray(params["text"]["token_embedding"])
    embeds = np.random.default_rng(0).standard_normal(
        (2, 5, table.shape[1])).astype(np.float32)
    jp, jid = jpez.nn_project(jnp.asarray(embeds), jnp.asarray(table))
    tp, tid = tpez.nn_project(torch.from_numpy(embeds),
                              module.text.token_embedding.detach())
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("n_targets,prompt_len,loss_weight",
                         [(1, 6, 1.0), (3, 4, 2.0)])
def test_optimize_prompt_matches_jax(pair, monkeypatch, n_targets,
                                     prompt_len, loss_weight):
    params, module = pair
    target = np.random.default_rng(n_targets).standard_normal(
        (n_targets, 64)).astype(np.float32)
    kw = dict(prompt_len=prompt_len, iters=10, lr=0.1, weight_decay=0.1,
              loss_weight=loss_weight, seed=3)
    want, jax_ids = _jax_steps(monkeypatch, params, jnp.asarray(target), **kw)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    got = tpez.optimize_prompt(module.text, torch.from_numpy(target),
                               init_ids=_jax_init_ids(3, prompt_len), **kw)
    assert got["per_step_ids"] == jax_ids and len(jax_ids) == 10
    np.testing.assert_allclose(got["per_step_sims"], want["per_step_sims"],
                               atol=1e-5)
    assert got["ids"] == want["ids"]
    assert abs(got["sim"] - want["sim"]) <= 1e-5
    # the tower is untouched and takes no gradient, then is given back
    assert all(torch.equal(v, before[k])
               for k, v in module.state_dict().items())
    assert all(p.grad is None and p.requires_grad
               for p in module.text.parameters())


def test_optimize_prompt_seeded_start_and_subsample(pair):
    module = pair[1]
    target = torch.randn(5, 64, generator=torch.Generator().manual_seed(0))
    runs = [tpez.optimize_prompt(module.text, target, prompt_len=3, iters=2,
                                 seed=s, batch_size=2) for s in (4, 4, 5)]
    assert runs[0] == runs[1] and runs[0]["per_step_ids"] \
        != runs[2]["per_step_ids"]
    assert all(0 <= i < 49406 for i in runs[0]["per_step_ids"][0])
    with pytest.raises(ValueError, match="init_ids"):
        tpez.optimize_prompt(module.text, target, prompt_len=3, iters=1,
                             init_ids=np.zeros((1, 4), np.int64))


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

CAPTIONS = ["a red car on the road", "two dogs!", "x"]


@pytest.fixture(scope="module")
def files(pair, tmp_path_factory):
    root = tmp_path_factory.mktemp("pez")
    module = pair[1]
    ckpt = save_state_dict(params_to_openclip(module.state_dict(),
                                              module.cfg),
                           str(root / "ckpt"), "openclip")
    (root / "captions.txt").write_text("\n".join(CAPTIONS) + "\n\n")
    (root / "config.json").write_text(json.dumps(
        {"iter": 99, "lr": 0.05, "model": MODEL, "prompt_len": "match"}))
    rng = np.random.default_rng(1)
    images = []
    for i in range(2):
        path = str(root / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(path)
        images.append(path)
    return str(root), ckpt, images


def _start_from_jax(monkeypatch):
    """The port's driver starts each inversion from the JAX package's
    initial ids for the same seed and prompt length."""
    inner = tpez.optimize_prompt

    def from_jax(text, target, prompt_len=8, seed=0, **kw):
        return inner(text, target, prompt_len=prompt_len, seed=seed,
                     init_ids=_jax_init_ids(seed, prompt_len), **kw)

    monkeypatch.setattr(tpez, "optimize_prompt", from_jax)


def _same_payload(got, want):
    """The same config (the port's has its device besides; each wrote
    into a directory of its own), results and mean, similarities to
    1e-5."""
    config, wanted = dict(got["config"]), dict(want["config"])
    assert config.pop("device") == "cpu"
    assert config.pop("output") != wanted.pop("output")
    assert config == wanted
    assert len(got["results"]) == len(want["results"])
    for g, w in zip(got["results"], want["results"]):
        g, w = dict(g), dict(w)
        assert abs(g.pop("cosine_sim") - w.pop("cosine_sim")) <= 1e-5
        assert g == w
    assert abs(got["mean_cosine_sim"] - want["mean_cosine_sim"]) <= 1e-5


def test_pez_driver_captions_match_jax(files, monkeypatch):
    root, ckpt, _ = files
    _start_from_jax(monkeypatch)
    flags = ["--config", os.path.join(root, "config.json"), "--pretrained",
             ckpt, "--captions", os.path.join(root, "captions.txt"),
             "--iter", "4", "--n-samples", "2", "--seed", "2"]
    want = jdriver.main(flags + ["--output", os.path.join(root, "jax")])
    got = tdriver.main(flags + ["--output", os.path.join(root, "torch"),
                                "--device", "cpu"])
    _same_payload(got, want)
    # the flags override the config, which overrides the defaults
    assert (got["config"]["iter"], got["config"]["lr"],
            got["config"]["n_samples"]) == (4, 0.05, 2)
    assert [r["prompt_len"] for r in got["results"]] == [6, 3]
    assert sorted(os.listdir(os.path.join(root, "torch"))) \
        == sorted(os.listdir(os.path.join(root, "jax"))) \
        == [f"results-2smpls-4iters-{MODEL}.json"]


def test_pez_driver_images_match_jax(files, monkeypatch, tmp_path):
    root, ckpt, images = files
    _start_from_jax(monkeypatch)
    flags = ["--model", MODEL, "--pretrained", ckpt, "--images", *images,
             "--iter", "3", "--prompt-len", "5"]
    want = jdriver.main(flags + ["--output", str(tmp_path / "jax")])
    got = tdriver.main(flags + ["--output", str(tmp_path / "torch"),
                                "--device", "cpu"])
    _same_payload(got, want)
    assert got["results"][0]["prompt_len"] == 5
    assert len(got["results"][0]["ids_rec"]) == 5


def test_pez_metrics_match_jax(files, tmp_path):
    payload = {"config": {}, "results": [
        {"original": "a red car on the road", "reconstructed": "red car road",
         "cosine_sim": 0.8, "ids_orig": [49406, 736, 1615, 49407, 0],
         "ids_rec": [736, 320, 1615]},
        {"original": "two dogs!", "reconstructed": "", "cosine_sim": 0.5,
         "ids_orig": [49406, 1237, 49407], "ids_rec": [0, 0]}]}
    assert tmetrics.evaluate_results(payload) \
        == jmetrics.evaluate_results(payload)
    assert "bleu" in tmetrics.evaluate_results(payload)
    (tmp_path / "results-2smpls-1iters-m.json").write_text(
        json.dumps(payload))
    (tmp_path / "other.json").write_text("{}")
    assert tmetrics.main([str(tmp_path)]) == jmetrics.main([str(tmp_path)])
    image_payload = {"results": [{"images": ["a.png"], "reconstructed": "x",
                                  "cosine_sim": 0.3, "ids_rec": [1]}]}
    with pytest.raises(ValueError, match="image-target"):
        tmetrics.evaluate_results(image_payload)


def test_pez_metrics_without_sacrebleu(monkeypatch):
    monkeypatch.setitem(sys.modules, "sacrebleu", None)
    monkeypatch.setitem(sys.modules, "sacrebleu.metrics", None)
    assert tmetrics.compute_bleu(["a b"], ["a b"]) is None
    m = tmetrics.evaluate_results({"results": [
        {"original": "a b", "reconstructed": "a", "cosine_sim": 1.0}]})
    assert "bleu" not in m and m["word_accuracy"] == 1.0


def test_pez_driver_refusals(files):
    root, ckpt, _ = files
    with pytest.raises(SystemExit):
        tdriver.main(["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 11"):
        tdriver.main(["--model", MODEL, "--pretrained", "openai",
                      "--captions", os.path.join(root, "captions.txt"),
                      "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdriver.main(["--model", MODEL, "--captions",
                          os.path.join(root, "captions.txt")])
