"""leaf_tpu_torch's standalone text evals (TextFARE, zero-shot text
classification, COCO retrieval) and its COCO reader against the JAX
package's, in fp32 on the CPU at ViT-tiny-test.

One set of JAX-initialised weights goes to both packages (the port's copy
by way of `interop.params_from_jax`), with the same sentences, images and
image embeddings.  Held: `eval_textfare` under each attack writes the JAX
package's CSV rows (sentences equal, drifts to 1e-4 relative) and means;
`eval_zero_shot_text` the JAX package's metrics and CSV, the same rows in
the same places whatever order the dataset comes in, and a chunk's rows
are on disk before the next chunk runs; `pre_caption`, `evaluate_scores`
and `eval_retrieval` (untargeted and targeted) the JAX package's values,
adversarial captions and CSV; the COCO reader the JAX package's captions,
pairs and pixels (PNG), and the same pixels from `.npy` arrays.  The
three command lines run with `--device cpu`.
"""
import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from leaf_tpu.attacks.engine import CandidateScorer as JScorer
from leaf_tpu.data import coco as jcoco
from leaf_tpu.data.textcls import TextClassificationData as JTextCls
from leaf_tpu.evals import retrieval as jret
from leaf_tpu.evals import textfare as jtf
from leaf_tpu.evals import zero_shot_text as jzst
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import preprocess as jpre
from leaf_tpu.tokenizer import get_tokenizer as jax_tokenizer
from leaf_tpu_torch.attacks.engine import CandidateScorer as TScorer
from leaf_tpu_torch.data import coco as tcoco
from leaf_tpu_torch.data.textcls import TextClassificationData as TTextCls
from leaf_tpu_torch.evals import retrieval as tret
from leaf_tpu_torch.evals import textfare as ttf
from leaf_tpu_torch.evals import zero_shot_text as tzst
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import preprocess as tpre
from leaf_tpu_torch import profile_charmer
from leaf_tpu_torch.tokenizer import get_tokenizer as port_tokenizer

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
TEXTS = ["tax cut", "the team won the cup after extra time", "stocks rally",
         "a very long report about the quarterly earnings of the company",
         "rain", "election results are in and counting continues"]
# a short attack vocabulary keeps the candidate grids small
VOCAB = [-1] + [ord(c) for c in " aeiostxz7!."]
CAPTIONS = ["A cat on a mat.", "a dog (in) the park!", "a red car on the road",
            "a bird on a branch", "two boats near the river bank",
            "an old man walks"]


def _pair(seed: int):
    """(JAX params, the port's CLIP module) holding the same weights."""
    params = jclip.init_clip(jax.random.PRNGKey(seed),
                             jconfig.get_model_config(MODEL))
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    module.eval().requires_grad_(False)
    return params, module


@pytest.fixture(scope="module")
def pairs():
    return _pair(0), _pair(1)


@pytest.fixture(scope="module")
def scorers():
    return (JScorer(jconfig.get_model_config(MODEL), bucket=128),
            TScorer(tconfig.get_model_config(MODEL), "cpu", bucket=128))


@pytest.fixture(scope="module")
def toks():
    return jax_tokenizer(), port_tokenizer()


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


# ---------------------------------------------------------------------------
# TextFARE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attack", ["leaf", "charmer", "bruteforce"])
def test_eval_textfare_matches_jax(pairs, scorers, toks, attack, tmp_path):
    (jparams, module), (jclean, clean) = pairs
    samples = [{"text": "stocks rally on strong earnings"},
               {"text": "the match ended in a draw"}, "rain today"]
    want = jtf.eval_textfare(scorers[0], jparams["text"], jclean["text"],
                             toks[0], samples, attack_name=attack, rho=4,
                             vocab=VOCAB, out_csv=str(tmp_path / "jax.csv"),
                             attack_batch=2)
    got = ttf.eval_textfare(scorers[1], module.text, clean.text, toks[1],
                            samples, attack_name=attack, rho=4,
                            vocab=VOCAB, out_csv=str(tmp_path / "torch.csv"),
                            attack_batch=2)
    assert got["n"] == want["n"] == 3
    for key in ("textfare_clean", "textfare_adv"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    jrows, trows = _rows(tmp_path / "jax.csv"), _rows(tmp_path / "torch.csv")
    assert len(trows) == 3
    for t, j in zip(trows, jrows):
        for key in ("textfare_clean", "textfare_adv"):
            np.testing.assert_allclose(float(t.pop(key)), float(j.pop(key)),
                                       rtol=1e-4, atol=1e-6)
        assert t == j
    assert got["textfare_adv"] > got["textfare_clean"]


# ---------------------------------------------------------------------------
# zero-shot text classification
# ---------------------------------------------------------------------------

def _textcls(pkg, order=None):
    samples = [{"text": t, "label": i % 3} for i, t in enumerate(TEXTS)]
    if order is not None:
        samples = [samples[i] for i in order]
    return pkg.from_samples("agnews", samples)


def test_eval_zero_shot_text_matches_jax(pairs, scorers, toks, tmp_path):
    """Image anchors (the anchor asset through both packages' resize)."""
    jparams, module = pairs[0]
    jcfg = jconfig.get_model_config(MODEL)
    ja = jzst.class_anchor_features(
        scorers[0], jparams, toks[0], _textcls(JTextCls), "image",
        jpre.image_transform(64, do_normalize=False), jcfg)
    ta = tzst.class_anchor_features(
        scorers[1], module, toks[1], _textcls(TTextCls), "image",
        tpre.image_transform(64, do_normalize=False))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    want = jzst.eval_zero_shot_text(scorers[0], jparams, toks[0],
                                    _textcls(JTextCls), ja, rho=3, k=2,
                                    out_csv=str(tmp_path / "jax.csv"),
                                    chunk_size=8)
    got = tzst.eval_zero_shot_text(scorers[1], module.text, toks[1],
                                   _textcls(TTextCls), ta, rho=3, k=2,
                                   out_csv=str(tmp_path / "torch.csv"),
                                   chunk_size=8)
    assert got == want and got["n"] == len(TEXTS)
    assert _rows(tmp_path / "torch.csv") == _rows(tmp_path / "jax.csv")


def test_eval_zero_shot_text_order_invariant_across_packages(
        pairs, scorers, toks, tmp_path):
    """The JAX package's rows on the dataset in order, and the port's on
    the dataset in order and reversed: full rows, compared by position."""
    jparams, module = pairs[0]
    n = len(TEXTS)
    jd = _textcls(JTextCls)
    ja = jzst.class_anchor_features(scorers[0], jparams, toks[0], jd, "text")
    want = jzst.eval_zero_shot_text(scorers[0], jparams, toks[0], jd, ja,
                                    rho=3, out_csv=str(tmp_path / "jax.csv"),
                                    chunk_size=2)
    jrows = _rows(tmp_path / "jax.csv")
    for name, order in (("fwd", list(range(n))), ("rev", list(range(n))[::-1])):
        td = _textcls(TTextCls, order)
        ta = tzst.class_anchor_features(scorers[1], module, toks[1], td,
                                        "text")
        got = tzst.eval_zero_shot_text(scorers[1], module.text, toks[1], td,
                                       ta, rho=3,
                                       out_csv=str(tmp_path / f"{name}.csv"),
                                       chunk_size=2)
        assert got == want
        assert _rows(tmp_path / f"{name}.csv") == [jrows[i] for i in order]


def test_zero_shot_text_rows_reach_disk_chunk_by_chunk(
        pairs, scorers, toks, tmp_path, monkeypatch):
    """A run that fails in its second chunk leaves the first chunk's rows
    (the two shortest sentences) in the CSV."""
    module = pairs[0][1]
    attack = tzst.attack_text_charmer_classification_batched
    calls = []

    def attack_once(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("stopped in the second chunk")
        return attack(*args, **kwargs)

    monkeypatch.setattr(tzst, "attack_text_charmer_classification_batched",
                        attack_once)
    td = _textcls(TTextCls)
    ta = tzst.class_anchor_features(scorers[1], module, toks[1], td, "text")
    with pytest.raises(RuntimeError, match="second chunk"):
        tzst.eval_zero_shot_text(scorers[1], module.text, toks[1], td, ta,
                                 rho=3, out_csv=str(tmp_path / "z.csv"),
                                 chunk_size=2)
    rows = _rows(tmp_path / "z.csv")
    assert [r["sentence"] for r in rows] == ["rain", "tax cut"]
    assert list(rows[0]) == tzst.COLUMNS


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

def test_pre_caption_and_evaluate_scores_match_jax():
    for cap in CAPTIONS + ["A Big  CAT!! (on a mat).", " ".join(["w"] * 60),
                           "x;y:z~#*"]:
        assert tret.pre_caption(cap) == jret.pre_caption(cap)
        assert tret.pre_caption(cap, 3) == jret.pre_caption(cap, 3)
    rng = np.random.default_rng(5)
    img2txt = {i: [2 * i, 2 * i + 1] for i in range(6)}
    txt2img = {t: t // 2 for t in range(12)}
    for scores in (rng.standard_normal((6, 12)),
                   np.round(rng.standard_normal((6, 12)), 1)):  # with ties
        assert tret.evaluate_scores(scores, img2txt, txt2img) == \
            jret.evaluate_scores(scores, img2txt, txt2img)


@pytest.mark.parametrize("target", [None, 0])
def test_eval_retrieval_matches_jax(pairs, scorers, toks, target, tmp_path):
    jparams, module = pairs[0]
    captions = [tret.pre_caption(c) for c in CAPTIONS]
    rng = np.random.default_rng(6)
    image_embeds = rng.standard_normal((3, 64)).astype(np.float32)
    image_embeds /= np.linalg.norm(image_embeds, axis=-1, keepdims=True)
    img2txt = {i: [2 * i, 2 * i + 1] for i in range(3)}
    txt2img = {t: t // 2 for t in range(6)}
    np.testing.assert_allclose(
        tret.embed_texts(scorers[1], module.text, toks[1], captions),
        jret.embed_texts(scorers[0], jparams["text"], toks[0], captions),
        atol=1e-5)
    want = jret.eval_retrieval(scorers[0], jparams, toks[0], image_embeds,
                               captions, img2txt, txt2img, target=target,
                               rho=3, out_csv=str(tmp_path / "jax.csv"),
                               attack_batch=4)
    got = tret.eval_retrieval(scorers[1], module.text, toks[1], image_embeds,
                              captions, img2txt, txt2img, target=target,
                              rho=3, out_csv=str(tmp_path / "torch.csv"),
                              attack_batch=4)
    assert got == want
    assert got["adv_captions"] != captions
    assert _rows(tmp_path / "torch.csv") == _rows(tmp_path / "jax.csv")


# ---------------------------------------------------------------------------
# the COCO reader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """Four seeded 48 x 40 images, as PNGs and as .npy arrays, with a
    Karpathy JSON for each and a flickr captions.txt."""
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(8)
    entries = {"png": [], "npy": []}
    for i in range(4):
        img = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / f"{i}.png")
        np.save(root / f"{i}.npy", img)
        caps = [CAPTIONS[(i + j) % len(CAPTIONS)] for j in range(2)]
        for ext in entries:
            entries[ext].append({"image": f"{i}.{ext}", "caption": caps})
    for ext, ann in entries.items():
        with open(root / f"ann_{ext}.json", "w") as f:
            json.dump(ann, f)
    with open(root / "captions.txt", "w") as f:
        f.write("image,caption\n1.jpg,a cat, on a mat\n2.jpg,a dog\n"
                "1.jpg,a red car\nbad.png,skipped\n")
    return root


def test_coco_reader_matches_jax(coco):
    root = str(coco)
    want = jcoco.get_coco_retrieval(root, os.path.join(root, "ann_png.json"),
                                    jpre.image_transform(32, do_normalize=False),
                                    batch_size=3)
    batches = {}
    for ext in ("png", "npy"):
        ds = tcoco.get_coco_retrieval(
            root, os.path.join(root, f"ann_{ext}.json"),
            tpre.image_transform(32, do_normalize=False), batch_size=3)
        assert (ds.text, ds.img2txt, ds.txt2img) == \
            (want.text, want.img2txt, want.txt2img)
        assert len(ds) == 4 and ds.num_batches == 2
        batches[ext] = list(ds.image_batches())
    jb = list(want.image_batches())
    for ext in ("png", "npy"):
        assert [b.shape for b in batches[ext]] == [(3, 32, 32, 3),
                                                   (1, 32, 32, 3)]
        for t, j in zip(batches[ext], jb):
            np.testing.assert_array_equal(t, j)
    raw = tcoco.get_coco_retrieval(root, os.path.join(root, "ann_npy.json"),
                                   None, num_samples=2)
    assert next(iter(raw.image_batches())).dtype == np.uint8 and len(raw) == 2
    txt = os.path.join(root, "captions.txt")
    assert tcoco.load_retrieval_annotations(txt) == \
        jcoco.load_retrieval_annotations(txt)


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def test_the_new_modules_import_no_jax_and_no_pil():
    code = ("import sys\n"
            "import leaf_tpu_torch.attacks, leaf_tpu_torch.data.coco\n"
            "import leaf_tpu_torch.evals.textfare\n"
            "import leaf_tpu_torch.evals.zero_shot_text\n"
            "import leaf_tpu_torch.evals.retrieval\n"
            "import leaf_tpu_torch.profile_charmer\n"
            "import leaf_tpu_torch.attacks.apgd, leaf_tpu_torch.attacks.square\n"
            "import leaf_tpu_torch.train, leaf_tpu_torch.train.fare_driver\n"
            "import leaf_tpu_torch.benchmark.zeroshot_classification\n"
            "import leaf_tpu_torch.evals.imagenet_robust\n"
            "import leaf_tpu_torch.profile_fare\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'leaf_tpu', 'PIL', 'regex', 'optax')))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_profile_charmer_runs_on_cpu():
    out = profile_charmer.main(["--model", MODEL, "--batch", "2", "--words",
                                "3", "--n", "3", "--reps", "1", "--precision",
                                "fp32", "--device", "cpu"])
    assert out["device"] == "cpu" and out["same_sentences"]
    assert out["probes_per_sentence"] > 0 and out["cands_per_sentence"] > 0
    assert sorted(out["phases_fused_path"]) == [
        "p1_grid_encode_ms", "p1_score_ms", "p2_grid_encode_ms",
        "p2_score_ms"]
    assert len(out["phases_string_path"]) == 6


@pytest.mark.parametrize("cli", ["textfare", "zero_shot_text", "retrieval"])
def test_command_line_runs_on_cpu(cli, coco, tmp_path):
    flags = ["--model", MODEL, "--rho", "3", "--device", "cpu"]
    if cli == "textfare":
        out = ttf.main(flags + ["--dataset", "synthetic", "--n_test", "3",
                                "--attack_name", "charmer", "--output-dir",
                                str(tmp_path)])
        assert out["n"] == 3 and out["textfare_adv"] > out["textfare_clean"]
        assert os.listdir(tmp_path) == [
            "ViT-tiny-test_synthetic_charmer_k1_rho_3.csv"]
    elif cli == "zero_shot_text":
        out = tzst.main(flags + ["--dataset", "synthetic", "--n_test", "3",
                                 "--output-dir", str(tmp_path)])
        assert out["n"] == 3 and 0.0 <= out["acc_adv"] <= 1.0
        assert os.listdir(tmp_path) == ["ViT-tiny-test_agnews_k1_rho_3_image.csv"]
    else:
        out_json = str(tmp_path / "r.json")
        out = tret.main(flags + ["--coco-root", str(coco), "--annotation",
                                 str(coco / "ann_npy.json"), "--target", "1",
                                 "--output", out_json])
        with open(out_json) as f:
            assert json.load(f) == out
        assert sorted(out) == ["adv", "clean"]
        assert len(_rows(tmp_path / "r_perturbations.csv")) == 8
    # a registry tag resolves from the local checkpoint cache (ported since
    # this case was written); 'openai' names no file of the tiny model
    extra = ["--coco-root", "x", "--annotation", "y"] * (cli == "retrieval")
    main = {"textfare": ttf, "zero_shot_text": tzst, "retrieval": tret}[cli]
    with pytest.raises(FileNotFoundError, match="registry tag"):
        main.main(flags + ["--pretrained", "openai"] + extra)
