"""leaf_tpu_torch's data layer against the JAX package's, on the CPU.

The same files, written here from a seed (three tar shards with `tarfile`,
a CSV, an image folder of PNGs), go through `leaf_tpu.data` and
`leaf_tpu_torch.data`: the captions come out in the same order for the
same seed and epoch, the image folders give the same paths, labels and
order, and pixels agree to one uint8 level.  The port's numpy bicubic
resize is held to Pillow's, and its anchor-image asset to Pillow's decode
of the JAX package's files.
"""
import io
import os
import sys
import tarfile

import numpy as np
import pytest
from PIL import Image

from leaf_tpu import data as jdata
from leaf_tpu.data import imagenet as jimagenet
from leaf_tpu.data import textcls as jtextcls
from leaf_tpu.data import wds as jwds
from leaf_tpu.models import preprocess as jpre
from leaf_tpu.train import params as jparams
from leaf_tpu_torch import data as tdata
from leaf_tpu_torch.data import anchor_assets
from leaf_tpu_torch.data import common as tcommon
from leaf_tpu_torch.data import csv_data as tcsv
from leaf_tpu_torch.data import imagenet as timagenet
from leaf_tpu_torch.data import textcls as ttextcls
from leaf_tpu_torch.data import wds as twds
from leaf_tpu_torch.models import preprocess as tpre
from leaf_tpu_torch.tokenizer import get_tokenizer
from leaf_tpu_torch.train import params as tparams

WORDS = ("a photo of the small large red blue green dog cat man woman child "
         "car street house tree river beach city park field").split()
PIXEL = 1 / 255 + 1e-6      # one uint8 level, in [0, 1] units


def _captions(rng, n):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 40))))
            for _ in range(n)]


def _png_bytes(rng, h, w) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _write_shards(root, rng, n_shards=3, per_shard=10, images=False):
    for s in range(n_shards):
        with tarfile.open(os.path.join(root, f"{s:03d}.tar"), "w") as tf:
            for i, cap in enumerate(_captions(rng, per_shard)):
                members = [("txt", cap.encode())]
                if images:
                    members.append(("png", _png_bytes(rng, 40 + i, 50)))
                for ext, payload in members:
                    info = tarfile.TarInfo(f"s{s}_{i:04d}.{ext}")
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
    return os.path.join(root, "{000..%03d}.tar" % (n_shards - 1))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Tar shards (captions only, and captions with PNGs), a CSV over PNG
    files and an ImageNet-style folder of PNGs of several sizes."""
    root = str(tmp_path_factory.mktemp("data"))
    rng = np.random.default_rng(0)
    out = {"root": root}
    os.makedirs(os.path.join(root, "text"))
    out["tars"] = _write_shards(os.path.join(root, "text"), rng)
    os.makedirs(os.path.join(root, "img_tars"))
    out["img_tars"] = _write_shards(os.path.join(root, "img_tars"), rng,
                                    per_shard=4, images=True)
    os.makedirs(os.path.join(root, "csv"))
    rows = []
    for i, cap in enumerate(_captions(rng, 12)):
        name = f"im{i}.png"
        with open(os.path.join(root, "csv", name), "wb") as f:
            f.write(_png_bytes(rng, 30, 36))
        rows.append(f"{name}\t{cap}")
    out["csv"] = os.path.join(root, "csv", "train.csv")
    with open(out["csv"], "w") as f:
        f.write("filepath\ttitle\n" + "\n".join(rows) + "\n")
    out["folder"] = os.path.join(root, "imagenet")
    for c, cls in enumerate(("n01", "n02", "n03")):
        os.makedirs(os.path.join(out["folder"], cls))
        for i in range(4 + c):
            with open(os.path.join(out["folder"], cls, f"{i}.png"), "wb") as f:
                f.write(_png_bytes(rng, 24 + 7 * i, 40 - 3 * c))
    return out


def _length_fn():
    tok = get_tokenizer()
    return lambda text: min(len(tok.encode(text)) + 2, tok.context_length)


def _epochs(ds, n=2):
    """Captions of the first `n` epochs, batch by batch."""
    return [[list(texts) for _, texts in ds] for _ in range(n)]


# ---------------------------------------------------------------------------
# webdataset tars
# ---------------------------------------------------------------------------

def _corrupt(pattern):
    """Break the header checksum of a member in the middle of shard 001:
    reading stops there, and the samples before it stay."""
    path = jwds.expand_urls(pattern)[1]
    with tarfile.open(path) as tf:
        bad = tf.getmembers()[6]
    with open(path, "r+b") as f:
        f.seek(bad.offset)
        f.write(b"X")
    with tarfile.open(path) as tf:
        assert len(tf.getmembers()) == 6


@pytest.mark.parametrize("case", ["plain", "bucket_by_length", "resampled",
                                  "two_hosts", "corrupt_member"])
def test_wds_yields_the_jax_captions(files, tmp_path, case):
    urls = files["tars"]
    kw = dict(batch_size=4, seed=3, num_samples=28, text_only=True,
              sample_shuffle_size=7)
    if case == "bucket_by_length":
        kw.update(bucket_by_length=True, length_fn=_length_fn())
    elif case == "resampled":
        shards = jwds.expand_urls(urls)
        urls = f"{shards[0]}::{shards[1]}"
        kw.update(resampled=True, upsampling_factors=[1.0, 3.0])
    elif case == "two_hosts":
        kw.update(process_index=1, process_count=2)
    elif case == "corrupt_member":
        _write_shards(str(tmp_path), np.random.default_rng(5))
        urls = os.path.join(str(tmp_path), "{000..002}.tar")
        _corrupt(urls)
    want = _epochs(jwds.WdsDataset(jwds.WdsConfig(urls=urls, **kw)))
    got = _epochs(twds.WdsDataset(twds.WdsConfig(urls=urls, **kw)))
    assert got == want
    assert len(got[0]) == kw["num_samples"] // (
        kw["batch_size"] * kw.get("process_count", 1)) + (
            case == "two_hosts")   # 28 / 8 rounds up to 4 batches
    assert got[0] != got[1]        # the epochs reshuffle


def test_wds_images_match_the_jax_pipeline(files):
    kw = dict(batch_size=3, seed=1, num_samples=9, workers=2)
    want = list(jwds.WdsDataset(jwds.WdsConfig(urls=files["img_tars"], **kw),
                                jpre.image_transform(32, do_normalize=False)))
    got = list(twds.WdsDataset(twds.WdsConfig(urls=files["img_tars"], **kw),
                               tpre.image_transform(32, do_normalize=False)))
    assert [t for _, t in got] == [t for _, t in want]
    for (gi, _), (wi, _) in zip(got, want):
        assert gi.shape == wi.shape == (3, 32, 32, 3)
        np.testing.assert_allclose(gi, wi, rtol=0, atol=PIXEL)


def test_expand_urls_and_helpers_match_jax():
    for spec in ("a-{000..003}.tar", "x_{0..2}_{a,b}.tar::y.tar",
                 "{train,val}-{00..01}.tar", ["p.tar", "q.tar"]):
        assert twds.expand_urls(spec) == jwds.expand_urls(spec)
    assert twds.expand_urls_with_weights("a{0..1}::b", "1::2") == \
        jwds.expand_urls_with_weights("a{0..1}::b", "1::2")
    for path in ("dir/x.tar.txt", "y.jpg", ".hidden", "d/a.b/c.png"):
        assert twds.base_plus_ext(path) == jwds.base_plus_ext(path)
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(1, 80, 40)]
    assert list(tcommon.bucket_batches(iter(lens), 4, int, (16, 32, 77))) == \
        list(jdata.common.bucket_batches(iter(lens), 4, int, (16, 32, 77)))


def test_wds_pipe_urls_and_errors(files):
    shard = jwds.expand_urls(files["tars"])[0]
    cfg = dict(batch_size=5, is_train=False, text_only=True)
    got = [t for _, t in twds.WdsDataset(
        twds.WdsConfig(urls=f"pipe:cat {shard}", **cfg))]
    assert got == [t for _, t in jwds.WdsDataset(
        jwds.WdsConfig(urls=shard, **cfg))]
    with pytest.raises(ValueError, match="upsampling"):
        twds.WdsDataset(twds.WdsConfig(urls="a::b", upsampling_factors=[1, 2]))
    with pytest.raises(ValueError, match="one upsampling factor"):
        twds.expand_urls_with_weights("a::b", "1")


def test_decode_without_pillow_raises_by_name(monkeypatch):
    sample = {"__key__": "k", "txt": b"a cat", "png": b"not a png"}
    assert twds.decode_sample(sample, None, text_only=True) == \
        {"image": None, "text": "a cat"}
    assert twds.decode_sample(sample, None) is None      # undecodable: skip
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        twds.decode_sample(sample, None)
    with pytest.raises(ImportError, match="Pillow"):
        tpre.read_image("x.png")
    assert twds.decode_sample(sample, None, text_only=True)["text"] == "a cat"


# ---------------------------------------------------------------------------
# CSV and get_data's train branch
# ---------------------------------------------------------------------------

def test_csv_yields_the_jax_captions(files):
    kw = dict(batch_size=4, seed=2, shuffle=True, drop_last=True)
    want = _epochs(jdata.CsvDataset(
        files["csv"], jpre.image_transform(16), **kw))
    got = _epochs(tcsv.CsvDataset(files["csv"], None, text_only=True, **kw))
    assert got == want and got[0] != got[1]
    two = dict(kw, process_index=1, process_count=2)
    assert _epochs(tcsv.CsvDataset(files["csv"], None, text_only=True, **two)) \
        == _epochs(jdata.CsvDataset(files["csv"], jpre.image_transform(16),
                                    **two))
    # with images: the port reads them (numpy resize) as the JAX package
    # does with Pillow
    jimg = next(iter(jdata.CsvDataset(files["csv"],
                                      jpre.image_transform(16), **kw)))
    timg = next(iter(tcsv.CsvDataset(files["csv"],
                                     tpre.image_transform(16), **kw)))
    np.testing.assert_allclose(timg[0], jimg[0], rtol=0, atol=1e-5)


def _args(pkg, flags):
    return pkg.parse_args(["--model", "ViT-tiny-test", "--seed", "4"] + flags)


@pytest.mark.parametrize("flags", [
    ["--dataset-type", "webdataset", "--train-num-samples", "24",
     "--batch-size", "4"],
    ["--dataset-type", "auto", "--train-num-samples", "24", "--batch-size",
     "4", "--bucket-by-length"],
    ["--dataset-type", "csv", "--batch-size", "4"],
], ids=["webdataset", "auto_bucketed", "csv"])
def test_get_data_train_branch_matches_jax(files, flags):
    data_flag = files["csv"] if "csv" in flags else files["tars"]
    flags = flags + ["--train-data", data_flag]
    want = jdata.get_data(_args(jparams, flags), jpre.image_transform(16),
                          text_only=True)["train"]
    got = tdata.get_data(_args(tparams, flags), tpre.image_transform(16),
                         text_only=True)["train"]
    assert (got.num_batches, got.num_samples) == \
        (want.num_batches, want.num_samples)
    assert _epochs(got.loader) == _epochs(want.loader)


def test_get_data_eval_sets_match_jax(files):
    flags = ["--dataset-type", "synthetic", "--imagenet-val", files["folder"],
             "--imagenet-v2", files["folder"], "--n_val_imagenet", "9",
             "--val-text-classification", "synthetic", "--n_val_text", "7",
             "--batch-size", "4"]
    want = jdata.get_data(_args(jparams, flags), jpre.image_transform(16))
    got = tdata.get_data(_args(tparams, flags), tpre.image_transform(16))
    assert sorted(got) == sorted(want)
    for key in ("imagenet-val", "imagenet-v2"):
        assert list(got[key].loader.paths) == list(want[key].loader.paths)
        assert list(got[key].loader.labels) == list(want[key].loader.labels)
    for key in ("train-agnews", "train-sst2"):
        g, w = got[key], want[key]
        assert (g.samples, g.captions, g.template, sorted(g.vocab)) == \
            (w.samples, w.captions, w.template, sorted(w.vocab))
        pre_t = tpre.image_transform(32, do_normalize=False)
        pre_j = jpre.image_transform(32, do_normalize=False)
        np.testing.assert_allclose(g.anchor_images(pre_t),
                                   w.anchor_images(pre_j), rtol=0, atol=PIXEL)
    # --val-data: the tars in order, through `preprocess_val`
    flags = ["--val-data", files["img_tars"], "--batch-size", "4"]
    want = jdata.get_data(_args(jparams, flags), None,
                          preprocess_val=jpre.image_transform(16))["val"]
    got = tdata.get_data(_args(tparams, flags), None,
                         preprocess_val=tpre.image_transform(16))["val"]
    assert got.num_samples == want.num_samples
    pairs = list(zip(got.loader, want.loader))
    assert len(pairs) == 3
    for (gi, gt), (wi, wt) in pairs:
        assert list(gt) == list(wt)
        np.testing.assert_allclose(gi, wi, rtol=0, atol=PIXEL)


def test_hub_text_classification_needs_datasets(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        ttextcls.get_text_classification_dataset("agnews", 8)
    with pytest.raises(KeyError, match="unknown"):
        ttextcls.get_text_classification_dataset("nope", 8)
    assert ttextcls.char_vocabulary(["ab", "bc"]) == \
        jtextcls.char_vocabulary(["ab", "bc"])


# ---------------------------------------------------------------------------
# image folders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_random=8, seed=1),
    dict(shuffle=True, seed=2, process_index=1, process_count=2),
    dict(subsample_per_class=2, seed=3, shuffle=True),
], ids=["val_subset", "shuffled_two_hosts", "per_class"])
def test_image_folder_matches_jax(files, kw):
    pre = dict(image_size=20, do_normalize=False)
    want = jimagenet.ImageFolderDataset(
        files["folder"], jpre.image_transform(**pre), batch_size=3, **kw)
    got = timagenet.ImageFolderDataset(
        files["folder"], tpre.image_transform(**pre), batch_size=3, **kw)
    assert got.classes == want.classes
    assert list(got.paths) == list(want.paths)
    assert list(got.labels) == list(want.labels)
    for _ in range(2):
        batches = list(zip(got, want))
        assert len(batches) == want.num_batches
        for (gi, gl), (wi, wl) in batches:
            assert list(gl) == list(wl)
            np.testing.assert_allclose(gi, wi, rtol=0, atol=PIXEL)


def test_image_folder_reads_arrays(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {}
    for cls in ("b", "a"):
        os.makedirs(tmp_path / cls)
        for i in range(2):
            a = rng.integers(0, 256, (30 + i, 26, 3), dtype=np.uint8)
            np.save(tmp_path / cls / f"{i}.npy", a)
            arrays[(cls, i)] = a
    info = timagenet.get_imagenet(str(tmp_path), tpre.image_transform(
        24, do_normalize=False), batch_size=4, n_val=None)
    assert [os.path.relpath(p, tmp_path) for p in info.loader.paths] == \
        ["a/0.npy", "a/1.npy", "b/0.npy", "b/1.npy"]
    images, labels = next(iter(info.loader))
    assert list(labels) == [0, 0, 1, 1]
    want = np.asarray(Image.fromarray(arrays[("b", 1)]).resize(
        (24, round(31 * 24 / 26)), Image.BICUBIC), np.float32) / 255
    np.testing.assert_array_equal(images[3], tpre.center_crop(want, 24))


# ---------------------------------------------------------------------------
# the numpy bicubic resize and the anchor asset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,size", [
    ((60, 45), (30, 40)), ((60, 45), (90, 120)), ((31, 200), (7, 5)),
    ((224, 224), (224, 224)), ((17, 33), (224, 113)), ((500, 333), (224, 336)),
])
def test_bicubic_resize_equals_pillow(shape, size):
    a = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(a).resize(size, Image.BICUBIC))
    got = tpre.resample_bicubic(a, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_anchor_asset_equals_pillow_and_resizes_as_pillow():
    decoded = anchor_assets.decode_sources()
    with np.load(ttextcls.ANCHOR_NPZ) as f:
        assert sorted(f.files) == anchor_assets.anchor_names()
        for name in f.files:
            np.testing.assert_array_equal(f[name], decoded[name])
    for name, arr in decoded.items():
        h, w = arr.shape[:2]
        short = 224
        size = ((short, round(h * short / w)) if w < h
                else (round(w * short / h), short))
        want = np.asarray(Image.fromarray(arr).resize(size, Image.BICUBIC))
        got = tpre.resize_shorter(arr, short)
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1, name
    # the shortcut: a shorter side of the size already is left as it is
    a = decoded["Negative.png"]
    assert tpre.resize_shorter(a, a.shape[0]) is a


def test_image_transform_matches_jax_and_refuses_other_modes():
    rng = np.random.default_rng(3)
    for shape in ((50, 70, 3), (90, 40, 3), (32, 32, 4), (41, 29)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        for norm in (True, False):
            np.testing.assert_allclose(
                tpre.image_transform(32, do_normalize=norm)(a),
                jpre.image_transform(32, do_normalize=norm)(a),
                rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="resize_mode"):
        tpre.image_transform(32, resize_mode="squash")
    with pytest.raises(NotImplementedError, match="interpolation"):
        tpre.image_transform(32, interpolation="bilinear")

