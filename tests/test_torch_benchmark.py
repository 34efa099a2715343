"""leaf_tpu_torch's benchmark suite against the JAX package's, in fp32 on
the CPU at ViT-tiny-test.

Every dataset layout the builder knows is written once (PNG, JPEG and PPM
images, CIFAR pickles, MNIST idx, `.mat` files, HDF5, CSV, VOC XML, tars,
TFRecords) and read by both packages' `build_dataset`: the same task,
class names, templates, labels and pixels.  One set of JAX-initialised
weights goes to both packages (the port's copy by way of
`interop.params_from_jax`, the command lines' by one OpenCLIP checkpoint
written from it).  Held: each `evaluate_*` gives the JAX function's
metrics exactly (they are counts), the linear probe its loss to 1e-4 from
the same initial weight with the same predictions; `cli eval` the JAX
command line's JSON, `build` its CSV byte for byte, `reformat` its table
where pandas keeps every row; BLEU-4 and CIDEr-D the JAX values; the
paths not ported raise by name.
"""
import gzip
import io
import json
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from leaf_tpu.benchmark import builder as jbld
from leaf_tpu.benchmark import captioning as jcap
from leaf_tpu.benchmark import cli as jcli
from leaf_tpu.benchmark import image_caption_selection as jics
from leaf_tpu.benchmark import linear_probe as jlp
from leaf_tpu.benchmark import model_collection as jmc
from leaf_tpu.benchmark import tfds_datasets as jtfds
from leaf_tpu.benchmark import zeroshot_classification as jzsc
from leaf_tpu.benchmark import zeroshot_retrieval as jzsr
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import preprocess as jpre
from leaf_tpu.tokenizer import get_tokenizer as jax_tokenizer
from leaf_tpu_torch.benchmark import builder as tbld
from leaf_tpu_torch.benchmark import captioning as tcap
from leaf_tpu_torch.benchmark import cli as tcli
from leaf_tpu_torch.benchmark import image_caption_selection as tics
from leaf_tpu_torch.benchmark import linear_probe as tlp
from leaf_tpu_torch.benchmark import model_collection as tmc
from leaf_tpu_torch.benchmark import tfds_datasets as ttfds
from leaf_tpu_torch.benchmark import zeroshot_classification as tzsc
from leaf_tpu_torch.benchmark import zeroshot_retrieval as tzsr
from leaf_tpu_torch.convert import params_to_openclip, save_state_dict
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import preprocess as tpre
from leaf_tpu_torch.tokenizer import get_tokenizer as port_tokenizer

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
SIZE = 24             # pixels of the written images
READ_SIZE = 32        # the readers' tests resize to this


# ---------------------------------------------------------------------------
# the dataset layouts
# ---------------------------------------------------------------------------

def _arr(rng, h=SIZE, w=SIZE):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _save(path, rng, fmt=None, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(_arr(rng, **kw)).save(path, format=fmt)


def _png(rng):
    buf = io.BytesIO()
    Image.fromarray(_arr(rng)).save(buf, format="PNG")
    return buf.getvalue()


def _folder(root, rng, classes, per_class=2, ext="png"):
    for c in classes:
        for i in range(per_class):
            _save(os.path.join(root, c, f"{i}.{ext}"), rng)


def _cifar(root, rng, n_classes):
    if n_classes == 10:
        d = os.path.join(root, "cifar-10-batches-py")
        files, meta = ["test_batch"], "batches.meta"
        keys = (b"labels", b"label_names")
    else:
        d = os.path.join(root, "cifar-100-python")
        files, meta = ["test"], "meta"
        keys = (b"fine_labels", b"fine_label_names")
    os.makedirs(d)
    for fn in files:
        with open(os.path.join(d, fn), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (5, 3072),
                                               dtype=np.uint8),
                         keys[0]: [int(x) for x in rng.integers(0, n_classes,
                                                                5)]}, f)
    with open(os.path.join(d, meta), "wb") as f:
        pickle.dump({keys[1]: [f"class{i}".encode()
                               for i in range(n_classes)]}, f)


def _mnist(root, rng):
    d = os.path.join(root, "MNIST", "raw")
    os.makedirs(d)
    imgs = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    with gzip.open(os.path.join(d, "t10k-images-idx3-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">IIII", 0x803, 5, 28, 28) + imgs.tobytes())
    with gzip.open(os.path.join(d, "t10k-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">II", 0x801, 5)
                + np.array([1, 0, 7, 7, 3], np.uint8).tobytes())


def _svhn(root, rng):
    from scipy.io import savemat
    os.makedirs(root)
    savemat(os.path.join(root, "test_32x32.mat"),
            {"X": rng.integers(0, 256, (32, 32, 3, 5), dtype=np.uint8),
             "y": np.array([[10], [1], [2], [10], [9]], np.uint8)})


def _stl10(root, rng):
    d = os.path.join(root, "stl10_binary")
    os.makedirs(d)
    rng.integers(0, 256, (3, 3, 96, 96), dtype=np.uint8).tofile(
        os.path.join(d, "test_X.bin"))
    np.array([1, 10, 4], np.uint8).tofile(os.path.join(d, "test_y.bin"))
    with open(os.path.join(d, "class_names.txt"), "w") as f:
        f.write("\n".join(f"thing{i}" for i in range(10)) + "\n")


def _food101(root, rng):
    d = os.path.join(root, "food-101")
    table = {"apple_pie": ["apple_pie/1", "apple_pie/2"], "sushi": ["sushi/9"]}
    os.makedirs(os.path.join(d, "meta"))
    with open(os.path.join(d, "meta", "test.json"), "w") as f:
        json.dump(table, f)
    for rels in table.values():
        for rel in rels:
            _save(os.path.join(d, "images", rel + ".jpg"), rng, "JPEG")


def _dtd(root, rng):
    d = os.path.join(root, "dtd")
    rels = ["banded/b_1.jpg", "zigzagged/z_2.jpg", "banded/b_3.jpg"]
    os.makedirs(os.path.join(d, "labels"))
    with open(os.path.join(d, "labels", "test1.txt"), "w") as f:
        f.write("\n".join(rels) + "\n")
    for rel in rels:
        _save(os.path.join(d, "images", rel), rng, "JPEG")


def _pets(root, rng):
    os.makedirs(os.path.join(root, "annotations"))
    lines = ["#comment", "Abyssinian_1 1 1 1", "great_pyrenees_4 2 2 1"]
    with open(os.path.join(root, "annotations", "test.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for stem in ("Abyssinian_1", "great_pyrenees_4"):
        _save(os.path.join(root, "images", stem + ".jpg"), rng, "JPEG")


def _flowers(root, rng):
    from scipy.io import savemat
    d = os.path.join(root, "flowers-102")
    os.makedirs(d)
    savemat(os.path.join(d, "imagelabels.mat"),
            {"labels": np.array([[1, 5, 102]])})
    savemat(os.path.join(d, "setid.mat"),
            {"trnid": np.array([[1]]), "valid": np.array([[2]]),
             "tstid": np.array([[2, 3]])})
    for i in (1, 2, 3):
        _save(os.path.join(d, "jpg", f"image_{i:05d}.jpg"), rng, "JPEG")


def _fgvc(root, rng):
    d = os.path.join(root, "fgvc-aircraft-2013b", "data")
    os.makedirs(d)
    with open(os.path.join(d, "variants.txt"), "w") as f:
        f.write("707-320\nA300B4\nDC-3\n")
    with open(os.path.join(d, "images_variant_test.txt"), "w") as f:
        f.write("0001 DC-3\n0002 707-320\n")
    for i in ("0001", "0002"):
        _save(os.path.join(d, "images", i + ".jpg"), rng, "JPEG")


def _gtsrb(root, rng):
    d = os.path.join(root, "gtsrb")
    img_dir = os.path.join(d, "GTSRB", "Final_Test", "Images")
    os.makedirs(img_dir)
    with open(os.path.join(d, "GT-final_test.csv"), "w") as f:
        f.write("Filename;Width;ClassId\n00000.ppm;24;7\n00001.ppm;24;42\n")
    for fn in ("00000.ppm", "00001.ppm"):
        _save(os.path.join(img_dir, fn), rng, "PPM")


def _pcam(root, rng):
    import h5py
    os.makedirs(root)
    with h5py.File(os.path.join(
            root, "camelyonpatch_level_2_split_test_x.h5"), "w") as f:
        f["x"] = rng.integers(0, 256, (3, 96, 96, 3), dtype=np.uint8)
    with h5py.File(os.path.join(
            root, "camelyonpatch_level_2_split_test_y.h5"), "w") as f:
        f["y"] = np.array([0, 1, 1], np.uint8).reshape(3, 1, 1, 1)


def _fer(root, rng):
    d = os.path.join(root, "fer2013")
    os.makedirs(d)
    rows = [f"{e},{' '.join(str(v) for v in rng.integers(0, 256, 48 * 48))}"
            for e in (3, 0, 6)]
    with open(os.path.join(d, "test.csv"), "w") as f:
        f.write("emotion,pixels\n" + "\n".join(rows) + "\n")


def _sun397(root, rng):
    d = os.path.join(root, "SUN397")
    rels = ["/a/abbey", "/t/tent/outdoor"]
    os.makedirs(d)
    with open(os.path.join(d, "ClassName.txt"), "w") as f:
        f.write("\n".join(rels) + "\n")
    for rel in rels:
        _save(os.path.join(d, rel.lstrip("/"), "sun_1.jpg"), rng, "JPEG")


def _voc(root, rng):
    d = os.path.join(root, "VOCdevkit", "VOC2007")
    objects = {"000001": [("dog", (1, 1, 20, 20)), ("person", (5, 4, 30, 26))],
               "000002": [("cat", (2, 2, 18, 23))]}
    os.makedirs(os.path.join(d, "Annotations"))
    os.makedirs(os.path.join(d, "ImageSets", "Main"))
    with open(os.path.join(d, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(objects) + "\n")
    for image_id, objs in objects.items():
        _save(os.path.join(d, "JPEGImages", image_id + ".jpg"), rng, "JPEG")
        parts = "".join(
            f"<object><name>{c}</name><bndbox><xmin>{b[0]}</xmin>"
            f"<ymin>{b[1]}</ymin><xmax>{b[2]}</xmax><ymax>{b[3]}</ymax>"
            f"</bndbox></object>" for c, b in objs)
        with open(os.path.join(d, "Annotations", image_id + ".xml"),
                  "w") as f:
            f.write(f"<annotation>{parts}</annotation>")


def _objectnet(root, rng):
    os.makedirs(os.path.join(root, "mappings"))
    with open(os.path.join(root, "mappings",
                           "folder_to_objectnet_label.json"), "w") as f:
        json.dump({"chair_dir": "Chair", "banana_dir": "Banana",
                   "weird_dir": "Weird Thing"}, f)
    with open(os.path.join(root, "mappings",
                           "objectnet_to_imagenet_1k.json"), "w") as f:
        json.dump({"Chair": "folding chair", "Banana": "banana"}, f)
    _folder(os.path.join(root, "objectnet-1.0", "images"), rng,
            ("chair_dir", "banana_dir", "weird_dir"), per_class=1)


def _wds(root, rng):
    os.makedirs(os.path.join(root, "test"))
    with tarfile.open(os.path.join(root, "test", "test-0000.tar"), "w") as tf:
        for i in range(5):
            for ext, data in (("png", _png(rng)), ("cls", str(i % 2).encode())):
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    with open(os.path.join(root, "classnames.txt"), "w") as f:
        f.write("zero\none\n")


def _tfds(root, rng, tfds_name, split, examples):
    d = os.path.join(root, tfds_name, "3.0.0")
    os.makedirs(d)
    jtfds.write_tfrecord(
        os.path.join(d, f"{tfds_name}-{split}.tfrecord-00000-of-00001"),
        [jtfds.encode_example(e) for e in examples])


def _resisc(root, rng):
    _tfds(root, rng, "resisc45", "train",
          [{"image": [_png(rng)], "label": [i % 45]} for i in range(10)])


def _clevr(root, rng):
    _tfds(root, rng, "clevr", "validation",
          [{"image": [_png(rng)], "objects/size": [0] * (3 + i),
            "objects/pixel_coords": [1.0, 2.0, 8.0 + i / 2] * (3 + i)}
           for i in range(4)])


def _wnid(root, rng, which):
    wnids = jbld.load_imagenet_wnids()[which]
    _folder(root, rng, wnids[:3], per_class=1)


def _retrieval(root, rng):
    ann = []
    for i in range(4):
        _save(os.path.join(root, f"{i}.png"), rng)
        ann.append({"image": f"{i}.png",
                    "caption": [f"A photo, number {i}!", f"caption two {i}"]})
    with open(os.path.join(root, "karpathy.json"), "w") as f:
        json.dump(ann, f)


def _sugar(root, rng):
    ann = {}
    for i in range(3):
        _save(os.path.join(root, "images", f"{i}.png"), rng)
        ann[str(i)] = {"filename": f"{i}.png", "caption": f"a dog number {i}",
                       "negative_caption": f"a cat number {i}"}
    with open(os.path.join(root, "add_att.json"), "w") as f:
        json.dump(ann, f)


# name -> (writer, build_dataset keywords)
LAYOUTS = {
    "cifar10": (lambda r, g: _cifar(r, g, 10), {}),
    "cifar100": (lambda r, g: _cifar(r, g, 100), {}),
    "mnist": (_mnist, {}),
    "svhn": (_svhn, {}),
    "stl10": (_stl10, {}),
    "food101": (_food101, {}),
    "dtd": (_dtd, {}),
    "pets": (_pets, {}),
    "flowers": (_flowers, {}),
    "fgvc_aircraft": (_fgvc, {}),
    "gtsrb": (_gtsrb, {}),
    "pcam": (_pcam, {}),
    "fer2013": (_fer, {}),
    "eurosat": (lambda r, g: _folder(os.path.join(r, "2750"), g,
                                     ("Annual_Crop", "Forest")), {}),
    "country211": (lambda r, g: _folder(
        os.path.join(r, "country211", "test"), g, ("AD", "FR")), {}),
    "renderedsst2": (lambda r, g: _folder(
        os.path.join(r, "rendered-sst2", "test"), g, ("negative",
                                                      "positive")), {}),
    "sun397": (_sun397, {}),
    "caltech101": (lambda r, g: _folder(os.path.join(
        r, "caltech101", "101_ObjectCategories"), g, ("accordion", "ant")),
        {}),
    "voc2007": (_voc, {}),
    "voc2007_multilabel": (_voc, {}),
    "objectnet": (_objectnet, {}),
    "wds/mytest": (_wds, {}),
    "resisc45": (_resisc, {}),
    "clevr_count_all": (_clevr, {}),
    "imagenet-a": (lambda r, g: _wnid(r, g, "imagenet-a"), {}),
    "imagenet1k": (lambda r, g: _wnid(r, g, "all"), {"language": "de"}),
    "imagenetv2": (lambda r, g: _folder(r, g, ("0", "2", "10"), 1), {}),
    "imagefolder": (lambda r, g: _folder(r, g, ("cat", "dog")), {}),
    "mscoco_captions": (_retrieval, {}),
    "sugar_crepe/add_att": (_sugar, {}),
}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    base = tmp_path_factory.mktemp("layouts")
    rng = np.random.default_rng(0)
    roots = {}
    for name, (write, _) in LAYOUTS.items():
        root = str(base / name.replace("/", "-"))
        write(root, rng)
        roots[name] = root
    return roots


def _both(name, root, **kw):
    kw = {"split": "test", "batch_size": 2, **kw}
    if name == "mscoco_captions":
        kw["annotation_file"] = os.path.join(root, "karpathy.json")
    return (jbld.build_dataset(name, root, jpre.image_transform(
                READ_SIZE, do_normalize=False), **kw),
            tbld.build_dataset(name, root, tpre.image_transform(
                READ_SIZE, do_normalize=False), **kw))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_build_dataset_matches_jax(layouts, name):
    """Task, class names, templates, labels and pixels of every layout."""
    (jds, jtask, jcls, jtpl), (tds, ttask, tcls, ttpl) = _both(
        name, layouts[name], **LAYOUTS[name][1])
    assert ttask == jtask and tcls == jcls
    if jtpl is not None:
        assert [f("red fox") for f in ttpl] == [f("red fox") for f in jtpl]
    if ttask == "zeroshot_retrieval":
        assert tds.text == jds.text and tds.img2txt == jds.img2txt
        jb, tb = list(jds.image_batches()), list(tds.image_batches())
    else:
        jb, tb = list(jds), list(tds)
    assert len(tb) == len(jb) > 0
    for (ti, tl), (ji, jl) in (zip(tb, jb) if ttask != "zeroshot_retrieval"
                               else (((t, 0), (j, 0))
                                     for t, j in zip(tb, jb))):
        np.testing.assert_allclose(ti, ji, atol=1e-6)
        if ttask == "image_caption_selection":
            assert tl == jl
        else:
            np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("language", ["en", "cn", "it", "jp", "ar", "de"])
def test_classnames_and_templates_every_language(language):
    for name in ("imagenet1k", "cifar10", "flowers", "imagenetv2"):
        j = jbld.classnames_and_templates(name, language,
                                          fallback_classes=["a", "b"])
        t = tbld.classnames_and_templates(name, language,
                                          fallback_classes=["a", "b"])
        assert t[0] == j[0]
        assert [f("x") for f in t[1]] == [f("x") for f in j[1]]


def test_tables_and_collections():
    assert tbld.DATASET_COLLECTIONS == jbld.DATASET_COLLECTIONS
    assert tbld.load_imagenet_wnids() == jbld.load_imagenet_wnids()
    for name in ("sugar_crepe/x", "wds/flickr30k", "cifar10"):
        assert tbld.get_dataset_default_task(name) \
            == jbld.get_dataset_default_task(name)
    assert tmc.MODEL_COLLECTIONS == jmc.MODEL_COLLECTIONS
    for spec in (["openai"], ["ViT-B-32"], ["ViT-L-14,fare2", "leaf"]):
        assert tmc.expand_models(spec, "p") == jmc.expand_models(spec, "p")


def test_model_collection_file_and_registry(tmp_path):
    f = tmp_path / "models.txt"
    f.write_text("# comment\nViT-B-32,laion2b\n\nRN50\n")
    assert tmc.expand_models([str(f)]) == jmc.expand_models([str(f)]) \
        == [("ViT-B-32", "laion2b"), ("RN50", "")]
    # the pretrained registry is ported since this case was written:
    # openclip_all enumerates it (tests/test_torch_pretrained.py)
    assert tmc.expand_models(["openclip_all"]) == jmc.expand_models(
        ["openclip_all"])


def test_tfrecord_codec_matches_jax(tmp_path):
    ex = {"image": [b"\x89PNGxx"], "label": [7], "neg": [-3],
          "objects/pixel_coords": [1.5, 2.5, 9.25]}
    assert ttfds.encode_example(ex) == jtfds.encode_example(ex)
    assert ttfds.parse_example(jtfds.encode_example(ex)) \
        == jtfds.parse_example(jtfds.encode_example(ex))
    for data in (b"", b"123456789", bytes(range(256))):
        assert ttfds.crc32c(data) == jtfds.crc32c(data)
    recs = [b"alpha", b"beta" * 50, b""]
    ttfds.write_tfrecord(str(tmp_path / "t"), recs)
    jtfds.write_tfrecord(str(tmp_path / "j"), recs)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    assert list(ttfds.iter_tfrecords(str(tmp_path / "j"))) == recs
    for spec in ("train", "train[80%:]", "test[:50%]", "train[800:]"):
        assert ttfds.parse_split_spec(spec) == jtfds.parse_split_spec(spec)


def test_vtab_label_derivations_match_jax():
    assert set(ttfds.VTAB_TFDS) == set(jtfds.VTAB_TFDS)
    rng = np.random.default_rng(3)
    for _ in range(5):
        n = int(rng.integers(3, 11))
        ex = {"objects/size": [0] * n, "label": [int(rng.integers(0, 9))],
              "label_orientation": [2], "label_x_position": [5],
              "label_azimuth": [4], "label_elevation": [1],
              "objects/pixel_coords": list(rng.uniform(0, 12, 3 * n)),
              "objects/type": list(rng.integers(0, 6, n)),
              "objects/location": list(rng.uniform(-5, 40, 3 * n))}
        for name, spec in ttfds.VTAB_TFDS.items():
            js = jtfds.VTAB_TFDS[name]
            assert (spec.tfds_name, spec.test_split, spec.train_split,
                    spec.num_classes) == (js.tfds_name, js.test_split,
                                          js.train_split, js.num_classes)
            assert spec.label_fn(ex) == js.label_fn(ex)


def test_missing_layouts_raise(tmp_path):
    pre = tpre.image_transform(READ_SIZE, do_normalize=False)
    with pytest.raises(FileNotFoundError, match="torchvision-native"):
        tbld.build_dataset("food101", str(tmp_path), pre)
    with pytest.raises(FileNotFoundError, match="tfds layout"):
        tbld.build_dataset("dmlab", str(tmp_path), pre)
    with pytest.raises(FileNotFoundError, match="devkit"):
        tbld.build_dataset("voc2007", str(tmp_path), pre)
    with pytest.raises(ValueError, match="annotation-file"):
        tbld.build_dataset("flickr30k", str(tmp_path), pre)


# ---------------------------------------------------------------------------
# the evaluations, one set of weights in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    params = jclip.init_clip(jax.random.PRNGKey(0),
                             jconfig.get_model_config(MODEL))
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    module.eval().requires_grad_(False)
    return params, module


@pytest.fixture(scope="module")
def toks():
    return jax_tokenizer(), port_tokenizer()


def _images(seed, n):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 64, 64, 3)).astype(np.float32)


CLASSES = ["cat", "dog", "red car", "tree", "boat", "bird"]


def _batches(seed=1, n=8, bs=4):
    labels = np.random.default_rng(seed).integers(0, len(CLASSES), n)
    images = _images(seed, n)
    return [(images[i:i + bs], labels[i:i + bs]) for i in range(0, n, bs)]


@pytest.mark.parametrize("attack", [None, "apgd"])
def test_zeroshot_classification_matches_jax(pair, toks, attack):
    params, module = pair
    _, templates = tbld.classnames_and_templates(
        "cifar10", fallback_classes=CLASSES)
    cfg = tconfig.get_model_config(MODEL)
    kw = dict(attack=attack, eps=8 / 255, n_iter=3)
    want = jzsc.evaluate_zeroshot_classification(
        params, jconfig.get_model_config(MODEL), toks[0], _batches(),
        CLASSES, templates, **kw)
    seconds = {}
    got = tzsc.evaluate_zeroshot_classification(
        module, cfg, toks[1], _batches(), CLASSES, templates,
        seconds=seconds, **kw)
    assert got == want
    assert set(seconds) == {"classifier", "data", "clean"} | (
        {"apgd"} if attack else set())


def test_multilabel_map_matches_jax(pair, toks):
    params, module = pair
    rng = np.random.default_rng(4)
    loader = [(_images(4, 6), (rng.uniform(size=(6, 6)) < 0.4)
               .astype(np.float32))]
    names, templates = tbld.classnames_and_templates(
        "x", fallback_classes=CLASSES)
    want = jzsc.evaluate_zeroshot_classification(
        params, jconfig.get_model_config(MODEL), toks[0], loader, names,
        templates)
    got = tzsc.evaluate_zeroshot_classification(
        module, tconfig.get_model_config(MODEL), toks[1], loader, names,
        templates)
    assert got == want and set(got) == {"mean_average_precision", "n"}
    scores = rng.standard_normal((7, 3))
    targets = rng.integers(0, 2, (7, 3))
    np.testing.assert_array_equal(
        tzsc.average_precision_per_class(scores, targets),
        jzsc.average_precision_per_class(scores, targets))
    with pytest.raises(ValueError, match="multilabel"):
        tzsc.evaluate_zeroshot_classification(
            module, tconfig.get_model_config(MODEL), toks[1], loader, names,
            templates, attack="apgd")


def test_retrieval_and_caption_selection_match_jax(pair, toks):
    params, module = pair
    jcfg, tcfg = jconfig.get_model_config(MODEL), tconfig.get_model_config(
        MODEL)
    images = _images(5, 5)
    captions = [f"a photo of thing {i}" for i in range(9)] + ["x!"]
    img2txt = {i: [2 * i, 2 * i + 1] for i in range(5)}
    kw = dict(recall_ks=(1, 2, 5), batch_size=3)
    want = jzsr.evaluate_zeroshot_retrieval(
        params, jcfg, toks[0], [images[:3], images[3:]], captions, img2txt,
        **kw)
    got = tzsr.evaluate_zeroshot_retrieval(
        module, tcfg, toks[1], [images[:3], images[3:]], captions, img2txt,
        **kw)
    assert got == want
    scores = np.random.default_rng(2).standard_normal((4, 6))
    pos = np.random.default_rng(3).uniform(size=(4, 6)) < 0.4
    np.testing.assert_array_equal(tzsr.recall_at_k(scores, pos, 2),
                                  jzsr.recall_at_k(scores, pos, 2))
    data = [(images[:2], [["a dog", "a cat", "a car"], ["tree", "boat"]]),
            (images[2:], [["x", "y"], ["bird", "dog", "cat"], ["z", "w"]])]
    assert tics.evaluate_image_caption_selection(module, tcfg, toks[1], data) \
        == jics.evaluate_image_caption_selection(params, jcfg, toks[0], data)


def _jax_w(dim, n_classes, seed):
    """The JAX probe's initial weight (`linear_probe.py`'s draw)."""
    return np.asarray(0.01 * jax.random.normal(jax.random.PRNGKey(seed),
                                               (dim, n_classes)))


def test_train_probe_matches_jax():
    rng = np.random.default_rng(6)
    X = rng.standard_normal((24, 16)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = rng.integers(0, 3, 24)
    for wd in (0.0, 0.1):
        jp, jloss = jlp.train_probe(X, y, 3, lr=0.1, weight_decay=wd,
                                    epochs=30, seed=2)
        tp, tloss = tlp.train_probe(X, y, 3, lr=0.1, weight_decay=wd,
                                    epochs=30, seed=2,
                                    init_w=_jax_w(16, 3, 2))
        assert abs(tloss - jloss) <= 1e-4
        np.testing.assert_allclose(tp["w"], np.asarray(jp["w"]), atol=1e-4)
        np.testing.assert_array_equal((X @ tp["w"] + tp["b"]).argmax(-1),
                                      np.asarray(X @ jp["w"] + jp["b"])
                                      .argmax(-1))
    # the seeded draw and the refusal of an empty training
    np.testing.assert_array_equal(tlp.initial_weights(16, 3, 5),
                                  tlp.initial_weights(16, 3, 5))
    with pytest.raises(ValueError, match="epochs"):
        tlp.train_probe(X, y, 3, epochs=0)


@pytest.mark.parametrize("fewshot_k,wds", [(-1, (0.0,)), (2, (0.0, 0.1))])
def test_linear_probe_matches_jax(pair, fewshot_k, wds):
    params, module = pair
    rng = np.random.default_rng(7)
    train = [(_images(8, 6), rng.integers(0, 3, 6)),
             (_images(9, 4), rng.integers(0, 3, 4))]
    test = [(_images(10, 5), rng.integers(0, 3, 5))]
    kw = dict(n_classes=3, epochs=20, fewshot_k=fewshot_k, weight_decays=wds)
    want = jlp.evaluate_linear_probe(params, jconfig.get_model_config(MODEL),
                                     train, test, **kw)
    got = tlp.evaluate_linear_probe(
        module.visual, tconfig.get_model_config(MODEL), train, test,
        init_w=_jax_w(64, 3, 0), **kw)
    assert abs(got.pop("lp_train_loss") - want.pop("lp_train_loss")) <= 1e-4
    assert got == want


def test_captioning_scores_match_jax():
    cands = ["a cat sits on the mat", "a dog runs in the park!",
             "completely unrelated words"]
    refs = [["a cat is on the mat", "the cat sat"], ["a dog runs"],
            ["words that relate", "nothing here"]]
    assert tcap.bleu4(cands, refs) == jcap.bleu4(cands, refs)
    assert tcap.cider_d(cands, refs) == jcap.cider_d(cands, refs)
    assert tcap.bleu4(cands[:2], [[c] for c in cands[:2]]) \
        == pytest.approx(1.0)
    # captions of a CoCa model (held to the JAX command line's in
    # tests/test_torch_coca.py)
    from leaf_tpu_torch.models.coca import create_coca_model
    from leaf_tpu_torch.models.factory import get_tokenizer
    images = np.random.default_rng(0).random((2, 64, 64, 3), np.float32)
    m = tcap.evaluate_captioning(
        create_coca_model("coca-tiny-test"), get_tokenizer("coca-tiny-test"),
        [(images, [["a cat"], "a dog"])], seq_len=8, generation_type="top_k")
    assert m["num_samples"] == 2 and 0.0 <= m["bleu4"] <= 1.0 \
        and m["cider_d"] >= 0.0


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(pair, tmp_path_factory):
    module = pair[1]
    return save_state_dict(params_to_openclip(module.state_dict(),
                                              module.cfg),
                           str(tmp_path_factory.mktemp("ckpt")), "openclip")


@pytest.fixture(scope="module")
def probe_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("probe")
    rng = np.random.default_rng(11)
    _folder(str(root / "train"), rng, ("a", "b", "c"), per_class=3)
    _folder(str(root / "val"), rng, ("a", "b", "c"), per_class=2)
    return str(root)


def _run_both(args, tmp_path, monkeypatch=None):
    """The two command lines on `args`, each writing its own output file:
    (JAX result, port result, JAX file, port file)."""
    out = []
    for tag, main, extra in (("jax", jcli.main, []),
                             ("torch", tcli.main, ["--device", "cpu"])):
        path = str(tmp_path / f"{tag}_{{dataset}}_{{task}}.json")
        res = main(["eval"] + args + ["--output", path] + extra)
        out.append((res, [json.load(open(path.format(
            dataset=r["dataset"].replace("/", "-"), task=r["task"])))
            for r in res]))
    return out


CLI_CASES = {
    "classification": ["--dataset", "cifar10", "--batch-size", "2"],
    "apgd": ["--dataset", "cifar10", "--attack", "apgd", "--attack-iters",
             "2", "--eps", "8", "--batch-size", "5"],
    "retrieval": ["--dataset", "mscoco_captions", "--recall-k", "1", "3"],
    "caption_selection": ["--dataset", "sugar_crepe/add_att"],
    "two_datasets": ["--dataset", "imagefolder", "imagenet-a",
                     "--task", "zeroshot_classification"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_eval_matches_jax(case, layouts, ckpt, tmp_path):
    args = CLI_CASES[case]
    name = args[1]
    root = layouts[name] if case != "two_datasets" else None
    if case == "two_datasets":
        # one root that holds both folders, through the {dataset} template
        root = os.path.join(os.path.dirname(layouts["imagefolder"]),
                            "{dataset}")
    if case == "retrieval":
        args = args + ["--annotation-file",
                       os.path.join(root, "karpathy.json")]
    (jres, jfiles), (tres, tfiles) = _run_both(
        ["--model", MODEL, "--pretrained", ckpt, "--dataset-root", root]
        + args, tmp_path)
    assert tres == jres and tfiles == jfiles
    assert len(tres) == (2 if case == "two_datasets" else 1)


def test_cli_linear_probe_matches_jax(ckpt, probe_root, tmp_path,
                                      monkeypatch):
    monkeypatch.setattr(tlp, "initial_weights", _jax_w)
    (jres, _), (tres, _) = _run_both(
        ["--model", MODEL, "--pretrained", ckpt, "--dataset", "probe",
         "--dataset-root", probe_root, "--task", "linear_probe",
         "--fewshot-epochs", "15", "--fewshot-k", "2"], tmp_path)
    j, t = jres[0]["metrics"], tres[0]["metrics"]
    assert abs(t.pop("lp_train_loss") - j.pop("lp_train_loss")) <= 1e-4
    assert t == j and t["n_train"] == 6


def test_cli_interpolate(pair, layouts, ckpt, tmp_path):
    """`--interpolate --beta 0` evaluates the other checkpoint; beta 0.5
    the JAX command line's blend."""
    other = tclip.CLIP(tconfig.get_model_config(MODEL))
    other.init_weights(torch.Generator().manual_seed(3))
    other_ckpt = save_state_dict(params_to_openclip(other.state_dict(),
                                                    other.cfg),
                                 str(tmp_path / "other"), "openclip")
    base = ["eval", "--model", MODEL, "--dataset", "imagefolder",
            "--dataset-root", layouts["imagefolder"], "--device", "cpu"]
    alone = tcli.main(base + ["--pretrained", other_ckpt])
    mixed = tcli.main(base + ["--pretrained", ckpt, "--interpolate",
                              "--beta", "0", "--interpolate-ckpt",
                              other_ckpt])
    assert mixed[0]["metrics"] == alone[0]["metrics"]
    flags = ["--model", MODEL, "--pretrained", ckpt, "--dataset", "cifar10",
             "--dataset-root", layouts["cifar10"], "--interpolate", "--beta",
             "0.5", "--interpolate-ckpt", other_ckpt]
    (jres, _), (tres, _) = _run_both(flags, tmp_path)
    assert tres == jres


def test_cli_build_and_reformat_match_jax(tmp_path):
    files = []
    for i, (ds, acc, attack) in enumerate((
            ("wds/cifar10", 0.8125, "apgd"), ("wds/vtab/flowers", 0.62,
                                              "apgd"),
            ("cifar10", 0.3333333333333333, "apgd"),
            ("cifar10", 0.5, "none"))):
        rec = {"model": "ViT-B-32", "pretrained": "p" if i < 3 else "",
               "task": "zeroshot_classification", "dataset": ds,
               "language": "en", "attack": attack,
               "metrics": {"acc1": acc, "acc5": None if i else 0.9,
                           "n": 16}}
        if attack == "apgd":
            rec.update(eps=2.0, iterations_adv=100 - 90 * (i == 2))
        path = tmp_path / f"r{i}.json"
        path.write_text(json.dumps(rec))
        files.append(str(path))
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        main(["build", *files, "--output", str(tmp_path / f"{tag}.csv")])
    assert (tmp_path / "torch.csv").read_bytes() \
        == (tmp_path / "jax.csv").read_bytes()
    # every index cell filled: the same table as pandas
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        main(["build", *files[:3], "--output", str(tmp_path / f"{tag}3.csv")])
        main(["reformat", str(tmp_path / f"{tag}3.csv"), "--output",
              str(tmp_path / f"{tag}_pivot.csv")])
    assert (tmp_path / "torch_pivot.csv").read_text() \
        == (tmp_path / "jax_pivot.csv").read_text()
    # a clean row (no eps, no pretrained) stays in the port's table
    tcli.main(["reformat", str(tmp_path / "torch.csv"), "--output",
               str(tmp_path / "all.csv")])
    rows = (tmp_path / "all.csv").read_text().splitlines()
    assert rows[0] == ("model,pretrained,attack,eps,iterations_adv,cifar10,"
                       "flowers")
    assert rows[-1] == "ViT-B-32,,none,,,50.0," and len(rows) == 4


@pytest.mark.parametrize("flags,error,match", [
    (["--model-type", "hf_clip", "--pretrained", "openai"], ValueError,
     "hf_clip"),
    # since the registry was ported, a hub repo and a registry tag load
    # from the local checkpoint cache, empty here; coca-roberta's tokenizer
    # needs transformers and its vocabulary
    (["--model-type", "hf_clip"], RuntimeError, "hf-hub:ViT-tiny-test"),
    (["--model-type", "ja_clip"], ImportError, "japanese_clip"),
    (["--pretrained", "laion2b_s32b_b82k"], FileNotFoundError,
     "registry tag"),
    (["--task", "captioning", "--model", "coca-roberta-tiny-test"],
     NotImplementedError, "vocabulary files"),
    (["--precision", "bf16", "--attack", "apgd"], ValueError, "float32"),
    (["--interpolate"], ValueError, "interpolate-ckpt"),
])
def test_cli_refusals(layouts, flags, error, match, monkeypatch, tmp_path):
    # the checkpoint cache: an empty directory of the test's own
    from leaf_tpu_torch.models import pretrained
    monkeypatch.setattr(pretrained, "DEFAULT_CACHE_DIR", str(tmp_path))
    with pytest.raises(error, match=match):
        tcli.main(["eval", "--model", MODEL, "--dataset", "imagefolder",
                   "--dataset-root", layouts["imagefolder"], "--device",
                   "cpu"] + flags)


def test_cli_bf16_runs(layouts):
    """`--precision bf16` computes the towers in bf16 (the JAX command line
    passes the flag to `create_model`, but its benchmark functions take the
    fp32 parameters and never read the resulting dtype)."""
    res = tcli.main(["eval", "--model", MODEL, "--dataset", "imagefolder",
                     "--dataset-root", layouts["imagefolder"], "--device",
                     "cpu", "--precision", "bf16"])
    m = res[0]["metrics"]
    assert m["n"] == 4 and 0.0 <= m["acc1"] <= 1.0


def test_cli_defaults_to_the_card(layouts):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["eval", "--model", MODEL, "--dataset", "imagefolder",
                   "--dataset-root", layouts["imagefolder"]])
