"""The port's slim data tier against the JAX package's on the CPU:
``utils.helpers`` (``add_contrast_channels`` at 1e-6, the label count),
``data.fetch`` over ``file://`` URLs (tar, tar.gz, zip and a bare gz
archive, the path-traversal and link refusals), the MNIST readers (raw
and gzipped IDX) and the CIFAR-10 readers (python pickle and binary
batches), the prepared shards (each package reads the shards the other
wrote; shards and manifests equal), ``get_dataset`` for ``mnist``,
``cifar10`` and ``prepared`` with and without a factory preprocessing,
``download_and_convert`` for the three datasets (its shards equal to the
JAX CLI's), and ``TFFlowers`` / ``IlsvrcCls`` with ``preprocess_name``.

Everything here is host numpy / cv2 code: batches are held bit for bit
(``assert_array_equal``), except the contrast channels (1e-6, float32
torch against jnp: the same subtractions, measured 0).
"""

import gzip
import io
import json
import os
import shutil
import tarfile
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch.config import Paths as PtPaths
from tensorflow_yolo2_torch.data import cifar10 as pt_cifar
from tensorflow_yolo2_torch.data import fetch as pt_fetch
from tensorflow_yolo2_torch.data import mnist as pt_mnist
from tensorflow_yolo2_torch.data import prepared as pt_prepared
from tensorflow_yolo2_torch.data.flowers import TFFlowers as PtFlowers
from tensorflow_yolo2_torch.data.ilsvrc import IlsvrcCls as PtIlsvrc
from tensorflow_yolo2_torch.entries import datasets as pt_datasets
from tensorflow_yolo2_torch.entries import download_and_convert as pt_dac
from tensorflow_yolo2_torch.utils import helpers as pt_helpers
from tensorflow_yolo2_tpu.config import Paths as JxPaths
from tensorflow_yolo2_tpu.data import cifar10 as jx_cifar
from tensorflow_yolo2_tpu.data import fetch as jx_fetch
from tensorflow_yolo2_tpu.data import mnist as jx_mnist
from tensorflow_yolo2_tpu.data import prepared as jx_prepared
from tensorflow_yolo2_tpu.data.flowers import TFFlowers as JxFlowers
from tensorflow_yolo2_tpu.data.ilsvrc import IlsvrcCls as JxIlsvrc
from tensorflow_yolo2_tpu.entries import datasets as jx_datasets
from tensorflow_yolo2_tpu.entries import download_and_convert as jx_dac
from tensorflow_yolo2_tpu.utils import helpers as jx_helpers
from tests import synthetic


def same_batches(a, b, n: int = 3) -> None:
    """``n`` batches of two datasets equal, images and labels, with their
    dtypes, and the cursors and epochs after."""
    for _ in range(n):
        (ai, al), (bi, bl) = a.get(), b.get()
        assert ai.dtype == bi.dtype and al.dtype == bl.dtype
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(al, bl)
    assert (a.cursor, a.epoch) == (b.cursor, b.epoch)


# -- helpers ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 3), (3, 6, 1, 3)])
def test_add_contrast_channels_matches_jax(shape):
    x = np.random.RandomState(len(shape) + shape[1]).uniform(
        -1, 1, shape).astype(np.float32)
    got = pt_helpers.add_contrast_channels(torch.from_numpy(x)).numpy()
    want = np.asarray(jx_helpers.add_contrast_channels(jnp.asarray(x)))
    assert got.shape == want.shape == shape[:3] + (15,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the border: no up difference on the first row, no right one on the
    # last column
    assert not got[:, 0, :, 3:6].any() and not got[:, :, -1, 12:15].any()


def test_compare_label_values_matches_jax():
    preds, labels = np.array([1, 2, 3, 4]), np.array([1, 0, 3, 0])
    assert pt_helpers.compare_label_values(preds, labels) == \
        jx_helpers.compare_label_values(preds, labels) == (2, 0.5)


# -- fetch over file:// -------------------------------------------------------


def _payload(root) -> dict:
    files = {"cifar-10-batches-py/data_batch_1": b"one",
             "cifar-10-batches-py/sub/readme.txt": b"two"}
    for rel, data in files.items():
        path = root / "src" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    return files


def _archive(root, kind: str) -> str:
    files = _payload(root)
    src = root / "src"
    if kind == "zip":
        path = root / "mirror" / "cifar-10-python.zip"
        path.parent.mkdir(exist_ok=True)
        with zipfile.ZipFile(path, "w") as zf:
            for rel in files:
                zf.write(src / rel, rel)
        return str(path)
    suffix = {"tar": ".tar", "tar.gz": ".tar.gz", "tgz": ".tgz"}[kind]
    path = root / "mirror" / f"cifar-10-python{suffix}"
    path.parent.mkdir(exist_ok=True)
    with tarfile.open(path, "w:gz" if "gz" in kind else "w") as tar:
        tar.add(src / "cifar-10-batches-py", "cifar-10-batches-py")
    return str(path)


@pytest.mark.parametrize("kind", ["tar", "tar.gz", "tgz", "zip"])
def test_fetch_dataset_over_file_urls_matches_jax(tmp_path, kind):
    """Both packages fetch the same ``file://`` archive, unpack it and
    return the same source dir holding the same files."""
    url = "file://" + _archive(tmp_path, kind)
    got = pt_fetch.fetch_dataset("cifar10", str(tmp_path / "pt"), [url],
                                 progress=False)
    want = jx_fetch.fetch_dataset("cifar10", str(tmp_path / "jx"), [url],
                                  progress=False)
    assert os.path.relpath(got, tmp_path / "pt") == \
        os.path.relpath(want, tmp_path / "jx") == "cifar-10-batches-py"
    assert (tmp_path / "pt" / "cifar-10-batches-py" / "sub" /
            "readme.txt").read_bytes() == b"two"
    for path in (got, want):
        assert sorted(os.listdir(path)) == ["data_batch_1", "sub"]
    # a second fetch finds the archive and downloads nothing
    assert pt_fetch.download(url, str(tmp_path / "pt"), progress=False) == \
        str(tmp_path / "pt" / os.path.basename(url))


def test_fetch_mnist_gz_files_stay_compressed(tmp_path, capsys):
    """The bare ``.gz`` IDX files are downloaded as they are (the readers
    open them), with the progress line; ``gunzip`` gives the raw bytes."""
    src = synthetic.make_mnist(str(tmp_path / "src"), n_train=5, n_test=3,
                               gz=True)
    urls = ["file://" + os.path.join(src, f) for f in sorted(os.listdir(src))]
    out = pt_fetch.fetch_dataset("mnist", str(tmp_path / "pt"), urls)
    assert out == str(tmp_path / "pt")
    assert "Downloading" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == sorted(os.listdir(src))
    raw = pt_fetch.gunzip(os.path.join(out, "t10k-labels-idx1-ubyte.gz"))
    with gzip.open(os.path.join(src, "t10k-labels-idx1-ubyte.gz")) as f:
        assert open(raw, "rb").read() == f.read()
    np.testing.assert_array_equal(
        pt_mnist.read_idx_images(os.path.join(out, "train-images-idx3-ubyte")),
        jx_mnist.read_idx_images(os.path.join(src, "train-images-idx3-ubyte")))


def _evil_tar(path, member: tarfile.TarInfo, data: bytes = b"x") -> str:
    with tarfile.open(path, "w") as tar:
        tar.addfile(member, io.BytesIO(data) if member.isfile() else None)
    return str(path)


@pytest.mark.parametrize("case", ["dotdot", "absolute", "symlink",
                                  "hardlink", "zip_dotdot"])
def test_uncompress_refuses_escaping_members_as_jax(tmp_path, case):
    if case == "zip_dotdot":
        path = str(tmp_path / "evil.zip")
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("../outside.txt", b"x")
        match = "escapes extraction dir"
    else:
        if case in ("dotdot", "absolute"):
            member = tarfile.TarInfo("../outside.txt" if case == "dotdot"
                                     else "/tmp/outside.txt")
            member.size = 1
            match = "escapes extraction dir"
        else:
            member = tarfile.TarInfo("link")
            member.type = (tarfile.SYMTYPE if case == "symlink"
                           else tarfile.LNKTYPE)
            member.linkname = "target"
            match = "link member"
        path = _evil_tar(tmp_path / "evil.tar", member)
    for pkg in (pt_fetch, jx_fetch):
        dest = tmp_path / pkg.__name__.split(".")[0]
        dest.mkdir()
        with pytest.raises(ValueError, match=match):
            pkg.uncompress(path, str(dest))
        assert os.listdir(dest) == []
    assert not (tmp_path / "outside.txt").exists()


def test_fetch_dataset_needs_urls_without_a_table(tmp_path):
    with pytest.raises(ValueError, match="pass --download-url"):
        pt_fetch.fetch_dataset("svhn", str(tmp_path))
    assert pt_fetch.DATASET_URLS == jx_fetch.DATASET_URLS


# -- MNIST and CIFAR-10 -------------------------------------------------------


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("split", ["train", "test", "validation"])
def test_mnist_matches_jax(tmp_path, gz, split):
    root = synthetic.make_mnist(str(tmp_path), n_train=20, n_test=12, gz=gz)
    pt = pt_mnist.MNIST(split, batch_size=7, data_path=root, seed=3)
    jx = jx_mnist.MNIST(split, batch_size=7, data_path=root, seed=3)
    assert (pt.classes, pt.num_class, pt.image_size) == \
        (jx.classes, jx.num_class, jx.image_size)
    assert pt.total_batch == jx.total_batch
    same_batches(pt, jx, n=4)
    assert pt.epoch > 1


def test_mnist_refuses_a_bad_magic_and_split(tmp_path):
    root = synthetic.make_mnist(str(tmp_path), n_train=4, n_test=4)
    shutil.copy(os.path.join(root, "train-images-idx3-ubyte"),
                os.path.join(root, "t10k-labels-idx1-ubyte"))
    with pytest.raises(ValueError, match="bad IDX1 magic"):
        pt_mnist.MNIST("test", data_path=root)
    with pytest.raises(ValueError, match="was not recognized"):
        pt_mnist.MNIST("dev", data_path=root)


@pytest.mark.parametrize("fmt", ["python", "binary"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_cifar10_matches_jax(tmp_path, fmt, split):
    root = synthetic.make_cifar10(str(tmp_path), per_batch=6, fmt=fmt)
    pt = pt_cifar.Cifar10(split, batch_size=4, data_path=root, seed=1)
    jx = jx_cifar.Cifar10(split, batch_size=4, data_path=root, seed=1)
    assert pt.classes == jx.classes and pt.classes[1] == "automobile"
    np.testing.assert_array_equal(pt._images, jx._images)
    assert pt._images.shape[1:] == (32, 32, 3)
    same_batches(pt, jx, n=4)


def test_cifar10_chw_unpacking(tmp_path):
    """A record's 3072 bytes are R, G, B planes of 32×32, row-major."""
    root = synthetic.make_cifar10(str(tmp_path), per_batch=2, fmt="binary")
    rec = np.fromfile(os.path.join(root, "test_batch.bin"), np.uint8)
    images, labels, _ = pt_cifar.read_binary_batches(root, "test")
    assert labels[0] == rec[0]
    assert images[0, 3, 5, 1] == rec[1 + 1024 + 3 * 32 + 5]


# -- prepared shards ----------------------------------------------------------


@pytest.mark.parametrize("rgb", [False, True])
def test_prepared_image_directory_shards_cross_read(tmp_path, rgb):
    flowers = synthetic.make_flowers(str(tmp_path / "flowers"), per_class=5)
    outs = {}
    for name, pkg in (("pt", pt_prepared), ("jx", jx_prepared)):
        outs[name] = str(tmp_path / name)
        manifest = pkg.convert_image_directory(
            flowers, outs[name], image_size=40, shard_size=4, rgb=rgb)
        assert manifest["num_examples"] == 15
        assert len(manifest["shards"]) == 4
    with open(os.path.join(outs["pt"], "manifest.json")) as f, \
            open(os.path.join(outs["jx"], "manifest.json")) as g:
        assert f.read() == g.read()
    for shard in sorted(os.listdir(outs["pt"])):
        if shard.endswith(".npz"):
            a = np.load(os.path.join(outs["pt"], shard))
            b = np.load(os.path.join(outs["jx"], shard))
            for key in ("images", "labels"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
    # each package reads the other's shards
    same_batches(pt_prepared.PreparedDataset(outs["jx"], batch_size=4),
                 jx_prepared.PreparedDataset(outs["pt"], batch_size=4), n=5)


def test_prepared_arrays_and_the_cli_match_jax(tmp_path, capsys):
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (11, 28, 28, 1), np.uint8)
    labels = rng.randint(0, 10, 11)
    for name, pkg in (("pt", pt_prepared), ("jx", jx_prepared)):
        pkg.convert_arrays(images, labels, tuple("abcdefghij"),
                           str(tmp_path / name), shard_size=5)
    assert json.load(open(tmp_path / "pt" / "manifest.json")) == \
        json.load(open(tmp_path / "jx" / "manifest.json"))
    pt = pt_prepared.PreparedDataset(str(tmp_path / "jx"), batch_size=3,
                                     seed=2)
    jx = jx_prepared.PreparedDataset(str(tmp_path / "pt"), batch_size=3,
                                     seed=2)
    assert pt.name == "prepared_jx" and pt.image_size == 28
    same_batches(pt, jx, n=5)
    flowers = synthetic.make_flowers(str(tmp_path / "flowers"), per_class=2)
    assert pt_prepared.main([flowers, str(tmp_path / "cli"),
                             "--image-size", "32", "--shard-size", "4"]) == 0
    assert "converted 6 images, 2 shards, 3 classes" in \
        capsys.readouterr().out


# -- the dataset factory ------------------------------------------------------


def _factory_sources(tmp_path) -> dict:
    prepared = str(tmp_path / "prepared")
    jx_prepared.convert_image_directory(
        synthetic.make_flowers(str(tmp_path / "flowers"), per_class=4),
        prepared, image_size=48, shard_size=8)
    return {"mnist": synthetic.make_mnist(str(tmp_path / "mnist"),
                                          n_train=12, n_test=8),
            "cifar10": synthetic.make_cifar10(str(tmp_path / "cifar")),
            "cifar-10": synthetic.make_cifar10(str(tmp_path / "cifar")),
            "prepared": prepared}


# (dataset, factory preprocessing); inception and vgg convert a 3-channel
# image, which MNIST's single channel is not (cv2 refuses it in both)
FACTORY_CASES = [(name, pp) for name in ("mnist", "cifar10", "cifar-10",
                                         "prepared")
                 for pp in (None, "lenet", "cifarnet", "inception", "vgg")
                 if not (name == "mnist" and pp in ("inception", "vgg"))]


@pytest.mark.parametrize("name, pp", FACTORY_CASES)
def test_get_dataset_new_names_match_jax(tmp_path, name, pp):
    path = _factory_sources(tmp_path)[name]
    for split in ("train", "test"):
        kw = dict(batch_size=4, data_path=path, seed=5, preprocessing_name=pp)
        pt = pt_datasets.get_dataset(name, split, **kw)
        jx = jx_datasets.get_dataset(name, split, **kw)
        assert type(pt).__name__ == type(jx).__name__
        assert (pt.name, pt.classes) == (jx.name, jx.classes)
        assert (pt.preprocess_fn is None) == (pp is None)
        same_batches(pt, jx, n=2)


def test_get_dataset_refusals_match_jax(tmp_path):
    for pkg in (pt_datasets, jx_datasets):
        with pytest.raises(ValueError, match="needs data_path"):
            pkg.get_dataset("prepared")
        for name in ("voc", "synthetic"):
            with pytest.raises(ValueError, match="is not supported by"):
                pkg.get_dataset(name, preprocessing_name="vgg")
        with pytest.raises(FileNotFoundError):
            pkg.get_dataset("mnist", data_path=str(tmp_path))
        with pytest.raises(ValueError, match="was not recognized"):
            pkg.get_dataset("mnist", data_path=synthetic.make_mnist(
                str(tmp_path / "m"), n_train=4, n_test=4),
                preprocessing_name="nosuch")


# -- download_and_convert -----------------------------------------------------


def _shards_equal(a: str, b: str) -> None:
    assert json.load(open(os.path.join(a, "manifest.json"))) == \
        json.load(open(os.path.join(b, "manifest.json")))
    for shard in json.load(open(os.path.join(a, "manifest.json")))["shards"]:
        x, y = np.load(os.path.join(a, shard)), np.load(os.path.join(b, shard))
        for key in ("images", "labels"):
            np.testing.assert_array_equal(x[key], y[key])


def _cifar_tarball(tmp_path) -> str:
    src = synthetic.make_cifar10(
        str(tmp_path / "src" / "cifar-10-batches-py"), per_batch=5)
    path = tmp_path / "mirror" / "cifar-10-python.tar.gz"
    path.parent.mkdir()
    with tarfile.open(path, "w:gz") as tar:
        tar.add(src, "cifar-10-batches-py")
    return "file://" + str(path)


@pytest.mark.parametrize("dataset", ["mnist", "cifar10", "flowers",
                                     "cifar10_url", "mnist_url"])
def test_download_and_convert_matches_jax(tmp_path, monkeypatch, dataset):
    monkeypatch.setenv("TFY2_ROOT", str(tmp_path / "root"))
    name = dataset.split("_")[0]
    if dataset == "mnist":
        extra = ["--source-dir", synthetic.make_mnist(
            str(tmp_path / "src"), n_train=13, n_test=7)]
    elif dataset == "cifar10":
        extra = ["--source-dir", synthetic.make_cifar10(
            str(tmp_path / "src"), per_batch=4, fmt="binary")]
    elif dataset == "flowers":
        extra = ["--source-dir", synthetic.make_flowers(
            str(tmp_path / "src"), per_class=3), "--image-size", "40"]
    elif dataset == "cifar10_url":
        extra = ["--download-url", _cifar_tarball(tmp_path)]
    else:
        src = synthetic.make_mnist(str(tmp_path / "src"), n_train=9,
                                   n_test=5, gz=True)
        extra = [a for f in sorted(os.listdir(src)) for a in
                 ("--download-url", "file://" + os.path.join(src, f))]
    outs = {}
    for label, pkg in (("pt", pt_dac), ("jx", jx_dac)):
        outs[label] = str(tmp_path / label)
        assert pkg.main(["--dataset-name", name, "--dataset-dir",
                         outs[label], "--shard-size", "6", *extra]) == 0
    splits = ["train"] if name == "flowers" else ["train", "test"]
    assert sorted(d for d in os.listdir(outs["pt"]) if d != "raw") == \
        sorted(splits)
    for split in splits:
        _shards_equal(os.path.join(outs["pt"], split),
                      os.path.join(outs["jx"], split))
    # the output trains through --dataset-name prepared
    ds = pt_datasets.get_dataset("prepared", data_path=os.path.join(
        outs["pt"], "train"), batch_size=2)
    assert ds.get()[0].dtype == np.float32


def test_download_and_convert_refuses_a_missing_source(tmp_path, capsys,
                                                       monkeypatch):
    monkeypatch.setenv("TFY2_ROOT", str(tmp_path))
    with pytest.raises(SystemExit):
        pt_dac.main(["--dataset-name", "mnist", "--dataset-dir",
                     str(tmp_path / "out"), "--source-dir",
                     str(tmp_path / "none")])
    assert "raw mnist not found" in capsys.readouterr().err


# -- flowers and ILSVRC with a factory preprocessing --------------------------


@pytest.mark.parametrize("pp", ["inception", "vgg", "darknet19"])
def test_flowers_preprocess_name_matches_jax(tmp_path, pp):
    root = synthetic.make_flowers(str(tmp_path), per_class=4)
    kw = dict(batch_size=3, image_size=56, val_split=0.25, data_path=root,
              seed=7, preprocess_name=pp)
    pt, jx = PtFlowers(**kw), JxFlowers(**kw)
    for get in ("get_train", "get_val", "get_train"):
        (pi, pl), (ji, jl) = getattr(pt, get)(), getattr(jx, get)()
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pl, jl)
    assert pt.epoch == jx.epoch


@pytest.mark.parametrize("image_set, data_aug", [("train", True),
                                                 ("train", False),
                                                 ("val", False)])
def test_ilsvrc_preprocess_name_matches_jax(ilsvrc_dir, tmp_path, image_set,
                                            data_aug):
    """The train form on the train split with ``data_aug``, else the eval
    form; ``uint8`` with a preprocessing refused in both packages."""
    kw = dict(batch_size=4, image_size=64, data_aug=data_aug, seed=3,
              preprocess_name="inception", data_path=ilsvrc_dir)
    pt = PtIlsvrc(image_set, paths=PtPaths(str(tmp_path / "pt")), **kw)
    jx = JxIlsvrc(image_set, paths=JxPaths(str(tmp_path / "jx")), **kw)
    same_batches(pt, jx, n=3)
    with pytest.raises(ValueError, match="use float transfer"):
        PtIlsvrc(image_set, paths=PtPaths(str(tmp_path / "pt")), uint8=True,
                 **kw)
