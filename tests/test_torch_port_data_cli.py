"""The slim CLIs on the data tier and the inception family, on the CPU in
float32: ``download_and_convert`` of a ``file://`` CIFAR-10 archive, then
``train_classifier --dataset-name prepared --model-name cifarnet
--preprocessing-name cifarnet`` and ``eval_classifier`` on its snapshot
with the eval preprocessing; ``--dataset-name mnist --model-name lenet
--preprocessing-name lenet`` (MNIST's single channel reaches ``conv1``);
``--model-name darknet19 --preprocessing-name darknet19`` on prepared
flowers shards; ``--model-name inception_v3 --aux-loss
--preprocessing-name inception`` on a flowers tree (at 112² on the CPU)
with ``aux_loss`` in the log, then ``eval_classifier`` on that snapshot;
and the refusals that stay: ``--aux-loss`` on a net without an auxiliary
head, a factory preprocessing on ``synthetic``.

The first batch each package's preprocessing gives the CLI is held bit
for bit to the JAX package's in ``tests/test_torch_port_data_tier.py``.
"""

import os
import tarfile

import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch.entries import download_and_convert
from tensorflow_yolo2_torch.entries import eval_classifier as pt_eval
from tensorflow_yolo2_torch.entries import train_classifier as pt_train
from tests import synthetic
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)
from tests.test_torch_port_slim_cli import CPU, _snap, root, run  # noqa: F401

COMMON = ["--num-workers", "1", "--log-every", "1", *CPU]


@pytest.fixture
def cifar_prepared(root):
    """``download_and_convert`` of a seeded CIFAR-10 python archive over a
    ``file://`` URL into ``<root>/cifar10_prepared``."""
    src = synthetic.make_cifar10(
        str(root / "mirror" / "cifar-10-batches-py"), per_batch=6)
    tarball = root / "mirror" / "cifar-10-python.tar.gz"
    with tarfile.open(tarball, "w:gz") as tar:
        tar.add(src, "cifar-10-batches-py")
    out = str(root / "cifar10_prepared")
    text = run(download_and_convert.main, [
        "--dataset-name", "cifar10", "--download-url", f"file://{tarball}",
        "--dataset-dir", out, "--shard-size", "8"])
    assert "cifar10/train: 30 examples, 4 shards, 10 classes" in text
    assert "cifar10/test: 6 examples, 1 shards, 10 classes" in text
    return out


def test_prepared_cifarnet_train_and_eval(cifar_prepared):
    text = run(pt_train.main, [
        "--dataset-name", "prepared", "--data-path",
        os.path.join(cifar_prepared, "train"), "--model-name", "cifarnet",
        "--preprocessing-name", "cifarnet", "--iters", "3",
        "--batch-size", "4", *COMMON])
    assert "iter 3: loss" in text
    steps, snap = _snap("cifarnet", "prepared_train")
    assert steps == [1, 2, 3] and snap["step"] == 3
    text = run(pt_eval.main, [
        "--dataset-name", "prepared", "--data-path",
        os.path.join(cifar_prepared, "train"), "--model-name", "cifarnet",
        "--preprocessing-name", "cifarnet", "--batch-size", "2",
        "--max-batches", "2", *CPU])
    assert "eval at step 3: accuracy" in text and "over 4 images" in text


def test_mnist_lenet_takes_one_channel(root):
    data = synthetic.make_mnist(str(root / "mnist"), n_train=12, n_test=8,
                                gz=True)
    text = run(pt_train.main, [
        "--dataset-name", "mnist", "--data-path", data, "--model-name",
        "lenet", "--preprocessing-name", "lenet", "--iters", "2",
        "--batch-size", "4", *COMMON])
    assert "iter 2: loss" in text
    _, snap = _snap("lenet", "mnist")
    assert snap["model"]["conv1.weight"].shape == (32, 1, 5, 5)
    text = run(pt_eval.main, [
        "--dataset-name", "mnist", "--data-path", data, "--model-name",
        "lenet", "--preprocessing-name", "lenet", "--batch-size", "4",
        *CPU])
    assert "eval at step 2:" in text and "over 8 images" in text


def test_prepared_darknet19_with_its_preprocessing(root):
    shards = str(root / "flowers_prepared")
    run(download_and_convert.main, [
        "--dataset-name", "flowers", "--source-dir",
        synthetic.make_flowers(str(root / "flowers"), per_class=3),
        "--dataset-dir", shards, "--image-size", "64"])
    text = run(pt_train.main, [
        "--dataset-name", "prepared", "--data-path",
        os.path.join(shards, "train"), "--model-name", "darknet19",
        "--preprocessing-name", "darknet19", "--iters", "1",
        "--batch-size", "3", *COMMON])
    assert "iter 1: loss" in text
    _, snap = _snap("darknet19", "prepared_train")
    assert snap["model"]["conv19.conv.weight"].shape[0] == 3


def test_inception_v3_aux_loss_on_flowers_then_eval(root):
    synthetic.make_flowers(str(root / "data" / "TF_flowers"), per_class=3)
    text = run(pt_train.main, [
        "--model-name", "inception_v3", "--aux-loss", "--preprocessing-name",
        "inception", "--image-size", "112", "--iters", "2",
        "--batch-size", "2", "--optimizer", "momentum", *COMMON])
    assert "aux_loss" in text and "iter 2: loss" in text
    _, snap = _snap("inception_v3", "tf_flowers")
    assert snap["model"]["aux_logits.weight"].shape == (3, 768, 1, 1)
    assert not any(k.endswith("bn.weight") for k in snap["model"])
    text = run(pt_eval.main, [
        "--model-name", "inception_v3", "--preprocessing-name", "inception",
        "--image-size", "112", "--batch-size", "2", "--max-batches", "1",
        *CPU])
    assert "Restored snapshot at iter 2" in text
    assert "eval at step 2: accuracy" in text


@pytest.mark.parametrize("name", ["inception_v2", "inception_resnet_v2"])
def test_aux_loss_refused_without_an_aux_head(root, capsys, name):
    with pytest.raises(SystemExit):
        pt_train.main(["--model-name", name, "--aux-loss", "--dataset-name",
                       "synthetic", "--image-size", "96", "--iters", "1",
                       *COMMON])
    assert f"--aux-loss: {name} has no auxiliary classifier head" in \
        capsys.readouterr().err


def test_one_channel_images_need_a_net_that_takes_them(root, capsys):
    data = synthetic.make_mnist(str(root / "mnist"), n_train=4, n_test=4)
    with pytest.raises(SystemExit):
        pt_train.main(["--dataset-name", "mnist", "--data-path", data,
                       "--model-name", "vgg_a", "--iters", "1", *COMMON])
    assert "takes 1-channel images only as lenet" in capsys.readouterr().err


def test_preprocessing_refused_on_synthetic(root):
    with pytest.raises(ValueError, match="is not supported by dataset"):
        pt_train.main(["--dataset-name", "synthetic", "--preprocessing-name",
                       "vgg", "--iters", "1", *COMMON])


def test_lenet_in_channels_matches_flax_conv1():
    """The registry's ``in_channels`` gives ``conv1`` the kernel flax
    infers from a 1-channel batch."""
    from tensorflow_yolo2_torch.models import registry

    model = registry.get_network("lenet", num_classes=10, in_channels=1)
    assert model.conv1.weight.shape == (32, 1, 5, 5)
    with torch.no_grad():
        out = model.eval()(torch.zeros(2, 28, 28, 1))
    assert out.shape == (2, 10) and bool(torch.isfinite(out).all())
    assert np.prod(model.fc3.weight.shape) == 7 * 7 * 64 * 1024
