"""The dataset factory, name → dataset (port of
tensorflow_yolo2_tpu/entries/datasets.py): ``get_dataset`` builds
``synthetic`` (in-memory seeded random images, ``SyntheticClassification``),
``synthetic-bg`` (the same with class 0 kept free as an ImageNet-style
background slot, the layout ``--labels-offset`` strips), ``flowers``
(``data.flowers.TFFlowers``), ``imagenet`` (``data.ilsvrc.IlsvrcCls``;
``validation`` and ``test`` read the val split), ``voc``
(``data.voc.PascalVOC``), ``mnist`` (``data.mnist.MNIST``), ``cifar10``
or ``cifar-10`` (``data.cifar10.Cifar10``) and ``prepared``
(``data.prepared.PreparedDataset`` over the shards at ``data_path``).

``preprocessing_name`` picks a factory preprocessing
(``data.preprocessing.get_preprocessing``, slim's
``--preprocessing_name``) in place of a dataset's own convention: the
train form on the train split, the eval form on the others. The
raw-image datasets (flowers, imagenet) and the uint8 in-memory ones
(mnist, cifar10, prepared) take it; voc and synthetic refuse it, as in
the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from tensorflow_yolo2_torch.data.memory import InMemoryImdb


class SyntheticClassification(InMemoryImdb):
    """In-memory seeded random classification data: float32 images in
    [-1, 1] and labels in [label_min, num_class), the JAX package's
    numpy draws (the same arrays for a seed)."""

    def __init__(self, split: str = "train", batch_size: int = 32,
                 num_class: int = 10, image_size: int = 64, seed: int = 0,
                 size: int = 256, label_min: int = 0, **_: Any):
        self.name = f"synthetic_{num_class}"
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_class = num_class
        self.classes = tuple(f"class_{i}" for i in range(num_class))
        rng = np.random.RandomState(seed + (0 if split == "train" else 1))
        self._images = rng.uniform(-1, 1, (size, image_size, image_size, 3)
                                   ).astype(np.float32)
        self._labels = rng.randint(label_min, num_class, size
                                   ).astype(np.int32)
        self._init_order(seed)


def _with_preprocess(imdb, preprocessing_name, split):
    """Set an in-memory uint8 dataset's ``preprocess_fn`` from the
    factory (the train form on the train split)."""
    if preprocessing_name:
        from tensorflow_yolo2_torch.data.preprocessing import (
            get_preprocessing,
        )

        imdb.preprocess_fn = get_preprocessing(
            preprocessing_name, is_training=split == "train",
            image_size=imdb.image_size)
    return imdb


def get_dataset(name: str, split: str = "train", **kwargs: Any):
    """Build a dataset by name (module docstring); ``ValueError`` for an
    unknown one."""
    name = name.lower()
    pp_name = kwargs.get("preprocessing_name")
    if name == "flowers":
        from tensorflow_yolo2_torch.data.flowers import TFFlowers

        return TFFlowers(batch_size=kwargs.get("batch_size", 16),
                         image_size=kwargs.get("image_size", 224),
                         val_split=kwargs.get("val_split", 0.2),
                         data_path=kwargs.get("data_path"),
                         seed=kwargs.get("seed", 0),
                         preprocess_name=pp_name)
    if name in ("imagenet", "ilsvrc", "ilsvrc_2017_cls"):
        from tensorflow_yolo2_torch.data.ilsvrc import IlsvrcCls

        if split in ("validation", "test"):  # slim's canonical split name
            split = "val"
        return IlsvrcCls(split, batch_size=kwargs.get("batch_size", 48),
                         data_path=kwargs.get("data_path"),
                         data_aug=split == "train",
                         preprocess_name=pp_name)
    if name in ("voc", "pascal", "voc_2007", "synthetic") and pp_name:
        raise ValueError(f"preprocessing_name={pp_name!r} is not supported "
                         f"by dataset {name!r}")
    if name in ("voc", "pascal", "voc_2007"):
        from tensorflow_yolo2_torch.data.voc import PascalVOC

        return PascalVOC(split if split != "train" else "trainval",
                         batch_size=kwargs.get("batch_size", 24),
                         data_path=kwargs.get("data_path"))
    if name == "mnist":
        from tensorflow_yolo2_torch.data.mnist import MNIST

        return _with_preprocess(
            MNIST(split, batch_size=kwargs.get("batch_size", 32),
                  data_path=kwargs.get("data_path"),
                  seed=kwargs.get("seed", 0)), pp_name, split)
    if name in ("cifar10", "cifar-10"):
        from tensorflow_yolo2_torch.data.cifar10 import Cifar10

        return _with_preprocess(
            Cifar10(split, batch_size=kwargs.get("batch_size", 32),
                    data_path=kwargs.get("data_path"),
                    seed=kwargs.get("seed", 0)), pp_name, split)
    if name == "prepared":
        from tensorflow_yolo2_torch.data.prepared import PreparedDataset

        if not kwargs.get("data_path"):
            raise ValueError("prepared dataset needs data_path=<shard dir>")
        return _with_preprocess(
            PreparedDataset(kwargs["data_path"],
                            batch_size=kwargs.get("batch_size", 32),
                            seed=kwargs.get("seed", 0)), pp_name, split)
    if name == "synthetic":
        return SyntheticClassification(split, **kwargs)
    if name == "synthetic-bg":
        return SyntheticClassification(split, label_min=1, **kwargs)
    raise ValueError(f"Name of dataset unknown {name!r}")
