"""Prepared (converted once) datasets (port of
tensorflow_yolo2_tpu/data/prepared.py).

``convert_image_directory`` packs a directory-per-class image tree into
compressed npz shards of decoded, resized uint8 images and int32 labels
with a ``manifest.json``; ``convert_arrays`` packs arrays already
decoded (MNIST, CIFAR-10) the same way; ``PreparedDataset`` reads the
shards back as an in-memory dataset. The shards and the manifest are the
JAX package's, byte for byte, so each package reads the other's.
Converting once takes the image decode out of the training loop.

    python -m tensorflow_yolo2_torch.data.prepared DATA_DIR OUT_DIR \\
        --image-size 224 --shard-size 256
"""

from __future__ import annotations

import json
import os
from typing import Any

import cv2
import numpy as np

from tensorflow_yolo2_torch.data.memory import InMemoryImdb


def convert_image_directory(data_dir: str, out_dir: str,
                            image_size: int = 224,
                            shard_size: int = 256,
                            rgb: bool = False) -> dict:
    """dir-per-class images → npz shards of (images uint8, labels int32).

    Returns the manifest (also written to ``manifest.json``).
    """
    classes = tuple(sorted(
        d for d in os.listdir(data_dir)
        if os.path.isdir(os.path.join(data_dir, d))))
    entries = []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(data_dir, cls)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith((".jpg", ".jpeg", ".png")):
                entries.append((os.path.join(cdir, fn), ci))
    rng = np.random.RandomState(0)
    rng.shuffle(entries)

    os.makedirs(out_dir, exist_ok=True)
    shards = []
    for si in range(0, len(entries), shard_size):
        chunk = entries[si:si + shard_size]
        images = np.zeros((len(chunk), image_size, image_size, 3), np.uint8)
        labels = np.zeros(len(chunk), np.int32)
        for i, (path, ci) in enumerate(chunk):
            img = cv2.imread(path)
            if rgb:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            images[i] = cv2.resize(img, (image_size, image_size))
            labels[i] = ci
        name = f"shard_{si // shard_size:05d}.npz"
        np.savez_compressed(os.path.join(out_dir, name),
                            images=images, labels=labels)
        shards.append(name)
    manifest = {"classes": classes, "num_examples": len(entries),
                "image_size": image_size, "shards": shards, "rgb": rgb}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def convert_arrays(images: np.ndarray, labels: np.ndarray,
                   classes: tuple, out_dir: str,
                   shard_size: int = 256) -> dict:
    """Pack already-decoded (images, labels) arrays into npz shards with
    a PreparedDataset-readable manifest (the per-dataset converter body
    of reference download_and_convert_{cifar10,mnist}.py, minus the
    network fetch)."""
    os.makedirs(out_dir, exist_ok=True)
    shards = []
    for si in range(0, len(labels), shard_size):
        name = f"shard_{si // shard_size:05d}.npz"
        np.savez_compressed(os.path.join(out_dir, name),
                            images=images[si:si + shard_size],
                            labels=labels[si:si + shard_size].astype(
                                np.int32))
        shards.append(name)
    manifest = {"classes": list(classes), "num_examples": int(len(labels)),
                "image_size": int(images.shape[1]), "shards": shards,
                "rgb": True}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class PreparedDataset(InMemoryImdb):
    """imdb over converted shards (uniform get/classes/... interface).

    Images come back float32 in [-1, 1] (the repo convention)."""

    def __init__(self, out_dir: str, batch_size: int = 32, seed: int = 0,
                 **_: Any):
        with open(os.path.join(out_dir, "manifest.json")) as f:
            manifest = json.load(f)
        self.name = "prepared_" + os.path.basename(os.path.normpath(out_dir))
        self.classes = tuple(manifest["classes"])
        self.num_class = len(self.classes)
        self.image_size = manifest["image_size"]
        self.batch_size = batch_size
        arrays = [np.load(os.path.join(out_dir, s)) for s in
                  manifest["shards"]]
        self._images = np.concatenate([a["images"] for a in arrays])
        self._labels = np.concatenate([a["labels"] for a in arrays])
        self._init_order(seed)


def main(argv: list[str] | None = None) -> int:
    """Converter CLI (reference download_and_convert_data.py)."""
    import argparse

    p = argparse.ArgumentParser(description=convert_image_directory.__doc__)
    p.add_argument("data_dir")
    p.add_argument("out_dir")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--shard-size", type=int, default=256)
    p.add_argument("--rgb", action="store_true")
    args = p.parse_args(argv)
    manifest = convert_image_directory(args.data_dir, args.out_dir,
                                       args.image_size, args.shard_size,
                                       args.rgb)
    print(f"converted {manifest['num_examples']} images, "
          f"{len(manifest['shards'])} shards, "
          f"{len(manifest['classes'])} classes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
