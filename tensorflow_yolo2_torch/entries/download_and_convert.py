"""Dataset conversion CLI, download_and_convert (port of
tensorflow_yolo2_tpu/entries/download_and_convert.py).

Turns a raw dataset (``--dataset-name mnist | cifar10 | flowers``) into
prepared shards (``data.prepared``: npz shards and a manifest) under
``--dataset-dir``, one directory a split (mnist and cifar10: ``train``
and ``test``; flowers: ``train``, resized to ``--image-size``), which
train through ``--dataset-name prepared``. The raw files come from
``--source-dir`` (already unpacked: MNIST's IDX files, CIFAR-10's python
or binary batches, a directory-per-class flowers tree), else from
``<root>/data/<name>`` when it exists and no ``--download-url`` is given,
else from the URLs (``--download-url``, repeatable; ``file://`` mirrors
work; without it the reference's URL table of ``data.fetch``), fetched
and unpacked into ``--download-dir`` (default ``<dataset-dir>/raw``).

    python -m tensorflow_yolo2_torch.entries.download_and_convert \\
        --dataset-name cifar10 \\
        --download-url file:///mirrors/cifar-10-python.tar.gz \\
        --dataset-dir $TFY2_ROOT/data/cifar10_prepared
"""

from __future__ import annotations

import argparse
import os


def _convert_mnist(source: str, out_dir: str, shard_size: int) -> dict:
    from tensorflow_yolo2_torch.data.mnist import (
        _SPLIT_FILES,
        read_idx_images,
        read_idx_labels,
    )
    from tensorflow_yolo2_torch.data.prepared import convert_arrays

    manifests = {}
    for split, (img_file, lbl_file) in _SPLIT_FILES.items():
        images = read_idx_images(os.path.join(source, img_file))[..., None]
        labels = read_idx_labels(os.path.join(source, lbl_file))
        manifests[split] = convert_arrays(
            images, labels, tuple(str(i) for i in range(10)),
            os.path.join(out_dir, split), shard_size)
    return manifests


def _convert_cifar10(source: str, out_dir: str, shard_size: int) -> dict:
    from tensorflow_yolo2_torch.data.cifar10 import (
        read_binary_batches,
        read_python_batches,
    )
    from tensorflow_yolo2_torch.data.prepared import convert_arrays

    reader = (read_python_batches
              if os.path.exists(os.path.join(source, "data_batch_1"))
              else read_binary_batches)
    manifests = {}
    for split in ("train", "test"):
        images, labels, names = reader(source, split)
        manifests[split] = convert_arrays(
            images, labels, names, os.path.join(out_dir, split), shard_size)
    return manifests


def _convert_flowers(source: str, out_dir: str, shard_size: int,
                     image_size: int) -> dict:
    from tensorflow_yolo2_torch.data.prepared import convert_image_directory

    return {"train": convert_image_directory(
        source, os.path.join(out_dir, "train"), image_size=image_size,
        shard_size=shard_size)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset-name", required=True,
                   choices=["cifar10", "flowers", "mnist"])
    p.add_argument("--dataset-dir", required=True,
                   help="output directory for the prepared shards")
    p.add_argument("--source-dir", default=None,
                   help="already-unpacked raw dataset (skips the fetch)")
    p.add_argument("--download-url", action="append", default=None,
                   help="URL(s) of the raw artifacts; file:// mirrors "
                        "work. Repeat for multi-file datasets (mnist). "
                        "Omit to use the reference's built-in URL table "
                        "(needs network access).")
    p.add_argument("--download-dir", default=None,
                   help="where fetched archives land (default: "
                        "<dataset-dir>/raw)")
    p.add_argument("--shard-size", type=int, default=256)
    p.add_argument("--image-size", type=int, default=224,
                   help="flowers resize target (mnist/cifar10 keep their "
                        "native sizes)")
    args = p.parse_args(argv)

    from tensorflow_yolo2_torch.config import Paths

    if args.source_dir is not None:
        source = args.source_dir
    else:
        source = os.path.join(Paths().root, "data", args.dataset_name)
        if not os.path.isdir(source) or args.download_url:
            from tensorflow_yolo2_torch.data.fetch import fetch_dataset

            raw_dir = args.download_dir or os.path.join(args.dataset_dir,
                                                        "raw")
            source = fetch_dataset(args.dataset_name, raw_dir,
                                   urls=args.download_url)
    if not os.path.isdir(source):
        p.error(f"raw {args.dataset_name} not found at {source}; pass "
                "--source-dir with a local mirror or --download-url "
                "(file:// works without network access)")

    if args.dataset_name == "mnist":
        manifests = _convert_mnist(source, args.dataset_dir,
                                   args.shard_size)
    elif args.dataset_name == "cifar10":
        manifests = _convert_cifar10(source, args.dataset_dir,
                                     args.shard_size)
    else:
        manifests = _convert_flowers(source, args.dataset_dir,
                                     args.shard_size, args.image_size)
    for split, m in manifests.items():
        print(f"{args.dataset_name}/{split}: {m['num_examples']} examples, "
              f"{len(m['shards'])} shards, {len(m['classes'])} classes "
              f"-> {os.path.join(args.dataset_dir, split)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
