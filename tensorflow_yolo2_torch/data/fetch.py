"""Dataset download and unpacking (port of
tensorflow_yolo2_tpu/data/fetch.py).

Fetches a dataset's raw files over a URL (``urllib``; ``file://`` URLs
take the same path, which is how a machine without network access reads
a local mirror), shows a progress line, and unpacks tar, tar.gz and zip
archives into the dataset directory, refusing a member whose path would
land outside it or that is a link. ``DATASET_URLS`` holds the
reference's URL tables for cifar10, mnist and flowers.
"""

from __future__ import annotations

import gzip
import os
import shutil
import sys
import tarfile
import urllib.request
import zipfile

# The reference's URL tables: name → (urls, the subdir the archive
# unpacks to, or None).
DATASET_URLS: dict[str, tuple[tuple[str, ...], str | None]] = {
    "cifar10": (
        ("https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",),
        "cifar-10-batches-py",
    ),
    "mnist": (
        tuple(
            "http://yann.lecun.com/exdb/mnist/" + f
            for f in (
                "train-images-idx3-ubyte.gz",
                "train-labels-idx1-ubyte.gz",
                "t10k-images-idx3-ubyte.gz",
                "t10k-labels-idx1-ubyte.gz",
            )
        ),
        None,
    ),
    "flowers": (
        ("http://download.tensorflow.org/example_images/flower_photos.tgz",),
        "flower_photos",
    ),
}

_ARCHIVE_SUFFIXES = (".tar.gz", ".tgz", ".tar", ".zip")


def download(url: str, dataset_dir: str, *, progress: bool = True) -> str:
    """Fetch ``url`` into ``dataset_dir``; skip if already present.

    Returns the local file path; ``file://`` URLs read a local mirror.
    """
    os.makedirs(dataset_dir, exist_ok=True)
    filename = url.rstrip("/").split("/")[-1]
    filepath = os.path.join(dataset_dir, filename)
    if os.path.exists(filepath) and os.path.getsize(filepath) > 0:
        return filepath

    def _progress(count: int, block_size: int, total_size: int) -> None:
        if total_size > 0:
            pct = min(100.0, 100.0 * count * block_size / total_size)
            sys.stdout.write(f"\r>> Downloading {filename} {pct:.1f}%")
            sys.stdout.flush()

    tmp = filepath + ".part"
    urllib.request.urlretrieve(url, tmp, _progress if progress else None)
    os.replace(tmp, filepath)
    if progress:
        print(f"\n>> Downloaded {filename} "
              f"({os.path.getsize(filepath)} bytes)")
    return filepath


def _safe_members(tar: tarfile.TarFile, dest: str):
    dest_real = os.path.realpath(dest)
    for member in tar.getmembers():
        target = os.path.realpath(os.path.join(dest, member.name))
        if not (target == dest_real
                or target.startswith(dest_real + os.sep)):
            raise ValueError(
                f"archive member escapes extraction dir: {member.name!r}")
        if member.islnk() or member.issym():
            raise ValueError(
                f"refusing link member in dataset archive: {member.name!r}")
        yield member


def uncompress(filepath: str, dataset_dir: str) -> str:
    """Unpack an archive in place; return the path of what it produced.

    tar/tgz/zip archives extract into ``dataset_dir``; a bare ``.gz``
    (the MNIST IDX files) is left compressed — the readers open ``.gz``
    transparently (``data.mnist``). Non-archives pass through.
    """
    name = os.path.basename(filepath)
    if name.endswith((".tar.gz", ".tgz", ".tar")):
        mode = "r:gz" if name.endswith(("gz",)) else "r"
        with tarfile.open(filepath, mode) as tar:
            tar.extractall(dataset_dir,
                           members=_safe_members(tar, dataset_dir),
                           filter="data")
        return dataset_dir
    if name.endswith(".zip"):
        with zipfile.ZipFile(filepath) as zf:
            dest_real = os.path.realpath(dataset_dir)
            for member in zf.namelist():
                target = os.path.realpath(os.path.join(dataset_dir, member))
                if not (target == dest_real
                        or target.startswith(dest_real + os.sep)):
                    raise ValueError(
                        f"archive member escapes extraction dir: {member!r}")
            zf.extractall(dataset_dir)
        return dataset_dir
    return filepath


def gunzip(filepath: str, dest: str | None = None) -> str:
    """Decompress a single ``.gz`` file (kept for callers that need the
    raw bytes on disk; the MNIST path does not)."""
    dest = dest or filepath[: -len(".gz")]
    with gzip.open(filepath, "rb") as src, open(dest, "wb") as out:
        shutil.copyfileobj(src, out)
    return dest


def fetch_dataset(
    name: str,
    dataset_dir: str,
    urls: tuple[str, ...] | list[str] | None = None,
    *,
    progress: bool = True,
) -> str:
    """Download + unpack a dataset's raw artifacts; return the source dir
    the converter should read (reference flow: download_and_convert_*.py
    ``run()`` calls download_and_uncompress_tarball then converts).

    ``urls`` overrides the built-in table — pass ``file://`` mirrors here.
    """
    table = DATASET_URLS.get(name)
    if urls is None:
        if table is None:
            raise ValueError(f"no built-in URL table for dataset {name!r}; "
                             "pass --download-url")
        urls = table[0]
    subdir = table[1] if table else None

    for url in urls:
        filepath = download(url, dataset_dir, progress=progress)
        if filepath.endswith(_ARCHIVE_SUFFIXES):
            uncompress(filepath, dataset_dir)

    if subdir and os.path.isdir(os.path.join(dataset_dir, subdir)):
        return os.path.join(dataset_dir, subdir)
    return dataset_dir
