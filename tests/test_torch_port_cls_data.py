"""The port's classification data path against the JAX package on the
CPU: the augmentation chain, ``IlsvrcCls``, ``EpochShardedStream``, the
process prefetch loader and the synset maps.

Everything here is exact: the same cv2 calls on arrays of the same types
from the same ``random.Random`` draws give the same bytes, so images are
compared bit for bit, labels, cursors and epochs for equality.
"""

import functools
import os
import random

import cv2
import numpy as np
import pytest

from tensorflow_yolo2_torch.config import Paths as PtPaths
from tensorflow_yolo2_torch.data import augment as pt_aug
from tensorflow_yolo2_torch.data import prefetch as pt_prefetch
from tensorflow_yolo2_torch.data import synsets as pt_synsets
from tensorflow_yolo2_torch.data.ilsvrc import IlsvrcCls as PtIlsvrc
from tensorflow_yolo2_tpu.config import Paths as JxPaths
from tensorflow_yolo2_tpu.data import augment as jx_aug
from tensorflow_yolo2_tpu.data import prefetch as jx_prefetch
from tensorflow_yolo2_tpu.data import synsets as jx_synsets
from tensorflow_yolo2_tpu.data.ilsvrc import IlsvrcCls as JxIlsvrc


def _images():
    """Seeded uint8 images: portrait, landscape, square and one smaller
    than the crop's short side."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, shape).astype(np.uint8)
            for shape in ((90, 70, 3), (60, 100, 3), (80, 80, 3),
                          (40, 52, 3))]


@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("rgb", [False, True])
def test_augment_image_bit_equal_to_jax(u8, rgb):
    """48 draws an image (every branch: flip, rotation, colour with both
    signs, exposure both ways, crop, too small, warp), the same bytes and
    the same rng state after each."""
    kw = dict(image_size=64, rand_crop_upbound=83)
    pcfg, jcfg = pt_aug.AugmentConfig(**kw), jx_aug.AugmentConfig(**kw)
    pfn = pt_aug.augment_image_u8 if u8 else pt_aug.augment_image
    jfn = jx_aug.augment_image_u8 if u8 else jx_aug.augment_image
    prng, jrng = random.Random(11), random.Random(11)
    for image in _images():
        for _ in range(48):
            got = pfn(image, pcfg, prng, rgb=rgb)
            want = jfn(image, jcfg, jrng, rgb=rgb)
            assert got.dtype == want.dtype == (np.uint8 if u8
                                               else np.float32)
            assert got.shape == want.shape == (64, 64, 3)
            np.testing.assert_array_equal(got, want)
            assert prng.getstate() == jrng.getstate()


def test_augment_image_noise_bit_equal_to_jax():
    kw = dict(image_size=64, rand_crop_upbound=83, random_noise=True)
    prng, jrng = random.Random(3), random.Random(3)
    for image in _images():
        for _ in range(8):
            np.testing.assert_array_equal(
                pt_aug.augment_image(image, pt_aug.AugmentConfig(**kw), prng),
                jx_aug.augment_image(image, jx_aug.AugmentConfig(**kw),
                                     jrng))
    with pytest.raises(ValueError, match="random_noise"):
        pt_aug.augment_image_u8(_images()[0], pt_aug.AugmentConfig(**kw),
                                prng)


def test_read_and_augment_bit_equal_to_jax(tmp_path):
    path = str(tmp_path / "a.jpg")
    cv2.imwrite(path, _images()[0])
    prng, jrng = random.Random(5), random.Random(5)
    for rgb in (False, True, False):
        np.testing.assert_array_equal(
            pt_aug.read_and_augment(path, pt_aug.AugmentConfig(), prng, rgb),
            jx_aug.read_and_augment(path, jx_aug.AugmentConfig(), jrng, rgb))
    with pytest.raises(FileNotFoundError):
        pt_aug.read_and_augment(str(tmp_path / "none.jpg"),
                                pt_aug.AugmentConfig(), prng)


# -- IlsvrcCls ----------------------------------------------------------------


def _pair(ilsvrc_dir, tmp_path, image_set, **kw):
    return (PtIlsvrc(image_set, data_path=ilsvrc_dir,
                     paths=PtPaths(str(tmp_path / "pt")), **kw),
            JxIlsvrc(image_set, data_path=ilsvrc_dir,
                     paths=JxPaths(str(tmp_path / "jx")), **kw))


@pytest.mark.parametrize("image_set,kw", [
    ("train", dict(data_aug=True)),
    ("train", dict(data_aug=True, uint8=True, rgb=True)),
    ("val", dict()),
    ("val", dict(uint8=True)),
    ("val", dict(resize_policy="pad")),
    ("train", dict(resize_policy="pad", uint8=True)),
])
def test_ilsvrc_batches_bit_equal_to_jax(ilsvrc_dir, tmp_path, image_set,
                                         kw):
    """Batches of 5 over two epochs (12 train / 6 val entries): images
    bit for bit, labels, cursor and epoch; then again from the pickle
    cache each package wrote."""
    for _ in range(2):  # the second time from the caches
        pt, jx = _pair(ilsvrc_dir, tmp_path, image_set, batch_size=5,
                       image_size=64, seed=4, **kw)
        assert pt.classes == jx.classes and pt.num_class == 3
        assert pt.gt_labels == jx.gt_labels
        assert pt.total_batch == jx.total_batch
        for _ in range(5):
            (pi, pl), (ji, jl) = pt.get(), jx.get()
            assert pi.dtype == ji.dtype == (np.uint8 if kw.get("uint8")
                                            else np.float32)
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pl, jl)
            assert pl.dtype == np.int32
            assert (pt.cursor, pt.epoch) == (jx.cursor, jx.epoch)
        assert pt.epoch > 1
    assert os.path.isfile(os.path.join(
        str(tmp_path / "pt"), "cache", f"ilsvrc_{image_set}_gt_labels.pkl"))


def test_ilsvrc_refusals(ilsvrc_dir, tmp_path):
    paths = PtPaths(str(tmp_path))
    with pytest.raises(ValueError, match="use float transfer"):
        PtIlsvrc("train", data_path=ilsvrc_dir, paths=paths, uint8=True,
                 preprocess_name="inception_v1")
    with pytest.raises(ValueError, match="random_noise"):
        PtIlsvrc("train", data_path=ilsvrc_dir, paths=paths, uint8=True,
                 random_noise=True)
    with pytest.raises(FileNotFoundError, match="ILSVRC path"):
        PtIlsvrc("val", data_path=str(tmp_path / "none"), paths=paths)


# -- EpochShardedStream and the process loader --------------------------------


def test_epoch_slice_matches_jax():
    pt = pt_prefetch.EpochShardedStream(None, batch_size=4, seed=7)
    jx = jx_prefetch.EpochShardedStream(None, batch_size=4, seed=7)
    for epoch in range(3):
        slices = [pt.epoch_slice(epoch, w, 2, 13) for w in range(2)]
        assert slices == [jx.epoch_slice(epoch, w, 2, 13) for w in range(2)]
        assert sorted(slices[0] + slices[1]) == list(range(13))
    assert pt.epoch_slice(0, 0, 1, 13) != pt.epoch_slice(1, 0, 1, 13)


def _imdb(ilsvrc_dir, root, cls):
    paths = (PtPaths if cls is PtIlsvrc else JxPaths)(root)
    return cls("train", batch_size=4, image_size=64, data_aug=False,
               data_path=ilsvrc_dir, seed=2, paths=paths)


def test_epoch_sharded_stream_bit_equal_to_jax(ilsvrc_dir, tmp_path):
    """Two workers, two epochs, in one process: the same batches as JAX's,
    and across the workers every entry once an epoch."""
    root = str(tmp_path)
    kw = dict(batch_size=4, epochs=2, seed=3)
    pt = pt_prefetch.EpochShardedStream(
        functools.partial(_imdb, ilsvrc_dir, root, PtIlsvrc), **kw)
    jx = jx_prefetch.EpochShardedStream(
        functools.partial(_imdb, ilsvrc_dir, root, JxIlsvrc), **kw)
    seen = []
    for w in range(2):
        pget, jget = pt(w, 2), jx(w, 2)
        while True:
            try:
                pb = pget()
            except StopIteration:
                with pytest.raises(StopIteration):
                    jget()
                break
            jb = jget()
            for a, b in zip(pb, jb):
                np.testing.assert_array_equal(a, b)
            seen.append(pb[1])
    labels = np.concatenate(seen)
    imdb = _imdb(ilsvrc_dir, root, PtIlsvrc)
    # 12 entries: 6 a worker an epoch, a batch of 4 and one of 2
    assert len(labels) == 2 * 12
    want = np.bincount([c for _, c in imdb.gt_labels], minlength=3) * 2
    np.testing.assert_array_equal(np.bincount(labels, minlength=3), want)


def _fails(worker_id, num_workers):
    def get_batch():
        raise OSError(f"worker {worker_id} cannot read")
    return get_batch


def test_process_prefetch_loader(ilsvrc_dir, tmp_path):
    """Two spawned workers over one epoch deliver every entry once, then
    the stream ends; a worker's error reaches the parent."""
    stream = pt_prefetch.EpochShardedStream(
        functools.partial(_imdb, ilsvrc_dir, str(tmp_path), PtIlsvrc),
        batch_size=4, epochs=1, seed=3, drop_remainder=True)
    with pt_prefetch.ProcessPrefetchLoader(stream, num_workers=2,
                                           prefetch_size=4) as loader:
        batches = list(loader)
    assert len(batches) == 2  # 6 entries a worker: one full batch each
    assert all(b[0].shape == (4, 64, 64, 3) for b in batches)
    with pt_prefetch.ProcessPrefetchLoader(_fails, num_workers=1) as loader:
        with pytest.raises(RuntimeError, match="cannot read"):
            next(loader)


# -- synsets ------------------------------------------------------------------


def test_synset_maps_match_jax(tmp_path):
    listing = tmp_path / "synsets.txt"
    listing.write_text("n01440764\n\nn01443537\nn01484850\n")
    meta = tmp_path / "meta.txt"
    meta.write_text("1 n01440764 tench\n2 n01443537 goldfish\nbad\n")
    syn = pt_synsets.load_synset_list(str(listing))
    assert syn == jx_synsets.load_synset_list(str(listing))
    assert pt_synsets.build_maps_from_list(syn) == \
        jx_synsets.build_maps_from_list(syn)
    assert pt_synsets.build_maps_from_meta(str(meta)) == \
        jx_synsets.build_maps_from_meta(str(meta))
    maps = pt_synsets.build_maps_from_list(syn)
    pt_synsets.save_maps(*maps, str(tmp_path / "out"))
    assert jx_synsets.load_maps(str(tmp_path / "out")) == maps
