"""The port's preprocessing factory (``data.preprocessing``) against the
JAX package's on the CPU, bit for bit: each family (vgg, inception,
darknet, lenet, cifarnet) in its train and eval form on seeded BGR
images of several shapes (one smaller than the crop), from one seed, so
that the ``random.Random`` draw order is part of the result; the
``_FAMILIES`` table; the tf.image-convention pieces (RGB↔HSV,
``distort_color`` with each of its orderings in fast and full mode,
``sample_distorted_bounding_box`` with and without boxes to cover,
``central_crop``, ``crop_or_pad``, the per-image standardization).
"""

import random

import numpy as np
import pytest

from tensorflow_yolo2_torch.data import preprocessing as pt_pp
from tensorflow_yolo2_tpu.data import preprocessing as jx_pp

FAMILIES = ("vgg", "inception", "darknet19", "lenet", "cifarnet")


def _images():
    """Seeded uint8 BGR images: landscape, portrait, square, and one
    smaller than a 32² crop."""
    rng = np.random.RandomState(11)
    return [rng.randint(0, 256, shape).astype(np.uint8)
            for shape in ((60, 90, 3), (96, 64, 3), (48, 48, 3),
                          (20, 26, 3))]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_is_bit_equal_to_jax(name, train):
    """Two passes over the images through one function of each package
    (the second pass continues the draws): the same float32 arrays."""
    size = 32
    pt = pt_pp.get_preprocessing(name, is_training=train, image_size=size,
                                 seed=9)
    jx = jx_pp.get_preprocessing(name, is_training=train, image_size=size,
                                 seed=9)
    for _ in range(2):
        for image in _images():
            got, want = pt(image), jx(image)
            assert got.dtype == want.dtype
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_families_table_matches_jax():
    assert {k: v.__name__ for k, v in pt_pp._FAMILIES.items()} == \
        {k: v.__name__ for k, v in jx_pp._FAMILIES.items()}
    for pkg in (pt_pp, jx_pp):
        with pytest.raises(ValueError, match="was not recognized"):
            pkg.get_preprocessing("nosuch")


def test_hsv_round_trip_matches_jax():
    rgb = np.random.RandomState(4).uniform(0, 1, (17, 19, 3)).astype(
        np.float32)
    rgb[0, :4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0]]
    hsv = pt_pp._rgb_to_hsv(rgb)
    np.testing.assert_array_equal(hsv, jx_pp._rgb_to_hsv(rgb))
    np.testing.assert_array_equal(pt_pp._hsv_to_rgb(hsv),
                                  jx_pp._hsv_to_rgb(hsv))


@pytest.mark.parametrize("fast_mode", [True, False], ids=["fast", "full"])
@pytest.mark.parametrize("ordering", [0, 1, 2, 3])
def test_distort_color_matches_jax(ordering, fast_mode):
    rgb = np.random.RandomState(ordering).uniform(0, 1, (12, 10, 3)).astype(
        np.float32)
    got = pt_pp.distort_color(rgb.copy(), ordering, random.Random(ordering),
                              fast_mode)
    want = jx_pp.distort_color(rgb.copy(), ordering, random.Random(ordering),
                               fast_mode)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("bboxes", [None, [[0.1, 0.2, 0.5, 0.6]],
                                    [[0.0, 0.0, 0.05, 0.05],
                                     [0.4, 0.4, 1.0, 1.0]]])
def test_sample_distorted_bounding_box_matches_jax(bboxes):
    boxes = None if bboxes is None else np.asarray(bboxes)
    a, b = random.Random(1), random.Random(1)
    for h, w in ((100, 60), (40, 200), (3, 3), (299, 299)):
        kw = dict(bboxes=boxes, min_object_covered=0.3)
        assert pt_pp.sample_distorted_bounding_box(h, w, a, **kw) == \
            jx_pp.sample_distorted_bounding_box(h, w, b, **kw)
    assert a.getstate() == b.getstate()


def test_crops_and_standardize_match_jax():
    image = np.random.RandomState(2).randint(0, 256, (37, 50, 3)).astype(
        np.float32)
    for fraction in (0.875, 0.5, 1.0):
        np.testing.assert_array_equal(pt_pp.central_crop(image, fraction),
                                      jx_pp.central_crop(image, fraction))
    for size in (16, 40, 64):
        np.testing.assert_array_equal(pt_pp.crop_or_pad(image, size),
                                      jx_pp.crop_or_pad(image, size))
    np.testing.assert_array_equal(pt_pp._standardize(image),
                                  jx_pp._standardize(image))
    flat = np.full((4, 4, 3), 7.0, np.float32)  # stddev 0: the floor
    np.testing.assert_array_equal(pt_pp._standardize(flat),
                                  jx_pp._standardize(flat))
