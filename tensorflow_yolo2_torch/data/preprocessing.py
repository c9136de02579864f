"""The preprocessing factory, one function a model family (port of
tensorflow_yolo2_tpu/data/preprocessing.py).

Host-side numpy / cv2 functions of a BGR uint8 image, each with a train
(augmenting) and an eval form, chosen by model name as slim's
``preprocessing_factory`` does: ``vgg`` (the VGG and ResNet names: an
aspect-preserving resize, a crop, the RGB means), ``inception`` (a
sampled distorted box, a flip and one of four colour orderings in
tf.image's HSV convention; eval a central crop), ``darknet`` (the repo's
own warp resize to [-1, 1], ``data.augment``'s chain in training),
``lenet`` and ``cifarnet``. ``get_preprocessing(name, is_training,
image_size, seed)`` returns ``fn(image) → float32 image``; its draws come
from one ``random.Random(seed)`` in the JAX package's order, so the same
seed gives the same output, bit for bit.
"""

from __future__ import annotations

import random
from typing import Callable

import cv2
import numpy as np

from tensorflow_yolo2_torch.data.augment import AugmentConfig, augment_image

# ImageNet RGB means (vgg_preprocessing.py convention, 0-255 scale).
_VGG_MEANS = np.array([123.68, 116.78, 103.94], np.float32)


def _vgg(image: np.ndarray, size: int, train: bool,
         rng: random.Random) -> np.ndarray:
    """Aspect-preserving resize (short side ∈ [256, 512] train / 256 eval
    at size=224, scaling with size as 8/7·size..16/7·size) → random/center
    crop → RGB mean subtraction."""
    h, w = image.shape[:2]
    short = (rng.randint(size * 8 // 7, size * 16 // 7) if train
             else size * 8 // 7)
    scale = short / min(h, w)
    image = cv2.resize(image, (max(size, int(w * scale)),
                               max(size, int(h * scale))))
    h, w = image.shape[:2]
    if train:
        top = rng.randint(0, h - size)
        left = rng.randint(0, w - size)
        if rng.random() < 0.5:
            image = image[:, ::-1]
    else:
        top, left = (h - size) // 2, (w - size) // 2
    crop = image[top:top + size, left:left + size]
    rgb = cv2.cvtColor(crop, cv2.COLOR_BGR2RGB).astype(np.float32)
    return rgb - _VGG_MEANS


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized RGB→HSV on float [0,1] images (tf.image convention:
    h, s, v all in [0,1])."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(axis=-1)
    minc = rgb.min(axis=-1)
    v = maxc
    delta = maxc - minc
    safe = np.where(delta == 0, 1.0, delta)
    s = np.where(maxc == 0, 0.0, delta / np.where(maxc == 0, 1.0, maxc))
    h = np.where(
        maxc == r, (g - b) / safe,
        np.where(maxc == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = np.where(delta == 0, 0.0, h / 6.0) % 1.0
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    choices = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1)], 0)
    return np.take_along_axis(choices, i[None, ..., None],
                              axis=0)[0].astype(hsv.dtype)


def _adjust_saturation(rgb: np.ndarray, factor: float) -> np.ndarray:
    """tf.image.adjust_saturation: RGB→HSV, scale S (clipped), →RGB."""
    hsv = _rgb_to_hsv(rgb)
    hsv[..., 1] = np.clip(hsv[..., 1] * factor, 0.0, 1.0)
    return _hsv_to_rgb(hsv)


def _adjust_hue(rgb: np.ndarray, delta: float) -> np.ndarray:
    """tf.image.adjust_hue: rotate H by delta (fraction of the circle)."""
    hsv = _rgb_to_hsv(rgb)
    hsv[..., 0] = (hsv[..., 0] + delta) % 1.0
    return _hsv_to_rgb(hsv)


def _adjust_contrast(rgb: np.ndarray, factor: float) -> np.ndarray:
    mean_c = rgb.mean(axis=(0, 1), keepdims=True)
    return (rgb - mean_c) * factor + mean_c


def distort_color(image: np.ndarray, color_ordering: int,
                  rng: random.Random, fast_mode: bool = True) -> np.ndarray:
    """Ordered color distortion on an RGB [0,1] image — numpy port of
    inception_preprocessing.py:45-97 (distort_color). The ops are
    non-commutative, so the reference samples one of 4 fixed orderings
    (2 in fast mode); output clipped to [0,1]."""
    def brightness(x):
        return x + rng.uniform(-32.0 / 255.0, 32.0 / 255.0)

    def saturation(x):
        return _adjust_saturation(np.clip(x, 0.0, 1.0),
                                  rng.uniform(0.5, 1.5))

    def hue(x):
        return _adjust_hue(np.clip(x, 0.0, 1.0), rng.uniform(-0.2, 0.2))

    def contrast(x):
        return _adjust_contrast(x, rng.uniform(0.5, 1.5))

    if fast_mode:
        orders = ([brightness, saturation] if color_ordering == 0
                  else [saturation, brightness])
    else:
        orders = {
            0: [brightness, saturation, hue, contrast],
            1: [saturation, brightness, contrast, hue],
            2: [contrast, hue, brightness, saturation],
            3: [hue, saturation, contrast, brightness],
        }[color_ordering]
    for op in orders:
        image = op(image)
    return np.clip(image, 0.0, 1.0)


def sample_distorted_bounding_box(
    h: int,
    w: int,
    rng: random.Random,
    bboxes: np.ndarray | None = None,
    min_object_covered: float = 0.1,
    aspect_ratio_range: tuple[float, float] = (0.75, 1.33),
    area_range: tuple[float, float] = (0.05, 1.0),
    max_attempts: int = 100,
) -> tuple[int, int, int, int]:
    """Numpy port of tf.image.sample_distorted_bounding_box (the kernel
    behind inception_preprocessing.py:99-155): sample (top, left, ch, cw)
    with aspect ratio w/h ∈ aspect_ratio_range, area fraction ∈
    area_range, covering ≥ min_object_covered of some supplied bbox
    ([ymin, xmin, ymax, xmax] in [0,1], rows of ``bboxes``); falls back
    to the whole image after max_attempts (use_image_if_no_bounding_boxes
    semantics when bboxes is None)."""
    total = float(h * w)
    for _ in range(max_attempts):
        aspect = rng.uniform(*aspect_ratio_range)
        min_ch = int(np.ceil(np.sqrt(area_range[0] * total / aspect)))
        max_ch = int(np.floor(np.sqrt(area_range[1] * total / aspect)))
        max_ch = min(max_ch, h, int(w / aspect))
        if max_ch < max(min_ch, 1):
            continue
        ch = rng.randint(max(min_ch, 1), max_ch)
        cw = int(round(ch * aspect))
        if cw < 1 or cw > w:
            continue
        area_frac = (ch * cw) / total
        if not (area_range[0] <= area_frac <= area_range[1]):
            continue
        top = rng.randint(0, h - ch)
        left = rng.randint(0, w - cw)
        if bboxes is not None and len(bboxes):
            covered = False
            for ymin, xmin, ymax, xmax in bboxes:
                by0, bx0 = ymin * h, xmin * w
                by1, bx1 = ymax * h, xmax * w
                barea = max(by1 - by0, 0.0) * max(bx1 - bx0, 0.0)
                iy = max(0.0, min(by1, top + ch) - max(by0, top))
                ix = max(0.0, min(bx1, left + cw) - max(bx0, left))
                if barea > 0 and iy * ix / barea >= min_object_covered:
                    covered = True
                    break
            if not covered:
                continue
        return top, left, ch, cw
    return 0, 0, h, w


def central_crop(image: np.ndarray, fraction: float) -> np.ndarray:
    """tf.image.central_crop: keep the central ``fraction`` along each
    spatial dim (offsets floor'd like the TF op)."""
    h, w = image.shape[:2]
    top = int((h - h * fraction) / 2.0)
    left = int((w - w * fraction) / 2.0)
    return image[top:h - top, left:w - left]


def _inception(image: np.ndarray, size: int, train: bool,
               rng: random.Random, fast_mode: bool = True) -> np.ndarray:
    """Faithful numpy port of slim inception preprocessing
    (inception_preprocessing.py:128-234 train, :237-273 eval).

    Train: distorted-bbox crop (aspect 3/4-4/3, area 5-100%, whole-image
    bbox) → bilinear resize → random flip → one of 4 ordered color
    distortions → (x-0.5)*2. Eval: central_crop(0.875) → bilinear resize
    → (x-0.5)*2."""
    rgb = cv2.cvtColor(image, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    if train:
        h, w = rgb.shape[:2]
        top, left, ch, cw = sample_distorted_bounding_box(h, w, rng)
        rgb = rgb[top:top + ch, left:left + cw]
        rgb = cv2.resize(rgb, (size, size), interpolation=cv2.INTER_LINEAR)
        if rng.random() < 0.5:
            rgb = rgb[:, ::-1]
        # the reference samples 4 cases even in fast mode (orderings 1-3
        # share the saturation-first branch): preprocess_for_train:225-228
        rgb = distort_color(rgb, rng.randint(0, 3), rng,
                            fast_mode=fast_mode)
    else:
        rgb = central_crop(rgb, 0.875)
        rgb = cv2.resize(rgb, (size, size), interpolation=cv2.INTER_LINEAR)
    return (rgb - 0.5) * 2.0


def _darknet(image: np.ndarray, size: int, train: bool,
             rng: random.Random) -> np.ndarray:
    """The repo's own convention: BGR warp-resize, [-1, 1], reference aug
    suite when training (pascal_voc.py:60-67 + ilsvrc aug)."""
    if train:
        return augment_image(image, AugmentConfig(image_size=size), rng)
    image = cv2.resize(image, (size, size)).astype(np.float32)
    return image / 255.0 * 2.0 - 1.0


def crop_or_pad(image: np.ndarray, size: int) -> np.ndarray:
    """Center crop-or-zero-pad to size×size (tf.image
    resize_image_with_crop_or_pad semantics: symmetric floor offsets)."""
    h, w = image.shape[:2]
    if h > size:
        top = (h - size) // 2
        image = image[top:top + size]
    if w > size:
        left = (w - size) // 2
        image = image[:, left:left + size]
    h, w = image.shape[:2]
    if h < size or w < size:
        pt, pl = (size - h) // 2, (size - w) // 2
        pad = [(pt, size - h - pt), (pl, size - w - pl)]
        pad += [(0, 0)] * (image.ndim - 2)
        image = np.pad(image, pad)
    return image


def _standardize(image: np.ndarray) -> np.ndarray:
    """tf.image.per_image_standardization: (x - mean) / adjusted_stddev,
    adjusted_stddev = max(stddev, 1/sqrt(num_elements))."""
    image = image.astype(np.float32)
    std = max(float(image.std()), 1.0 / np.sqrt(image.size))
    return (image - image.mean()) / std


def _lenet(image: np.ndarray, size: int, train: bool,
           rng: random.Random) -> np.ndarray:
    """lenet: crop-or-pad + (x-128)/128, identical train/eval
    (lenet_preprocessing.py:39-44 — no distortions, no flip)."""
    del train, rng
    image = crop_or_pad(image.astype(np.float32), size)
    return (image - 128.0) / 128.0


def _cifarnet(image: np.ndarray, size: int, train: bool,
              rng: random.Random) -> np.ndarray:
    """cifarnet: train = pad 4 → random crop → random flip → random
    brightness (±63) → random contrast (0.2-1.8) → per-image
    standardization (cifarnet_preprocessing.py:30-70); eval =
    crop-or-pad + standardization (:73-96)."""
    image = image.astype(np.float32)
    if train:
        image = np.pad(image, [(4, 4), (4, 4)] + [(0, 0)] * (image.ndim - 2))
        h, w = image.shape[:2]
        top = rng.randint(0, max(h - size, 0))
        left = rng.randint(0, max(w - size, 0))
        image = image[top:top + size, left:left + size]
        image = crop_or_pad(image, size)  # inputs smaller than size-8
        if rng.random() < 0.5:
            image = image[:, ::-1]
        image = image + rng.uniform(-63.0, 63.0)
        # tf.image.random_contrast: per-channel (x - mean_c)*factor + mean_c
        factor = rng.uniform(0.2, 1.8)
        mean_c = image.mean(axis=(0, 1), keepdims=True)
        image = (image - mean_c) * factor + mean_c
    else:
        image = crop_or_pad(image, size)
    return _standardize(image)


_FAMILIES: dict[str, Callable] = {}
for _name in ("vgg", "vgg_a", "vgg_16", "vgg_19", "resnet_v1_50",
              "resnet_v1_101", "resnet_v1_152", "resnet_v1_200", "resnet50",
              # preprocessing_factory.py:59-61 maps resnet_v2 to vgg too
              "resnet_v2_50", "resnet_v2_101", "resnet_v2_152",
              "resnet_v2_200"):
    _FAMILIES[_name] = _vgg  # slim maps resnets to vgg preprocessing (:56-61)
for _name in ("inception", "inception_v1", "inception_v2", "inception_v3",
              "inception_v4", "inception_resnet_v2", "alexnet_v2",
              "overfeat"):
    _FAMILIES[_name] = _inception
for _name in ("darknet19", "darknet19_detection", "yolo1"):
    _FAMILIES[_name] = _darknet
_FAMILIES["lenet"] = _lenet
_FAMILIES["cifarnet"] = _cifarnet


def get_preprocessing(name: str, is_training: bool = False,
                      image_size: int = 224, seed: int = 0) -> Callable:
    """fn(BGR uint8 image) → float32 (image_size, image_size, 3)."""
    if name not in _FAMILIES:
        raise ValueError(f"Preprocessing name [{name}] was not recognized")
    fam = _FAMILIES[name]
    rng = random.Random(seed)

    def preprocess(image: np.ndarray) -> np.ndarray:
        return fam(image, image_size, is_training, rng)

    return preprocess
