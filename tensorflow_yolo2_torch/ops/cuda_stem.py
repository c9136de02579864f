"""The fused Darknet19 stem: CUDA kernels and their plain PyTorch version
(port of tensorflow_yolo2_tpu/ops/pallas_stem.py).

``fused_stem`` computes the first two stages of the folded Darknet19
trunk, conv1 3×3 3→32 + bias + leaky + 2×2 max pool, then conv2 3×3
32→64 + bias + leaky + 2×2 max pool, SAME padding, on an NHWC image batch
(N, H, W, 3) with H and W multiples of 4, into (N, H/4, W/4, 64). On the
card it is one of two kernels, both replacing ``_stem_kernel``, by the
images' type:

- bfloat16: ``csrc/stem.cu`` (B4): one block a tile of 8×16 output
  pixels, the stage-1 map kept in shared memory, both convs on the
  tensor cores. Its work, 2.2 GFLOP an image at 448², bounds it, not its
  bytes: 0.569 ms at batch 256 on an H100. conv1 runs on ``mma.sync``
  with its B fragments and bias held in registers for the life of a
  block; conv2, 84% of the work, on Hopper's ``wgmma`` (m64n64k16, A from
  registers, B from shared memory through a descriptor). What is left
  (the source says more): conv1 takes the largest share of the time, its
  K padded from 27 to 32 and its halo recomputed 1.27×; a tile's loads do
  not overlap its own math (no TMA or ``cp.async`` pipeline, no warp
  specialisation).
- float32: ``csrc/stem_f32.cu`` (B4-f32): the same tiles, the stage-1
  map kept in float32, both convs in float32 on the FMA units (TF32
  would not meet the 1e-5 the plain version is held to), reading the
  HWIO kernels as they are. Bound by operations: 8.39 ms at batch 256,
  448², at 67 TFLOP/s.

Each kernel rounds where ``_stem_kernel`` rounds in its type: inputs and
weights in the working type, float32 sums, bias and leaky
``max(0.1·x, x)`` in float32, the stage-1 map rounded to the working type
once and the output once (no rounding in float32). ``fused_stem_plain``
is the same function in plain PyTorch with those rounding points (the
XLA composition ``stem_reference`` rounds each conv output as well, and
is kept for tests). A wrapper takes the plain version only for a tensor
on the CPU, in any floating type; on a CUDA tensor it launches the
kernel of its type (``cuda_kernel``), or raises for any other type.
``STEM_LAUNCHES`` and ``STEM_F32_LAUNCHES`` count kernel launches.

``pack_stem_weights`` builds the kernels' operands once: the contiguous
float32 HWIO kernels and biases (B4-f32's operands, and the plain
version's); for B4 the kernels reshaped to (9·C, O), k = (dy·3 + dx)·C +
c, conv1's K zero-padded from 27 to 32 in the order of ``mma.sync``'s B
fragments (``mma_fragments``), conv2's in ``wgmma``'s K-major layout
without swizzle (``wgmma_tiles``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tensorflow_yolo2_torch.models.fast_stem import detect_tail
from tensorflow_yolo2_torch.models.layers import leaky_relu
from tensorflow_yolo2_torch.utils import cuda_build

STEM_LAUNCHES = 0
STEM_F32_LAUNCHES = 0

C1, C2 = 32, 64


def reset_launch_counts() -> None:
    global STEM_LAUNCHES, STEM_F32_LAUNCHES
    STEM_LAUNCHES = 0
    STEM_F32_LAUNCHES = 0


def bind(lib: ctypes.CDLL, entry: str = "tfy2_fused_stem") -> ctypes.CDLL:
    """Declares the C entry of a library built from ``csrc/stem.cu``
    (``tfy2_fused_stem``) or ``csrc/stem_f32.cu``
    (``tfy2_fused_stem_f32``); both take the same arguments."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, entry)
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    fn.restype = i32
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(cuda_build.load("stem"))


@functools.cache
def _lib_f32() -> ctypes.CDLL:
    return bind(cuda_build.load("stem_f32"), "tfy2_fused_stem_f32")


# the kernel (csrc/<name>.cu) that runs a CUDA batch of each type
CUDA_KERNELS = {torch.bfloat16: "stem", torch.float32: "stem_f32"}


def cuda_kernel(dtype: torch.dtype) -> str:
    """The name of the kernel (``csrc/<name>.cu``) that runs images of
    ``dtype`` on the card; raises ``TypeError`` for a type with none."""
    if dtype not in CUDA_KERNELS:
        raise TypeError(f"the CUDA stem takes bfloat16 or float32 images, "
                        f"got {dtype}")
    return CUDA_KERNELS[dtype]


class StemWeights(NamedTuple):
    """The stem's weights: contiguous float32 HWIO kernels and biases for
    the plain version and B4-f32, and B4's bf16 B operands: conv1's as
    ``mma.sync`` fragments, conv2's as ``wgmma`` tiles."""
    w1: torch.Tensor  # (3, 3, 3, 32)
    b1: torch.Tensor  # (32,)
    w2: torch.Tensor  # (3, 3, 32, 64)
    b2: torch.Tensor  # (64,)
    w1_frags: torch.Tensor  # (2, 4, 32, 4) bf16
    w2_tiles: torch.Tensor  # (18, 8, 2, 8, 8) bf16


def mma_fragments(w: torch.Tensor) -> torch.Tensor:
    """A (3, 3, C, O) kernel as the B operand of ``mma.sync.m16n8k16``:
    the (9C, O) matrix, K zero-padded to a multiple of 16, cut into K
    steps of 16 and N tiles of 8, each tile as its 32 lanes hold it. Lane
    g·4 + t of tile (s, j) holds rows 16s + 2t, +1, +8, +9 of column
    8j + g, in that order. Returns (K/16, O/8, 32, 4) bfloat16."""
    kh, kw, c, o = w.shape
    b = w.reshape(kh * kw * c, o).to(torch.bfloat16)
    k = -(-b.shape[0] // 16) * 16
    b = F.pad(b, (0, 0, 0, k - b.shape[0]))
    # k = 16s + 8·half + 2t + pair, n = 8j + g → (s, j, g, t, half, pair)
    b = b.reshape(k // 16, 2, 4, 2, o // 8, 8).permute(0, 4, 5, 2, 1, 3)
    return b.reshape(k // 16, o // 8, 32, 4).contiguous()


# conv2's B operand in wgmma's K-major layout without swizzle, as
# csrc/stem.cu's descriptor reads it: core matrices of 8 columns n × 8 rows
# k (16 bytes a column, 128 contiguous bytes), WGMMA_LBO bytes apart along
# K and WGMMA_SBO bytes apart along N; one K step of 16 takes
# O/8 · WGMMA_SBO bytes.
WGMMA_LBO = 128
WGMMA_SBO = 256


def wgmma_tiles(w: torch.Tensor) -> torch.Tensor:
    """A (3, 3, C, O) kernel as the B operand of
    ``wgmma.m64nOk16`` in shared memory: the (9C, O) matrix, K
    zero-padded to a multiple of 16, as (K/16, O/8, 2, 8, 8) bfloat16,
    element [s, j, h, n % 8, k % 8] = B[16s + 8h + k % 8, 8j + n % 8], so
    that (k, n) lies at byte s·(O/8)·WGMMA_SBO + (n/8)·WGMMA_SBO +
    ((k % 16)/8)·WGMMA_LBO + (n % 8)·16 + (k % 8)·2."""
    kh, kw, c, o = w.shape
    b = w.reshape(kh * kw * c, o).to(torch.bfloat16)
    k = -(-b.shape[0] // 16) * 16
    b = F.pad(b, (0, 0, 0, k - b.shape[0]))
    # k = 16s + 8h + kk, n = 8j + nn → (s, j, h, nn, kk)
    b = b.reshape(k // 16, 2, 8, o // 8, 8).permute(0, 3, 1, 4, 2)
    return b.contiguous()


def pack_stem_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor, device=None) -> StemWeights:
    """The folded conv1 (3, 3, 3, 32) and conv2 (3, 3, 32, 64) HWIO kernels
    and their biases as ``StemWeights`` on ``device`` (default: w1's)."""
    w1, b1, w2, b2 = (torch.as_tensor(t) for t in (w1, b1, w2, b2))
    if tuple(w1.shape) != (3, 3, 3, C1) or tuple(b1.shape) != (C1,) or \
            tuple(w2.shape) != (3, 3, C1, C2) or tuple(b2.shape) != (C2,):
        raise ValueError(
            f"the stem takes w1 (3, 3, 3, 32), b1 (32,), w2 (3, 3, 32, 64), "
            f"b2 (64,); got {tuple(w1.shape)}, {tuple(b1.shape)}, "
            f"{tuple(w2.shape)}, {tuple(b2.shape)}")
    device = w1.device if device is None else torch.device(device)
    w1, b1, w2, b2 = (t.to(device=device, dtype=torch.float32).contiguous()
                      for t in (w1, b1, w2, b2))
    return StemWeights(w1, b1, w2, b2, mma_fragments(w1), wgmma_tiles(w2))


def _check_images(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[3] != 3 or x.shape[1] % 4 or x.shape[2] % 4:
        raise ValueError(f"the stem takes (N, H, W, 3) images with H and W "
                         f"multiples of 4, got {tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"the stem takes floating images, got {x.dtype}")


# each kernel's operands, as pack_stem_weights makes them
_PACKED = {
    "stem": {"b1": ((C1,), torch.float32), "b2": ((C2,), torch.float32),
             "w1_frags": ((2, C1 // 8, 32, 4), torch.bfloat16),
             "w2_tiles": ((18, C2 // 8, 2, 8, 8), torch.bfloat16)},
    "stem_f32": {"w1": ((3, 3, 3, C1), torch.float32),
                 "b1": ((C1,), torch.float32),
                 "w2": ((3, 3, C1, C2), torch.float32),
                 "b2": ((C2,), torch.float32)},
}


def _check_packed(weights: StemWeights, device: torch.device,
                  kernel: str) -> None:
    """The kernel's operands as ``pack_stem_weights`` makes them."""
    for name, (shape, dtype) in _PACKED[kernel].items():
        t = getattr(weights, name)
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != device or not t.is_contiguous():
            raise ValueError(
                f"weights.{name} must be a contiguous {shape} {dtype} "
                f"tensor on {device} (pack_stem_weights), got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")


def fused_stem_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fused_stem`` in x's type: the kernels rounded to
    it; the convs, bias, leaky and pool in float32 (float64 for float64
    x); the stage-1 map and the output rounded to x's type."""
    _check_images(x)
    dtype = x.dtype
    acc = torch.promote_types(dtype, torch.float32)

    def stage(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
        w = w.to(device=y.device, dtype=dtype).to(acc).permute(3, 2, 0, 1)
        z = F.max_pool2d(F.conv2d(y.to(acc), w, padding=1), 2)
        return leaky_relu(z + b.to(device=y.device, dtype=acc)[:, None, None]
                          ).to(dtype)

    y = stage(stage(x.permute(0, 3, 1, 2), w1, b1), w2, b2)
    return y.permute(0, 2, 3, 1).contiguous()


def stem_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The XLA composition's counterpart, for tests: each conv output
    rounded to ``dtype`` before the bias, then leaky in float32, rounded
    again, and the pool."""
    def block(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
        w = w.to(dtype).float().permute(3, 2, 0, 1)
        z = F.conv2d(y.float(), w, padding=1).to(dtype)
        z = leaky_relu(z.float() + b.float()[:, None, None]).to(dtype)
        return F.max_pool2d(z, 2, ceil_mode=True)

    y = block(block(x.to(dtype).permute(0, 3, 1, 2), w1, b1), w2, b2)
    return y.permute(0, 2, 3, 1).contiguous()


def fused_stem(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The first two Darknet19 stages of x (N, H, W, 3), H and W multiples
    of 4, with the HWIO kernels w1 (3, 3, 3, 32), w2 (3, 3, 32, 64) and
    biases b1, b2: (N, H/4, W/4, 64) in x's type. Packs the weights on
    every call; a caller that keeps them packs them once with
    ``pack_stem_weights`` and calls ``fused_stem_packed``."""
    return fused_stem_packed(x, pack_stem_weights(w1, b1, w2, b2, x.device))


def fused_stem_packed(x: torch.Tensor, weights: StemWeights) -> torch.Tensor:
    """``fused_stem`` with weights packed by ``pack_stem_weights``. On the
    card x must be bfloat16 (B4) or float32 (B4-f32) and contiguous, with
    the weights on its device."""
    global STEM_LAUNCHES, STEM_F32_LAUNCHES
    _check_images(x)
    if x.device.type == "cpu":
        return fused_stem_plain(x, weights.w1, weights.b1, weights.w2,
                                weights.b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    kernel = cuda_kernel(x.dtype)
    if not x.is_contiguous():
        raise ValueError("the CUDA stem reads a contiguous NHWC batch")
    if x.data_ptr() % 4:
        raise ValueError("the CUDA stem reads its images in 4-byte words: "
                         "x must start 4-byte aligned")
    _check_packed(weights, x.device, kernel)
    n, h, w, _ = x.shape
    out = torch.empty((n, h // 4, w // 4, C2), dtype=x.dtype,
                      device=x.device)
    if n == 0:
        return out
    if kernel == "stem":
        entry = _lib().tfy2_fused_stem
        operands = (weights.w1_frags, weights.b1, weights.w2_tiles,
                    weights.b2)
    else:
        entry = _lib_f32().tfy2_fused_stem_f32
        operands = (weights.w1, weights.b1, weights.w2, weights.b2)
        if any(t.data_ptr() % 16 for t in (weights.w1, weights.w2)):
            raise ValueError("the float32 CUDA stem reads its kernels in "
                             "16-byte words: w1 and w2 must start 16-byte "
                             "aligned (pack_stem_weights)")
    with torch.cuda.device(x.device):
        err = entry(x.data_ptr(), *(t.data_ptr() for t in operands),
                    out.data_ptr(), n, h, w, ctypes.c_void_p(
                        torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"tfy2_fused_{kernel} launch failed with "
                           f"cudaError_t {err}")
    if kernel == "stem":
        STEM_LAUNCHES += 1
    else:
        STEM_F32_LAUNCHES += 1
    return out


def fused_detect_forward(detector: torch.nn.Module, images: torch.Tensor,
                         weights: StemWeights) -> torch.Tensor:
    """A folded ``Darknet19Detector``'s forward with ``fused_stem`` on the
    first two conv + pool stages and the detector's own modules after it
    (``models.fast_stem.detect_tail``): NHWC images in the detector's type
    → the (N, S, S, C) float32 grid. The counterpart of
    ``pallas_detect_forward``; its ``linear_output`` is the detector's
    ``bn_on_output=False``. ``weights`` are the detector's conv1 and conv2,
    packed once from the float32 folded weights
    (``entries.pascal_detect_darknet.stem_weights``), so that bf16 serving
    keeps float32 biases."""
    return detect_tail(detector, fused_stem_packed(images, weights))
