"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs where only PyTorch is installed,
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances (chip_smoke.compare_*): scores and classes exact, boxes to
1e-6 — the kernels repeat the plain versions' float32 arithmetic with
the same rounding (and the anchor kernel calls the expf that torch.exp
calls).
"""

import pytest
import torch

import chip_smoke
from tensorflow_yolo2_torch.config import YoloConfig, yolo_v2_config
from tensorflow_yolo2_torch.entries.pascal_detect_darknet import make_detect_fn
from tensorflow_yolo2_torch.models.darknet import (
    Darknet19Detector,
    Darknet19DetectorV2,
    randomize_,
)
from tensorflow_yolo2_torch.ops import cuda_decode

pytestmark = pytest.mark.cuda
K = 32


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("S", [7, 14])
def test_kernels_match_plain(card, S, class_aware):
    cfg = YoloConfig(S=S, image_size=32 * S)
    net = torch.from_numpy(chip_smoke.synthetic_grid(cfg, 256, S)).to(card)
    chip_smoke.compare_dense(cuda_decode.decode_grid_fused(net, cfg, 0.5),
                             cuda_decode.decode_grid_plain(net, cfg, 0.5))
    chip_smoke.compare_kept(
        cuda_decode.decode_nms_fused(net, cfg, 0.5, 0.5, K, class_aware),
        cuda_decode.decode_nms_plain(net, cfg, 0.5, 0.5, K, class_aware))
    torch.cuda.synchronize()


def test_kernels_take_odd_shapes(card):
    """One image with K above its 50 slots, and a grid whose NMS threads
    hold several slots each (S=33: 2178 slots, 171 KB of shared memory)."""
    for S, batch, k in ((5, 1, 64), (33, 3, 8)):
        cfg = YoloConfig(S=S, image_size=32 * S)
        net = torch.from_numpy(chip_smoke.synthetic_grid(cfg, batch, seed=1)
                               ).to(card)
        chip_smoke.compare_dense(cuda_decode.decode_grid_fused(net, cfg, 0.5),
                                 cuda_decode.decode_grid_plain(net, cfg, 0.5))
        chip_smoke.compare_kept(
            cuda_decode.decode_nms_fused(net, cfg, 0.5, 0.5, k),
            cuda_decode.decode_nms_plain(net, cfg, 0.5, 0.5, k))


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("S", [7, 13, 19])
def test_anchor_kernel_matches_plain(card, S, class_aware):
    cfg = yolo_v2_config(32 * S)
    net = torch.from_numpy(chip_smoke.synthetic_grid_v2(cfg, 256, S)).to(card)
    for thresh in (0.05, 0.5):
        chip_smoke.compare_kept(
            cuda_decode.decode_nms_fused(net, cfg, thresh, 0.5, K,
                                         class_aware),
            cuda_decode.decode_nms_v2_plain(net, cfg, thresh, 0.5, K,
                                            class_aware))
    torch.cuda.synchronize()


def test_anchor_kernel_takes_odd_shapes(card):
    """K above the slots of an image; 3 anchors of our own; 4 slots a
    thread (S=28: 3920 slots); and past 4096 slots an image, an error."""
    for cfg, batch, k in (
            (yolo_v2_config(224), 1, 300),
            (yolo_v2_config(320, ((0.5, 0.7), (2.0, 1.5), (4.0, 5.0))), 5, 32),
            (yolo_v2_config(32 * 28), 3, 8)):
        net = torch.from_numpy(chip_smoke.synthetic_grid_v2(cfg, batch, 1)
                               ).to(card)
        chip_smoke.compare_kept(
            cuda_decode.decode_nms_fused(net, cfg, 0.5, 0.5, k),
            cuda_decode.decode_nms_v2_plain(net, cfg, 0.5, 0.5, k))
    torch.cuda.synchronize()
    cfg = yolo_v2_config(32 * 29)
    with pytest.raises(RuntimeError, match="tfy2_decode_nms_v2"):
        cuda_decode.decode_nms_fused(
            torch.zeros((1, 29, 29, 125), device=card), cfg)


def test_cuda_wrappers_never_fall_back(card):
    cfg = YoloConfig(S=7)
    net = torch.zeros((2, 7, 30, 7), device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_decode.decode_nms_fused(net, cfg)
    with pytest.raises(TypeError, match="float32"):
        cuda_decode.decode_grid_fused(net.contiguous().half(), cfg)
    v2 = yolo_v2_config(224)
    net = torch.zeros((2, 7, 125, 7), device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_decode.decode_nms_fused(net, v2)


def test_detect_runs_through_the_kernels(card):
    cfg = YoloConfig(S=2, image_size=64)
    model = randomize_(Darknet19Detector(), torch.Generator().manual_seed(0))
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    cuda_decode.reset_launch_counts()
    for use_nms in (True, False):
        out = make_detect_fn(cfg, model.state_dict(), object_thresh=0.05,
                             use_nms=use_nms)(images)
        assert out.scores.device.type == "cuda"
    assert cuda_decode.DECODE_NMS_LAUNCHES == 1
    assert cuda_decode.DECODE_GRID_LAUNCHES == 1


def test_detect_v2_runs_through_the_anchor_kernel(card):
    cfg = yolo_v2_config(64)
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    cuda_decode.reset_launch_counts()
    for passthrough, model in (
            (True, Darknet19DetectorV2()),
            (False, Darknet19Detector(125, bn_on_output=False))):
        state = randomize_(model, torch.Generator().manual_seed(0)
                           ).state_dict()
        for use_nms in (True, False):
            out = make_detect_fn(cfg, state, object_thresh=0.05,
                                 use_nms=use_nms, v2=True,
                                 passthrough=passthrough)(images)
            assert out.scores.device.type == "cuda"
            assert out.scores.shape == (2, 32 if use_nms else 20)
    assert cuda_decode.DECODE_NMS_V2_LAUNCHES == 2
    assert cuda_decode.DECODE_NMS_LAUNCHES == 0
    assert cuda_decode.DECODE_GRID_LAUNCHES == 0
