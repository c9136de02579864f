"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs where only PyTorch is installed,
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances (chip_smoke.compare_*): scores and classes exact, boxes to
1e-6 — the kernels repeat the plain versions' float32 arithmetic with
the same rounding.
"""

import pytest
import torch

import chip_smoke
from tensorflow_yolo2_torch.config import YoloConfig
from tensorflow_yolo2_torch.entries.pascal_detect_darknet import make_detect_fn
from tensorflow_yolo2_torch.models.darknet import Darknet19Detector, randomize_
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


def test_cuda_wrappers_never_fall_back(card):
    cfg = YoloConfig(S=7)
    net = torch.zeros((2, 7, 30, 7), device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_decode.decode_nms_fused(net, cfg)
    with pytest.raises(TypeError, match="float32"):
        cuda_decode.decode_grid_fused(net.contiguous().half(), cfg)


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
