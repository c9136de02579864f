"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs where only PyTorch is installed,
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances (chip_smoke.compare_*): scores and classes exact, boxes to
1e-6 — the kernels repeat the plain versions' float32 arithmetic with
the same rounding (and the anchor kernel calls the expf that torch.exp
calls). The max-pool backward kernel (B5) is bit-equal to its plain
version and to torch's autograd of ``F.max_pool2d``: it copies dout or
writes 0. A float32 train step on the card, TF32 off, against float64 on the
CPU: loss rtol 1e-4, each gradient 5e-2 and all gradients 1e-2
relative norm (chip_smoke's bounds: float32 rounding alone puts the
early BatchNorm gradients up to ~1e-2 from float64 on any device). The
fused stem (B4) against its plain version: chip_smoke.compare_stem's
bounds, at least 99.9% bit-equal, each difference within one bf16 ulp of
the value or of the output's RMS, relative norm 1e-4. The float32 stem
(B4-f32) against its plain version, TF32 off: rtol = atol = 1e-5
(chip_smoke.compare_stem_f32, the JAX package's bound for its float32
stem); the float32 ``--pallas-stem`` grid against the stock float32
grid: 2e-4 relative norm. The v2p train step at 416² runs B5 five
times a step with finite metrics; ``run_eval`` on the card gives the
same APs as the plain decode of the same grids (exactly: the kernel's
kept sets, scores and classes are the plain version's). The int8 chain
(``ops.quant``, im2col + ``torch._int_mm``): each conv's int32 sums equal
the CPU's exact float64 conv of the same int8 input, the grid within
chip_smoke.INT8_GRID_REL_TOL of the CPU's; no float conv runs. The slim
tier (``-k slim``): its three CLIs on the card, each optimizer's update
within 1e-6 of the CPU's, k=2 accumulation equal to the doubled batch
within 1e-5 with B5 4 times a yolo1 step, a remat step bit-equal to the
plain one. The inception family and the data tier (``-k "inception or
data_tier"``): each inception net's float32 forward on the card (TF32
off) within chip_smoke.ZOO_F32_REL_TOL of the CPU's and its bf16 forward
within ZOO_BF16_REL_TOL, the auxiliary logits too; the identity fold of
inception_v3 at 299² within chip_smoke.FOLD_REL_TOL of the unfolded
logits; ``train_classifier`` on prepared shards, MNIST and the flowers
tree (darknet19 with B5 5 times a step, inception_v3 with ``--aux-loss``)
and ``eval_classifier`` with ``--preprocessing-name``. TF checkpoint
import and adversarial training (``-k "tf_import or adversarial"``): a
written V2 bundle imported bit for bit, serving through B1 as its state
dict does; the detect, ResNet train and ``verify_released_ckpts`` CLIs
on TF checkpoints; B5 15 times a Darknet19 adversarial pair; a float32
pair (TF32 off) against float64 on the CPU (losses 1e-4, the FGSM
images where the float64 input gradient exceeds 1e-2 of its largest
value); the adversarial CLI with ``--device cuda``. Parallelism over a
world-1 NCCL group (``-k parallel``): the data-parallel step (B5 5 times,
its float32 step against float64 on the CPU with the step bounds above),
the live-BatchNorm spatial step (the same, and its running statistics at
1e-2), the spatial serving path's decode launches (B1 and B3 once a v1
call, B2 once a v2p call). The quality program (``-k quality``):
``int8_quality`` on a 2-stage ``quality_curve`` v1 snapshot, finite mAPs
in [0, 1] and B1 once an evaluation batch. The plain v2 head's training
(``-k v2_plain``): the quality recipe's bf16 steps at 224² (B5 5 times a
step), a float32 step against float64 on the CPU with the step bounds
above, and the float32 chain of chip_smoke.check_v2_chains against the
float64 one (within chip_smoke.V2_CHAIN_RATIO of the CPU's own float32
chains, both heads).
"""

import ctypes
import functools
import math

import numpy as np
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
from tensorflow_yolo2_torch.ops import cuda_decode, cuda_pool, cuda_stem
from tensorflow_yolo2_torch.ops.boxes import decode_grid_v2
from tensorflow_yolo2_torch.utils.device import device_normalize

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
    """One image with K above its 50 slots, and a larger grid (S=33:
    2178 slots, staged in three chunks)."""
    for S, batch, k in ((5, 1, 64), (33, 3, 8)):
        cfg = YoloConfig(S=S, image_size=32 * S)
        net = torch.from_numpy(chip_smoke.synthetic_grid(cfg, batch, seed=1)
                               ).to(card)
        chip_smoke.compare_dense(cuda_decode.decode_grid_fused(net, cfg, 0.5),
                                 cuda_decode.decode_grid_plain(net, cfg, 0.5))
        chip_smoke.compare_kept(
            cuda_decode.decode_nms_fused(net, cfg, 0.5, 0.5, k),
            cuda_decode.decode_nms_plain(net, cfg, 0.5, 0.5, k))


@pytest.mark.parametrize("batch", [1, 256])
@pytest.mark.parametrize("S", [7, 14, 28])
def test_dense_decode_matches_plain(card, S, batch):
    """B3 on synthetic grids (S=7 at batch 1: 49 cells, a block not
    filled), thresholds 0.5 and 0.05."""
    cfg = YoloConfig(S=S, image_size=32 * S)
    net = torch.from_numpy(chip_smoke.synthetic_grid(cfg, batch, S)).to(card)
    for thresh in (0.5, 0.05):
        chip_smoke.compare_dense(
            cuda_decode.decode_grid_fused(net, cfg, thresh),
            cuda_decode.decode_grid_plain(net, cfg, thresh))
    torch.cuda.synchronize()


def test_dense_decode_threshold_ties_and_alignment(card):
    """B3: a confidence exactly at the threshold scores 0 and one a float
    above keeps its value (the rule is conf > threshold); tied class
    scores go to the first class; 3·5·5 = 75 cells, the last block not
    filled; and a grid that starts 4 bytes past a 16-byte boundary (the
    kernel stages it with 4-byte loads)."""
    cfg = YoloConfig(S=5, image_size=160)
    C, B = cfg.num_class, cfg.B
    net = chip_smoke.synthetic_grid(cfg, 3, seed=2)
    net[..., :C] = np.round(net[..., :C])  # many ties among the classes
    net[:, 0, 0, C] = 0.5
    net[:, 0, 0, C + 1] = np.nextafter(np.float32(0.5), np.float32(1))
    got = None
    for offset in (0, 1):
        flat = torch.zeros(net.size + offset, device=card)
        flat[offset:] = torch.from_numpy(net).to(card).reshape(-1)
        x = flat[offset:].view(net.shape)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
        got = cuda_decode.decode_grid_fused(x, cfg, 0.5)
        want = cuda_decode.decode_grid_plain(x, cfg, 0.5)
        chip_smoke.compare_dense(got, want)
        first = np.argmax(net[..., :C].reshape(-1, C), axis=1)
        assert np.array_equal(got.classes.cpu().numpy().reshape(-1, B)[:, 0],
                              first)
        assert (got.scores[:, 0] == 0).all()
        assert (got.scores[:, 1] == float(net[0, 0, 0, C + 1])).all()
    torch.cuda.synchronize()


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
    """K above the slots of an image; 3 anchors of our own; 3920 slots
    (S=28), staged in eight chunks; and past 4096 slots an image, an
    error."""
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


def check_nms(net, cfg, thresh, iou_thresh, k, class_aware=True):
    """The decode + NMS kernel against its plain version
    (``compare_kept``'s rule); returns the plain version's result."""
    plain = (cuda_decode.decode_nms_v2_plain if cfg.per_slot_classes
             else cuda_decode.decode_nms_plain)
    want = plain(net, cfg, thresh, iou_thresh, k, class_aware)
    chip_smoke.compare_kept(cuda_decode.decode_nms_fused(
        net, cfg, thresh, iou_thresh, k, class_aware), want)
    torch.cuda.synchronize()
    return want


def dense_scores(net, cfg, thresh):
    """The thresholded score of every slot of the grid."""
    if cfg.per_slot_classes:
        return decode_grid_v2(net, cfg, thresh).scores
    return cuda_decode.decode_grid_plain(net, cfg, thresh).scores


def head_grid(head, S, batch, seed):
    """A seeded synthetic grid: the v1 head (B=2) or the anchor head
    (B=5), and its config."""
    if head == "v1":
        cfg = YoloConfig(S=S, image_size=32 * S)
        return chip_smoke.synthetic_grid(cfg, batch, seed), cfg
    cfg = yolo_v2_config(32 * S)
    return chip_smoke.synthetic_grid_v2(cfg, batch, seed), cfg


def all_alive_grid(head, S, batch, seed):
    """Every slot scores above 0 (the v1 confidences made positive;
    an anchor score is positive anyway): with threshold 0 all n slots are
    candidates."""
    net, cfg = head_grid(head, S, batch, seed)
    if head == "v1":
        conf = net[..., cfg.num_class:cfg.num_class + cfg.B]
        conf[...] = np.abs(conf) + 0.01
    return net, cfg


def tied_grid(head, S, batch, seed):
    """Half the slots, picked at random, share one score exactly and
    draw large boxes of one class, so which of them survives depends on
    the tie order (lowest key b·S·S + cell first)."""
    net, cfg = head_grid(head, S, batch, seed)
    rng = np.random.RandomState(seed + 1)
    C, B = cfg.num_class, cfg.B
    tied = rng.rand(batch, S, S, B) < 0.5
    if head == "v1":
        cells = tied.any(-1)
        net[..., :C][cells] = 0.0
        net[..., 3][cells] = 2.0
        conf = net[..., C:C + B]
        conf[tied] = 0.75
        wh = net[..., C + B:].reshape(batch, S, S, B, 4)[..., 2:]
        wh[tied] = 0.7
    else:
        slots = net.reshape(batch, S, S, B, 5 + C)
        slots[..., 5:][tied] = 0.0
        slots[..., 5 + 3][tied] = 4.0
        slots[..., 4][tied] = 1.5
        slots[..., 2:4][tied] = 0.5
    return net, cfg


@pytest.mark.parametrize("head", ["v1", "anchor"])
def test_nms_with_no_candidate(card, head):
    """No slot above the threshold (m = 0): K empty kept slots, all 0."""
    cfg = (YoloConfig(S=14, image_size=448) if head == "v1"
           else yolo_v2_config(416))
    net = torch.full((3, cfg.S, cfg.S, cfg.cell_channels), -4.0,
                     device=card)
    got = cuda_decode.decode_nms_fused(net, cfg, 0.5, 0.5, K)
    assert not got.scores.any() and not got.boxes.any()
    assert not got.classes.any()
    check_nms(net, cfg, 0.5, 0.5, K)


@pytest.mark.parametrize("head,S", [("v1", 14), ("anchor", 13),
                                    ("anchor", 19)])
def test_nms_every_slot_alive_with_k_n(card, head, S):
    """Every slot a candidate and K = n: the scan walks the whole sorted
    list (S=19 stages the grid in four chunks)."""
    net, cfg = all_alive_grid(head, S, 16, S)
    net = torch.from_numpy(net).to(card)
    n = S * S * cfg.B
    assert bool((dense_scores(net, cfg, 0.0) > 0).all())
    for class_aware in (True, False):
        want = check_nms(net, cfg, 0.0, 0.5, n, class_aware)
        assert bool(((want.scores > 0).sum(1) < n).all())  # it suppressed


@pytest.mark.parametrize("head,S", [("v1", 14), ("anchor", 13)])
def test_nms_ties_go_to_the_lowest_key(card, head, S):
    net, cfg = tied_grid(head, S, 32, S)
    net = torch.from_numpy(net).to(card)
    for scores in dense_scores(net, cfg, 0.05):  # many slots tie
        assert torch.unique(scores[scores > 0], return_counts=True)[1].max() > 10
    for class_aware in (True, False):
        for k in (K, S * S * cfg.B):
            check_nms(net, cfg, 0.05, 0.5, k, class_aware)


def test_nms_iou_equal_to_the_threshold(card):
    """Two boxes of one class whose IoU is exactly the threshold both
    survive (the rule is IoU > threshold); one float below it, the
    second is suppressed."""
    cfg = YoloConfig(S=7, image_size=224)
    C, B = cfg.num_class, cfg.B
    net = np.full((1, 7, 7, cfg.cell_channels), -1.0, np.float32)
    net[0, 3, 3, :C] = 0.0
    net[0, 3, 3, 3] = 1.0
    net[0, 3, 3, C:C + B] = (0.9, 0.8)
    net[0, 3, 3, C + B:] = (0.5, 0.5, 0.6, 0.6, 0.4, 0.6, 0.5, 0.7)
    net = torch.from_numpy(net)
    # the IoU as the sweep takes it: slot 0 picked (area from its
    # corners), slot 1 the candidate (area w·h from its decode)
    p, c = cuda_decode.decode_grid_plain(net, cfg, 0.5).boxes[0, 48:50]
    raw = net[0, 3, 3, C + B + 4:]
    area = torch.square(raw[2]) * torch.square(raw[3])
    iw = torch.clamp(torch.minimum(c[2], p[2]) - torch.maximum(c[0], p[0]),
                     min=0.0)
    ih = torch.clamp(torch.minimum(c[3], p[3]) - torch.maximum(c[1], p[1]),
                     min=0.0)
    inter = iw * ih
    iou = torch.clamp(inter / torch.clamp(area + (p[2] - p[0]) *
                                          (p[3] - p[1]) - inter, min=1e-10),
                      0.0, 1.0)
    assert 0.0 < iou.item() < 1.0
    below = float(np.nextafter(np.float32(iou.item()), np.float32(0)))
    net = net.to(card)
    for thresh, kept in ((iou.item(), 2), (below, 1)):
        want = check_nms(net, cfg, 0.5, thresh, K)
        assert int((want.scores > 0).sum()) == kept


@pytest.mark.parametrize("head,S", [("v1", 14), ("anchor", 13)])
def test_nms_negative_iou_threshold(card, head, S):
    """Below 0 an IoU of 0 suppresses too, so disjoint boxes of a class
    go as well: without class_aware one box an image survives."""
    net, cfg = head_grid(head, S, 32, S)
    net = torch.from_numpy(net).to(card)
    for class_aware in (True, False):
        for k in (K, S * S * cfg.B):
            want = check_nms(net, cfg, 0.05, -0.25, k, class_aware)
            if not class_aware:
                assert bool(((want.scores > 0).sum(1) == 1).all())


def test_nms_largest_anchor_grid(card):
    """S=28, B=5: 3920 slots, near the most the kernel takes."""
    net, cfg = head_grid("anchor", 28, 4, 28)
    net = torch.from_numpy(net).to(card)
    for thresh in (0.05, 0.5):
        for class_aware in (True, False):
            check_nms(net, cfg, thresh, 0.5, K, class_aware)
    check_nms(net, cfg, 0.05, 0.5, 28 * 28 * 5)


def test_nms_launch_geometry(card):
    """Two blocks an SM for the serving grids (v1 448², v2p 416²: one
    wave at batch 256 on 132 SMs), the grid staged in two chunks; the
    largest grids in more, within a block's shared memory."""
    lib = cuda_decode._lib()

    def geometry(S, B, v2):
        out = (ctypes.c_int * 4)()
        assert lib.tfy2_decode_nms_occupancy(S, B, 20, v2, out) == 0
        return dict(zip(("threads", "smem", "chunks", "blocks"), out))

    for S, B, v2 in ((14, 2, 0), (13, 5, 1)):
        g = geometry(S, B, v2)
        assert g["chunks"] == 2 and g["blocks"] >= 2, g
    for S, B, v2 in ((19, 5, 1), (28, 5, 1), (45, 2, 0)):
        g = geometry(S, B, v2)
        assert g["chunks"] > 2 and g["blocks"] >= 1, g


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pool_kernel_matches_plain_and_autograd(card, dtype):
    """B5 at the five pool sites of a 224² step at batch 2."""
    gen = torch.Generator(device=card).manual_seed(0)
    for shape in chip_smoke.pool_sites(2):
        n, c, h, w = shape
        x, dout = (torch.randn(s, generator=gen, device=card).to(dtype)
                   .contiguous(memory_format=torch.channels_last)
                   for s in (shape, (n, c, h // 2, w // 2)))
        assert chip_smoke.check_pool(x, dout, f"{dtype} {shape}") == 0.0
    torch.cuda.synchronize()


def test_pool_kernel_ties_and_odd_shapes(card):
    """The batch-24 sites, integer ties, odd C, small maps, NCHW memory."""
    assert chip_smoke.check_pool_kernel(card) == 0.0


def test_pool_kernel_never_falls_back(card):
    y = torch.zeros(1, 2, 2, 2, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_pool.max_pool2_bwd_fused(torch.zeros(1, 2, 4, 4, device=card,
                                                  dtype=torch.float16),
                                      y.half(), y.half())
    with pytest.raises(ValueError, match="even"):
        cuda_pool.max_pool2_bwd_fused(torch.zeros(1, 2, 5, 4, device=card),
                                      y, y)
    cuda_pool.reset_launch_counts()
    cuda_pool.max_pool2_bwd_fused(torch.zeros(1, 2, 4, 4, device=card), y, y)
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 1


@pytest.fixture()
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.parametrize("shape", [(2, 32, 32), (1, 56, 64),
                                   (8, 448, 448)])
def test_stem_kernel_matches_plain(card, no_tf32, shape):
    weights = cuda_stem.pack_stem_weights(
        *chip_smoke.random_stem_weights(torch.Generator().manual_seed(0)),
        device=card)
    x = (torch.rand(shape + (3,), device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
         * 2 - 1).to(torch.bfloat16)
    cuda_stem.reset_launch_counts()
    got = cuda_stem.fused_stem_packed(x, weights)
    assert cuda_stem.STEM_LAUNCHES == 1
    _, unequal = chip_smoke.compare_stem(
        got, cuda_stem.fused_stem_plain(x, *weights[:4]), f"{shape}")
    if shape[1] == 448:  # a share of a few images' outputs, not of one
        assert unequal <= (1 - chip_smoke.STEM_BIT_SHARE) * got.numel()
    torch.cuda.synchronize()


def test_stem_kernel_edges_and_shapes(card, no_tf32):
    """All 8 STEM_SHAPES with both weight sets (the batch of 256 too),
    and all-zero images with b1 > 0 (SAME zeros of the stage-1 map)."""
    state = randomize_(Darknet19Detector(),
                       torch.Generator().manual_seed(0)).state_dict()
    assert chip_smoke.check_stem_kernel(card, state) < 0.1


@pytest.mark.parametrize("shape", [(2, 32, 32), (1, 56, 64), (3, 40, 72),
                                   (8, 448, 448)])
def test_stem_f32_kernel_matches_plain(card, no_tf32, shape):
    """B4-f32 on random weights at rtol = atol = 1e-5; (3, 40, 72) has
    partial tiles (10 × 18 outputs)."""
    weights = cuda_stem.pack_stem_weights(
        *chip_smoke.random_stem_weights(torch.Generator().manual_seed(0)),
        device=card)
    x = torch.rand(shape + (3,), device=card,
                   generator=torch.Generator(device=card).manual_seed(1)) \
        * 2 - 1
    cuda_stem.reset_launch_counts()
    got = cuda_stem.fused_stem_packed(x, weights)
    assert cuda_stem.STEM_F32_LAUNCHES == 1 and cuda_stem.STEM_LAUNCHES == 0
    chip_smoke.compare_stem_f32(got, cuda_stem.fused_stem_plain(
        x, *weights[:4]), f"{shape}")
    torch.cuda.synchronize()


def test_stem_f32_kernel_edges_and_shapes(card, no_tf32):
    """All STEM_SHAPES with both weight sets (the batch of 256 too), and
    all-zero images with b1 > 0 (SAME zeros of the stage-1 map)."""
    state = randomize_(Darknet19Detector(),
                       torch.Generator().manual_seed(0)).state_dict()
    assert math.isfinite(chip_smoke.check_stem_kernel(card, state,
                                                     torch.float32))


def test_detect_f32_runs_through_the_stem_f32_kernel(card, no_tf32):
    """``make_detect_fn(dtype=torch.float32, pallas_stem=True)``: B4-f32
    once a call (never B4), the decode kernel once a call, for the v1
    and ``--v2`` heads, NMS on and off; its grid within 2e-4 (relative
    norm) of the stock float32 grid."""
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    for cfg, model, kw in (
            (YoloConfig(S=2, image_size=64), Darknet19Detector(), {}),
            (yolo_v2_config(64), Darknet19Detector(125, bn_on_output=False),
             {"v2": True})):
        state = randomize_(model, torch.Generator().manual_seed(0)
                           ).state_dict()
        cuda_decode.reset_launch_counts()
        cuda_stem.reset_launch_counts()
        for use_nms in (True, False):
            out = make_detect_fn(cfg, state, object_thresh=0.05,
                                 use_nms=use_nms, pallas_stem=True,
                                 dtype=torch.float32, **kw)(images)
            assert out.scores.device.type == "cuda"
            assert bool(torch.isfinite(out.scores).all())
        assert cuda_stem.STEM_F32_LAUNCHES == 2
        assert cuda_stem.STEM_LAUNCHES == 0
        launched = (cuda_decode.DECODE_NMS_V2_LAUNCHES if kw else
                    cuda_decode.DECODE_NMS_LAUNCHES
                    + cuda_decode.DECODE_GRID_LAUNCHES)
        assert launched == (1 if kw else 2)
        grid = chip_smoke.card_grid(cfg, state, images, card,
                                    pallas_stem=True, dtype=torch.float32,
                                    **kw)
        stock = chip_smoke.card_grid(cfg, state, images, card,
                                     dtype=torch.float32, **kw)
        assert chip_smoke.rel_norm(grid, stock) <= \
            chip_smoke.STEM_F32_PATH_REL_TOL


def test_stem_kernel_never_falls_back(card):
    """float16 and float64 images raise; float32 images launch B4-f32,
    bfloat16 images B4."""
    weights = cuda_stem.pack_stem_weights(
        *chip_smoke.random_stem_weights(torch.Generator().manual_seed(0)),
        device=card)
    cuda_stem.reset_launch_counts()
    for dtype in (torch.float16, torch.float64):
        x = torch.zeros((1, 32, 32, 3), device=card, dtype=dtype)
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            cuda_stem.fused_stem_packed(x, weights)
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            cuda_stem.fused_stem(x, *weights[:4])
    assert cuda_stem.STEM_LAUNCHES == cuda_stem.STEM_F32_LAUNCHES == 0
    cuda_stem.fused_stem_packed(torch.zeros((1, 32, 32, 3), device=card),
                                weights)
    assert cuda_stem.STEM_F32_LAUNCHES == 1 and cuda_stem.STEM_LAUNCHES == 0
    cuda_stem.fused_stem_packed(
        torch.zeros((1, 32, 32, 3), device=card, dtype=torch.bfloat16),
        weights)
    assert cuda_stem.STEM_F32_LAUNCHES == 1 and cuda_stem.STEM_LAUNCHES == 1
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        make_detect_fn(YoloConfig(S=2, image_size=64),
                       randomize_(Darknet19Detector(),
                                  torch.Generator().manual_seed(0)
                                  ).state_dict(),
                       dtype=torch.float16, pallas_stem=True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_stem.fused_stem_packed(
            torch.zeros((1, 32, 32, 3), device=card, dtype=torch.bfloat16)
            .transpose(1, 2), weights)
    with pytest.raises(ValueError, match="multiples of 4"):
        cuda_stem.fused_stem_packed(
            torch.zeros((1, 30, 32, 3), device=card, dtype=torch.bfloat16),
            weights)
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="pack_stem_weights"):
            cuda_stem.fused_stem_packed(
                torch.zeros((1, 32, 32, 3), device=card, dtype=dtype),
                cuda_stem.pack_stem_weights(*weights[:4], device="cpu"))


def test_stem_kernel_refuses_misaligned_images(card):
    """The kernel reads x in 4-byte words: a contiguous batch that starts
    2 bytes into a word raises, never falls back."""
    weights = cuda_stem.pack_stem_weights(
        *chip_smoke.random_stem_weights(torch.Generator().manual_seed(0)),
        device=card)
    flat = torch.zeros(32 * 32 * 3 + 1, device=card, dtype=torch.bfloat16)
    x = flat[1:].view(1, 32, 32, 3)
    assert x.is_contiguous() and x.data_ptr() % 4 == 2
    cuda_stem.reset_launch_counts()
    with pytest.raises(ValueError, match="4-byte aligned"):
        cuda_stem.fused_stem_packed(x, weights)
    assert cuda_stem.STEM_LAUNCHES == 0


def test_detect_normalizes_uint8_as_the_host_does(card):
    """On the card a uint8 batch is divided by a device tensor of 255, the
    IEEE quotient (a division by the Python number 255.0 multiplies by
    its reciprocal there): all 256 levels equal the host's x / 255 * 2 - 1
    in float32, and ``make_detect_fn`` on a uint8 batch gives the same
    dense detections, bit for bit, as the same detector fed those
    host-normalized floats, on the stock path and through B4."""
    levels = torch.arange(256).to(torch.uint8)
    host = levels.float() / 255.0 * 2.0 - 1.0
    assert torch.equal(device_normalize(levels.to(card)).cpu(), host)
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    images.view(-1)[:256] = levels
    state = randomize_(Darknet19Detector(), torch.Generator().manual_seed(0)
                       ).state_dict()
    for pallas_stem in (False, True):
        detect = make_detect_fn(YoloConfig(S=2, image_size=64), state,
                                object_thresh=0.0, pallas_stem=pallas_stem)
        got = detect(images)
        want = detect(images.float() / 255.0 * 2.0 - 1.0)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_detect_runs_through_the_stem_kernel(card):
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    cuda_decode.reset_launch_counts()
    cuda_stem.reset_launch_counts()
    for cfg, model, kw in (
            (YoloConfig(S=2, image_size=64), Darknet19Detector(), {}),
            (yolo_v2_config(64), Darknet19Detector(125, bn_on_output=False),
             {"v2": True})):
        state = randomize_(model, torch.Generator().manual_seed(0)
                           ).state_dict()
        out = make_detect_fn(cfg, state, object_thresh=0.05, use_nms=True,
                             pallas_stem=True, **kw)(images)
        assert out.scores.device.type == "cuda"
        assert bool(torch.isfinite(out.scores).all())
    assert cuda_stem.STEM_LAUNCHES == 2
    assert cuda_decode.DECODE_NMS_LAUNCHES == 1
    assert cuda_decode.DECODE_NMS_V2_LAUNCHES == 1


def test_train_step_matches_cpu(card, no_tf32):
    """20 bf16 steps of the v1 detector at 224², batch 4, on one batch,
    with the pools' backward through B5 (5 launches a step); then, from
    the weights they reached, a float32 step on the card against the same
    step in float64 on the CPU (loss rtol 1e-4, each gradient 5e-2 and
    all gradients 1e-2 relative norm) and the bf16 loss against the
    float32 one (5e-2): chip_smoke's checks and bounds."""
    import numpy as np

    yolo = YoloConfig()
    images, labels = (torch.from_numpy(a).to(card)
                      for a in chip_smoke.train_batch(
                          np.random.RandomState(0), 4, yolo))
    trainer, state = chip_smoke.make_trainer(yolo, torch.bfloat16, card)
    cuda_pool.reset_launch_counts()
    losses = [trainer.train_step(state, images, labels)[1]["loss"].item()
              for _ in range(20)]
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 5 * 20
    assert losses[-1] < losses[0]
    chip_smoke.check_train_step_against_cpu(
        functools.partial(chip_smoke.make_trainer, yolo), images, labels,
        card,
        {k: v.cpu() for k, v in state.model.state_dict().items()})


def test_v2_plain_train_step_matches_cpu(card, no_tf32):
    """20 bf16 steps of the plain v2 head (``--v2``, linear output) at
    224², batch 4, with the quality recipe's trainer (grad clip 5,
    BatchNorm momentum 0.9): B5 5 times a step, the burn-in on; then a
    float32 step on the card against float64 on the CPU from the weights
    they reached, with chip_smoke's step bounds."""
    import numpy as np

    yolo = yolo_v2_config(224)
    images, labels = (torch.from_numpy(a).to(card)
                      for a in chip_smoke.train_batch(
                          np.random.RandomState(0), 4, yolo))
    trainer, state = chip_smoke.make_v2_trainer(yolo, torch.bfloat16, card)
    cuda_pool.reset_launch_counts()
    metrics = [trainer.train_step(state, images, labels)[1]
               for _ in range(20)]
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 5 * 20
    assert all(m["burnin_loss"].item() > 0 for m in metrics)
    assert all(math.isfinite(m["loss"].item()) for m in metrics)
    chip_smoke.check_train_step_against_cpu(
        functools.partial(chip_smoke.make_v2_trainer, yolo), images, labels,
        card, {k: v.cpu() for k, v in state.model.state_dict().items()})


def test_v2_plain_chain_matches_cpu(card, no_tf32):
    """chip_smoke.check_v2_chains: the float32 chains of the plain v2 and
    v2p heads on the card against float64 on the CPU, across the end of
    the burn-in and the clip."""
    out = chip_smoke.check_v2_chains(card)
    assert set(out) == {"v2", "v2p"}


def test_train_loop_on_the_card(card, tmp_path):
    """``run_train_loop`` on the card, as the CLI calls it: every step's
    metrics, copied to pinned host memory behind the step and read one
    step later, reach ``events.jsonl`` finite, the histograms on logging
    steps; the snapshots are written."""
    import json

    import numpy as np

    from tensorflow_yolo2_torch.config import Paths
    from tensorflow_yolo2_torch.entries.common import run_train_loop
    from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
    from tensorflow_yolo2_torch.train.metrics import MetricsWriter
    from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task

    yolo = YoloConfig(S=2, B=2, num_class=4, image_size=64)
    batches = iter([chip_smoke.train_batch(np.random.RandomState(i), 2, yolo)
                    for i in range(4)])
    trainer = Trainer(Darknet19Detector(yolo.cell_channels),
                      yolo_task(yolo, histograms=True), device=card)
    state = trainer.create_state(torch.Generator().manual_seed(0))
    paths = Paths(root=str(tmp_path))
    mgr = CheckpointManager("darknet19", "voc_2007", paths=paths, yolo=yolo)
    logdir = str(tmp_path / "events")
    writer = MetricsWriter(logdir, tensorboard=False)
    state = run_train_loop(trainer, state, lambda: next(batches), mgr,
                           writer, start_iter=0, num_iters=4, log_every=2,
                           save_every=2, num_workers=1)
    writer.close()
    recs = [json.loads(line) for line in
            open(f"{logdir}/events.jsonl").read().splitlines()]
    scalars = [r for r in recs if "hist" not in r]
    assert [r["step"] for r in scalars] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in scalars)
    assert sorted((r["step"], r["hist"]) for r in recs if "hist" in r) == [
        (s, h) for s in (2, 4) for h in ("hist/confidence", "hist/iou")]
    assert state.step == 4 and mgr.all_steps() == [2, 4]


@pytest.mark.parametrize("batch", [1, 32, 256])
@pytest.mark.parametrize("head,S", [("v1", 14), ("anchor", 13)])
def test_nms_at_the_eval_threshold(card, head, S, batch):
    """B1 (v1, S=14) and B2 (anchor head, S=13) at ``pascal_eval_map``'s
    threshold 0.005 and K=32, where almost every slot of a random grid is
    a candidate: the kernel against its plain version."""
    net, cfg = head_grid(head, S, batch, seed=batch + S)
    net = torch.from_numpy(net).to(card)
    want = check_nms(net, cfg, chip_smoke.EVAL_THRESH, 0.5, K)
    candidates = (dense_scores(net, cfg, chip_smoke.EVAL_THRESH) > 0).sum(1)
    assert bool((candidates > cfg.S * cfg.S * cfg.B // 3).all())
    assert bool(((want.scores > 0).sum(1) == K).all())


def test_v2p_train_step_runs_b5(card):
    """Three bf16 steps of the v2p detector at 416² (S=13, B=5) on a
    per-slot batch of 2: B5 five times a step, finite metrics, the
    burn-in term on."""
    import numpy as np

    yolo = yolo_v2_config(416)
    images, labels = (torch.from_numpy(a).to(card)
                      for a in chip_smoke.train_batch(
                          np.random.RandomState(0), 2, yolo))
    assert labels.shape == (2, 13, 13, 5, 25)
    trainer, state = chip_smoke.make_trainer(yolo, torch.bfloat16, card)
    cuda_pool.reset_launch_counts()
    for _ in range(3):
        state, metrics = trainer.train_step(state, images, labels)
    torch.cuda.synchronize()
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 5 * 3
    assert all(math.isfinite(v.item()) for v in metrics.values())
    assert metrics["burnin_loss"].item() > 0
    assert state.step == 3


@pytest.mark.parametrize("head", ["v1", "v2p"])
def test_run_eval_on_the_card_equals_the_plain_decode(card, head):
    """``run_eval`` through ``make_detect_fn`` on the card on a seeded
    in-memory set (64 images at batch 32, threshold 0.005): the decode
    kernel once a batch, the APs (all-points and VOC07) equal to those of
    the plain decode on the same grids (chip_smoke.check_eval)."""
    import numpy as np

    if head == "v1":
        yolo, state = chip_smoke.v1_detector()
    else:
        yolo, state = chip_smoke.v2_detector(passthrough=True)
    images, labels = chip_smoke.train_batch(np.random.RandomState(3), 64,
                                            yolo)
    out = chip_smoke.check_eval(head, yolo, state, images, labels, card)
    assert out["launches"] == 2 and out["max_abs_err"] <= chip_smoke.BOX_TOL
    assert 0.0 <= out["map"] <= 1.0


def int8_chain(head: str, size: int, seed: int = 3):
    """A seeded head's int8 chain, calibrated on the card (TF32 off) on two
    uint8 images, and its config; the images and the layers on the CPU."""
    from tensorflow_yolo2_torch.models.fold import fold_params
    from tensorflow_yolo2_torch.ops import quant

    if head == "v1":
        yolo = YoloConfig(S=size // 32, image_size=size)
        model = Darknet19Detector(yolo.cell_channels)
    else:
        yolo = yolo_v2_config(size)
        model = (Darknet19DetectorV2(yolo.cell_channels) if head == "v2p"
                 else Darknet19Detector(yolo.cell_channels,
                                        bn_on_output=False))
    state = fold_params(randomize_(model, torch.Generator().manual_seed(
        seed)).state_dict())
    if head == "v1":  # confident slots
        state["detection.output.conv.bias"][20:22] += 2.0
    images = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (4, size, size, 3)).astype(np.uint8))
    plan_head = "detector_v2p" if head == "v2p" else "detector"
    kw = {"v2": head != "v1", "head": plan_head}
    scales = quant.calibrate({k: v.cuda() for k, v in state.items()},
                             device_normalize(images[:2].cuda()), **kw)
    return yolo, quant.quantize_folded(state, scales, **kw), images, kw


@pytest.mark.parametrize("head", ["v1", "v2", "v2p"])
def test_int8_sums_on_the_card_equal_the_cpu(card, no_tf32, head):
    """Each conv's int32 sums from the card's int8 input equal the CPU's
    exact float64 conv of that input; the grids agree (relative norm
    chip_smoke.INT8_GRID_REL_TOL)."""
    from unittest import mock

    from tensorflow_yolo2_torch.ops import quant

    _, layers, images, kw = int8_chain(head, 64)
    on_card, on_cpu = quant.prepare(layers, card), quant.prepare(layers, "cpu")
    index = {id(layer): i for i, layer in enumerate(on_card)}
    seen, conv = [], quant.conv_int8

    def recording(x, layer):
        acc = conv(x, layer)
        seen.append((index[id(layer)], x, acc))
        return acc

    with mock.patch.object(quant, "conv_int8", recording):
        grid = quant.forward_int8(on_card, images.to(card), **kw)
    assert [i for i, _, _ in seen] == list(range(len(layers)))
    for i, x, acc in seen:
        assert torch.equal(acc.cpu(), quant.conv_int8(x.cpu(), on_cpu[i])), i
    want = quant.forward_int8(on_cpu, images, **kw).double()
    rel = ((grid.cpu().double() - want).norm() / want.norm()).item()
    assert rel <= chip_smoke.INT8_GRID_REL_TOL


def test_int8_conv_takes_small_and_odd_shapes(card):
    """_int_mm's limits (M > 16, K and N multiples of 8) are met by zero
    padding: a 1×1 map of one image, conv1's K = 27, an output conv's
    N = 30; the sums equal the CPU's. Non-int8 input raises."""
    from tensorflow_yolo2_torch.ops import quant

    g = torch.Generator().manual_seed(0)
    for (n, h, w, c), (kh, cout) in (((1, 1, 1, 1024), (3, 30)),
                                     ((2, 5, 7, 3), (3, 32)),
                                     ((3, 4, 4, 64), (1, 125))):
        x = torch.randint(-127, 128, (n, h, w, c), generator=g,
                          dtype=torch.int8)
        layer = {"kernel": torch.randint(-127, 128, (kh, kh, c, cout),
                                         generator=g, dtype=torch.int8)}
        got = quant.conv_int8(x.to(card), {"kernel": layer["kernel"].to(
            card)})
        assert torch.equal(got.cpu(), quant.conv_int8(x, layer))
    with pytest.raises(TypeError, match="int8"):
        quant.conv_int8(x.to(card).float(), {"kernel": layer["kernel"]})


@pytest.mark.parametrize("head", ["v1", "v2", "v2p"])
def test_int8_detect_launches_the_decode_kernels(card, head):
    """``make_detect_fn_int8``: B1 (v1) or B2 (anchor heads) once a call
    with NMS, B3 once without (v1), each equal to its plain version on the
    int8 grid; no float conv operator or kernel in the profiled call."""
    from torch.profiler import ProfilerActivity, profile

    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        make_detect_fn_int8,
    )
    from tensorflow_yolo2_torch.ops import quant

    yolo, layers, images, kw = int8_chain(head, 96)
    v2 = head != "v1"
    detect = make_detect_fn_int8(yolo, layers, 0.05, use_nms=True, v2=v2,
                                 passthrough=head == "v2p")
    dense = make_detect_fn_int8(yolo, layers, 0.05, v2=v2,
                                passthrough=head == "v2p")
    x = images.to(card)
    cuda_decode.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kept = detect(x)
        dense(x)
        torch.cuda.synchronize()
    counts = (cuda_decode.DECODE_NMS_LAUNCHES,
              cuda_decode.DECODE_NMS_V2_LAUNCHES,
              cuda_decode.DECODE_GRID_LAUNCHES)
    assert counts == ((0, 1, 0) if v2 else (1, 0, 1))
    names = [e.key.lower() for e in prof.key_averages()]
    assert not [n for n in names if any(m in n for m in
                                        chip_smoke.FLOAT_CONV_MARKS)]
    assert any("_int_mm" in n for n in names)
    grid = quant.forward_int8(quant.prepare(layers, card), x, **kw)
    plain = (cuda_decode.decode_nms_v2_plain if v2
             else cuda_decode.decode_nms_plain)
    want = plain(grid, yolo, 0.05, 0.5, K)
    chip_smoke.compare_kept(kept, want, "decode_nms_v2" if v2
                            else "decode_nms")
    assert bool((want.scores > 0).any())


def test_native_read_serves_on_the_card(card):
    """``assets/demo.jpg`` read by the port's native layer (cv2's or
    libjpeg's decode, then the native resize) and served by the int8 v1
    chain on the card with NMS: B1 once, kept boxes equal to the plain
    decode's."""
    from tensorflow_yolo2_torch.data.augment import image_read_u8
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        make_detect_fn_int8,
    )
    from tensorflow_yolo2_torch.ops import quant
    from tensorflow_yolo2_torch.utils import native

    native.require()
    image = image_read_u8(chip_smoke.DEMO, 224)
    assert image.shape == (224, 224, 3) and image.dtype == np.uint8
    yolo, layers, _, kw = int8_chain("v1", 224)
    cuda_decode.reset_launch_counts()
    kept = make_detect_fn_int8(yolo, layers, 0.05, use_nms=True)(
        image[None])
    torch.cuda.synchronize()
    assert cuda_decode.DECODE_NMS_LAUNCHES == 1
    grid = quant.forward_int8(quant.prepare(layers, card),
                              torch.from_numpy(image[None]).to(card), **kw)
    chip_smoke.compare_kept(kept, cuda_decode.decode_nms_plain(
        grid, yolo, 0.05, 0.5, K))


# -- the Darknet19 classifier -------------------------------------------------


def test_pool_kernel_at_the_classifier_sites(card):
    """B5 at the five pool sites of a 224² classifier step at batch 48,
    bf16 and float32: bit for bit its plain version and autograd."""
    assert chip_smoke.check_cls_pool_sites(card) == 0.0


def test_classifier_train_step_matches_cpu(card, no_tf32):
    """10 bf16 steps of the 1000-class classifier at 224², batch 4, on one
    batch (B5 5 times a step, the loss falling); then a float32 step on
    the card against float64 on the CPU: chip_smoke's checks and
    bounds."""
    images, labels = (torch.from_numpy(a).to(card) for a in
                      chip_smoke.cls_batch(np.random.RandomState(0), 4))
    trainer, state = chip_smoke.make_cls_trainer(torch.bfloat16, card)
    cuda_pool.reset_launch_counts()
    losses = [trainer.train_step(state, images, labels)[1]["loss"].item()
              for _ in range(10)]
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 5 * 10
    assert losses[-1] < losses[0]
    chip_smoke.check_train_step_against_cpu(
        chip_smoke.make_cls_trainer, images, labels, card,
        {k: v.cpu() for k, v in state.model.state_dict().items()})


def test_classifier_train_cli_uint8_transfer(card, tmp_path, monkeypatch,
                                             capsys):
    """``imagenet_train_darknet --uint8-transfer --device cuda`` on a small
    ILSVRC tree: exits 0, an epoch-named snapshot, B5 5 times a step."""
    from tensorflow_yolo2_torch.entries import imagenet_train_darknet

    monkeypatch.setenv("TFY2_ROOT", str(tmp_path))
    chip_smoke.write_ilsvrc_tree(str(tmp_path / "data" / "ILSVRC"),
                                 np.random.RandomState(0))
    cuda_pool.reset_launch_counts()
    assert imagenet_train_darknet.main(
        ["--batch-size", "8", "--iters", "5", "--save-every", "5",
         "--eval-every", "2", "--num-workers", "2", "--uint8-transfer",
         "--device", "cuda"]) == 0
    torch.cuda.synchronize()
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 5 * 5
    assert "Saved snapshot at iter 5 (epoch 1)" in capsys.readouterr().out


def test_int8_classifier_sums_on_the_card_equal_the_cpu(card, no_tf32):
    """The 1000-class classifier at 224², seeded weights, BN folded: each
    conv's int32 sums, ``conv19``'s among them, from the card's int8
    input equal the CPU's exact conv; the logits agree (relative norm
    chip_smoke.INT8_GRID_REL_TOL)."""
    from tensorflow_yolo2_torch.models.darknet import Darknet19Classifier
    from tensorflow_yolo2_torch.models.fold import fold_params
    from tensorflow_yolo2_torch.ops import quant

    state = fold_params(randomize_(Darknet19Classifier(1000),
                                   torch.Generator().manual_seed(0))
                        .state_dict())
    images = torch.from_numpy(chip_smoke.cls_batch(
        np.random.RandomState(1), 2)[0])
    scales = quant.calibrate({k: v.to(card) for k, v in state.items()},
                             device_normalize(images.to(card)),
                             head="classifier")
    layers = quant.quantize_folded(state, scales, head="classifier")
    rel, _ = chip_smoke.check_int8_sums(
        "int8 classifier", quant.prepare(layers, card),
        quant.prepare(layers, "cpu"), images[:1],
        quant.forward_int8_classifier, "logits")
    assert rel <= chip_smoke.INT8_GRID_REL_TOL


def test_importing_the_entries_initialises_no_cuda(card):
    """A spawned prefetch worker imports the train entry: the import must
    not create a CUDA context."""
    import subprocess
    import sys

    code = ("import torch\n"
            "from tensorflow_yolo2_torch.entries import (\n"
            "    imagenet_predict_darknet, imagenet_test_darknet,\n"
            "    imagenet_train_adversarial, imagenet_train_darknet,\n"
            "    imagenet_train_resnet, pascal_detect_resnet,\n"
            "    pascal_train_darknet, pascal_train_resnet,\n"
            "    verify_released_ckpts)\n"
            "assert not torch.cuda.is_initialized()\n")
    import os

    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.abspath(
                             chip_smoke.__file__)))
    assert out.returncode == 0, out.stderr


# -- the ResNet50 family ------------------------------------------------------


def test_resnet_serving_runs_b1_and_b3(card):
    """``make_resnet_detect_fn`` at 224², bf16, threshold 0.2: B1 once a
    call with NMS, B3 once without, each equal to its plain version on
    the card grid; the grid within chip_smoke.GRID_REL_TOL of the
    float32 CPU forward (chip_smoke.check_resnet_serving)."""
    images = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (chip_smoke.BATCH, 224, 224, 3)).astype(np.uint8))
    out = chip_smoke.check_resnet_serving(card, images)
    assert out["launches"] == {"decode_nms": 1, "decode_grid": 1,
                               "decode_nms_v2": 0}
    assert out["errs"]["decode_grid"] <= chip_smoke.BOX_TOL


def test_resnet_train_step_matches_cpu(card, no_tf32):
    """A float32 step of the ResNet detector at 64², batch 4, dropout off
    (no B5) on the card against float64 on the CPU, from the weights of
    chip_smoke.resnet_check_weights (float64 steps on the CPU):
    chip_smoke's checks, with the gradient bounds of
    chip_smoke.RESNET_GRAD_BOUNDS, 1e-1 worst and 3e-2 all (float32
    rounding alone crosses the detector steps' 1e-2 on all gradients on
    ResNet50 at 64²)."""
    from tensorflow_yolo2_torch.config import YoloConfig

    build = functools.partial(chip_smoke.make_resnet_trainer,
                              size=chip_smoke.RESNET_CHECK_SIZE,
                              dropout_rate=0.0)
    images, labels = (torch.from_numpy(a).to(card) for a in
                      chip_smoke.train_batch(
                          np.random.RandomState(15),
                          chip_smoke.RESNET_CHECK_IMAGES,
                          YoloConfig(image_size=64)))
    weights = chip_smoke.resnet_check_weights(images, labels)
    cuda_pool.reset_launch_counts()
    chip_smoke.check_train_step_against_cpu(
        build, images, labels, card, weights,
        bounds=chip_smoke.RESNET_GRAD_BOUNDS)
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 0


def test_resnet_dropout_draws_on_the_card(card):
    """The detector's dropout generator lives on the card and advances
    once a train step; two trainers from one seed take the same steps."""
    from tensorflow_yolo2_torch.config import YoloConfig

    images, labels = (torch.from_numpy(a).to(card) for a in
                      chip_smoke.train_batch(np.random.RandomState(1), 4,
                                             YoloConfig()))
    runs = []
    for _ in range(2):
        trainer, state = chip_smoke.make_resnet_trainer(torch.bfloat16, card)
        assert state.rng.device.type == "cuda"
        states = [state.rng.get_state()]
        losses = []
        for _ in range(2):
            losses.append(trainer.train_step(state, images, labels)[1][
                "loss"].item())
            states.append(state.rng.get_state())
        assert not torch.equal(states[0], states[1])
        assert not torch.equal(states[1], states[2])
        runs.append(losses)
        del trainer, state
    assert runs[0] == runs[1]


def test_resnet_fine_tune_freezes_the_trunk(card):
    """``imagenet_train_resnet``'s optimizer on the 1000-class ResNet50 at
    224², batch 8, 3 bf16 steps: the trunk bit-equal, its BatchNorm
    statistics moved, the logits moved, slots for the logits alone."""
    from tensorflow_yolo2_torch.entries.imagenet_train_resnet import (
        fine_tune_config,
    )
    from tensorflow_yolo2_torch.models.resnet import ResNet50V1
    from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task

    trainer = Trainer(ResNet50V1(1000, global_pool=True), softmax_task(),
                      fine_tune_config(1e-3), device=card)
    state = trainer.create_state(torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    images, labels = (torch.from_numpy(a).to(card) for a in
                      chip_smoke.cls_batch(np.random.RandomState(2), 8))
    for _ in range(3):
        trainer.train_step(state, images, labels)
    after = state.model.state_dict()
    for k, p in state.model.named_parameters():
        assert torch.equal(after[k], start[k]) != k.startswith("logits."), k
        assert p.requires_grad == k.startswith("logits."), k
    assert all(not torch.equal(after[k], start[k]) for k in after
               if "running" in k)
    assert sorted(state.opt_state.trace) == ["logits.bias", "logits.weight"]



# -- the slim tier: the CLIs, the optimizers, remat, B5 on yolo1 ------------


def test_slim_clis_on_the_card(card):
    """``train_classifier`` (darknet19, rmsprop, weight decay, EMA,
    k=2, ``--save-interval-secs``, summaries; B5 5 times a micro-step),
    ``eval_classifier --use-ema`` and ``flowers_train`` on a flowers
    tree at 224² (``chip_smoke.run_slim_clis``)."""
    out = chip_smoke.run_slim_clis(card)
    assert out["train_launches"] == 5 * chip_smoke.SLIM_CLI_ITERS
    assert out["flowers_launches"] == 10


def test_slim_optimizers_on_the_card(card):
    """Each of the nine optimizers, MultiSteps and the EMA: one float32
    update on the card within 1e-6 of the CPU's from the same state."""
    out = chip_smoke.check_slim_optimizers(card)
    assert set(out) >= {"sgd", "rmsprop", "adagrad", "ftrl", "adadelta",
                        "adam", "adamw", "lamb", "momentum", "ema",
                        "multisteps_rmsprop_k2"}
    assert max(out.values()) <= chip_smoke.OPT_REL_TOL


def test_slim_accumulation_and_yolo1_pool_launches(card):
    """``yolo1_pretrain`` at 224², k=2 on two batches of 16 = one step on
    32 (1e-5), B5 4 times a micro-step; then a ``yolo1`` step at 448²
    with its loss: B5 4 times a step, a finite loss."""
    from tensorflow_yolo2_torch.config import OptimizerConfig, YoloConfig
    from tensorflow_yolo2_torch.models.registry import get_network
    from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task

    assert chip_smoke.check_accumulation(card)["launches"] == 8
    yolo = YoloConfig(image_size=448)
    trainer = Trainer(get_network("yolo1"), yolo_task(yolo),
                      OptimizerConfig(name="rmsprop", weight_decay=4e-5),
                      device=card)
    state = trainer.create_state(torch.Generator().manual_seed(0),
                                 chip_smoke.fresh_state_dict(
                                     get_network("yolo1"), card))
    images, labels = (torch.from_numpy(a).to(card) for a in
                      chip_smoke.train_batch(np.random.RandomState(3), 4,
                                             yolo))
    cuda_pool.reset_launch_counts()
    state, metrics = trainer.train_step(state, images, labels)
    torch.cuda.synchronize()
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 4
    assert math.isfinite(metrics["loss"].item())


def test_slim_remat_is_bit_equal_on_the_card(card):
    """A remat step of resnet_v1_152 at batch 8 leaves parameters,
    running statistics, slots and generator where the plain step does
    (``chip_smoke.check_remat``, cuDNN deterministic)."""
    assert chip_smoke.check_remat(card)["max_abs_diff"] == 0.0


# -- the inception family and the slim data tier -----------------------------


@pytest.mark.parametrize("name", ["inception_v1", "inception_v2",
                                  "inception_v3", "inception_v4",
                                  "inception_resnet_v2"])
def test_inception_forward_on_the_card_matches_the_cpu(card, no_tf32, name):
    """One net at its default size, batch 2, seeded random weights drawn
    on the card, eval mode, with its auxiliary head where it has one
    (``chip_smoke.check_zoo`` on that net alone)."""
    from unittest import mock

    from tensorflow_yolo2_torch.models import registry

    with mock.patch.object(registry, "list_networks", lambda: [name]):
        out = chip_smoke.check_zoo(card)[name]
    assert out["f32_rel_err"] <= chip_smoke.ZOO_F32_REL_TOL
    assert out["bf16_rel_err"] <= chip_smoke.ZOO_BF16_REL_TOL
    assert ("aux_f32_rel_err" in out) == (name in chip_smoke.AUX_NETS)


def test_inception_no_scale_batchnorm_gradients_on_the_card(card, no_tf32):
    """``layers.BatchNorm(use_scale=False)`` in train mode on the card:
    the output, the bias gradient, the input gradient and the running
    statistics within 1e-5 of the CPU's (float32, the same arithmetic in
    another order)."""
    from tensorflow_yolo2_torch.models.layers import BatchNorm

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 192, 5, 5, generator=gen) * 2 + 0.5
    dout = torch.randn(4, 192, 5, 5, generator=gen)
    bias = torch.randn(192, generator=gen) * 0.1
    runs = []
    for dev in ("cpu", card):
        bn = BatchNorm(192, use_scale=False).to(dev).train()
        with torch.no_grad():
            bn.bias.copy_(bias)
        xi = x.detach().to(dev).clone().requires_grad_(True)
        y = bn(xi)
        y.backward(dout.to(dev))
        runs.append([t.detach().cpu() for t in (
            y, bn.bias.grad, xi.grad, bn.running_mean, bn.running_var)])
    assert [n for n, _ in bn.named_parameters()] == ["bias"]
    for got, want in zip(runs[1], runs[0]):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_inception_identity_fold_on_the_card(card, no_tf32):
    out = chip_smoke.check_inception_fold(card)
    assert out["tensors_folded"] > 0
    assert max(out["logits_rel_err"], out["aux_logits_rel_err"]) <= \
        chip_smoke.FOLD_REL_TOL


def test_data_tier_clis_on_the_card(card):
    """``download_and_convert`` from a ``file://`` mirror, then
    ``train_classifier`` on the prepared cifar10 shards, MNIST, the
    prepared flowers shards (darknet19: B5 5 times a step) and
    ``inception_v3 --aux-loss`` at 299², and ``eval_classifier``
    (``chip_smoke.run_data_tier_clis``)."""
    out = chip_smoke.run_data_tier_clis(card)
    assert out["darknet19_launches"] == 5 * chip_smoke.SLIM_CLI_ITERS
    assert out["inception_v3_launches"] == 0



# -- TF checkpoint import and adversarial training ----------------------------


def test_tf_import_reader_and_importers_on_the_card(card, tmp_path):
    """The 448² v1 detector written as a TF V2 bundle in the reference's
    names (``chip_smoke.write_tf_bundle``) and a ResNet-50 trunk in
    slim's: the port's import equals the written arrays bit for bit,
    loads strictly, and the imported detector serves through B1 on the
    card exactly as the state dict it came from."""
    from tensorflow_yolo2_torch.compat.tf_import import (
        import_darknet19_checkpoint,
        import_resnet50_checkpoint,
        state_dict_for,
    )
    from tensorflow_yolo2_torch.models.resnet import ResNet50V1

    yolo, state = chip_smoke.v1_detector()
    prefix = str(tmp_path / "darknet19_pascal.ckpt")
    chip_smoke.write_tf_bundle(prefix, chip_smoke.tf_darknet19_names(state))
    imported = state_dict_for(import_darknet19_checkpoint(prefix))
    assert set(imported) == set(state)
    assert all(torch.equal(imported[k], v) for k, v in state.items()
               if not k.endswith("num_batches_tracked"))
    images = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, (4, 448, 448, 3)).astype(np.uint8)).to(card)
    got, want = (make_detect_fn(yolo, sd, 0.2, use_nms=True)(images)
                 for sd in (imported, state))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    trunk = chip_smoke.random_weights_(
        ResNet50V1(), torch.Generator().manual_seed(2)).state_dict()
    rprefix = str(tmp_path / "resnet_v1_50.ckpt")
    chip_smoke.write_tf_bundle(rprefix,
                               chip_smoke.tf_resnet50_trunk_names(trunk))
    model = ResNet50V1().to(card)
    model.load_state_dict(state_dict_for(import_resnet50_checkpoint(
        rprefix)), strict=True)
    assert all(torch.equal(model.state_dict()[k].cpu(), v)
               for k, v in trunk.items())


def test_tf_import_clis_on_the_card(card):
    """``pascal_detect_darknet --tf-checkpoint --nms --device cuda`` at
    448² (B1 once, the boxes of the state dict) and
    ``pascal_train_resnet --tf-checkpoint`` (``chip_smoke.check_tf_import``)."""
    out = chip_smoke.check_tf_import(card)
    assert out["detect_launches"] == 1
    assert out["resnet_trunk_max_move"] <= chip_smoke.TF_RESNET_MOVE


def test_verify_released_ckpts_tf_import_on_the_card(card, tmp_path,
                                                     monkeypatch):
    """``verify_released_ckpts --device cuda``: no bundle, all skipped;
    a generated darknet19-Pascal bundle at 224² passes its own golden
    check through B1."""
    from tensorflow_yolo2_torch.entries import verify_released_ckpts

    monkeypatch.setenv("TFY2_ROOT", str(tmp_path))
    demo = ["--images", chip_smoke.DEMO, "--device", "cuda"]
    assert verify_released_ckpts.main(demo) == 0
    assert verify_released_ckpts.RESULT["ran"] == []
    _, state = chip_smoke.v1_detector()
    (tmp_path / "weights").mkdir()
    chip_smoke.write_tf_bundle(str(tmp_path / "weights" /
                                   "darknet19_pascal.ckpt"),
                               chip_smoke.tf_darknet19_names(state))
    golden = str(tmp_path / "golden.json")
    cuda_decode.reset_launch_counts()
    assert verify_released_ckpts.main(demo + ["--golden-out", golden]) == 0
    assert verify_released_ckpts.RESULT["ran"] == ["darknet19_pascal"]
    assert cuda_decode.DECODE_NMS_LAUNCHES == 1
    assert verify_released_ckpts.main(demo + ["--golden-check",
                                              golden]) == 0
    assert verify_released_ckpts.RESULT["golden_ok"] is True


def _adversarial_darknet(card, pairs: int):
    """The white-box Darknet19 classifier at 224², batch 18, bf16, after
    ``pairs`` adversarial pairs on one seeded batch."""
    from tensorflow_yolo2_torch.train.adversarial import (
        adversarial_train_step_pair,
    )

    images, labels = (torch.from_numpy(a).to(card) for a in
                      chip_smoke.cls_batch(np.random.RandomState(3), 18))
    images = images.float() / 255.0 * 2.0 - 1.0
    trainer, state = chip_smoke.adversarial_trainer(
        "darknet19", 224, torch.bfloat16, card)
    for _ in range(pairs):
        state, clean, adv = adversarial_train_step_pair(
            trainer, state, images, labels, chip_smoke.ADV_EPSILON)
    return trainer, state, images, labels


def test_adversarial_pair_runs_b5_fifteen_times(card):
    """B5 in the clean step (5), in the FGSM input gradient (5) and in the
    adversarial step (5) of a Darknet19 pair."""
    from tensorflow_yolo2_torch.train.adversarial import (
        adversarial_train_step_pair,
    )

    trainer, state, images, labels = _adversarial_darknet(card, 1)
    cuda_pool.reset_launch_counts()
    _, clean, adv = adversarial_train_step_pair(
        trainer, state, images, labels, chip_smoke.ADV_EPSILON)
    torch.cuda.synchronize()
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 15
    assert math.isfinite(clean["loss"].item())
    assert math.isfinite(adv["loss"].item())


def test_adversarial_pair_matches_float64(card, no_tf32):
    """One float32 pair on the card against float64 on the CPU from
    weights trained 3 pairs (``chip_smoke.check_pair_against_float64``:
    the clean and adversarial steps' losses to 1e-4, the FGSM images
    where |g64| > 1e-2 max|g64|)."""
    _, state, images, labels = _adversarial_darknet(card, 3)
    trained = {k: v.detach().cpu() for k, v in
               state.model.state_dict().items()}
    out = chip_smoke.check_pair_against_float64(
        trained, images[:4], labels[:4], card)
    assert out["flips_firm"] == 0
    assert out["adv_loss_rel_err"] <= chip_smoke.LOSS_REL_TOL


def test_adversarial_cli_on_the_card(card, tmp_path, monkeypatch):
    """``imagenet_train_adversarial --device cuda``, darknet19 at 224²,
    white-box, 2 iterations at batch 8 with a validation batch at 2: B5
    15 times a pair and 5 times the validation attack."""
    from tensorflow_yolo2_torch.entries import imagenet_train_adversarial

    monkeypatch.setenv("TFY2_ROOT", str(tmp_path))
    chip_smoke.write_ilsvrc_tree(str(tmp_path / "data" / "ILSVRC"),
                                 np.random.RandomState(6))
    cuda_pool.reset_launch_counts()
    assert imagenet_train_adversarial.main(
        ["--backbone", "darknet19", "--image-size", "224", "--iters", "2",
         "--batch-size", "8", "--eval-every", "2", "--num-workers", "2",
         "--device", "cuda"]) == 0
    torch.cuda.synchronize()
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 2 * 15 + 5
    assert (tmp_path / "ckpts" / "darknet19_adv" / "ilsvrc_2017_cls" /
            "train_iter_2").is_dir()


@pytest.fixture()
def world1(card):
    """A world-1 NCCL group in this process (chip_smoke.world1_group),
    destroyed after the test."""
    with chip_smoke.world1_group():
        yield card


def _trained_v1(card, n: int = 4, steps: int = 10):
    """Seeded 224² batch and the v1 detector's weights after ``steps``
    plain bf16 steps on it (fresh weights make the responsible boxes flip
    under rounding, as chip_smoke's step checks note)."""
    import numpy as np

    yolo = YoloConfig()
    images, labels = (torch.from_numpy(a).to(card)
                      for a in chip_smoke.train_batch(
                          np.random.RandomState(1), n, yolo))
    trainer, state = chip_smoke.make_trainer(yolo, torch.bfloat16, card)
    for _ in range(steps):
        trainer.train_step(state, images, labels)
    return yolo, images, labels, {k: v.detach().cpu().clone()
                                  for k, v in state.model.state_dict().items()}


def test_parallel_dp_step_world1_nccl(world1, no_tf32):
    """The data-parallel Trainer step on a (1, 1) mesh over NCCL: B5 5
    times a bf16 step, and its float32 step against the plain float64 step
    on the CPU with chip_smoke's step bounds (chip_smoke.check_dp)."""
    from tensorflow_yolo2_torch.parallel.mesh import MeshConfig, make_mesh
    from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task

    yolo, images, labels, weights = _trained_v1(world1)
    mesh = make_mesh(MeshConfig(1, 1))

    def build(dtype, where, state_dict=None):
        on_card = torch.device(where).type == "cuda"
        t = Trainer(Darknet19Detector(yolo.cell_channels), yolo_task(yolo),
                    device=where, compute_dtype=dtype,
                    mesh=mesh if on_card else None)
        return t, t.create_state(torch.Generator().manual_seed(0),
                                 state_dict)

    trainer, state = build(torch.bfloat16, world1, weights)
    cuda_pool.reset_launch_counts()
    trainer.train_step(state, images, labels)
    torch.cuda.synchronize()
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 5
    chip_smoke.check_train_step_against_cpu(build, images, labels, world1,
                                            weights)


def test_parallel_spatial_step_world1_nccl(world1, no_tf32):
    """The live-BatchNorm spatial v1 step over the world-1 spatial mesh:
    B5 5 times, the loss, gradients and running statistics against the
    plain float64 step on the CPU (chip_smoke.check_spatial_training)."""
    yolo, images, labels, weights = _trained_v1(world1)
    out = chip_smoke.check_spatial_training(
        world1, [("v1", yolo, weights, images, labels)])
    assert out["v1"]["launches"] == 5


def test_parallel_spatial_serving_launches(world1):
    """make_spatial_detect_fn over the world-1 mesh: B1 and B3 once a v1
    call (NMS on, off), B2 once a v2p call, the grid equal to the stock
    path's within chip_smoke.GRID_REL_TOL."""
    import numpy as np

    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        make_spatial_detect_fn,
    )

    rng = np.random.RandomState(2)
    for v2 in (False, True):
        cfg, state = (chip_smoke.v2_detector(True) if v2 else
                      chip_smoke.v1_detector())
        images = torch.from_numpy(rng.randint(
            0, 256, (4, cfg.image_size, cfg.image_size, 3)).astype(np.uint8))
        kw = {"v2": True, "passthrough": True} if v2 else {}
        cuda_decode.reset_launch_counts()
        kept = make_spatial_detect_fn(cfg, state, None, 0.5, use_nms=True,
                                      n_shards=1, device=world1,
                                      **kw)(images)
        if not v2:
            make_spatial_detect_fn(cfg, state, None, 0.5, use_nms=False,
                                   n_shards=1, device=world1)(images)
        torch.cuda.synchronize()
        assert (cuda_decode.DECODE_NMS_V2_LAUNCHES,
                cuda_decode.DECODE_NMS_LAUNCHES,
                cuda_decode.DECODE_GRID_LAUNCHES) == \
            ((1, 0, 0) if v2 else (0, 1, 1))
        stock = make_detect_fn(cfg, state, object_thresh=0.5, use_nms=True,
                               device=world1, **kw)(images)
        assert kept.boxes.shape == stock.boxes.shape == (4, K, 4)


def test_quality_int8_on_a_two_stage_v1_snapshot(card, tmp_path, monkeypatch,
                                                 capsys):
    """``quality_curve --stages 1,2`` on a small hard fixture, then
    ``int8_quality`` on its v1 snapshot with ``--device cuda``: finite
    mAPs in [0, 1], B1 once an evaluation batch of each path (8 train and
    4 val images at batch 8: 2 batches a path)."""
    import json

    from tensorflow_yolo2_torch.entries import int8_quality, quality_curve

    monkeypatch.setenv("TFY2_ROOT", str(tmp_path))
    assert quality_curve.main(
        ["--stages", "1,2", "--batch", "4", "--n-train", "8", "--n-val",
         "4", "--device", "cuda"]) == 0
    capsys.readouterr()
    cuda_decode.reset_launch_counts()
    assert int8_quality.main(["--device", "cuda"]) == 0
    torch.cuda.synchronize()
    assert cuda_decode.DECODE_NMS_LAUNCHES == 2 * 2
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("INT8_QUALITY ")]
    result = json.loads(line[0][len("INT8_QUALITY "):])
    assert result["head"] == "v1"
    for split in ("train", "val"):
        for mode in ("bf16", "int8"):
            assert 0.0 <= result[f"map_{split}_{mode}"] <= 1.0
        assert math.isfinite(result[f"delta_{split}"])
