"""The port's decode, NMS and decode+NMS against the JAX package (CPU), and
the CUDA kernels against their plain versions (``cuda``-marked, card only).

Contract (that of tests/test_pallas_nms.py): scores equal, and boxes and
classes compared on kept (score > 0) slots only — the values of empty
slots are unspecified. Scores are copies of input confidences, so they
are compared exactly; boxes to atol 1e-6 (float32 arithmetic of values
below ~2, a few ulp); classes exactly. On the card the kernels repeat the
plain versions' arithmetic with the same rounding, so there scores and
classes are exact and kept boxes agree to 1e-6.

The decode+NMS sweep breaks score ties towards the lowest key
``b·S·S + cell`` (the Pallas kernel's rule), which is not ``nms_fixed``'s
argsort order; the grids below hold exact ties whose order decides which
box survives.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tensorflow_yolo2_torch import config as pt_config
from tensorflow_yolo2_torch.ops import boxes as pt_boxes
from tensorflow_yolo2_torch.ops.boxes import Detections
from tensorflow_yolo2_torch.ops import cuda_decode
from tensorflow_yolo2_torch.ops import iou as pt_iou
from tensorflow_yolo2_torch.ops.nms import nms_fixed as pt_nms_fixed
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.ops import boxes as jx_boxes
from tensorflow_yolo2_tpu.ops import iou as jx_iou
from tensorflow_yolo2_tpu.ops.nms import nms_fixed as jx_nms_fixed
from tensorflow_yolo2_tpu.ops.pallas_decode import (
    decode_grid_pallas,
    decode_nms_pallas,
)

K = 32
# tie_grid(cfg, batch, seed): random_grid plus exact score ties among large
# overlapping boxes: same class in (2,2) slot 1, (2,3) slot 0, (3,2) slot 0
# and (3,3) slot 1 (IoU ≈ 0.63 between neighbours), another class in (3,4)
# slot 0. The kernel order picks (2,3) slot 0 first (key 0·S·S + 2S+3 <
# 1·S·S + 2S+2); cell-major order would pick (2,2) slot 1.
tie_grid = chip_smoke.synthetic_grid
GRIDS = {7: 224, 14: 448}  # S → image size


def cfgs(S):
    return (pt_config.YoloConfig(S=S, image_size=GRIDS[S]),
            jx_config.YoloConfig(S=S, image_size=GRIDS[S]))


def random_grid(cfg, batch=3, seed=0):
    rng = np.random.RandomState(seed)
    net = rng.normal(0, 0.6, (batch, cfg.S, cfg.S, cfg.cell_channels)
                     ).astype(np.float32)
    C = cfg.num_class
    # confident same-cell box pairs, so the suppression sweep fires
    net[:, 1, 2, C] = 0.95
    net[:, 1, 2, C + 1] = 0.9
    net[:, 1, 3, C] = 0.8
    return net


def assert_equivalent(got, want):
    got_s, want_s = np.asarray(got.scores), np.asarray(want.scores)
    np.testing.assert_array_equal(got_s, want_s)
    kept = want_s > 0
    np.testing.assert_allclose(np.asarray(got.boxes)[kept],
                               np.asarray(want.boxes)[kept],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.classes)[kept],
                                  np.asarray(want.classes)[kept])


def test_iou_matches_jax():
    rng = np.random.RandomState(1)
    a = rng.uniform(0, 1, (6, 4)).astype(np.float32)
    b = rng.uniform(0, 1, (5, 4)).astype(np.float32)
    ca = pt_iou.cxcywh_to_corners(torch.from_numpy(a))
    cb = pt_iou.cxcywh_to_corners(torch.from_numpy(b))
    np.testing.assert_array_equal(
        ca.numpy(), np.asarray(jx_iou.cxcywh_to_corners(a)))
    np.testing.assert_allclose(
        pt_iou.corners_iou(ca[:5], cb).numpy(),
        np.asarray(jx_iou.corners_iou(np.asarray(ca[:5]), np.asarray(cb))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        pt_iou.pairwise_corners_iou(ca, cb).numpy(),
        np.asarray(jx_iou.pairwise_corners_iou(np.asarray(ca),
                                               np.asarray(cb))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("S", [7, 14])
def test_decode_grid_matches_jax_and_pallas(S):
    pcfg, jcfg = cfgs(S)
    net = tie_grid(pcfg)
    got = cuda_decode.decode_grid_plain(torch.from_numpy(net), pcfg, 0.5)
    eager = jax.vmap(lambda g: jx_boxes.decode_grid(g, jcfg, 0.5))(net)
    pallas = decode_grid_pallas(net, jcfg, 0.5)  # interpret mode on CPU
    for want in (eager, pallas):
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.scores.numpy(),
                                      np.asarray(want.scores))
        np.testing.assert_array_equal(got.classes.numpy(),
                                      np.asarray(want.classes))


@pytest.mark.parametrize("S,class_aware", [(7, True), (14, True), (7, False)])
def test_decode_nms_matches_pallas(S, class_aware):
    pcfg, jcfg = cfgs(S)
    net = tie_grid(pcfg)
    got = cuda_decode.decode_nms_plain(torch.from_numpy(net), pcfg, 0.5, 0.5,
                                       K, class_aware)
    want = decode_nms_pallas(net, jcfg, 0.5, 0.5, max_outputs=K,
                             class_aware=class_aware)
    assert got.boxes.shape == (3, K, 4) and got.classes.dtype == torch.int32
    assert (got.scores.numpy() > 0).sum() > 3 * 5  # the sweep kept boxes
    assert_equivalent(got, want)


def test_decode_nms_tie_order():
    """The tied same-class group keeps (2,3) slot 0 and the (3,2) box
    diagonal to it (IoU ≈ 0.43): the kernel order. nms_fixed's cell-major
    argsort keeps (2,2) slot 1 and (3,3) instead."""
    pcfg, _ = cfgs(7)
    net = tie_grid(pcfg, batch=1)
    dense = pt_boxes.decode_grid(torch.from_numpy(net[0]), pcfg, 0.5)

    def box(y, x, b):
        return dense.boxes[(y * 7 + x) * 2 + b]

    def kept_group(dets):
        tied = (dets.scores == np.float32(0.85)) & (dets.classes == 4)
        return sorted(dets.boxes[tied].tolist())

    got = cuda_decode.decode_nms_plain(torch.from_numpy(net), pcfg, 0.5, 0.5)
    assert kept_group(Detections(*(t[0] for t in got))) == \
        sorted([box(2, 3, 0).tolist(), box(3, 2, 0).tolist()])
    assert int(((got.scores[0] == np.float32(0.85))
                & (got.classes[0] == 9)).sum()) == 1  # other class kept
    assert kept_group(pt_nms_fixed(dense, 0.5, K)) == \
        sorted([box(2, 2, 1).tolist(), box(3, 3, 1).tolist()])


@pytest.mark.parametrize("class_aware", [True, False])
def test_nms_fixed_matches_jax(class_aware):
    pcfg, jcfg = cfgs(7)
    net = random_grid(pcfg, batch=2, seed=3)
    for i in range(len(net)):
        got = pt_nms_fixed(pt_boxes.decode_grid(torch.from_numpy(net[i]),
                                                pcfg, 0.5),
                           0.5, K, class_aware)
        want = jx_nms_fixed(jx_boxes.decode_grid(net[i], jcfg, 0.5), 0.5, K,
                            class_aware)
        assert_equivalent(got, want)


def test_wrappers_on_cpu_take_the_plain_path():
    pcfg, _ = cfgs(7)
    net = torch.from_numpy(tie_grid(pcfg))
    cuda_decode.reset_launch_counts()
    dense = cuda_decode.decode_grid_fused(net, pcfg, 0.5)
    kept = cuda_decode.decode_nms_fused(net, pcfg, 0.5, 0.5, K, False)
    for got, want in ((dense, cuda_decode.decode_grid_plain(net, pcfg, 0.5)),
                      (kept, cuda_decode.decode_nms_plain(net, pcfg, 0.5, 0.5,
                                                          K, False))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert cuda_decode.DECODE_GRID_LAUNCHES == 0
    assert cuda_decode.DECODE_NMS_LAUNCHES == 0


def test_wrappers_check_their_input():
    pcfg, _ = cfgs(7)
    net = torch.zeros((2, 7, 7, 30))
    with pytest.raises(ValueError, match="grid must be"):
        cuda_decode.decode_nms_fused(net[:, :6], pcfg)
    with pytest.raises(TypeError, match="float32"):
        cuda_decode.decode_grid_fused(net.double(), pcfg)
    with pytest.raises(ValueError, match="max_outputs"):
        cuda_decode.decode_nms_fused(net, pcfg, max_outputs=0)
    v2 = pt_config.YoloConfig(S=7, B=5, per_slot_classes=True)
    with pytest.raises(ValueError, match="v1 layout"):
        cuda_decode.decode_grid_fused(torch.zeros((1, 7, 7, 125)), v2)
    with pytest.raises(ValueError, match="grid must be"):
        cuda_decode.decode_nms_fused(torch.zeros((1, 7, 7, 30)), v2)


def test_empty_grid_keeps_nothing():
    pcfg, _ = cfgs(7)
    got = cuda_decode.decode_nms_plain(torch.zeros((2, 7, 7, 30)), pcfg)
    assert got.scores.max() == 0.0
    assert got.boxes.abs().max() == 0.0 and got.classes.max() == 0


@pytest.mark.parametrize("argv", [["--decode-ab"], ["--decode-ab", "a.cu"]])
def test_decode_ab_refuses_without_a_card(argv, monkeypatch):
    """Without a CUDA device ``chip_smoke.py --decode-ab`` returns 2 before
    building or running anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(argv) == 2


def test_kernel_registers_reads_ptxas_output():
    log = (
        "ptxas info    : Compiling entry function '_Z17decode_nms_kernelI1AE'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z17decode_nms_kernelI1AE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z18decode_grid_kernelv'"
        " for 'sm_90a'\n"
        "ptxas info    : Used 35 registers, used 1 barriers\n")
    assert chip_smoke.kernel_registers(log, "decode_nms_kernel") == {
        "_Z17decode_nms_kernelI1AE": "0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads Used 40 registers, used 1 barriers"}
