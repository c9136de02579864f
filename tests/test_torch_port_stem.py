"""The port's fused-stem serving path (``--pallas-stem``) against the JAX
package, on the CPU: ``models/fast_stem.py`` (``phase_kernel``,
``conv_pool_s2d``, ``fast_detect_forward``), ``ops/cuda_stem.py`` (B4's
plain version against ``fused_stem`` in Pallas interpret mode, and
``fused_detect_forward`` against ``pallas_detect_forward``), and
``make_detect_fn(pallas_stem=True)`` end to end.

Tolerances:

- ``phase_kernel``, the kernel's B-fragment layout, ``stem_reference``
  in bf16: exact (rearrangements; the same roundings).
- float32 stems: rtol / atol 1e-5 (the JAX package's own
  ``tests/test_pallas_stem.py``); ``fast_detect_forward`` 1e-4,
  ``fused_detect_forward`` 2e-4 (22 float32 convs summed in another
  order).
- bf16 stem against interpreted Pallas: ``chip_smoke.compare_stem``'s
  bounds, the ones B4 is held to on the card: at least 99.9% of the
  elements bit-equal, none more than one bf16 ulp of the value (or of the
  output's RMS) apart, relative norm 1e-4. Both round the stage-1 map and
  the output once; only the float32 sums' order differs.
- ``make_detect_fn``: scores 1e-4, boxes 1e-3, as the JAX package's
  ``test_make_detect_fn_pallas_stem_wiring``; at 224² (S=7), where XLA
  compiles the interpreted decode+NMS in seconds (minutes at S=2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from tensorflow_yolo2_torch import config as pt_config
from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pt_detect
from tensorflow_yolo2_torch.models import darknet as pt_darknet
from tensorflow_yolo2_torch.models import fast_stem as pt_fast
from tensorflow_yolo2_torch.models.layers import space_to_depth
from tensorflow_yolo2_torch.ops import cuda_stem
from tensorflow_yolo2_torch.utils import cuda_build
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.entries import pascal_detect_darknet as jx_detect
from tensorflow_yolo2_tpu.models import darknet as jx_darknet
from tensorflow_yolo2_tpu.models import fast_stem as jx_fast
from tensorflow_yolo2_tpu.models.fold import fold_params as jx_fold
from tensorflow_yolo2_tpu.models.layers import space_to_depth as jx_s2d
from tensorflow_yolo2_tpu.ops import pallas_stem as jx_stem
from tests.test_torch_port_models import rel_err, random_variables

THRESH = 0.05
CPU = torch.device("cpu")


def stem_weights(seed: int, cin: int = 3) -> tuple[np.ndarray, ...]:
    """Seeded (w1, b1, w2, b2) at the spreads of the JAX package's
    ``tests/test_pallas_stem.py``."""
    rng = np.random.RandomState(seed)
    return tuple(rng.normal(0, std, shape).astype(np.float32)
                 for shape, std in (((3, 3, cin, 32), 0.3), ((32,), 0.2),
                                    ((3, 3, 32, 64), 0.1), ((64,), 0.2)))


def images(shape, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def jx(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def pt(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def folded_state_dict(params, stats) -> dict:
    """The JAX package's BN fold, carried to a port state dict."""
    return convert.state_dict_from_flax(jax.device_get(
        jx_fold(params, stats)))


# -- models/fast_stem.py -----------------------------------------------------


@pytest.mark.parametrize("di,dj", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("c", [3, 32])
def test_phase_kernel_matches_jax(c, di, dj):
    w = np.random.RandomState(c).normal(0, 1, (3, 3, c, 8)).astype(
        np.float32)
    got = pt_fast.phase_kernel(torch.from_numpy(w), di, dj)
    assert got.shape == (2, 2, 4 * c, 8)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jx_fast.phase_kernel(jnp.asarray(w), di, dj)))


def test_conv_pool_s2d_matches_jax():
    x = images((2, 16, 24, 3), seed=1)
    w1, b1, _, _ = stem_weights(2)
    got = pt_fast.conv_pool_s2d(space_to_depth(torch.from_numpy(x)),
                                *pt(w1, b1), dtype=torch.float32)
    want = jx_fast.conv_pool_s2d(jx_s2d(jnp.asarray(x)), *jx(w1, b1),
                                 dtype=jnp.float32)
    assert got.shape == (2, 8, 12, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def detector_weights():
    """Seeded unfolded v1 detector weights (flax tree of numpy arrays),
    the output BN's offsets raised so that most slots are confident and
    boxes are large and overlap (NMS has work)."""
    v = random_variables(jx_darknet.Darknet19Detector(output_channels=30),
                         (1, 64, 64, 3), seed=21)
    beta = v["params"]["detection"]["output"]["bn"]["bias"]
    beta[20:22] += 0.6
    beta[[24, 25, 28, 29]] += 1.5
    return v["params"], v["batch_stats"]


def port_detector(state_dict, cfg, **head):
    return pt_detect.build_detector(cfg, state_dict, dtype=torch.float32,
                                    device="cpu", **head)


def test_fast_detect_forward_matches_jax(detector_weights):
    params, stats = detector_weights
    x = images((2, 64, 64, 3), seed=3)
    sd = folded_state_dict(params, stats)
    model = port_detector(sd, pt_config.YoloConfig(S=2, image_size=64))
    with torch.no_grad():
        got = pt_fast.fast_detect_forward(model, torch.from_numpy(x),
                                          dtype=torch.float32)
    want = jx_fast.fast_detect_forward(jx_fold(params, stats),
                                       jnp.asarray(x), dtype=jnp.float32)
    assert got.shape == (2, 2, 2, 30) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_after_stem_needs_the_pool_trunk():
    trunk = pt_darknet.Darknet19Backbone(fold_bn=True, downsample="stride")
    with pytest.raises(ValueError, match="stride"):
        trunk(torch.zeros(1, 64, 8, 8), after_stem=True)


# -- ops/cuda_stem.py --------------------------------------------------------


@pytest.mark.parametrize("h,w,batch", [(32, 32, 2), (64, 32, 1),
                                       (56, 64, 1)])
def test_fused_stem_float32_matches_pallas(h, w, batch):
    x = images((batch, h, w, 3), seed=h + w)
    weights = stem_weights(0)
    got = cuda_stem.fused_stem(*pt(x, *weights))
    want = jx_stem.fused_stem(*jx(x, *weights), interpret=True,
                              dtype=jnp.float32)
    assert got.shape == (batch, h // 4, w // 4, 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jx_stem.stem_reference(
            *jx(x, *weights), dtype=jnp.float32)), rtol=1e-5, atol=1e-5)


def to_torch_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("case", ["random", "zero_images"])
def test_fused_stem_bf16_matches_pallas(case):
    """224², batch 2, bf16: B4's plain version against interpreted
    Pallas, held as the card holds B4 to it. ``zero_images``: all-zero
    images with b1 > 0, where conv2's SAME padding is zeros of the
    stage-1 map, not leaky(b1), so the edge outputs differ from the
    interior."""
    w1, b1, w2, b2 = stem_weights(1)
    if case == "zero_images":
        x = np.zeros((2, 224, 224, 3), np.float32)
        b1 = np.abs(b1) + 0.1
    else:
        x = images((2, 224, 224, 3), seed=4)
    got = cuda_stem.fused_stem(torch.from_numpy(x).bfloat16(),
                               *pt(w1, b1, w2, b2))
    want = to_torch_bf16(jx_stem.fused_stem(*jx(x, w1, b1, w2, b2),
                                            interpret=True,
                                            dtype=jnp.bfloat16))
    _, unequal = chip_smoke.compare_stem(got, want, f"CPU, {case}")
    assert unequal <= (1 - chip_smoke.STEM_BIT_SHARE) * got.numel()
    if case == "zero_images":
        inner = got[:, 1:-1, 1:-1]
        assert bool((inner == got[:1, 1:2, 1:2]).all())
        for edge in (got[:, 0, 1:-1], got[:, -1, 1:-1], got[:, 1:-1, 0],
                     got[:, 1:-1, -1]):
            assert bool((edge != inner[:, :1, 0]).any(-1).all())


def test_stem_reference_matches_jax():
    x = images((1, 64, 64, 3), seed=5)
    weights = stem_weights(2)
    got = cuda_stem.stem_reference(*pt(x, *weights))
    want = to_torch_bf16(jx_stem.stem_reference(*jx(x, *weights)))
    assert torch.equal(got, want)


def test_mma_fragment_layout():
    """Lane g·4 + t of B tile (s, j) holds (k, n) = (16s + 2t, 8j + g),
    (16s + 2t + 1, ·), (16s + 2t + 8, ·), (16s + 2t + 9, ·): the register
    order of mma.sync.m16n8k16's B operand. conv1's K pads 27 to 32."""
    w1, _, w2, _ = stem_weights(3)
    for w, steps in ((w1, 2), (w2, 18)):
        b = torch.from_numpy(w).reshape(-1, w.shape[-1]).bfloat16()
        b = torch.cat([b, b.new_zeros((16 * steps - b.shape[0], b.shape[1]))])
        frags = cuda_stem.mma_fragments(torch.from_numpy(w))
        assert frags.shape == (steps, w.shape[-1] // 8, 32, 4)
        assert frags.dtype == torch.bfloat16
        for s in range(steps):
            for j in range(w.shape[-1] // 8):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    k = [16 * s + 2 * t + d for d in (0, 1, 8, 9)]
                    assert torch.equal(frags[s, j, lane], b[k, 8 * j + g])


@pytest.mark.parametrize("cin", [3, 32])
def test_wgmma_tile_layout(cin):
    """Every (k, n) of the (9·cin, O) bf16 matrix lies at the byte offset
    that csrc/stem.cu's descriptor implies for wgmma's K-major B without
    swizzle: core matrices of 8 columns × 16 bytes of k, WGMMA_LBO bytes
    apart along K and WGMMA_SBO along N, a K step of 16 every
    O/8·WGMMA_SBO bytes; K's padding to a multiple of 16 is zero."""
    w = stem_weights(3)[0 if cin == 3 else 2]
    k_rows, o = 9 * cin, w.shape[-1]
    tiles = cuda_stem.wgmma_tiles(torch.from_numpy(w))
    k_pad = -(-k_rows // 16) * 16
    assert tiles.shape == (k_pad // 16, o // 8, 2, 8, 8)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    flat = tiles.reshape(-1).view(torch.int16).numpy()
    k, n = np.meshgrid(np.arange(k_rows), np.arange(o), indexing="ij")
    byte = ((k // 16) * (o // 8) * cuda_stem.WGMMA_SBO
            + (n // 8) * cuda_stem.WGMMA_SBO
            + (k % 16) // 8 * cuda_stem.WGMMA_LBO + (n % 8) * 16
            + (k % 8) * 2)
    b = torch.from_numpy(w).reshape(k_rows, o).bfloat16()
    np.testing.assert_array_equal(flat[byte // 2],
                                  b.view(torch.int16).numpy())
    pad = np.ones(flat.size, bool)
    pad[byte.ravel() // 2] = False
    assert pad.sum() == (k_pad - k_rows) * o
    assert not flat[pad].any()


def test_stem_on_folded_backbone_weights():
    """The stem on the folded conv1 / conv2 of a Darknet19Backbone, carried
    by the converter: the port's ``stem_weights`` against the JAX
    package's folded kernels in ``fused_stem`` and ``stem_reference``."""
    x = images((2, 64, 64, 3), seed=6)
    v = random_variables(jx_darknet.Darknet19Backbone(), (1, 32, 32, 3),
                         seed=7)
    folded = jx_fold(v["params"], v["batch_stats"])
    c1, c2 = folded["conv1"]["conv"], folded["conv2"]["conv"]
    jw = (c1["kernel"], c1["bias"], c2["kernel"], c2["bias"])
    sd = convert.state_dict_from_flax({"backbone": v["params"]},
                                      {"backbone": v["batch_stats"]})
    weights = pt_detect.stem_weights(sd, CPU)
    for got_w, want_w in zip(weights[:4], jw):
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                                   rtol=1e-6, atol=1e-7)
    got = cuda_stem.fused_stem_packed(torch.from_numpy(x), weights).numpy()
    for want in (jx_stem.fused_stem(jnp.asarray(x), *jw, interpret=True,
                                    dtype=jnp.float32),
                 jx_stem.stem_reference(jnp.asarray(x), *jw,
                                        dtype=jnp.float32)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("linear_output", [False, True])
def test_fused_detect_forward_matches_pallas(linear_output):
    """B4's plain version and the rest of the folded detector against
    ``pallas_detect_forward`` at 64² in float32: the v1 head, and the
    ``--v2`` head's linear output conv."""
    cfg = (pt_config.yolo_v2_config(64) if linear_output
           else pt_config.YoloConfig(S=2, image_size=64))
    v = random_variables(jx_darknet.Darknet19Detector(
        output_channels=cfg.cell_channels, bn_on_output=not linear_output),
        (1, 64, 64, 3), seed=8)
    x = images((2, 64, 64, 3), seed=9)
    sd = folded_state_dict(v["params"], v["batch_stats"])
    model = port_detector(sd, cfg, v2=linear_output)
    with torch.no_grad():
        got = cuda_stem.fused_detect_forward(
            model, torch.from_numpy(x), pt_detect.stem_weights(sd, CPU))
        stock = model(torch.from_numpy(x))
    want = np.asarray(jx_stem.pallas_detect_forward(
        jx_fold(v["params"], v["batch_stats"]), jnp.asarray(x),
        dtype=jnp.float32, interpret=True, linear_output=linear_output))
    assert got.shape == (2, 2, 2, cfg.cell_channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert rel_err(got.numpy(), stock.numpy()) <= 1e-5


# what only each phase of a tile's work in csrc/stem.cu holds
PHASE_MARKS = {"load": "sxin_words[(lr + 2 * i)", "conv1": "mma_bf16(acc[nt]",
               "conv2": "wgmma_m64n64k16(acc"}


@pytest.mark.parametrize("phase", sorted(chip_smoke.STEM_PHASES))
def test_stem_phase_left_out(phase):
    """``chip_smoke.py --stem-ab``'s copies of B4's source: leaving a
    phase out takes its block, from its comment through its closing brace,
    and nothing else, and the braces still balance."""
    with open(cuda_build.source_path("stem")) as f:
        text = f.read()
    cut = chip_smoke.without_phases(text, [phase])
    gone = set(text.split("\n")) - set(cut.split("\n"))
    assert cut.count("{") == cut.count("}")
    assert text.count("{") - cut.count("{") >= 2
    assert any(line.startswith(chip_smoke.STEM_PHASES[phase])
               for line in gone)
    for other, mark in PHASE_MARKS.items():
        assert (mark in cut) == (other != phase), other
    assert chip_smoke.without_phases(text, []) == text


def test_stem_variants(tmp_path):
    """Each source whole (built from itself), each phase left out and each
    alone (copies written out), and the weight layout it reads: wgmma
    tiles, or mma.sync fragments for a source without wgmma."""
    src = cuda_build.source_path("stem")
    old = tmp_path / "stem_old.cu"
    old.write_text(open(src).read().replace("wgmma.mma_async", "mma.sync"))
    variants = chip_smoke.stem_variants([src, str(old)],
                                        str(tmp_path / "ab"))
    assert [v["name"] for v in variants[:7]] == [
        "stem", "stem -load", "stem -conv1", "stem -conv2",
        "stem, load alone", "stem, conv1 alone", "stem, conv2 alone"]
    assert variants[0]["build"] == src and variants[7]["build"] == str(old)
    assert [v["wgmma"] for v in variants] == [True] * 7 + [False] * 7
    for v in variants:
        assert v["source"] in (src, str(old))
        if v["left_out"]:
            assert open(v["build"]).read() == chip_smoke.without_phases(
                open(v["source"]).read(), v["left_out"])


@pytest.mark.parametrize("argv", [[], ["--stem-ab"], ["--stem-ab", "a.cu"]])
def test_chip_smoke_refuses_without_a_card(argv, monkeypatch):
    """Without a CUDA device the smoke run and the A/B run return 2 before
    building or running anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(argv) == 2


def test_wrapper_checks_its_input():
    weights = cuda_stem.pack_stem_weights(*pt(*stem_weights(0)))
    with pytest.raises(ValueError, match="multiples of 4"):
        cuda_stem.fused_stem_packed(torch.zeros(1, 30, 32, 3), weights)
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\)"):
        cuda_stem.fused_stem_packed(torch.zeros(1, 32, 32, 4), weights)
    with pytest.raises(TypeError, match="floating"):
        cuda_stem.fused_stem_packed(torch.zeros(1, 32, 32, 3,
                                                dtype=torch.uint8), weights)
    with pytest.raises(ValueError, match="w1 \\(3, 3, 3, 32\\)"):
        cuda_stem.pack_stem_weights(*pt(*stem_weights(0, cin=4)))
    cuda_stem.reset_launch_counts()
    cuda_stem.fused_stem_packed(torch.zeros(1, 32, 32, 3), weights)
    assert cuda_stem.STEM_LAUNCHES == 0  # the CPU runs the plain version


def test_pack_stem_weights_keeps_hwio_contiguous():
    """B4-f32 reads w1 and w2 as they are: the HWIO kernels, contiguous,
    so that w1 is the (27, 32) and w2 the (288, 64) matrix with k =
    (dy·3 + dx)·C + c, even when the caller passes a permuted view (as
    ``stem_weights`` does, OIHW → HWIO)."""
    w1, b1, w2, b2 = pt(*stem_weights(4))
    oihw1, oihw2 = (w.permute(3, 2, 0, 1).contiguous() for w in (w1, w2))
    packed = cuda_stem.pack_stem_weights(oihw1.permute(2, 3, 1, 0), b1,
                                         oihw2.permute(2, 3, 1, 0), b2)
    for got, want, c in ((packed.w1, w1, 3), (packed.w2, w2, 32)):
        assert got.is_contiguous() and got.dtype == torch.float32
        assert torch.equal(got, want)
        mat = got.view(9 * c, -1)
        for dy, dx, ci in ((0, 0, 0), (1, 2, c - 1), (2, 1, c // 2)):
            assert torch.equal(mat[(dy * 3 + dx) * c + ci], want[dy, dx, ci])


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "stem"), (torch.float32, "stem_f32"),
    (torch.float16, None), (torch.float64, None), (torch.uint8, None)])
def test_cuda_kernel_by_type(dtype, kernel):
    """The kernel a CUDA batch of each type launches; a type with none
    raises before anything is launched or built."""
    if kernel is None:
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            cuda_stem.cuda_kernel(dtype)
    else:
        assert cuda_stem.cuda_kernel(dtype) == kernel
        assert kernel in cuda_build.sources()


def test_compare_stem_f32_bounds():
    """``chip_smoke.compare_stem_f32`` holds B4-f32 to rtol = atol = 1e-5:
    an output within it passes, one just outside it fails."""
    x = torch.from_numpy(images((1, 32, 32, 3), seed=12))
    weights = cuda_stem.pack_stem_weights(*pt(*stem_weights(5)))
    want = cuda_stem.fused_stem_plain(x, *weights[:4])
    assert chip_smoke.compare_stem_f32(want, want, "equal") == (0.0, 0)
    tol = 1e-5 * (1 + want.abs())
    chip_smoke.compare_stem_f32(want + 0.9 * tol, want, "inside")
    with pytest.raises(RuntimeError, match="float32 stem"):
        chip_smoke.compare_stem_f32(want + 1.1 * tol, want, "outside")


# -- entries: make_detect_fn(pallas_stem=True) and the CLI -------------------


def test_make_detect_fn_pallas_stem_matches_jax(detector_weights):
    """224² (S=7), float32, NMS on, uint8 input: the port's --pallas-stem
    path against the JAX package's (interpreted Pallas stem and
    decode+NMS), and against the port's stock path."""
    params, stats = detector_weights
    x = np.random.RandomState(10).randint(0, 256, (2, 224, 224, 3)).astype(
        np.uint8)
    pcfg = pt_config.YoloConfig(S=7, image_size=224)
    kw = dict(object_thresh=THRESH, use_nms=True)
    got = pt_detect.make_detect_fn(pcfg, params, stats, pallas_stem=True,
                                   dtype=torch.float32, device="cpu",
                                   **kw)(x)
    stock = pt_detect.make_detect_fn(pcfg, params, stats,
                                     dtype=torch.float32, device="cpu",
                                     **kw)(x)
    want = jx_detect.make_detect_fn(jx_config.YoloConfig(S=7, image_size=224),
                                    params, stats, pallas_stem=True,
                                    dtype=jnp.float32, **kw)(jnp.asarray(x))
    kept = np.asarray(want.scores) > 0
    assert 8 <= kept.sum() < 2 * 7 * 7 * 2
    for out in (got, stock):
        np.testing.assert_allclose(out.scores.numpy(),
                                   np.asarray(want.scores), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(out.boxes.numpy()[kept],
                                   np.asarray(want.boxes)[kept], rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_array_equal(out.classes.numpy()[kept],
                                      np.asarray(want.classes)[kept])


@pytest.mark.parametrize("size", [64, 96])
def test_make_detect_fn_v2_pallas_stem_matches_jax(size):
    """The float32 ``--v2 --pallas-stem`` path (the linear-output anchor
    head behind the fused stem) against the JAX package's, dense decode,
    uint8 input: scores 1e-4, boxes 1e-3, classes exact where kept."""
    v = random_variables(jx_darknet.Darknet19Detector(
        output_channels=125, bn_on_output=False), (1, 64, 64, 3), seed=13)
    conv = v["params"]["detection"]["output"]["conv"]
    conv["kernel"] *= 0.1  # logits near the biases, as a trained head's
    conv["bias"].reshape(5, 25)[:, 4] += 2.0
    params, stats = v["params"], v["batch_stats"]
    x = np.random.RandomState(14).randint(0, 256, (2, size, size, 3)).astype(
        np.uint8)
    kw = dict(object_thresh=THRESH, use_nms=False, v2=True)
    got = pt_detect.make_detect_fn(pt_config.yolo_v2_config(size), params,
                                   stats, pallas_stem=True,
                                   dtype=torch.float32, device="cpu",
                                   **kw)(x)
    want = jx_detect.make_detect_fn(jx_config.yolo_v2_config(size), params,
                                    stats, pallas_stem=True,
                                    dtype=jnp.float32, **kw)(jnp.asarray(x))
    kept = np.asarray(want.scores) > 0
    assert kept.sum() >= 4
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[kept],
                               np.asarray(want.boxes)[kept], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(got.classes.numpy()[kept],
                                  np.asarray(want.classes)[kept])


@pytest.mark.parametrize("option,match", [
    ({"v2": True, "passthrough": True}, "no passthrough"),
    ({"int8": True}, "no int8"),
    ({"downsample": "stride"}, "stride"),
    ({"fold_bn": False}, "fold"),
])
def test_pallas_stem_guards(detector_weights, option, match):
    """Refused before anything is built, with the JAX package's words."""
    params, stats = detector_weights
    cfg = (pt_config.yolo_v2_config(64) if option.get("v2")
           else pt_config.YoloConfig(S=2, image_size=64))
    with pytest.raises(ValueError, match=match):
        pt_detect.make_detect_fn(cfg, params, stats, pallas_stem=True,
                                 device="cpu", **option)


def test_cli_pallas_stem(detector_weights, tmp_path):
    cv2 = pytest.importorskip("cv2")
    params, stats = detector_weights
    image = str(tmp_path / "in.png")
    cv2.imwrite(image, np.random.RandomState(11).randint(
        0, 256, (64, 64, 3)).astype(np.uint8))
    npz = str(tmp_path / "w.npz")
    convert.save_npz(npz, params, stats)
    out = str(tmp_path / "out.png")
    assert pt_detect.main([image, "--weights", npz, "--image-size", "64",
                           "--threshold", str(THRESH), "--nms",
                           "--pallas-stem", "--out", out,
                           "--device", "cpu"]) == 0
    # drawn by matplotlib, as the JAX package draws (utils.visualize)
    with Image.open(out) as drawn:
        assert drawn.format == "PNG" and min(drawn.size) > 0
        assert "matplotlib" in drawn.info.get("Software", "")
