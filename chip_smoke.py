#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tensorflow_yolo2_torch) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, the torch and CUDA versions, and
   builds the CUDA kernels from tensorflow_yolo2_torch/csrc with nvcc.
2. Holds each kernel against its plain PyTorch version on the card, on
   seeded synthetic grids with exact score ties and overlapping same- and
   cross-class boxes, batch 256, class-aware NMS on and off: the v1
   kernels at S=7 and 14, the anchor kernel at S=7, 10, 13, 14 and 19
   (224² to 608²).
3. Drives the v1 serving path, ``make_detect_fn`` on the full
   Darknet19-448 detector (BN folded, bf16, seeded random weights), on a
   seeded uint8 batch with NMS on and off; checks shapes, finiteness, that
   both v1 kernels were launched, one image's grid against the float32 CPU
   forward, and the kernels against their plain versions on the real grid.
4. Drives the two anchor serving paths the same way at YOLOv2's VOC size,
   416² (S=13, B=5, C=20, classic anchors): ``--v2 --passthrough``
   (``Darknet19DetectorV2``) and ``--v2`` (linear-output
   ``Darknet19Detector``), checking that the anchor kernel was launched,
   the grid, and the kernel on the real grid.
5. Times the v1 and v2p paths (images/s at batch 32 and 256, with a
   profile) and each kernel and its plain version at batch 256, and
   prints them, with each kernel's bound, as one JSON line
   ``{"kernels": [...]}``.
6. Ends with ``{"ok": true, "device": {...}}``.

Each path is driven with the launch counts set to 0 just before it and
read just after; the ``launches`` of a kernel are those of its path.
Exits non-zero, printing no result, without a CUDA device or if any phase
fails. Float32 checks on the card run with TF32 off.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores; bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

K = 32
BATCH = 256
PATH_BATCHES = (32, 256)
GRID_REL_TOL = 5e-2  # bf16 card forward vs float32 CPU forward, rel. norm
BOX_TOL = 1e-6
SOURCE = "tensorflow_yolo2_torch/csrc/decode.cu"
TPU_KERNELS = {
    "decode_nms": "tensorflow_yolo2_tpu/ops/pallas_decode.py:204",
    "decode_nms_v2": "tensorflow_yolo2_tpu/ops/pallas_decode.py:255",
    "decode_grid": "tensorflow_yolo2_tpu/ops/pallas_decode.py:42",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + what)


def synthetic_grid(cfg, batch: int = 3, seed: int = 0) -> np.ndarray:
    """Seeded grid with confident same-cell pairs, exact score ties among
    large overlapping boxes of one class, and a tied box of another."""
    rng = np.random.RandomState(seed)
    C, B = cfg.num_class, cfg.B
    net = rng.normal(0, 0.6, (batch, cfg.S, cfg.S, cfg.cell_channels)
                     ).astype(np.float32)
    net[:, 1, 2, C] = 0.95
    net[:, 1, 2, C + 1] = 0.9
    net[:, 1, 3, C] = 0.8
    for y, x, b, cls in ((2, 2, 1, 4), (2, 3, 0, 4), (3, 2, 0, 4),
                         (3, 3, 1, 4), (3, 4, 0, 9)):
        net[:, y, x, :C] = 0.0
        net[:, y, x, cls] = 3.0
        net[:, y, x, C:C + B] = 0.3
        net[:, y, x, C + b] = 0.85
        net[:, y, x, C + B + 4 * b:C + B + 4 * b + 4] = (0.5, 0.5, 0.8, 0.8)
    return net


def synthetic_grid_v2(cfg, batch: int = 3, seed: int = 0) -> np.ndarray:
    """Seeded per-slot anchor grid (S >= 7): random logits with 3·S
    confident slots, and large (0.6 × 0.6) boxes with exactly tied
    scores: class 4 at (2, 3) slot 0 and (2, 2) slot 1 (IoU ≈ 0.61; the
    key order b·S·S + cell keeps the first, cell-major order the
    second), class 9 at (3, 3) slot 2 (IoU ≈ 0.61 with the first, so
    only class-aware NMS keeps it), and a lower-scored duplicate of the
    first in the last slot of its cell (B >= 3)."""
    rng = np.random.RandomState(seed)
    S, B, C = cfg.S, cfg.B, cfg.num_class
    net = rng.normal(0, 0.6, (batch, S, S, cfg.cell_channels)
                     ).astype(np.float32)
    slots = net.reshape(batch, S, S, B, 5 + C)  # a view of net
    ys, xs, bs = (rng.randint(0, m, 3 * S) for m in (S, S, B))
    slots[:, ys, xs, bs, 4] = 4.0
    slots[:, ys, xs, bs, 5 + rng.randint(0, C, 3 * S)] = 5.0
    anchors = np.asarray(cfg.anchors or ((1.0, 1.0),) * B)
    for y, x, b, cls, conf in ((2, 3, 0, 4, 3.0), (2, 2, 1, 4, 3.0),
                               (3, 3, 2, 9, 3.0), (2, 3, B - 1, 4, 2.0)):
        slots[:, y, x, b] = 0.0
        slots[:, y, x, b, 2:4] = np.log(0.6 * S / anchors[b])
        slots[:, y, x, b, 4] = conf
        slots[:, y, x, b, 5 + cls] = 6.0
    return net


def compare_dense(got, want) -> float:
    """B3 against its plain version: scores and classes exact, boxes to
    BOX_TOL. Returns the largest absolute difference."""
    check(torch.equal(got.scores, want.scores), "decode_grid scores")
    check(torch.equal(got.classes, want.classes), "decode_grid classes")
    err = (got.boxes - want.boxes).abs().max().item()
    check(err <= BOX_TOL, f"decode_grid boxes differ by {err}")
    return err


def compare_kept(got, want, name: str = "decode_nms") -> float:
    """B1 or B2 against its plain version: scores exact, kept boxes to
    BOX_TOL, kept classes exact. Returns the largest absolute difference."""
    check(torch.equal(got.scores, want.scores), f"{name} scores")
    kept = want.scores > 0
    check(torch.equal(got.classes[kept], want.classes[kept]),
          f"{name} kept classes")
    err = (got.boxes[kept] - want.boxes[kept]).abs().max().item() \
        if kept.any() else 0.0
    check(err <= BOX_TOL, f"{name} kept boxes differ by {err}")
    return err


def graph_ms(fn, reps: int = 100) -> float:
    """Device time per call of ``fn()``, replayed from a CUDA graph of
    ``reps`` calls: the host's launch overhead is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 3) / reps


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` on the card's stream over ``reps`` calls,
    after a warm-up; gaps while the host launches are included."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_path(detect, images, top: int = 12) -> None:
    """Device time of one path call by kernel (torch.profiler), and the
    share of the call's wall time in which the card ran a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    detect(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        detect(images)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, ops = 0.0, []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        if e.device_type == DeviceType.CUDA:  # a kernel
            busy_us += us
        else:  # the operator that launched kernels: the same time, by op
            ops.append((us, e.count, e.key))
    print(f"profile, path batch {len(images)}: wall {wall_us:.0f} us, "
          f"kernels {busy_us:.0f} us, device idle share "
          f"{1 - busy_us / wall_us:.3f}; device time by operator:")
    for us, count, key in sorted(ops, reverse=True)[:top]:
        print(f"  {us:10.1f} us {count:4d}x  {key[:80]}")


def conv_flops_per_image(image_size: int, cell_channels: int,
                         passthrough: bool = False) -> float:
    """Multiply-add FLOPs (2 a MAC) of the detector's convs on one image:
    the Darknet19 trunk, then the v1 / ``--v2`` head (3 × 3×3×1024 and the
    1×1 output) or, with ``passthrough``, the YOLOv2 head (2 × 3×3×1024,
    the 1×1×64 passthrough at H/16, a 3×3 1280→1024 and the output)."""
    from tensorflow_yolo2_torch.models.darknet import _DARKNET19_SCHEDULE

    convs, hw, cin = [], image_size, 3
    for item in _DARKNET19_SCHEDULE:
        if item == "M":
            hw //= 2
            continue
        convs.append((hw, item[0], cin, item[1]))
        cin = item[1]
    if passthrough:
        convs += [(hw, 3, 1024, 1024)] * 2 + [(2 * hw, 1, 512, 64),
                                              (hw, 3, 1280, 1024)]
    else:
        convs += [(hw, 3, 1024, 1024)] * 3
    convs.append((hw, 1, 1024, cell_channels))
    return float(sum(2 * h * h * k * k * ci * co for h, k, ci, co in convs))


def decode_bound(cfg, batch: int, kept_per_image=None) -> tuple[float, str]:
    """Least time for the decode (+NMS) on this card: bytes (grid read
    once, outputs written once) over HBM rate against float32 operations
    over the non-tensor-core rate, an exp counting as one operation; the
    NMS counts the steps this run's data took (one per kept box)."""
    S, B, C = cfg.S, cfg.B, cfg.num_class
    cells, n = S * S, S * S * B
    in_bytes = batch * cells * cfg.cell_channels * 4
    if cfg.per_slot_classes:
        # per slot: argmax C-1; Σ exp(l - l_max) 3C; 3 sigmoids 9; clip 4;
        # w, h (2 exp, 2 mul, 2 div) 6; x, y 4; corners + area 7; score and
        # threshold 2
        ops = batch * n * (4 * C + 31)
    else:
        ops = batch * (cells * (C - 1) + n * 14)  # argmax, decode, threshold
    if kept_per_image is None:
        out_bytes = batch * n * 6 * 4
    else:
        out_bytes = batch * K * 6 * 4
        ops += int(kept_per_image.sum()) * n * 18  # IoU, kill, step max
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_path(detect, images, dev, label: str, flops: float) -> dict:
    """images/s of ``detect`` on uint8 batches already on the card, host
    clock around calls that end in a synchronize."""
    out = {}
    for b in PATH_BATCHES:
        xb = images[:b].to(dev)
        detect(xb)
        torch.cuda.synchronize()
        reps = 20 if b <= 32 else 8
        t0 = time.perf_counter()
        for _ in range(reps):
            detect(xb)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        out[b] = {"images_per_s": b / dt, "ms_per_batch": dt * 1e3,
                  "bound_images_per_s": BF16_FLOPS_PER_S / flops}
        print(f"path {label}, NMS on, uint8 batch {b} on the card: "
              f"{b / dt:.1f} images/s ({dt * 1e3:.3f} ms per batch; "
              f"conv bound {BF16_FLOPS_PER_S / flops:.0f} images/s at "
              f"{flops / 1e9:.2f} GFLOP per image)")
    for b in PATH_BATCHES:
        profile_path(detect, images[:b].to(dev))
    return out


def card_grid(yolo, state, images, dev, **head) -> torch.Tensor:
    """The bf16 detector's float32 grid of a uint8 batch, on the card."""
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        build_detector,
    )

    model = build_detector(yolo, state, dtype=torch.bfloat16, device=dev,
                           **head)
    with torch.inference_mode():
        return model(images.to(dev).float().div_(255.0).mul_(2.0).sub_(1.0)
                     .to(torch.bfloat16))


def grid_rel_err(yolo, state, images, dev, **head) -> float:
    """One image's grid, bf16 on the card against float32 on the CPU
    (BN unfolded), as a relative norm error."""
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        build_detector,
    )

    on_card = card_grid(yolo, state, images[:1], dev, **head).cpu().double()
    model = build_detector(yolo, state, fold_bn=False, dtype=torch.float32,
                           device="cpu", **head)
    with torch.inference_mode():
        on_cpu = model(images[:1].float() / 255.0 * 2.0 - 1.0).double()
    return ((on_card - on_cpu).norm() / on_cpu.norm()).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from tensorflow_yolo2_torch.config import YoloConfig, yolo_v2_config
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        make_detect_fn,
    )
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Detector,
        Darknet19DetectorV2,
        randomize_,
    )
    from tensorflow_yolo2_torch.ops import cuda_decode as cd
    from tensorflow_yolo2_torch.ops.boxes import decode_grid_v2
    from tensorflow_yolo2_torch.utils import cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. header and build ----------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}; TF32 off for float32 checks")
    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(cuda_build.sources())}")
    for log in logs.values():
        print(log, end="")

    errs = {"decode_nms": 0.0, "decode_nms_v2": 0.0, "decode_grid": 0.0}
    launches = {}

    # 2. kernels against their plain versions on synthetic grids -------------
    for S in (7, 14):
        cfg = YoloConfig(S=S, image_size=32 * S)
        net = torch.from_numpy(synthetic_grid(cfg, BATCH, seed=S)).to(dev)
        errs["decode_grid"] = max(errs["decode_grid"], compare_dense(
            cd.decode_grid_fused(net, cfg, 0.5),
            cd.decode_grid_plain(net, cfg, 0.5)))
        for class_aware in (True, False):
            got = cd.decode_nms_fused(net, cfg, 0.5, 0.5, K, class_aware)
            want = cd.decode_nms_plain(net, cfg, 0.5, 0.5, K, class_aware)
            errs["decode_nms"] = max(errs["decode_nms"],
                                     compare_kept(got, want))
            kept = (want.scores > 0).sum(1)
            check(bool((kept >= 5).all()), "synthetic grids keep boxes")
        torch.cuda.synchronize()
    for S in (7, 10, 13, 14, 19):  # 224² to 608²
        cfg = yolo_v2_config(32 * S)
        net = torch.from_numpy(synthetic_grid_v2(cfg, BATCH, seed=S)).to(dev)
        for class_aware in (True, False):
            got = cd.decode_nms_fused(net, cfg, 0.5, 0.5, K, class_aware)
            want = cd.decode_nms_v2_plain(net, cfg, 0.5, 0.5, K,
                                          class_aware)
            errs["decode_nms_v2"] = max(errs["decode_nms_v2"], compare_kept(
                got, want, "decode_nms_v2"))
            kept = (want.scores > 0).sum(1)
            check(bool((kept >= 5).all()), "synthetic anchor grids keep "
                                           "boxes")
        torch.cuda.synchronize()
    print(f"synthetic grids: kernels match their plain versions "
          f"(max abs err {errs})")

    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(
        0, 256, (max(PATH_BATCHES), 448, 448, 3)).astype(np.uint8))

    # 3. the v1 serving path at full width (the main path) -------------------
    yolo = YoloConfig(S=14, image_size=448)
    model = Darknet19Detector(output_channels=yolo.cell_channels)
    state = randomize_(model, torch.Generator().manual_seed(0)).state_dict()
    # larger w, h roots (channels 24-25, 28-29: boxes ~0.3 wide, several
    # cells at S=14) so that neighbouring boxes overlap and NMS has work
    state["detection.output.bn.bias"][[24, 25, 28, 29]] += 0.5
    batch = images[:16]

    v1_detect = make_detect_fn(yolo, state, object_thresh=0.5, use_nms=True)
    detect_dense = make_detect_fn(yolo, state, object_thresh=0.5,
                                  use_nms=False)
    cd.reset_launch_counts()
    kept = v1_detect(batch)
    dense = detect_dense(batch)
    torch.cuda.synchronize()
    launches["decode_nms"] = cd.DECODE_NMS_LAUNCHES
    launches["decode_grid"] = cd.DECODE_GRID_LAUNCHES
    print(f"v1 path launches: {launches}")
    check(launches["decode_nms"] > 0 and launches["decode_grid"] > 0,
          "the v1 path launched both kernels")
    check(kept.boxes.shape == (16, K, 4) and kept.scores.shape == (16, K)
          and kept.classes.shape == (16, K), "NMS output shapes")
    check(dense.boxes.shape == (16, 392, 4) and dense.scores.shape ==
          (16, 392), "dense output shapes")
    check(all(bool(torch.isfinite(t).all()) for t in (*kept[:2], *dense[:2])),
          "finite outputs")
    check(bool((kept.scores > 0).any()), "the path kept detections")

    rel = grid_rel_err(yolo, state, images, dev)
    print(f"v1 grid, bf16 card vs float32 CPU forward: relative norm error "
          f"{rel:.3e} (bound {GRID_REL_TOL})")
    check(rel <= GRID_REL_TOL, "card grid agrees with the CPU forward")

    del detect_dense
    grid = v1_grid = card_grid(yolo, state, images[:BATCH], dev)
    for thresh in (0.05, 0.5):
        errs["decode_grid"] = max(errs["decode_grid"], compare_dense(
            cd.decode_grid_fused(grid, yolo, thresh),
            cd.decode_grid_plain(grid, yolo, thresh)))
        for class_aware in (True, False):
            want = cd.decode_nms_plain(grid, yolo, thresh, 0.5, K,
                                       class_aware)
            errs["decode_nms"] = max(errs["decode_nms"], compare_kept(
                cd.decode_nms_fused(grid, yolo, thresh, 0.5, K, class_aware),
                want))
        # with K = every slot, nothing is cut by K: kept < valid shows
        # that the sweep suppressed boxes
        n = yolo.S * yolo.S * yolo.B
        want = cd.decode_nms_plain(grid, yolo, thresh, 0.5, n)
        errs["decode_nms"] = max(errs["decode_nms"], compare_kept(
            cd.decode_nms_fused(grid, yolo, thresh, 0.5, n), want))
        valid = (cd.decode_grid_plain(grid, yolo, thresh).scores > 0).sum(1)
        n_kept = (want.scores > 0).sum(1)
        print(f"v1 real grid, threshold {thresh}: {valid.float().mean():.1f} "
              f"valid and {n_kept.float().mean():.1f} surviving slots per "
              f"image")
        check(bool((n_kept < valid).all()), "NMS suppressed boxes")
    torch.cuda.synchronize()
    print(f"v1 real grid: kernels match their plain versions (max abs err "
          f"{errs})")

    # 4. the anchor serving paths at full width: YOLOv2 at 416² -------------
    v2cfg = yolo_v2_config(416)  # S=13, B=5, C=20: 125 channels
    n = v2cfg.S * v2cfg.S * v2cfg.B
    v2_images = torch.from_numpy(rng.randint(
        0, 256, (max(PATH_BATCHES), 416, 416, 3)).astype(np.uint8))
    for head in ("v2p", "v2"):
        passthrough = head == "v2p"
        model = (Darknet19DetectorV2(v2cfg.cell_channels) if passthrough
                 else Darknet19Detector(v2cfg.cell_channels,
                                        bn_on_output=False))
        state = randomize_(model, torch.Generator().manual_seed(1)
                           ).state_dict()
        # a trained head's logits stay near its biases: scale the linear
        # output conv, make every slot confident (conf logit +2) and class
        # 0 likely (+4), so that the grid keeps boxes at 0.05 and 0.5
        state["detection.output.conv.weight"] *= 0.1
        bias = state["detection.output.conv.bias"].view(5, 25)
        bias[:, 4] += 2.0
        bias[:, 5] += 4.0
        kw = {"v2": True, "passthrough": passthrough}
        detect_nms = make_detect_fn(v2cfg, state, object_thresh=0.5,
                                    use_nms=True, **kw)
        detect_dense = make_detect_fn(v2cfg, state, object_thresh=0.5,
                                      use_nms=False, **kw)
        cd.reset_launch_counts()
        kept = detect_nms(v2_images[:16])
        dense = detect_dense(v2_images[:16])
        torch.cuda.synchronize()
        n_launch = cd.DECODE_NMS_V2_LAUNCHES
        print(f"{head} path launches: decode_nms_v2 {n_launch}, "
              f"decode_nms {cd.DECODE_NMS_LAUNCHES}, "
              f"decode_grid {cd.DECODE_GRID_LAUNCHES}")
        check(n_launch > 0, f"the {head} path launched the anchor kernel")
        check(kept.boxes.shape == (16, K, 4) and dense.boxes.shape ==
              (16, n, 4), f"{head} output shapes")
        check(all(bool(torch.isfinite(t).all())
                  for t in (*kept[:2], *dense[:2])), f"{head} finite outputs")
        check(bool((kept.scores > 0).any()),
              f"the {head} path kept detections")
        if passthrough:
            launches["decode_nms_v2"] = n_launch
            v2p_detect = detect_nms
        del detect_dense

        rel = grid_rel_err(v2cfg, state, v2_images, dev, **kw)
        print(f"{head} grid, bf16 card vs float32 CPU forward: relative norm "
              f"error {rel:.3e} (bound {GRID_REL_TOL})")
        check(rel <= GRID_REL_TOL,
              f"{head} card grid agrees with the CPU forward")

        grid = card_grid(v2cfg, state, v2_images[:BATCH], dev, **kw)
        for thresh in (0.05, 0.5):
            for class_aware in (True, False):
                errs["decode_nms_v2"] = max(errs["decode_nms_v2"], compare_kept(
                    cd.decode_nms_fused(grid, v2cfg, thresh, 0.5, K,
                                        class_aware),
                    cd.decode_nms_v2_plain(grid, v2cfg, thresh, 0.5, K,
                                           class_aware), "decode_nms_v2"))
            want = cd.decode_nms_v2_plain(grid, v2cfg, thresh, 0.5, n)
            errs["decode_nms_v2"] = max(errs["decode_nms_v2"], compare_kept(
                cd.decode_nms_fused(grid, v2cfg, thresh, 0.5, n), want,
                "decode_nms_v2"))
            valid = (decode_grid_v2(grid, v2cfg, thresh).scores > 0).sum(1)
            n_kept = (want.scores > 0).sum(1)
            print(f"{head} real grid, threshold {thresh}: "
                  f"{valid.float().mean():.1f} valid and "
                  f"{n_kept.float().mean():.1f} surviving slots per image")
            check(bool((n_kept > 0).all()), f"{head} grid keeps boxes")
            check(bool((n_kept < valid).all()),
                  f"{head} NMS suppressed boxes")
        torch.cuda.synchronize()
        if passthrough:
            v2_grid = grid
    print(f"anchor real grids: the kernel matches its plain version (max "
          f"abs err {errs['decode_nms_v2']})")

    # 5. times ---------------------------------------------------------------
    print(f"times on {card}:")
    path = {
        "v1_448": time_path(v1_detect, images, dev, "v1 448²",
                            conv_flops_per_image(448, yolo.cell_channels)),
        "v2p_416": time_path(v2p_detect, v2_images, dev, "v2p 416²",
                             conv_flops_per_image(416, v2cfg.cell_channels,
                                                  passthrough=True)),
    }

    kept_v1 = (cd.decode_nms_plain(v1_grid, yolo, 0.5, 0.5, K).scores > 0
               ).sum(1)
    kept_v2 = (cd.decode_nms_v2_plain(v2_grid, v2cfg, 0.5, 0.5, K).scores
               > 0).sum(1)
    runs = {  # name → (kernel, plain version, bound, shape, kernel at K=1)
        "decode_nms": (
            lambda: cd.decode_nms_fused(v1_grid, yolo, 0.5, 0.5, K),
            lambda: cd.decode_nms_plain(v1_grid, yolo, 0.5, 0.5, K),
            decode_bound(yolo, BATCH, kept_v1), "448² (S=14)",
            lambda: cd.decode_nms_fused(v1_grid, yolo, 0.5, 0.5, 1)),
        "decode_nms_v2": (
            lambda: cd.decode_nms_fused(v2_grid, v2cfg, 0.5, 0.5, K),
            lambda: cd.decode_nms_v2_plain(v2_grid, v2cfg, 0.5, 0.5, K),
            decode_bound(v2cfg, BATCH, kept_v2), "416² (S=13, B=5)",
            lambda: cd.decode_nms_fused(v2_grid, v2cfg, 0.5, 0.5, 1)),
        "decode_grid": (
            lambda: cd.decode_grid_fused(v1_grid, yolo, 0.5),
            lambda: cd.decode_grid_plain(v1_grid, yolo, 0.5),
            decode_bound(yolo, BATCH), "448² (S=14)", None),
    }
    kernels = []
    for name, (fused, plain, (bound, by), shape, one_step) in runs.items():
        ms = graph_ms(fused)
        call_ms = cuda_ms(fused, 200)
        plain_ms = cuda_ms(plain, 5)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNELS[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "call_ms": call_ms})
        print(f"{name}, batch {BATCH}, {shape}, threshold 0.5: kernel "
              f"{ms * 1e3:.2f} us (graph replay; {call_ms * 1e3:.2f} us a "
              f"call from Python), plain {plain_ms * 1e3:.1f} us, bound "
              f"{bound * 1e3:.2f} us ({by}); no single PyTorch call computes "
              f"it")
        if one_step is not None:  # the decode and one step: the sweep's share
            kernels[-1]["k1_ms"] = k1_ms = graph_ms(one_step)
            print(f"  the same with K=1: {k1_ms * 1e3:.2f} us, so "
                  f"{(ms - k1_ms) / (K - 1) * 1e3:.2f} us a further step")
    print(json.dumps({"path": path, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
