"""Darknet19 YOLO detection (port of
tensorflow_yolo2_tpu/entries/pascal_detect_darknet.py).

The serving path: a batch of NHWC images → the BN-folded detector (bf16
by default) → with NMS, the CUDA decode+NMS kernel
(``ops.cuda_decode.decode_nms_fused``, K=32 kept slots per image), else
the dense decode. Three heads:

- v1 (default): ``Darknet19Detector`` with the reference's BN + leaky on
  the output conv; dense decode by the CUDA kernel ``decode_grid_fused``.
- ``--v2``: the same trunk and head with a linear output conv and the
  YOLOv2 anchor layout (``per_slot_classes``); dense decode by
  ``ops.boxes.decode_grid_v2`` (plain PyTorch, as in the JAX package).
- ``--v2 --passthrough``: ``Darknet19DetectorV2``, the YOLOv2
  architecture with the reorg route.

``--pallas-stem`` (v1 or ``--v2``) runs conv1 + pool + conv2 + pool as one
CUDA kernel, ``ops.cuda_stem.fused_stem`` (B4 for a bf16 detector, B4-f32
for a float32 one), which keeps the conv1 activation out of device
memory; the folded detector runs on from there.

``--spatial N`` serves the folded chain H-sharded over N ranks, one
process each (``torchrun --nproc-per-node N``; ``make_spatial_detect_fn``,
``parallel.spatial``): rank 0 reads and draws, every rank computes its
rows of every feature map, and rank 0 decodes the gathered grid as
``make_detect_fn`` does.

``--int8`` serves the post-training-quantized chain (``ops.quant``: int8
convs, calibrated on the input image; ``--int8-export NPZ`` also writes
it), ``--int8-weights NPZ`` serves such an artifact, of this package or
of the JAX package, with no weights and no calibration. ``--host-nms``
decodes without NMS on the card and runs the greedy NMS on the host, in
the native layer (``utils.native.nms``). The image (``assets/demo.jpg``
by default) is read by ``data.augment.image_read`` (cv2 or libjpeg, then
the native resize); the boxes are drawn onto it with PIL and matplotlib
(``utils.visualize``, the JAX package's drawing).

Weights come from a ``.npz`` written by ``convert.save_npz`` (a flax
params / batch_stats pair) given with ``--weights``; else, as in the JAX
package (``load_detector_params``), from the TF checkpoint given with
``--tf-checkpoint``, else ``<weights>/darknet19_pascal.ckpt[.index]``
(the plain v1 detector only), else the newest snapshot of this package's
own training run (``ckpts/<net>/voc_2007``). TF checkpoints are read in
numpy alone (``compat.tf_bundle``); Orbax snapshots of the JAX package
need JAX and are not read here. An anchor head decodes with the priors
of an ``anchors.json`` beside the ``.npz`` or in the snapshot's dir, else
(and always for a TF checkpoint) with the classic VOC priors.

    python -m tensorflow_yolo2_torch.entries.pascal_detect_darknet \\
        image.jpg --weights darknet19.npz --image-size 448 --nms
    python -m tensorflow_yolo2_torch.entries.pascal_detect_darknet \\
        image.jpg --weights v2p.npz --image-size 416 --nms --v2 --passthrough
    python -m tensorflow_yolo2_torch.entries.pascal_detect_darknet \\
        image.jpg --tf-checkpoint weights/darknet19_pascal.ckpt --nms
    python -m tensorflow_yolo2_torch.entries.pascal_detect_darknet \\
        image.jpg --weights darknet19.npz --image-size 448 --int8 \\
        --int8-export darknet19_int8.npz --host-nms
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Mapping

import torch

from tensorflow_yolo2_torch.compat.tf_bundle import checkpoint_present
from tensorflow_yolo2_torch.config import VOC_CLASSES, Paths, YoloConfig
from tensorflow_yolo2_torch.convert import load_npz, state_dict_from_flax
from tensorflow_yolo2_torch.data.augment import image_read
from tensorflow_yolo2_torch.data.anchors import (
    ANCHORS_FILE,
    v2_config_for_snapshot,
)
from tensorflow_yolo2_torch.entries.common import require_tf_checkpoint
from tensorflow_yolo2_torch.models.darknet import (
    Darknet19Detector,
    Darknet19DetectorV2,
)
from tensorflow_yolo2_torch.models.fold import fold_params
from tensorflow_yolo2_torch.ops import quant
from tensorflow_yolo2_torch.ops.boxes import Detections, decode_grid_v2
from tensorflow_yolo2_torch.ops.cuda_decode import (
    decode_grid_fused,
    decode_nms_fused,
)
from tensorflow_yolo2_torch.ops.cuda_stem import (
    StemWeights,
    cuda_kernel,
    fused_detect_forward,
    pack_stem_weights,
)
from tensorflow_yolo2_torch.train.checkpoint import (
    CheckpointManager,
    read_snapshot,
)
from tensorflow_yolo2_torch.utils import native
from tensorflow_yolo2_torch.utils.device import (
    device_normalize,
    resolve_device,
)
from tensorflow_yolo2_torch.utils.visualize import draw_detections


def as_state_dict(params_or_state_dict: Mapping[str, Any],
                  batch_stats: Mapping[str, Any] | None = None
                  ) -> dict[str, torch.Tensor]:
    """A flax params tree (nested dicts, numpy leaves) + batch_stats, or a
    port state dict (flat ``.``-joined keys) → a port state dict."""
    if any(isinstance(v, Mapping) for v in params_or_state_dict.values()):
        return state_dict_from_flax(params_or_state_dict, batch_stats)
    return {k: torch.as_tensor(v) for k, v in params_or_state_dict.items()}


def load_detector_params(yolo: YoloConfig, tf_checkpoint: str | None = None,
                         paths: Paths | None = None,
                         network_name: str = "darknet19",
                         imdb_name: str = "voc_2007"
                         ) -> dict[str, torch.Tensor]:
    """The detector's state dict, from the first of (the JAX package's
    order): the TF checkpoint ``tf_checkpoint``, where it exists;
    ``<weights>/darknet19_pascal.ckpt``, only for the plain v1
    ``darknet19`` network it was trained for (never for an anchor head or
    a stride-downsample ``_sd`` network); the newest snapshot of
    ``network_name`` on ``imdb_name`` (``FileNotFoundError`` when there is
    none)."""
    paths = paths or Paths()
    tf_path = tf_checkpoint
    if tf_path is None and not yolo.per_slot_classes \
            and network_name == "darknet19":
        tf_path = os.path.join(paths.weights, "darknet19_pascal.ckpt")
    if checkpoint_present(tf_path):
        from tensorflow_yolo2_torch.compat.tf_import import (
            import_darknet19_checkpoint,
            state_dict_for,
        )
        state_dict = state_dict_for(
            import_darknet19_checkpoint(tf_path, detection=True))
        print(f"Imported TF checkpoint {tf_path}")
        return state_dict
    snap_dir = os.path.join(paths.ckpts, network_name, imdb_name)
    path = (CheckpointManager(network_name, imdb_name, paths=paths)
            .latest_path() if os.path.isdir(snap_dir) else None)
    if path is None:
        raise FileNotFoundError(f"no snapshot under {snap_dir}")
    print(f"Restored snapshot from {path}")
    return read_snapshot(path)["model"]


def build_detector(yolo: YoloConfig, state_dict: Mapping[str, torch.Tensor],
                   fold_bn: bool = True, dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None,
                   v2: bool = False, passthrough: bool = False,
                   downsample: str = "pool") -> torch.nn.Module:
    """The detector in eval mode on ``device`` in ``dtype``:
    ``Darknet19DetectorV2`` with ``passthrough``, else
    ``Darknet19Detector`` with a linear output conv for ``v2`` and the
    reference's BN + leaky output otherwise.

    With ``fold_bn`` and BN entries in the state dict, BN is folded (in
    float32) before the cast; a state dict without BN entries is taken
    as folded already.
    """
    device = resolve_device(device)
    has_bn = any(".bn." in k for k in state_dict)
    if fold_bn and has_bn:
        state_dict = fold_params(state_dict)
    folded = not has_bn or fold_bn
    if passthrough:
        model = Darknet19DetectorV2(output_channels=yolo.cell_channels,
                                    fold_bn=folded, downsample=downsample)
    else:
        model = Darknet19Detector(output_channels=yolo.cell_channels,
                                  bn_on_output=not v2, fold_bn=folded,
                                  downsample=downsample)
    model.load_state_dict(state_dict)
    model.eval().requires_grad_(False)
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last)


def stem_weights(state_dict: Mapping[str, torch.Tensor],
                 device: str | torch.device) -> StemWeights:
    """The folded conv1 and conv2 of a port state dict, packed once for
    ``ops.cuda_stem`` on ``device``. BN is folded here in float32 when the
    state dict carries it, so the stem keeps float32 biases whatever type
    the detector is cast to."""
    if any(".bn." in k for k in state_dict):
        state_dict = fold_params(state_dict)
    conv1, conv2 = ((state_dict[f"backbone.{n}.conv.weight"]
                     .permute(2, 3, 1, 0),  # OIHW → HWIO
                     state_dict[f"backbone.{n}.conv.bias"])
                    for n in ("conv1", "conv2"))
    return pack_stem_weights(*conv1, *conv2, device=device)


def make_detect_fn(yolo: YoloConfig, params_or_state_dict, batch_stats=None,
                   object_thresh: float = 0.5, use_nms: bool = False,
                   nms_iou: float = 0.5, fold_bn: bool = True,
                   dtype: torch.dtype = torch.bfloat16, device=None,
                   v2: bool = False, passthrough: bool = False,
                   int8: bool = False, calib_images=None,
                   pallas_stem: bool = False, downsample: str = "pool"):
    """Build the batched images → detections function.

    ``v2`` selects the anchor head (linear output, ``per_slot_classes``
    layout; ``yolo`` from ``config.yolo_v2_config``), ``passthrough``
    with it the YOLOv2 reorg head. ``params_or_state_dict`` is a flax
    params tree (with ``batch_stats``) or a port state dict. The weights
    move to ``device`` (default ``cuda``; raises without a card) once.
    The returned function takes an NHWC (N, H, W, 3) batch, float in
    [-1, 1] or raw uint8 (normalized on the device as x/255·2−1), as a
    tensor or numpy array, and returns ``Detections`` on the device: K=32
    kept slots per image with ``use_nms``, else the dense S·S·B slots.

    ``pallas_stem`` runs the first two conv + pool stages through
    ``ops.cuda_stem`` (on the card the CUDA kernel of ``dtype``: B4 for
    bfloat16, B4-f32 for float32; any other type raises ``TypeError``)
    and the rest of the folded detector after them; it takes the v1 or
    ``v2`` head with the pool downsample and BN folding.

    ``int8`` serves the post-training-quantized chain (``ops.quant``,
    ``quantize_detector``): the BN-folded weights per-channel int8,
    activations per-tensor int8 calibrated on ``calib_images`` (a
    representative NHWC batch in [-1, 1], required), int8 convs; ``dtype``
    does not apply. It takes every head with the pool downsample and BN
    folding.
    """
    if v2 != yolo.per_slot_classes:
        raise ValueError(
            f"v2={v2} disagrees with yolo.per_slot_classes="
            f"{yolo.per_slot_classes}: the anchor head needs a per-slot "
            "config (config.yolo_v2_config), the v1 head a plain "
            "YoloConfig; a mismatch would decode with the wrong kernel")
    if passthrough and not v2:
        raise ValueError("passthrough is the YOLOv2 reorg head; it "
                         "requires v2=True (the anchor layout)")
    if pallas_stem:
        # checked before the int8 refusal below, so that pallas_stem with
        # int8 is refused as a combination, as the JAX package refuses it
        if passthrough or int8:
            raise ValueError("--pallas-stem covers the sequential Darknet19 "
                             "chain (no passthrough route, no int8)")
        if downsample != "pool":
            raise ValueError("--pallas-stem fuses the pool-based stem; the "
                             "stride variant has no pools to fuse")
        if not fold_bn:
            raise ValueError("--pallas-stem serves the BN-folded chain; "
                             "fold_bn=True is required")
    if int8:
        if calib_images is None:
            raise ValueError("int8 serving needs calib_images (a "
                             "representative batch) for activation "
                             "calibration")
        if not fold_bn:
            raise ValueError("int8 serving quantizes the BN-folded weights: "
                             "fold_bn=True is required")
        if downsample != "pool":
            raise ValueError("int8 serving covers the pool-based chain "
                             "(ops.quant's layer plan); the stride variant "
                             "is not quantized")
        qlayers = quantize_detector(params_or_state_dict, batch_stats,
                                    calib_images, v2=v2,
                                    passthrough=passthrough, device=device)
        return make_detect_fn_int8(yolo, qlayers, object_thresh, use_nms,
                                   nms_iou, v2, passthrough, device)
    device = resolve_device(device)
    if pallas_stem and device.type == "cuda":
        cuda_kernel(dtype)  # a type with no stem kernel raises here
    state_dict = as_state_dict(params_or_state_dict, batch_stats)
    model = build_detector(yolo, state_dict, fold_bn=fold_bn, dtype=dtype,
                           device=device, v2=v2, passthrough=passthrough,
                           downsample=downsample)
    stem = stem_weights(state_dict, device) if pallas_stem else None

    @torch.inference_mode()
    def detect(images) -> Detections:
        images = device_normalize(torch.as_tensor(images).to(device))
        images = images.to(dtype)
        if pallas_stem:
            grid = fused_detect_forward(model, images.contiguous(), stem)
        else:
            grid = model(images)
        return decode(grid, yolo, object_thresh, use_nms, nms_iou, v2)

    return detect


def make_spatial_detect_fn(yolo: YoloConfig, params_or_state_dict,
                           batch_stats=None, object_thresh: float = 0.5,
                           use_nms: bool = False, nms_iou: float = 0.5,
                           v2: bool = False, passthrough: bool = False,
                           downsample: str = "pool", n_shards: int = 2,
                           axis: str = "spatial",
                           dtype: torch.dtype = torch.bfloat16,
                           device=None):
    """The H-sharded serving twin of ``make_detect_fn`` (``--spatial N``):
    the BN-folded trunk and head run over the ``n_shards`` ranks of the
    process group (exactly that many; ``parallel.spatial.spatial_mesh``)
    with per-layer halo exchange (``parallel.spatial.
    spatial_detector_fn``), in ``dtype``, and rank 0 decodes the gathered
    grid with the serving decode (``decode``: B1 / B3, B2 for an anchor
    head with NMS). Every head and trunk (v1, ``v2``, ``passthrough``,
    ``downsample``). The returned function takes rank 0's NHWC batch
    (the other ranks may pass None) and returns ``Detections`` on rank 0,
    None on the others. Needs ``image_size`` % (32·n_shards) == 0 and
    batch statistics to fold."""
    from tensorflow_yolo2_torch.parallel.spatial import (
        spatial_detector_fn,
        spatial_mesh,
    )

    if v2 != yolo.per_slot_classes:
        raise ValueError(
            f"v2={v2} disagrees with yolo.per_slot_classes="
            f"{yolo.per_slot_classes} (see make_detect_fn)")
    if passthrough and not v2:
        raise ValueError("passthrough is the YOLOv2 reorg head — it "
                         "requires v2=True")
    if yolo.image_size % (32 * n_shards):
        raise ValueError(
            f"--spatial {n_shards} needs --image-size divisible by "
            f"{32 * n_shards} (5 stride-2 downsamples per shard); got "
            f"{yolo.image_size}")
    mesh = spatial_mesh(n_shards, axis)
    state_dict = as_state_dict(params_or_state_dict, batch_stats)
    if not any(k.endswith(".running_var") for k in state_dict):
        raise ValueError("spatial serving folds BN into the convs; the "
                         "restored snapshot has no batch statistics")
    device = resolve_device(device)
    folded = {k: v.float().to(device, dtype)
              for k, v in fold_params(state_dict).items()}
    forward = spatial_detector_fn(mesh, axis=axis, bn_on_output=not v2,
                                  downsample=downsample,
                                  head="v2p" if passthrough else "v1")
    chief = torch.distributed.get_rank(mesh.get_group(axis)) == 0

    @torch.inference_mode()
    def detect(images) -> Detections | None:
        grid = forward(folded, images if chief else None)
        if not chief:
            return None
        return decode(grid, yolo, object_thresh, use_nms, nms_iou, v2)

    return detect


def decode(grid: torch.Tensor, yolo: YoloConfig, object_thresh: float,
           use_nms: bool, nms_iou: float, v2: bool) -> Detections:
    """The serving path's decode of a grid: with NMS the decode+NMS kernel
    (B1, or B2 for an anchor head; K=32), else the dense decode (B3, or
    plain PyTorch for an anchor head, as in the JAX package)."""
    if use_nms:
        return decode_nms_fused(grid, yolo, object_thresh, nms_iou,
                                max_outputs=32)
    if v2:
        return decode_grid_v2(grid, yolo, object_thresh)
    return decode_grid_fused(grid, yolo, object_thresh)


def quantize_detector(params_or_state_dict, batch_stats, calib_images,
                      v2: bool = False, passthrough: bool = False,
                      device=None) -> tuple:
    """Fold BN and post-training-quantize a detector → the int8 layer
    chain (CPU tensors). The calibration forward runs in float32 on
    ``device`` (default ``cuda``; cuDNN without TF32), the quantization on
    the CPU. ``passthrough`` quantizes the YOLOv2 reorg head (ops.quant
    ``head="detector_v2p"``)."""
    device = resolve_device(device)
    head = "detector_v2p" if passthrough else "detector"
    state_dict = as_state_dict(params_or_state_dict, batch_stats)
    if any(".bn." in k for k in state_dict):
        state_dict = fold_params(state_dict)
    on_device = {k: v.float().to(device) for k, v in state_dict.items()}
    images = device_normalize(torch.as_tensor(calib_images).to(device))
    scales = quant.calibrate(on_device, images, v2=v2, head=head)
    return quant.quantize_folded(state_dict, scales, v2=v2, head=head)


def make_detect_fn_int8(yolo: YoloConfig, qlayers, object_thresh: float = 0.5,
                        use_nms: bool = False, nms_iou: float = 0.5,
                        v2: bool = False, passthrough: bool = False,
                        device=None):
    """The batched images → detections function of a prebuilt int8 chain
    (``quantize_detector``, or a ``quant.save_quantized`` artifact from
    either package): ``quant.forward_int8`` on ``device`` (default
    ``cuda``), then the serving path's decode."""
    device = resolve_device(device)
    head = "detector_v2p" if passthrough else "detector"
    layers = quant.prepare(qlayers, device)

    @torch.inference_mode()
    def detect(images) -> Detections:
        images = torch.as_tensor(images).to(device)
        grid = quant.forward_int8(layers, images, v2=v2, head=head)
        return decode(grid, yolo, object_thresh, use_nms, nms_iou, v2)

    return detect


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("image", nargs="?", default="assets/demo.jpg",
                   help="the image to detect on (default: assets/demo.jpg)")
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="params / batch_stats written by convert.save_npz "
                        "(default: --tf-checkpoint, else "
                        "weights/darknet19_pascal.ckpt for v1, else the "
                        "newest snapshot)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--nms", action="store_true",
                   help="apply class-aware NMS (the reference has none)")
    p.add_argument("--host-nms", action="store_true",
                   help="decode without NMS on the device, then run the "
                        "greedy NMS on the host in the native layer "
                        "(utils.native.nms): the same survivor set")
    p.add_argument("--image-size", type=int, default=224,
                   help="multiple of 32; the grid is S = size/32 (448 is "
                        "the Darknet19-448 config)")
    p.add_argument("--out", default=None)
    p.add_argument("--no-fold-bn", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="serve the post-training-quantized int8 chain "
                        "(ops.quant; calibrated on the input image)")
    p.add_argument("--int8-export", default=None, metavar="NPZ",
                   help="with --int8: also write the quantized chain as a "
                        "serving artifact (ops.quant.save_quantized)")
    p.add_argument("--int8-weights", default=None, metavar="NPZ",
                   help="serve a saved int8 artifact (this package's or "
                        "the JAX package's): no weights, no calibration")
    p.add_argument("--v2", action="store_true",
                   help="anchor-head weights (pascal_train_darknet --v2)")
    p.add_argument("--passthrough", action="store_true",
                   help="the YOLOv2 reorg head (pascal_train_darknet --v2 "
                        "--passthrough); requires --v2")
    p.add_argument("--downsample", default="pool", choices=["pool", "stride"],
                   help="'stride' serves weights trained with "
                        "pascal_train_darknet --downsample stride")
    p.add_argument("--pallas-stem", action="store_true",
                   help="the first two conv + pool stages as one fused "
                        "CUDA kernel (bf16; not with --passthrough)")
    p.add_argument("--tf-checkpoint", default=None,
                   help="TF checkpoint prefix (V1 or V2) of the reference's "
                        "detector to import instead of --weights")
    p.add_argument("--spatial", type=int, default=0, metavar="N",
                   help="serve the folded chain with the H dimension "
                        "sharded over N ranks (per-layer halo exchange, "
                        "parallel.spatial); start one process a rank: "
                        "torchrun --nproc-per-node N -m <this entry>; "
                        "--image-size must divide by 32·N")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    int8 = args.int8 or args.int8_weights
    if args.spatial and args.spatial < 2:
        p.error("--spatial N needs N >= 2 (1 shard is the normal path)")
    if args.spatial and (int8 or args.int8_export or args.pallas_stem
                         or args.no_fold_bn):
        p.error("--spatial serves the folded f32/bf16 chain sharded "
                "over devices; it composes with --nms/--v2/"
                "--passthrough/--downsample but not with int8, "
                "--pallas-stem or --no-fold-bn")
    if args.image_size % 32:
        p.error("--image-size must be a multiple of 32")
    if args.int8_export and not args.int8:
        p.error("--int8-export requires --int8 (it writes the chain "
                "quantized in this run)")
    if args.int8_weights and (args.int8 or args.int8_export):
        p.error("--int8-weights already serves a quantized artifact; drop "
                "--int8/--int8-export")
    if args.int8_weights and args.weights:
        p.error("--int8-weights serves the artifact's own weights; "
                "--weights would be ignored")
    if args.int8_weights and args.tf_checkpoint:
        p.error("--int8-weights serves the artifact's own weights; "
                "--tf-checkpoint would be ignored")
    if args.weights and args.tf_checkpoint:
        p.error("--weights and --tf-checkpoint both name the weights; "
                "pass one")
    require_tf_checkpoint(p, "--tf-checkpoint", args.tf_checkpoint)
    if args.no_fold_bn and int8:
        p.error("int8 serving quantizes the BN-folded chain; drop "
                "--no-fold-bn")
    if args.passthrough and not args.v2:
        p.error("--passthrough is the YOLOv2 reorg head; it requires --v2")
    if args.downsample == "stride" and int8:
        p.error("int8 serving covers the pool-based chain (ops.quant's "
                "layer plan); the stride variant is not quantized")
    if args.pallas_stem and int8:
        p.error("--pallas-stem covers the bf16 / float32 chain, not int8")

    net_name = ("darknet19_v2p" if args.passthrough else "darknet19_v2"
                if args.v2 else "darknet19")
    net_name += "_sd" if args.downsample == "stride" else ""
    paths = Paths()
    anchors_dir = (os.path.dirname(os.path.abspath(args.weights or
                                                   args.int8_weights))
                   if args.weights or args.int8_weights else
                   os.path.join(paths.ckpts, net_name, "voc_2007"))
    if args.v2:
        # an imported checkpoint decodes with the classic priors
        external = args.tf_checkpoint is not None
        yolo = v2_config_for_snapshot(anchors_dir, args.image_size,
                                      external_weights=external)
        stored = os.path.join(anchors_dir, ANCHORS_FILE)
        print("anchors: " + (stored if os.path.isfile(stored)
                             and not external else
                             f"the classic VOC priors (no {ANCHORS_FILE} "
                             "beside the weights, or a TF checkpoint)"))
    else:
        yolo = YoloConfig(S=args.image_size // 32,
                          image_size=args.image_size)
    state_dict = None
    if args.weights:
        state_dict = as_state_dict(*load_npz(args.weights))
    elif not args.int8_weights:
        try:
            state_dict = load_detector_params(yolo, args.tf_checkpoint,
                                              paths, network_name=net_name)
        except FileNotFoundError as e:
            p.error(f"--weights NPZ is required where there is no TF "
                    f"checkpoint and no snapshot of this package ({e}); "
                    "or pass --tf-checkpoint or --int8-weights")
    image = image_read(args.image, yolo.image_size)  # BGR, [-1, 1]
    use_nms = args.nms and not args.host_nms
    kw = {"use_nms": use_nms, "v2": args.v2, "passthrough": args.passthrough,
          "device": args.device}
    if args.int8_weights:
        qlayers, meta = quant.load_quantized(args.int8_weights)
        for key, want in (("v2", args.v2), ("passthrough", args.passthrough),
                          ("image_size", yolo.image_size)):
            if key in meta and meta[key] != want:
                p.error(f"--int8-weights artifact was quantized with "
                        f"{key}={meta[key]}, run requests {want}")
        detect = make_detect_fn_int8(yolo, qlayers, args.threshold, **kw)
    elif args.int8:
        if not any(k.endswith(".running_var") for k in state_dict):
            p.error("--int8 needs BatchNorm statistics to fold before "
                    "quantizing; the weights have none")
        qlayers = quantize_detector(state_dict, None, image[None], v2=args.v2,
                                    passthrough=args.passthrough,
                                    device=args.device)
        if args.int8_export:
            quant.save_quantized(args.int8_export, qlayers,
                                 {"v2": args.v2,
                                  "passthrough": args.passthrough,
                                  "image_size": yolo.image_size})
            print(f"Exported int8 artifact to {args.int8_export}")
        detect = make_detect_fn_int8(yolo, qlayers, args.threshold, **kw)
    elif args.spatial:
        from tensorflow_yolo2_torch.parallel.mesh import (
            maybe_initialize_distributed,
        )

        maybe_initialize_distributed(args.device)
        try:
            detect = make_spatial_detect_fn(
                yolo, state_dict, None, args.threshold,
                downsample=args.downsample, n_shards=args.spatial, **kw)
        except ValueError as e:
            p.error(str(e))
    else:
        detect = make_detect_fn(yolo, state_dict, None, args.threshold,
                                fold_bn=not args.no_fold_bn,
                                pallas_stem=args.pallas_stem,
                                downsample=args.downsample, **kw)
    dets = detect(image[None])
    if dets is None:  # a spatial rank other than 0: rank 0 draws
        return 0
    boxes, scores, classes = (t[0].cpu().numpy() for t in dets)
    if args.host_nms:
        native.require()  # raises with the compiler's output if not built
        keep = native.nms(boxes, scores, classes, iou_thresh=0.5,
                          class_aware=True, score_thresh=0.0)
        boxes, scores, classes = boxes[keep], scores[keep], classes[keep]
    out = draw_detections(args.image, boxes, scores, classes, VOC_CLASSES,
                          args.out or args.image + ".detections.png")
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
