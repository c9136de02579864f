"""Top-1 accuracy and throughput of the Darknet19 classifier over the
ILSVRC val split (port of
tensorflow_yolo2_tpu/entries/imagenet_test_darknet.py).

The newest classifier snapshot (``ckpts/darknet19/ilsvrc_2017_cls``; fresh
seeded weights without one) in eval mode, batch 64, over the whole split
or ``--max-batches``; each batch is timed to the host's read of its
accuracy. ``--int8`` serves the post-training-quantized chain instead
(``ops.quant``: BN folded, activations calibrated on the first batch,
``forward_int8_classifier``). Runs on ``cuda`` unless ``--device`` names
another device.

    python -m tensorflow_yolo2_torch.entries.imagenet_test_darknet \\
        --max-batches 100 --int8
"""

from __future__ import annotations

import torch

from tensorflow_yolo2_torch.config import Paths
from tensorflow_yolo2_torch.data.ilsvrc import IlsvrcCls
from tensorflow_yolo2_torch.data.prefetch import (
    PrefetchLoader,
    device_prefetch,
)
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.entries.imagenet_train_darknet import (
    NET_NAME,
    momentum_config,
)
from tensorflow_yolo2_torch.models.darknet import Darknet19Classifier
from tensorflow_yolo2_torch.models.fold import fold_params
from tensorflow_yolo2_torch.ops import quant
from tensorflow_yolo2_torch.parallel.mesh import idle, in_mesh, release_idle
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task
from tensorflow_yolo2_torch.utils.device import device_normalize
from tensorflow_yolo2_torch.utils.timer import Timer


def quantize_classifier(state_dict, calib_images,
                        device: torch.device) -> tuple:
    """Fold BN and post-training-quantize a classifier's state dict → the
    int8 layer chain (CPU tensors): calibration in float32 on ``device``
    (cuDNN without TF32), quantization on the CPU."""
    folded = fold_params({k: v.detach().float().cpu()
                          for k, v in state_dict.items()})
    on_device = {k: v.to(device) for k, v in folded.items()}
    images = device_normalize(torch.as_tensor(calib_images).to(device))
    scales = quant.calibrate(on_device, images, head="classifier")
    return quant.quantize_folded(folded, scales, head="classifier")


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--int8", action="store_true",
                   help="serve the post-training-quantized int8 chain "
                        "(ops.quant; BN folded, activations calibrated on "
                        "the first batch)")
    args = p.parse_args(argv)
    common.refuse_ignored_tf_checkpoint(p, args.tf_checkpoint)

    batch_size = args.batch_size or 64
    mesh = common.start_mesh(batch_size, args.device)
    if not in_mesh(mesh):
        return idle(mesh)
    chief = common.data_shard(mesh)[0] == 0
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)
    imdb = IlsvrcCls("val", batch_size=common.local_batch(batch_size, mesh),
                     data_path=args.data_path)
    n_batches = args.max_batches or max(1, len(imdb.gt_labels) //
                                        batch_size)
    common.shard_dataset(imdb, mesh)  # its rows of each global batch
    trainer = Trainer(Darknet19Classifier(num_classes=imdb.num_class),
                      softmax_task(), momentum_config(1e-3),
                      device=args.device, compute_dtype=dtype)
    mgr = CheckpointManager(NET_NAME, imdb.name, save_by_epoch=True,
                            paths=Paths())
    sample, _ = imdb.get()
    state, _ = common.bootstrap_state(trainer, mgr,
                                      torch.Generator().manual_seed(0))

    eval_step = trainer.eval_step
    if args.int8:
        layers = quant.prepare(
            quantize_classifier(state.model.state_dict(), sample,
                                trainer.device), trainer.device)

        @torch.inference_mode()
        def eval_step(_state, images, labels):
            logits = quant.forward_int8_classifier(layers, images)
            return {"accuracy": torch.mean(
                (torch.argmax(logits, -1) == labels).float())}

    timer = Timer()
    correct = total = 0
    with PrefetchLoader(imdb.get, num_workers=args.num_workers) as loader:
        stream = device_prefetch(iter(loader), size=2, device=trainer.device)
        for i in range(n_batches):
            images, labels = next(stream)
            timer.tic()
            acc = float(eval_step(state, images, labels)["accuracy"])
            timer.toc()
            correct += acc * labels.shape[0]
            total += labels.shape[0]
            if chief and i % 10 == 0:
                print(f"batch {i}/{n_batches}: acc {acc:.4f}, "
                      f"avg {timer.average_time:.4f}s/batch "
                      f"({batch_size / timer.average_time:.1f} img/s)")
    correct, total = common.sum_over_data(mesh, correct, total)
    total = int(total)
    if chief:
        print(f"top-1 accuracy: {correct / max(total, 1):.4f} over {total} "
              "images")
        print(f"throughput: {batch_size / timer.average_time:.1f} "
              "images/sec")
    release_idle(mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
