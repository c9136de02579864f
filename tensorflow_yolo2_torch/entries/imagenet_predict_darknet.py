"""Top-5 ImageNet classes of one image (port of
tensorflow_yolo2_tpu/entries/imagenet_predict_darknet.py).

The image (``data.augment.image_read``: warp-resized, [-1, 1]) through
the BN-folded bf16 Darknet19 classifier of the newest snapshot under
``ckpts/darknet19/ilsvrc_2017_cls``, then a softmax; prints the five most
likely synsets (the class dirs of the ILSVRC train split) with their
probabilities. Runs on ``cuda`` unless ``--device`` names another device.

    python -m tensorflow_yolo2_torch.entries.imagenet_predict_darknet img.jpg
"""

from __future__ import annotations

import argparse

import torch

from tensorflow_yolo2_torch.config import Paths
from tensorflow_yolo2_torch.data.augment import image_read
from tensorflow_yolo2_torch.data.ilsvrc import IlsvrcCls
from tensorflow_yolo2_torch.entries.imagenet_train_darknet import NET_NAME
from tensorflow_yolo2_torch.models.darknet import Darknet19Classifier
from tensorflow_yolo2_torch.models.fold import fold_params
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.utils.device import resolve_device


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image")
    p.add_argument("--data-path", default=None)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    imdb = IlsvrcCls("train", batch_size=1, data_path=args.data_path)
    mgr = CheckpointManager(NET_NAME, imdb.name, save_by_epoch=True,
                            paths=Paths())
    model = Darknet19Classifier(num_classes=imdb.num_class, fold_bn=True)
    model.load_state_dict(fold_params(mgr.restore_raw()["model"]))
    model.eval().requires_grad_(False)
    model.to(device=device, dtype=torch.bfloat16,
             memory_format=torch.channels_last)

    image = torch.from_numpy(image_read(args.image, args.image_size))
    with torch.inference_mode():
        logits = model(image[None].to(device, torch.bfloat16))
        probs = torch.softmax(logits, -1)[0].cpu()
    top5 = torch.argsort(-probs)[:5].tolist()
    for rank, idx in enumerate(top5, 1):
        print(f"{rank}. {imdb.classes[idx]}  p={probs[idx]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
