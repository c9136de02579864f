"""VOC mAP evaluation."""

from tensorflow_yolo2_torch.eval.voc_map import (  # noqa: F401
    VocMapEvaluator,
    voc_ap,
)
