"""Detection visualization (a copy of
tensorflow_yolo2_tpu/utils/visualize.py, which imports no JAX): draw
decoded boxes and class:confidence labels on the original image with PIL
and matplotlib, as the JAX package draws them, so that the two packages
write the same PNG for the same boxes.

The decode runs on the device (``ops.cuda_decode``, ``ops.boxes``); this
module only rasterizes on the host. The output is saved to a file
(headless environments) and optionally shown.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def draw_detections(image_path: str, boxes: np.ndarray, scores: np.ndarray,
                    classes: np.ndarray, class_names: Sequence[str],
                    out_path: str | None = None, show: bool = False) -> str:
    """Draw (N, 4) fractional-corner boxes with score > 0 on the image.

    Returns the path the annotated image was written to.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt
    from PIL import Image

    im = np.array(Image.open(image_path).convert("RGB"), dtype=np.uint8)
    im_h, im_w = im.shape[:2]

    fig, ax = plt.subplots(1)
    ax.imshow(im)
    for box, score, cls in zip(boxes, scores, classes):
        if score <= 0:
            continue
        x1, y1, x2, y2 = (box[0] * im_w, box[1] * im_h,
                          box[2] * im_w, box[3] * im_h)
        print(f"predicted bounding box: ({int(x1)}, {int(y1)}), "
              f"width:{int(x2 - x1)}, height:{int(y2 - y1)}")
        ax.add_patch(patches.Rectangle(
            (x1, y1), x2 - x1, y2 - y1, linewidth=1.5, edgecolor="r",
            facecolor="none"))
        ax.text(x1, y1, f"{class_names[int(cls)]}:{float(score):.2f}",
                color="r", fontsize=9,
                bbox=dict(facecolor="white", alpha=0.5, pad=0))
    ax.axis("off")
    out_path = out_path or (image_path + ".detections.png")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    if show:
        plt.show()
    plt.close(fig)
    return out_path
