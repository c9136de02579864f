"""The classifier's three CLIs on the CPU on the ``ilsvrc_dir`` fixture's
tree (``imagenet_train_darknet``, ``imagenet_test_darknet`` in float32
and with ``--int8``, ``imagenet_predict_darknet``), and the detect CLI's
drawing against the JAX package's (PIL + matplotlib: the same PNG
bytes). The detector's warm start from the classifier's snapshot:
``tests/test_torch_port_cls_warm.py``.

The CLIs run at their fixed 224² in float32 (bf16 autocast is slow on the
CPU), on 12 train and 6 val images of 3 synsets.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch.entries import imagenet_predict_darknet as predict
from tensorflow_yolo2_torch.entries import imagenet_test_darknet as test_cli
from tensorflow_yolo2_torch.entries import imagenet_train_darknet as train
from tensorflow_yolo2_torch.train.checkpoint import (
    CheckpointManager,
    read_snapshot,
)
from tensorflow_yolo2_torch.utils import visualize as pt_visualize
from tensorflow_yolo2_tpu.utils import visualize as jx_visualize
from tests import synthetic

CPU = ["--device", "cpu", "--compute-dtype", "float32"]


def write_tree(data) -> None:
    """The ``ilsvrc_dir`` fixture's synthetic ILSVRC tree under ``data``
    (a ``pathlib.Path``): 3 synsets × 4 train images, 6 val images
    labelled by XML."""
    synsets = ["n01000001", "n01000002", "n01000003"]
    lines = []
    for si, syn in enumerate(synsets):
        for i in range(4):
            rel = f"{syn}/{syn}_{i}"
            synthetic.make_image(str(data / "Data" / "CLS-LOC" / "train" /
                                     (rel + ".JPEG")), 64, 48,
                                 seed=si * 10 + i)
            lines.append(f"{rel} {len(lines) + 1}")
    (data / "ImageSets" / "CLS-LOC").mkdir(parents=True)
    (data / "ImageSets" / "CLS-LOC" / "train_cls.txt").write_text(
        "\n".join(lines) + "\n")
    (data / "Annotations" / "CLS-LOC" / "val").mkdir(parents=True)
    for i in range(6):
        name = f"ILSVRC2012_val_{i:08d}"
        synthetic.make_image(str(data / "Data" / "CLS-LOC" / "val" /
                                 (name + ".JPEG")), 64, 48, seed=100 + i)
        (data / "Annotations" / "CLS-LOC" / "val" / (name + ".xml")
         ).write_text(f"<annotation><object><name>{synsets[i % 3]}</name>"
                      "</object></annotation>")


def train_classifier(argv: list[str]) -> str:
    """``imagenet_train_darknet.main`` at batch 6 (2 iterations an
    epoch) on the CPU; what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train.main(["--batch-size", "6", "--save-every", "2",
                           "--eval-every", "2", "--log-every", "1",
                           "--num-workers", "1", *argv, *CPU]) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def cls_run(tmp_path_factory):
    """A run dir with the synthetic ILSVRC tree and a classifier trained
    there: 3 iterations at batch 6 (2 an epoch), a snapshot every 2 with
    ``--uint8-transfer``, then a resume for 2 more through 2 worker
    processes."""
    root = tmp_path_factory.mktemp("cls_root")
    data = root / "data" / "ILSVRC"
    write_tree(data)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFY2_ROOT", str(root))
        logs = [train_classifier(["--iters", "3", "--uint8-transfer"]),
                train_classifier(["--iters", "2", "--process-workers",
                                  "2"])]
        yield {"root": root, "data": str(data), "logs": logs}


def cls_manager(root):
    from tensorflow_yolo2_torch.config import Paths
    return CheckpointManager("darknet19", "ilsvrc_2017_cls",
                             save_by_epoch=True, paths=Paths(str(root)))


def test_train_cli_epoch_snapshots_eval_and_resume(cls_run):
    """Epoch-named snapshots (iteration // iterations an epoch), the tail
    skipped where its epoch holds a boundary snapshot, a validation batch
    every 2 iterations into its own writer, the resume by epoch."""
    first, second = cls_run["logs"]
    assert "Saved snapshot at iter 2 (epoch 1)" in first
    assert "Skipping tail save at iter 3: epoch 1 already holds" in first
    assert "Restored snapshot at epoch 1" in second
    assert "iter 3:" in second and "Saved snapshot at iter 4 (epoch 2)" \
        in second
    assert cls_manager(cls_run["root"]).all_steps() == [1, 2]
    snap = read_snapshot(cls_manager(cls_run["root"]).latest_path())
    assert snap["step"] == 4 and set(snap["optimizer"]) == {"count", "trace"}
    assert snap["optimizer"]["count"] == 4
    assert snap["model"]["conv19.conv.weight"].shape == (3, 1024, 1, 1)
    val = cls_run["root"] / "tensorboard" / "darknet19" / \
        "ilsvrc_2017_cls" / "val" / "events.jsonl"
    steps = [int(line.split('"step": ')[1].split(",")[0])
             for line in val.read_text().splitlines()]
    assert steps == [2, 4]


@pytest.mark.parametrize("int8", [False, True])
def test_test_cli(cls_run, int8, capsys):
    argv = ["--batch-size", "3", "--max-batches", "2", "--num-workers", "1",
            *CPU] + (["--int8"] if int8 else [])
    assert test_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "Restored snapshot at epoch 2" in out
    line = next(x for x in out.splitlines() if x.startswith("top-1"))
    acc = float(line.split()[2])
    assert line.endswith("over 6 images") and 0.0 <= acc <= 1.0
    assert "images/sec" in out


def test_predict_cli(cls_run, capsys):
    """The top 3 of 3 synsets with the probabilities of the folded bf16
    classifier of the newest snapshot."""
    image = os.path.join(cls_run["data"], "Data", "CLS-LOC", "val",
                         "ILSVRC2012_val_00000001.JPEG")
    assert predict.main([image, "--device", "cpu"]) == 0
    rows = [line.split() for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r[0] for r in rows] == ["1.", "2.", "3."]
    assert sorted(r[1] for r in rows) == ["n01000001", "n01000002",
                                          "n01000003"]
    probs = [float(r[2][2:]) for r in rows]
    assert probs == sorted(probs, reverse=True)
    assert abs(sum(probs) - 1) < 1e-2


def test_entries_import_without_cuda():
    """Importing the entries (as a spawned worker re-imports the train
    entry) initialises no CUDA context."""
    for module in (train, test_cli, predict):
        assert module.main
    assert not torch.cuda.is_initialized()


# -- C4: the detect CLI draws as the JAX package draws ------------------------


def test_draw_detections_writes_jax_png(tmp_path, capsys):
    """The same boxes drawn by the port's ``utils.visualize`` and by the
    JAX package's: the same PNG, byte for byte, and the same printed
    boxes; the detect CLI's image argument defaults to JAX's demo."""
    from tensorflow_yolo2_torch.config import VOC_CLASSES
    from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pdd

    image = str(tmp_path / "in.jpg")
    synthetic.make_image(image, 96, 80, seed=3)
    boxes = np.array([[0.1, 0.2, 0.5, 0.7], [0.4, 0.1, 0.9, 0.6],
                      [0.0, 0.0, 0.3, 0.3]], np.float32)
    scores = np.array([0.9, 0.55, 0.0], np.float32)
    classes = np.array([14, 6, 2], np.int32)
    ours = pt_visualize.draw_detections(image, boxes, scores, classes,
                                        VOC_CLASSES, str(tmp_path / "a.png"))
    printed = capsys.readouterr().out
    theirs = jx_visualize.draw_detections(image, boxes, scores, classes,
                                          VOC_CLASSES,
                                          str(tmp_path / "b.png"))
    assert printed == capsys.readouterr().out
    assert printed.count("predicted bounding box") == 2
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert pdd.draw_detections is pt_visualize.draw_detections
    with pytest.raises(SystemExit):
        pdd.main(["--help"])
    assert "assets/demo.jpg" in capsys.readouterr().out
