"""The ResNet50 CLIs on the CPU: ``pascal_train_resnet`` on a synthetic
VOC tree (snapshots, resume), ``pascal_detect_resnet`` on its snapshot
(the drawn boxes equal ``make_resnet_detect_fn``'s, with NMS and
without), ``imagenet_train_resnet`` on the ``ilsvrc_dir`` fixture's tree
(the frozen trunk, then ``--train-all``), and the two entries' TF
checkpoint warm start refusing a ``--tf-checkpoint`` that is not there
and failing, before any data is read, on a broken
``weights/resnet_v1_50.ckpt`` (the import itself:
``tests/test_torch_port_tf_entries.py``).

The detector CLIs run at a patched ``YoloConfig.image_size`` of 32 (a
1×1 block4 map; the grid stays S=7), the fine-tune at a patched
``IlsvrcCls`` image size of 64, in float32 on the CPU. Boxes, scores and
classes are compared exactly: the CLI and the function run the same
float32 forward and the same decode on the same image.
"""

import contextlib
import functools
import io
import os

import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch.config import Paths, YoloConfig
from tensorflow_yolo2_torch.data.augment import image_read
from tensorflow_yolo2_torch.entries import imagenet_train_resnet as cls_train
from tensorflow_yolo2_torch.entries import pascal_detect_resnet as detect
from tensorflow_yolo2_torch.entries import pascal_train_resnet as train
from tensorflow_yolo2_torch.models.darknet import init_params_
from tensorflow_yolo2_torch.models.resnet import ResNet50V1
from tensorflow_yolo2_torch.train.checkpoint import (
    CheckpointManager,
    read_snapshot,
)
from tests import synthetic
from tests.test_torch_port_cls_cli import write_tree
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)

CPU = ["--device", "cpu", "--compute-dtype", "float32"]
SIZE = 32
SMALL = functools.partial(YoloConfig, image_size=SIZE)
CLS_SIZE = 64


def run(main, argv: list[str]) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def run_root(tmp_path_factory):
    """A run dir with a synthetic VOC tree (4 images), the detector CLIs'
    ``YoloConfig`` at 32², and a detector trained there: 2 iterations at
    batch 2 with a snapshot at 2, then a resume for 1 more. At Adam's
    rate of 1e-6: at the CLI's 5e-4 the first steps move every weight by
    ~lr in a coherent direction, which can leave the output ReLU dead
    (every score 0) and the boxes' comparison below empty."""
    root = tmp_path_factory.mktemp("resnet_root")
    synthetic.make_voc(str(root / "data" / "VOCdevkit"), n_images=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFY2_ROOT", str(root))
        mp.setattr(train, "YoloConfig", SMALL)
        mp.setattr(detect, "YoloConfig", SMALL)
        argv = ["--batch-size", "2", "--save-every", "2", "--log-every", "1",
                "--num-workers", "1", "--learning-rate", "1e-6", *CPU]
        logs = [run(train.main, ["--iters", "2", *argv]),
                run(train.main, ["--iters", "1", *argv])]
        yield {"root": root, "logs": logs}


def test_train_cli_snapshots_and_resume(run_root):
    first, second = run_root["logs"]
    assert "Saved snapshot at iter 2 (iter 2)" in first
    assert "Restored snapshot at iter 2" in second
    assert "Saved final snapshot at iter 3 (iter 3)" in second
    mgr = CheckpointManager("resnet50", "voc_2007",
                            paths=Paths(str(run_root["root"])))
    assert mgr.all_steps() == [2, 3]
    snap = read_snapshot(mgr.latest_path())
    assert snap["step"] == 3 and snap["optimizer"]["count"] == 3
    assert set(snap["optimizer"]) == {"count", "mu", "nu"}
    assert snap["model"]["yolo_fc1.weight"].shape == (4096, 2048)
    assert snap["model"]["yolo_fc2.weight"].shape == (7 * 7 * 30, 4096)
    assert snap["rng"].dtype == torch.uint8  # the dropout generator
    assert snap["yolo"]["image_size"] == SIZE


@pytest.mark.parametrize("nms", [True, False])
@pytest.mark.parametrize("threshold", [None, "0.0"])
def test_detect_cli_draws_make_resnet_detect_fn_boxes(run_root, monkeypatch,
                                                      nms, threshold):
    """The boxes the CLI draws (its default threshold 0.2, and 0.0) are
    those of ``make_resnet_detect_fn`` on the newest snapshot: K=32 kept
    slots with ``--nms``, else the 7·7·2 dense slots."""
    image = str(run_root["root"] / "data" / "VOCdevkit" / "VOC2007" /
                "JPEGImages" / "000000.jpg")
    drawn = []

    def record(path, boxes, scores, classes, names, out_path=None):
        drawn.append((path, boxes, scores, classes, out_path))
        return "recorded.png"

    monkeypatch.setenv("TFY2_ROOT", str(run_root["root"]))
    monkeypatch.setattr(detect, "YoloConfig", SMALL)
    monkeypatch.setattr(detect, "draw_detections", record)
    argv = [image, "--device", "cpu"] + (["--nms"] if nms else []) + \
        (["--threshold", threshold] if threshold else [])
    assert "Wrote recorded.png" in run(detect.main, argv)
    (path, boxes, scores, classes, out_path), = drawn
    assert path == image and out_path is None

    snap = read_snapshot(CheckpointManager(
        "resnet50", "voc_2007", paths=Paths(str(run_root["root"])))
        .latest_path())
    fn = detect.make_resnet_detect_fn(
        SMALL(), snap["model"], float(threshold or 0.2), use_nms=nms,
        device="cpu")
    want = [t[0].numpy() for t in fn(image_read(image, SIZE)[None])]
    assert boxes.shape == ((32, 4) if nms else (98, 4))
    for got, w in zip((boxes, scores, classes), want):
        np.testing.assert_array_equal(got, w)
    if threshold == "0.0":
        assert (scores > 0).any()


def test_fine_tune_cli_freezes_the_trunk_then_trains_all(tmp_path,
                                                         monkeypatch):
    """``imagenet_train_resnet``: an epoch (2 iterations at batch 6) and
    its snapshot, whose trunk is bit-equal to the fresh weights of
    the seed (flax's initializers), its BatchNorm statistics moved, the
    logits trained, the momentum trace of the logits alone; then a
    resume with ``--train-all`` (the optimizer swapped) moves the
    trunk (a second epoch)."""
    write_tree(tmp_path / "data" / "ILSVRC")
    monkeypatch.setenv("TFY2_ROOT", str(tmp_path))
    monkeypatch.setattr(cls_train, "IlsvrcCls", functools.partial(
        cls_train.IlsvrcCls, image_size=CLS_SIZE))
    argv = ["--batch-size", "6", "--save-every", "2", "--eval-every", "2",
            "--log-every", "1", "--num-workers", "1", *CPU]
    first = run(cls_train.main, ["--iters", "2", *argv])
    assert "Saved snapshot at iter 2 (epoch 1)" in first
    mgr = CheckpointManager("resnet50", "ilsvrc_2017_cls",
                            save_by_epoch=True, paths=Paths(str(tmp_path)))
    snap = read_snapshot(mgr.latest_path())
    fresh = init_params_(ResNet50V1(3, global_pool=True),
                         torch.Generator().manual_seed(0)).state_dict()
    model = snap["model"]
    assert set(snap["optimizer"]["trace"]) == {"logits.weight",
                                               "logits.bias"}
    params = {k for k, _ in ResNet50V1(3, global_pool=True)
              .named_parameters()}
    for k in params - {"logits.weight", "logits.bias"}:
        assert torch.equal(model[k], fresh[k]), k
    assert not torch.equal(model["logits.weight"], fresh["logits.weight"])
    assert not torch.equal(model["block4_unit3.bn3.bn.running_var"],
                           fresh["block4_unit3.bn3.bn.running_var"])

    second = run(cls_train.main, ["--iters", "2", "--train-all", *argv])
    assert "Optimizer state in snapshot does not match" in second
    assert mgr.all_steps() == [1, 2]
    snap = read_snapshot(mgr.latest_path())
    assert len(snap["optimizer"]["trace"]) == len(params)
    assert not torch.equal(snap["model"]["conv1.weight"],
                           fresh["conv1.weight"])


@pytest.mark.parametrize("entry", ["pascal_train_resnet",
                                   "imagenet_train_resnet"])
@pytest.mark.parametrize("how", ["flag", "weights_file"])
def test_tf_checkpoint_import_is_refused_naming_a7(tmp_path, monkeypatch,
                                                   capsys, entry, how):
    """The TF import is ported now; what is refused is a checkpoint that
    is not one. A ``--tf-checkpoint`` that is not there: the parser's
    error, never a run from fresh weights. A broken
    ``weights/resnet_v1_50.ckpt.index`` (an empty file): the reader's
    error naming it. Either before any data is read or any snapshot dir
    is made."""
    main = {"pascal_train_resnet": train.main,
            "imagenet_train_resnet": cls_train.main}[entry]
    monkeypatch.setenv("TFY2_ROOT", str(tmp_path))
    argv = ["--device", "cpu"]
    if how == "flag":
        missing = str(tmp_path / "missing.ckpt")
        with pytest.raises(SystemExit) as err:
            main(argv + ["--tf-checkpoint", missing])
        assert err.value.code == 2
        assert f"{missing}: no TF checkpoint there" in \
            capsys.readouterr().err
    else:
        os.makedirs(tmp_path / "weights")
        (tmp_path / "weights" / "resnet_v1_50.ckpt.index").write_text("")
        with pytest.raises(ValueError, match="resnet_v1_50.ckpt.index: 0 "
                                             "bytes, shorter than a table"):
            main(argv)
    assert not (tmp_path / "ckpts").exists()
