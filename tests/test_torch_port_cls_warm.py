"""The detector's warm start from the classifier's snapshot, on the CPU:
a snapshot ``imagenet_train_darknet`` wrote (2 iterations on the
``ilsvrc_dir`` fixture's tree), then the detector's ``bootstrap_state``
and the ``pascal_train_darknet`` CLI on a synthetic VOC tree taking its
trunk from it."""

import pytest
import torch

from tensorflow_yolo2_torch.config import YoloConfig
from tensorflow_yolo2_torch.entries import common, pascal_train_darknet
from tensorflow_yolo2_torch.models.darknet import Darknet19Detector
from tensorflow_yolo2_torch.train.checkpoint import (
    CheckpointManager,
    read_snapshot,
)
from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task
from tests import synthetic
from tests.test_torch_port_cls_cli import (
    CPU,
    cls_manager,
    train_classifier,
    write_tree,
)


@pytest.fixture(scope="module")
def cls_run(tmp_path_factory):
    """A run dir with the synthetic ILSVRC tree and a classifier
    snapshot at epoch 1 (2 iterations at batch 6)."""
    root = tmp_path_factory.mktemp("warm_root")
    write_tree(root / "data" / "ILSVRC")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFY2_ROOT", str(root))
        train_classifier(["--iters", "2"])
        yield {"root": root}


def test_detector_warm_starts_from_the_classifier(cls_run, capsys):
    """``bootstrap_state`` of the detector takes the 18 trunk convs (with
    their BN scale and bias: 72 tensors) from the classifier's newest
    snapshot, not ``conv19``, and leaves the detection head fresh; the
    training CLI does so from the same snapshot dir."""
    warm = cls_manager(cls_run["root"]).latest_path()
    snap = read_snapshot(warm)["model"]
    yolo = YoloConfig()
    model = Darknet19Detector(yolo.cell_channels)
    trainer = Trainer(model, yolo_task(yolo), device="cpu",
                      compute_dtype=torch.float32)
    mgr = CheckpointManager("darknet19", "voc_2007_trainval",
                            paths=cls_manager(cls_run["root"]).paths)
    # torch's own initial weights (flax's initializers take seconds here)
    state, start = common.bootstrap_state(
        trainer, mgr, torch.Generator().manual_seed(0), warm_start_dir=warm,
        state_dict=model.state_dict())
    assert start == 0
    assert "Warm-started 72 tensors" in capsys.readouterr().out
    params = state.params
    taken = [k for k in params if k.startswith("backbone.")]
    assert len(taken) == 72 and {k.split(".")[1] for k in taken} == \
        {f"conv{i}" for i in range(1, 19)}
    for k in taken:
        assert torch.equal(params[k].detach(), snap[k]), k
    assert not any(k.startswith("conv19") for k in params)
    # the running statistics are not parameters: not taken
    key = "backbone.conv1.bn.running_mean"
    assert not torch.equal(state.model.state_dict()[key], snap[key])

    synthetic.make_voc(str(cls_run["root"] / "data" / "VOCdevkit"),
                       n_images=2)
    assert pascal_train_darknet.main(
        ["--iters", "1", "--batch-size", "2", "--num-workers", "1",
         "--save-every", "0", *CPU]) == 0
    assert f"Warm-started 72 tensors from {warm}" in capsys.readouterr().out
