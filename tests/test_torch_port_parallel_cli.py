"""The entries under ``torchrun`` on gloo ranks (CPU): ``train_classifier
--num-clones 2`` (each rank its shard of a flowers tree, rank 0 the
snapshot), a surplus rank that idles and exits 0, ``pascal_train_darknet
--spatial 2`` (a step of the v1 head at 224², S=7 padded to 8 rows) and
``pascal_detect_darknet --spatial 2`` drawing the boxes the unsharded CLI
draws. The refusals of a spatial run without its ranks. Each launch has
its own timeout and the process group a finite one.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from tests import synthetic
from tests.test_torch_port_parallel_mesh import (
    REPO,
    RANK_TIMEOUT,
    _free_port,
)
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)
from tensorflow_yolo2_torch.config import YoloConfig
from tensorflow_yolo2_torch.train.checkpoint import (
    CheckpointManager,
    read_snapshot,
)

CPU = ["--device", "cpu", "--compute-dtype", "float32"]


def torchrun(root, nproc: int, module: str, *argv: str) -> str:
    """``python -m torch.distributed.run --nproc-per-node nproc -m
    tensorflow_yolo2_torch.entries.<module> argv`` under the run root;
    its output (both ranks'), failing the test on a non-zero exit or a
    timeout."""
    env = {**os.environ, "TFY2_ROOT": str(root),
           "TFY2_DIST_TIMEOUT": str(RANK_TIMEOUT), "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", str(nproc), "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()),
           "-m", f"tensorflow_yolo2_torch.entries.{module}", *argv]
    try:
        done = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"{module} timed out after {RANK_TIMEOUT} s:\n"
                    f"{(e.stdout or '')[-3000:]}{(e.stderr or '')[-3000:]}")
    out = done.stdout + done.stderr
    assert done.returncode == 0, out[-6000:]
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("runroot")
    synthetic.make_flowers(str(root / "data" / "TF_flowers"), per_class=8)
    synthetic.make_voc(str(root / "data" / "VOCdevkit"), n_images=4)
    return root


@pytest.fixture(scope="module")
def spatial_run(root):
    """A spatial training step on 2 ranks (the snapshot the detect test
    serves)."""
    return torchrun(root, 2, "pascal_train_darknet", "--spatial", "2",
                    "--iters", "1", "--batch-size", "2", "--num-workers",
                    "1", "--log-every", "1", *CPU)


def test_train_classifier_num_clones_2(root):
    out = torchrun(root, 2, "train_classifier", "--num-clones", "2",
                   "--model-name", "lenet", "--image-size", "32",
                   "--batch-size", "4", "--iters", "2", "--save-every",
                   "2", "--log-every", "1", "--num-workers", "1", *CPU)
    assert out.count("iter 2: loss") == 1  # rank 0 alone logs
    mgr = CheckpointManager("lenet", "tf_flowers",
                            paths=_paths(root))
    assert mgr.all_steps() == [2]
    snap = read_snapshot(mgr.latest_path())
    assert snap["step"] == 2 and snap["optimizer"]["count"] == 2
    assert all(torch.isfinite(v).all() for v in snap["model"].values()
               if v.is_floating_point())


def test_surplus_rank_idles_and_exits_0(root):
    """Batch 3 on 2 ranks: the data axis is 1 (JAX's rule), rank 1 takes
    no step and waits until rank 0 is done."""
    out = torchrun(root, 2, "train_classifier", "--model-name", "lenet",
                   "--dataset-name", "synthetic", "--image-size", "28",
                   "--batch-size", "3", "--iters", "1", "--num-workers",
                   "1", *CPU)
    assert "rank 1: outside the 1x1 mesh, idle until the run ends" in out
    assert "batch 3 only shards over 1/2 devices" in out


def test_pascal_train_darknet_spatial_2(root, spatial_run):
    assert spatial_run.count("iter 1: loss") == 1  # rank 0 alone logs
    mgr = CheckpointManager("darknet19", "voc_2007", paths=_paths(root))
    assert mgr.all_steps() == [1]
    snap = read_snapshot(mgr.latest_path())
    assert snap["step"] == 1 and snap["optimizer"]["count"] == 1
    # the normal trainer's keys: a detector loads it as it is
    from tensorflow_yolo2_torch.models.darknet import Darknet19Detector

    Darknet19Detector(YoloConfig().cell_channels).load_state_dict(
        snap["model"])


def test_pascal_detect_darknet_spatial_2_draws_the_unsharded_boxes(
        root, spatial_run, tmp_path, monkeypatch):
    from tensorflow_yolo2_torch.entries import pascal_detect_darknet

    image = os.path.join(root, "data", "VOCdevkit", "VOC2007",
                         "JPEGImages", "000000.jpg")
    argv = [image, "--image-size", "256", "--threshold", "0.0", "--nms",
            "--device", "cpu"]
    monkeypatch.setenv("TFY2_ROOT", str(root))
    want = tmp_path / "unsharded.png"
    assert pascal_detect_darknet.main(argv + ["--out", str(want)]) == 0
    got = tmp_path / "spatial.png"
    torchrun(root, 2, "pascal_detect_darknet", *argv, "--spatial", "2",
             "--out", str(got))
    assert got.read_bytes() == want.read_bytes()


def test_spatial_refusals(root, spatial_run, monkeypatch, capsys):
    """A spatial serving run without its ranks names the launch; the
    detect CLI's own refusals."""
    from tensorflow_yolo2_torch.entries import pascal_detect_darknet

    monkeypatch.setenv("TFY2_ROOT", str(root))
    for argv, match in (
            (["--image-size", "256"], "--spatial 2 runs one process a "
             "shard: start it with torchrun --nproc-per-node 2"),
            (["--image-size", "224"], "needs --image-size divisible by 64"),
            (["--image-size", "256", "--pallas-stem"],
             "not with int8, --pallas-stem")):
        with pytest.raises(SystemExit):
            pascal_detect_darknet.main([*argv, "--spatial", "2",
                                        "--device", "cpu"])
        assert match in capsys.readouterr().err


def _paths(root):
    from tensorflow_yolo2_torch.config import Paths

    return Paths(root=str(root))
