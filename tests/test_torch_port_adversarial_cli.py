"""The port's ``imagenet_train_adversarial`` CLI on the CPU, on the
``ilsvrc_dir`` fixture's tree at 32²: ``lenet`` inside the contrast
wrapper, attacked through a ``cifarnet`` generator, batch 4, float32.

- 3 iterations with a snapshot every 2: ``train_iter_2`` and
  ``train_iter_3``, the train stream with ``clean/`` and ``adv/`` keys at
  every iteration, the val stream at iteration 2; a second run resumes;
- ``--grouped-opt --noise-aug``: only ``input_transform`` trains (every
  other weight in the snapshot equals the run's fresh one);
- ``--attack-snapshot``: a ``convert.save_npz`` file of the JAX
  package's cifarnet tree is merged into the generator; an Orbax-style
  directory is refused naming the ``.npz`` carrier;
- the refusals: ``--tf-checkpoint`` (the JAX entry reads none through
  it), a generator flag without ``--attack-model``.
"""

import json
import os

import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import Paths
from tensorflow_yolo2_torch.entries import imagenet_train_adversarial as adv
from tensorflow_yolo2_torch.models.contrast import ContrastInputModel
from tensorflow_yolo2_torch.models.darknet import init_params_
from tensorflow_yolo2_torch.models.registry import get_network
from tensorflow_yolo2_torch.train.checkpoint import (
    CheckpointManager,
    read_snapshot,
)
from tensorflow_yolo2_tpu.models.zoo import CifarNet as JxCifarNet
from tests.test_torch_port_models import random_variables
from tests.test_torch_port_resnet_cli import run
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)

CPU = ["--device", "cpu", "--compute-dtype", "float32"]
BASE = ["--backbone", "lenet", "--attack-model", "cifarnet", "--image-size",
        "32", "--batch-size", "4", "--num-workers", "1", "--log-every", "1",
        *CPU]


@pytest.fixture
def root(tmp_root, ilsvrc_dir, monkeypatch):
    (tmp_root / "data").mkdir(exist_ok=True)
    os.symlink(ilsvrc_dir, tmp_root / "data" / "ILSVRC")
    return tmp_root


def _events(root, split):
    path = (root / "tensorboard" / "lenet_adv" / "ilsvrc_2017_cls" / split /
            "events.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def _mgr(root):
    return CheckpointManager("lenet_adv", "ilsvrc_2017_cls",
                             paths=Paths(str(root)))


def test_cli_snapshots_streams_and_resume(root):
    out = run(adv.main, [*BASE, "--iters", "3", "--save-every", "2",
                         "--eval-every", "2"])
    assert "iter 3: clean/loss" in out and "iter 2 [val]: clean/loss" in out
    assert _mgr(root).all_steps() == [2, 3]
    train, val = _events(root, "train"), _events(root, "val")
    assert [r["step"] for r in train] == [1, 2, 3]
    assert [r["step"] for r in val] == [2]
    for rec in train + val:
        for key in ("clean/loss", "clean/accuracy", "adv/loss",
                    "adv/accuracy"):
            assert key in rec
    out = run(adv.main, [*BASE, "--iters", "1", "--eval-every", "0"])
    assert "Restored snapshot at iter 3" in out
    assert _mgr(root).all_steps() == [2, 3, 4]


def test_grouped_optimizer_trains_only_the_transform(root):
    run(adv.main, [*BASE, "--iters", "1", "--eval-every", "0",
                   "--grouped-opt", "--noise-aug"])
    snap = read_snapshot(_mgr(root).latest_path())
    assert set(snap["optimizer"]) == {"count", "group0/mu", "group0/nu",
                                      "group1/mu", "group1/nu"}
    assert snap["optimizer"]["group0/mu"] == {}  # lenet has no conv1a
    assert sorted(snap["optimizer"]["group1/mu"]) == [
        "input_transform.bias", "input_transform.weight"]
    # the run's fresh weights (seed 0), of which only the transform moved
    fresh = init_params_(ContrastInputModel(get_network(
        "lenet", num_classes=3, image_size=32)),
        torch.Generator().manual_seed(0)).state_dict()
    for k, v in fresh.items():
        assert torch.equal(snap["model"][k], v) != \
            k.startswith("input_transform."), k


def test_attack_snapshot_npz_and_orbax_refusal(root, tmp_path):
    variables = random_variables(JxCifarNet(num_classes=3), (1, 32, 32, 3),
                                 seed=4)
    npz = str(tmp_path / "cifarnet.npz")
    convert.save_npz(npz, variables["params"])
    n = len(convert.flatten(variables["params"]))
    out = run(adv.main, [*BASE, "--iters", "1", "--eval-every", "0",
                         "--attack-snapshot", npz])
    assert f"Attack generator cifarnet: restored {n} param / 0 stat " \
        f"tensors from {npz}" in out
    orbax = tmp_path / "orbax_snapshot"
    (orbax / "params").mkdir(parents=True)
    with pytest.raises(ValueError, match="convert.save_npz .* pass the .npz"):
        adv.main([*BASE, "--iters", "1", "--attack-snapshot", str(orbax)])


@pytest.mark.parametrize("argv, match", [
    (["--tf-checkpoint", "x.ckpt"], "reads no TF checkpoint"),
    (["--backbone", "lenet", "--attack-snapshot", "g.npz"],
     "name it with --attack-model"),
    (["--tf-weights", "missing.ckpt"], "no TF checkpoint there"),
])
def test_cli_refusals(root, capsys, argv, match):
    with pytest.raises(SystemExit):
        adv.main([*argv, *CPU])
    assert match in capsys.readouterr().err
