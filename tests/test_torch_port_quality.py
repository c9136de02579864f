"""The port's quality program (``entries.quality_curve``,
``entries.int8_quality``, ``data.synthetic``) on the CPU: its fixture
against the repository's, the stage program's contract, and its v1
and plain v2 scoring against the JAX package's.

Tolerances: the fixtures are byte-identical (the same seeds, draws and
cv2 writes). The v1 eval row: the port's float32 detector and JAX's
from the same seeded weights (``convert.py`` carries them across), each
package's ``run_eval`` over the same 3 val images against the per-slot
ground truth, mAP within 1e-6 (the detections are held to JAX's
elsewhere: kept scores rtol 1e-4, ``test_torch_port_detect.py``; the
ranking only changes if two scores within 1e-4 swap). The plain v2 row
likewise, with the priors of an ``anchors.json`` that both packages
read. JAX runs at S=7, where its tests run the interpreted decode+NMS on
the CPU.
"""

import argparse
import hashlib
import json
import os
import shutil

import jax.numpy as jnp
import pytest
import torch

from tensorflow_yolo2_torch import config as pt_config
from tensorflow_yolo2_torch.data import synthetic as pt_synthetic
from tensorflow_yolo2_torch.entries import int8_quality
from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pt_detect
from tensorflow_yolo2_torch.entries import pascal_train_darknet
from tensorflow_yolo2_torch.entries import quality_curve as qc
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.data.voc import PascalVOC as JxPascalVOC
from tensorflow_yolo2_tpu.entries import pascal_detect_darknet as jx_detect
from tensorflow_yolo2_tpu.entries import pascal_eval_map as jx_eval
from tensorflow_yolo2_tpu.models.darknet import Darknet19Detector
from tests import synthetic
from tests.test_torch_port_models import random_variables
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)

# the program at its smallest: 2 images a batch everywhere, 6 train / 3
# val images, a 1-iteration pretrain on 2 images a synset
TINY = ["--batch", "2", "--n-train", "6", "--n-val", "3",
        "--pretrain-iters", "1", "--eval-max-images", "4", "--device", "cpu"]


def tree_digest(root: str) -> dict[str, str]:
    """sha256 of every file under ``root``, by relative path."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@pytest.mark.parametrize("fixture", ["voc_hard", "cls_pretrain"])
def test_fixture_is_byte_identical(tmp_path, fixture):
    """``data.synthetic`` writes the trees of ``tests/synthetic.py``."""
    trees = {}
    for name, module in (("port", pt_synthetic), ("tests", synthetic)):
        root = str(tmp_path / name)
        if fixture == "voc_hard":
            module.make_voc_hard(root, n_train=6, n_val=3)
        else:
            module.make_cls_pretrain(root, per_class=3, n_val=4)
        trees[name] = tree_digest(root)
    assert len(trees["port"]) == (9 * 2 + 2 if fixture == "voc_hard"
                                  else 12 + 1 + 4 * 2)
    assert trees["port"] == trees["tests"]


def stage_lines(out: str) -> list[dict]:
    return [json.loads(line[len("STAGE "):]) for line in out.splitlines()
            if line.startswith("STAGE ")]


@pytest.fixture()
def snapshots_removed(tmp_root):
    """The run root, its snapshots (~0.6 GB a detector's with Adam's
    slots) removed after the test: pytest keeps the temporary dirs of its
    last runs."""
    yield tmp_root
    shutil.rmtree(tmp_root / "ckpts", ignore_errors=True)


def test_stage_program_contract(snapshots_removed, capsys, monkeypatch):
    """``--stages 2,3`` pretrains, trains 2 then 1 iterations and scores
    each stage; the same command again trains nothing; ``--stages 4``
    trains 1 iteration from the step-3 snapshot. Every stage trains with
    a seed of its own (the base plus its first iteration)."""
    tmp_root = snapshots_removed
    monkeypatch.setattr(qc, "PRETRAIN_BATCH", 2)
    monkeypatch.setattr(qc, "EVAL_BATCH", 2)
    pt_synthetic.make_cls_pretrain(
        str(tmp_root / "data" / "ILSVRC"), per_class=2, n_val=2)
    calls = []
    train = pascal_train_darknet.main

    def recording(argv):
        calls.append(argv)
        return train(argv)

    monkeypatch.setattr(pascal_train_darknet, "main", recording)

    def iters_and_seeds():
        return [(int(a[a.index("--iters") + 1]), int(a[a.index("--seed") + 1]))
                for a in calls]

    assert qc.main(["--stages", "2,3"] + TINY) == 0
    out = capsys.readouterr().out
    rows = stage_lines(out)
    assert [r["iters"] for r in rows] == [2, 3]
    for r in rows:
        assert set(r) == {"iters", "map_train", "map_val"}
        assert 0.0 <= r["map_train"] <= 1.0 and 0.0 <= r["map_val"] <= 1.0
    assert "| iters | train mAP@0.5 | val mAP@0.5 |" in out
    assert "Warm-started" in out  # from the pretrain's snapshot
    assert CheckpointManager("darknet19", "ilsvrc_2017_cls",
                             save_by_epoch=True).latest_step() is not None
    assert iters_and_seeds() == [(2, 1), (1, 3)]

    assert qc.main(["--stages", "2,3"] + TINY) == 0
    out = capsys.readouterr().out
    assert "pretrain snapshot present; skipping" in out
    assert "stage 3 already trained (at 3); skipping" in out
    assert stage_lines(out) == [] and len(calls) == 2

    assert qc.main(["--stages", "4"] + TINY) == 0
    out = capsys.readouterr().out
    assert [r["iters"] for r in stage_lines(out)] == [4]
    assert iters_and_seeds()[2:] == [(1, 4)]
    assert CheckpointManager("darknet19", "voc_2007").all_steps() == [2, 3, 4]
    seeds = [s for _, s in iters_and_seeds()]
    assert len(set(seeds)) == len(seeds)


class _Built(Exception):
    """Raised in place of the trainer, once the entry has built its
    model."""


@pytest.mark.parametrize("head", ["v1", "v2", "v2p"])
def test_stage_flags_reach_the_model_and_the_priors(tmp_root, monkeypatch,
                                                    head):
    """A stage's ``pascal_train_darknet`` (``quality_curve.train_argv``)
    builds every BatchNorm of the head with ``--bn-momentum 0.9``; an
    anchor head's ``--anchors kmeans`` writes JAX's IoU k-means priors of
    the fixture to ``anchors.json``, and the program decodes with them."""
    from tensorflow_yolo2_torch.models.layers import BatchNorm
    from tensorflow_yolo2_tpu.data import anchors as jx_anchors

    voc = pt_synthetic.make_voc_hard(str(tmp_root / "data" / "VOCdevkit"),
                                     n_train=12, n_val=3)
    built = []

    def trainer(model, *args, **kwargs):
        built.append(model)
        raise _Built

    monkeypatch.setattr(pascal_train_darknet, "Trainer", trainer)
    v2 = head != "v1"
    program = argparse.Namespace(
        batch=2, bn_momentum=0.9, v2=v2, passthrough=head == "v2p",
        anchors="kmeans", multiscale=None, grad_clip=5.0, lr_decay=None,
        device="cpu")
    with pytest.raises(_Built):
        pascal_train_darknet.main(qc.train_argv(program, 1, 1))
    norms = [m for m in built[0].modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(norms) >= 18
    assert all(isinstance(m, BatchNorm) and m.flax_momentum == 0.9
               for m in norms)
    if v2:
        net = qc.curve_net(True, head == "v2p")
        want, _ = jx_anchors.iou_kmeans(jx_anchors.collect_voc_wh_cells(
            voc, "trainval", 7, 224), 5)
        got = qc.snapshot_yolo(pt_config.Paths(), net, True).anchors
        assert got == tuple((float(w), float(h)) for w, h in want)
        assert got != pt_config.yolo_v2_config(224).anchors


def test_int8_quality_refuses_passthrough_without_v2(capsys):
    with pytest.raises(SystemExit):
        int8_quality.main(["--passthrough", "--device", "cpu"])
    assert "--passthrough requires --v2" in capsys.readouterr().err


# the v1 output BatchNorm's scale and bias for the scoring check, set so
# that the seeded trunk's normalized outputs (measured on the 3 val
# images) spread the kept boxes over ~0.2-0.4 of the image around each
# cell, with confidences ~0.5 ± 0.2 and cars, dogs and persons (the
# fixture's classes 6, 11, 14) ahead of the other classes
OUTPUT_BN_SCALE = (
    0.08, 0.13, 0.096, 0.096, 0.067, 0.143, 0.425, 0.098, 0.097, 0.117,
    0.078, 0.754, 0.088, 0.084, 0.337, 0.106, 0.093, 0.083, 0.076, 0.124,
    0.153, 0.469, 0.763, 0.762, 0.239, 0.371, 0.308, 0.547, 0.303, 0.285)
OUTPUT_BN_BIAS = (
    0.007, 0.11, 0.0, 0.009, 0.148, 0.102, 0.497, 0.001, 0.029, 0.12,
    0.124, 0.375, 0.111, 0.164, 0.573, 0.085, 0.085, 0.002, 0.052, 0.108,
    0.944, 0.258, 0.474, 0.045, 0.086, 0.257, 1.24, 0.938, 0.471, 0.363)


def v1_weights():
    """Seeded float32 weights of the v1 detector whose output BatchNorm
    keeps boxes of varied size and place (``OUTPUT_BN_*``), so that some
    match the val images' objects and the mAP is not 0."""
    v = random_variables(Darknet19Detector(output_channels=30),
                         (1, 224, 224, 3), seed=31)
    bn = v["params"]["detection"]["output"]["bn"]
    bn["scale"][:] = OUTPUT_BN_SCALE
    bn["bias"][:] = OUTPUT_BN_BIAS
    return v["params"], v["batch_stats"]


def test_v1_eval_row_matches_jax(tmp_root, monkeypatch):
    """The port's v1 scoring (``quality_curve.score`` against the
    per-slot ground truth) equals JAX's ``run_eval`` of JAX's detect
    function over ``PascalVOC("test", yolo=yolo_v2_config(224))``."""
    pt_synthetic.make_voc_hard(str(tmp_root / "data" / "VOCdevkit"),
                               n_train=6, n_val=3)
    params, stats = v1_weights()
    monkeypatch.setattr(qc, "EVAL_BATCH", 3)
    ours = qc.score(
        pt_detect.make_detect_fn(pt_config.YoloConfig(), params, stats,
                                 qc.EVAL_THRESH, use_nms=True,
                                 dtype=torch.float32, device="cpu"),
        pt_config.yolo_v2_config(224), "test")
    gt = jx_config.yolo_v2_config(224)
    imdb = JxPascalVOC(  # its own label cache
        "test", batch_size=3, yolo=gt,
        data_path=str(tmp_root / "data" / "VOCdevkit" / "VOC2007"),
        paths=jx_config.Paths(root=str(tmp_root / "jax")))
    theirs, aps = jx_eval.run_eval(
        jx_detect.make_detect_fn(jx_config.YoloConfig(), params, stats,
                                 qc.EVAL_THRESH, use_nms=True,
                                 dtype=jnp.float32), imdb, gt)
    assert abs(ours - float(theirs)) <= 1e-6
    assert sorted(aps) == [6, 11, 14]  # the val images' classes
    assert ours > 0  # some boxes match


# the plain v2 output conv for the scoring check: the seeded kernel
# scaled down so that each slot's box stays near its cell centre and its
# prior's size, confidences ~0.5, and cars, dogs and persons (the
# fixture's classes 6, 11, 14) ahead of the other classes
V2_KERNEL_SCALE = 0.05
V2_CLASS_BIAS = {6: 3.0, 11: 3.0, 14: 3.0}


def v2_weights():
    """Seeded float32 weights of the plain v2 detector (``--v2``, linear
    output, B=5, C=20) with the output conv of ``V2_*``."""
    v = random_variables(Darknet19Detector(output_channels=125,
                                           bn_on_output=False),
                         (1, 224, 224, 3), seed=37)
    out = v["params"]["detection"]["output"]["conv"]
    out["kernel"] *= V2_KERNEL_SCALE
    out["bias"][:] = 0.0
    for b in range(5):
        for c, bias in V2_CLASS_BIAS.items():
            out["bias"][b * 25 + 5 + c] = bias
    return v["params"], v["batch_stats"]


def test_v2_eval_row_matches_jax(tmp_root, monkeypatch):
    """The port's plain v2 scoring as ``quality_curve`` does it (priors
    from the snapshot dir's ``anchors.json``, written by
    ``persist_anchors``: JAX's k-means of the fixture; ``snapshot_yolo``;
    ``score`` against the per-slot ground truth of those priors) equals
    JAX's ``run_eval`` of JAX's v2 detect function with the priors JAX's
    ``v2_config_for_snapshot`` reads from the same file."""
    from tensorflow_yolo2_torch.data.anchors import persist_anchors
    from tensorflow_yolo2_tpu.data import anchors as jx_anchors

    voc = pt_synthetic.make_voc_hard(str(tmp_root / "data" / "VOCdevkit"),
                                     n_train=6, n_val=3)
    priors, _ = jx_anchors.iou_kmeans(
        jx_anchors.collect_voc_wh_cells(voc, "trainval", 7, 224), 5)
    paths = pt_config.Paths()
    net = qc.curve_net(True, False)
    assert persist_anchors(os.path.join(paths.ckpts, net, "voc_2007"),
                           priors, 7, has_snapshots=False) is not None
    yolo = qc.snapshot_yolo(paths, net, True)
    params, stats = v2_weights()
    monkeypatch.setattr(qc, "EVAL_BATCH", 3)
    ours = qc.score(
        pt_detect.make_detect_fn(yolo, params, stats, qc.EVAL_THRESH,
                                 use_nms=True, dtype=torch.float32,
                                 device="cpu", v2=True), yolo, "test")
    jyolo = jx_anchors.v2_config_for_snapshot(
        net, "voc_2007", 224, paths=jx_config.Paths(root=str(tmp_root)))
    assert jyolo.anchors == yolo.anchors != \
        pt_config.yolo_v2_config(224).anchors
    imdb = JxPascalVOC(  # its own label cache
        "test", batch_size=3, yolo=jyolo,
        data_path=str(tmp_root / "data" / "VOCdevkit" / "VOC2007"),
        paths=jx_config.Paths(root=str(tmp_root / "jax")))
    theirs, aps = jx_eval.run_eval(
        jx_detect.make_detect_fn(jyolo, params, stats, qc.EVAL_THRESH,
                                 use_nms=True, dtype=jnp.float32, v2=True),
        imdb, jyolo)
    assert abs(ours - float(theirs)) <= 1e-6
    assert sorted(aps) == [6, 11, 14]  # the val images' classes
    assert ours > 0  # some boxes match
