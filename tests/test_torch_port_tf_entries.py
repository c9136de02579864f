"""The entry points that read TF checkpoints, on the CPU, from V2
checkpoints that TensorFlow writes here (``tf.raw_ops.SaveV2``; V1 files
are held to TensorFlow's reader in ``tests/test_torch_port_tf_bundle.py``)
in the reference's names (``chip_smoke.tf_darknet19_names``,
``chip_smoke.tf_resnet50_trunk_names``, the classifier's below) from
seeded port weights. A bundle is read once for the module (the entries'
reads after the first come from a cache of ``load_tf_checkpoint``):

- ``pascal_detect_darknet --tf-checkpoint``: the drawn boxes equal
  ``make_detect_fn``'s on the same weights as a state dict, exactly
  (the same forward and decode); ``load_detector_params``'s order (the
  given checkpoint, ``weights/darknet19_pascal.ckpt`` for the plain v1
  net only, the newest snapshot; the import itself patched to name its
  path); an imported anchor head ignores a stale ``anchors.json``;
- ``pascal_eval_map --tf-checkpoint`` at a patched 64²;
  ``pascal_train_darknet --tf-checkpoint`` at a patched 32² (S=1): the
  run starts from the imported weights (one Adam step at 1e-3 moves a
  weight by at most 1e-3);
- ``pascal_train_resnet`` and ``imagenet_train_resnet`` from
  ``weights/resnet_v1_50.ckpt`` at 32² / 64²: every trunk tensor
  warm-started (the frozen fine-tune's trunk stays equal to it bit for
  bit);
- ``train_classifier --checkpoint-path <TF prefix>`` and
  ``eval_classifier --tf-checkpoint`` on darknet19 at 64²;
- ``verify_released_ckpts``: with no bundle every artifact is skipped
  and it exits 0; a generated darknet19-Pascal bundle at a patched 64²
  passes its own golden check, and a moved score fails the check.

TensorFlow is imported lazily (``pytest.importorskip``).
"""

import contextlib
import functools
import io
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from tensorflow_yolo2_torch.compat import tf_import
from tensorflow_yolo2_torch.config import Paths, YoloConfig
from tensorflow_yolo2_torch.data.anchors import (
    save_anchors,
    v2_config_for_snapshot,
)
from tensorflow_yolo2_torch.data.augment import image_read
from tensorflow_yolo2_torch.entries import eval_classifier
from tensorflow_yolo2_torch.entries import imagenet_train_resnet as cls_train
from tensorflow_yolo2_torch.entries import pascal_detect_darknet as detect
from tensorflow_yolo2_torch.entries import pascal_eval_map
from tensorflow_yolo2_torch.entries import pascal_train_darknet
from tensorflow_yolo2_torch.entries import pascal_train_resnet
from tensorflow_yolo2_torch.entries import train_classifier
from tensorflow_yolo2_torch.entries import verify_released_ckpts as verify
from tensorflow_yolo2_torch.models.darknet import (
    Darknet19Classifier,
    Darknet19Detector,
    randomize_,
)
from tensorflow_yolo2_torch.models.resnet import ResNet50V1
from tensorflow_yolo2_torch.train.checkpoint import (
    SNAPSHOT_FILE,
    CheckpointManager,
    read_snapshot,
)
from tests import synthetic
from tests.test_torch_port_cls_cli import write_tree
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)

CPU = ["--device", "cpu", "--compute-dtype", "float32"]
DEMO = os.path.abspath("assets/demo.jpg")


def run(main, argv: list[str]) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def tf():
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    return pytest.importorskip("tensorflow")


def tf_save(tf, path: str, tensors: dict) -> str:
    names = sorted(tensors)
    tf.raw_ops.SaveV2(prefix=path, tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[tensors[n] for n in names])
    return path


def classifier_names(sd: dict) -> dict:
    """The reference classifier's flat ``darknet19`` scope: 19 convs,
    ``Variable_<2i>`` / ``Variable_<2i+1>``, ``batch_normalization_<i>``."""
    out = {}
    for i in range(19):
        module = f"backbone.conv{i + 1}" if i < 18 else "conv19"
        out[f"darknet19/Variable" + (f"_{2 * i}" if i else "")] = \
            chip_smoke._tf_array(sd[f"{module}.conv.weight"])
        out[f"darknet19/Variable_{2 * i + 1}"] = chip_smoke._tf_array(
            sd[f"{module}.conv.bias"])
        bn = "darknet19/batch_normalization" + (f"_{i}" if i else "")
        for tf_leaf, leaf in chip_smoke._TF_BN:
            out[f"{bn}/{tf_leaf}"] = chip_smoke._tf_array(
                sd[f"{module}.bn.{leaf}"])
    return out


def seeded(model, seed: int) -> dict:
    return randomize_(model, torch.Generator().manual_seed(seed)).state_dict()


@pytest.fixture(scope="module")
def bundles(tf, tmp_path_factory):
    root = tmp_path_factory.mktemp("tf_entries")
    det = seeded(Darknet19Detector(30), 1)
    cls = seeded(Darknet19Classifier(10), 3)
    trunk = chip_smoke.random_weights_(
        ResNet50V1(), torch.Generator().manual_seed(4)).state_dict()
    return {
        "root": root, "det": det, "cls": cls, "trunk": trunk,
        "det_v2": tf_save(tf, str(root / "det"),
                          chip_smoke.tf_darknet19_names(det)),
        "cls_v2": tf_save(tf, str(root / "cls"), classifier_names(cls)),
        "trunk_v2": tf_save(tf, str(root / "trunk"),
                            chip_smoke.tf_resnet50_trunk_names(trunk)),
    }


@pytest.fixture(scope="module", autouse=True)
def read_once():
    """``load_tf_checkpoint`` through a cache by the file read (a link to
    a bundle hits the same entry): the 184 MiB detector is read once."""
    cache, read = {}, tf_import.load_tf_checkpoint

    def cached(path):
        index = path + ".index" if os.path.exists(path + ".index") else path
        key = os.stat(index).st_ino
        if key not in cache:
            cache[key] = read(path)
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tf_import, "load_tf_checkpoint", cached)
        yield


def _equal(got: dict, want: dict) -> bool:
    return all(torch.equal(got[k], v) for k, v in want.items()
               if not k.endswith("num_batches_tracked"))


def test_detect_cli_from_a_tf_checkpoint(bundles, tmp_root, monkeypatch):
    drawn = []

    def record(path, boxes, scores, classes, names, out_path=None):
        drawn.append((boxes, scores, classes))
        return "recorded.png"

    monkeypatch.setattr(detect, "draw_detections", record)
    out = run(detect.main, [DEMO, "--tf-checkpoint", bundles["det_v2"],
                            "--nms", "--image-size", "64", "--threshold",
                            "0.0", "--device", "cpu"])
    assert f"Imported TF checkpoint {bundles['det_v2']}" in out
    yolo = YoloConfig(S=2, image_size=64)
    fn = detect.make_detect_fn(yolo, bundles["det"], object_thresh=0.0,
                               use_nms=True, device="cpu")
    want = [t[0].numpy() for t in fn(image_read(DEMO, 64)[None])]
    (got,) = drawn
    assert (want[1] > 0).sum() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_load_detector_params_order(tmp_root, monkeypatch):
    """The given checkpoint; else ``weights/darknet19_pascal.ckpt`` for
    the plain v1 ``darknet19`` only; else the newest snapshot. The import
    is patched to return the path it imports."""
    monkeypatch.setattr(tf_import, "import_darknet19_checkpoint",
                        lambda path, detection: path)
    monkeypatch.setattr(tf_import, "state_dict_for",
                        lambda path: {"imported": path})
    paths = Paths(str(tmp_root))
    v1, v2 = YoloConfig(), v2_config_for_snapshot(None, 416)
    with pytest.raises(FileNotFoundError, match="no snapshot under"):
        detect.load_detector_params(v1, paths=paths)
    for net in ("darknet19", "darknet19_sd", "darknet19_v2"):
        d = tmp_root / "ckpts" / net / "voc_2007" / "train_iter_5"
        d.mkdir(parents=True)
        torch.save({"model": {"snapshot": net}}, d / SNAPSHOT_FILE)
    assert detect.load_detector_params(v1, paths=paths) == {
        "snapshot": "darknet19"}
    released = str(tmp_root / "weights" / "darknet19_pascal.ckpt")
    os.makedirs(tmp_root / "weights")
    open(released + ".index", "w").close()
    assert detect.load_detector_params(v1, paths=paths) == {
        "imported": released}
    for yolo, net in ((v1, "darknet19_sd"), (v2, "darknet19_v2")):
        assert detect.load_detector_params(
            yolo, paths=paths, network_name=net) == {"snapshot": net}
    given = str(tmp_root / "given.ckpt")
    open(given, "w").close()  # a V1 file
    assert detect.load_detector_params(v1, given, paths=paths) == {
        "imported": given}


def test_imported_anchor_head_ignores_a_stale_anchors_json(tmp_path):
    save_anchors(str(tmp_path), ((1.0, 2.0),) * 5, 13)
    assert v2_config_for_snapshot(str(tmp_path), 416).anchors[0] == (1.0, 2.0)
    classic = v2_config_for_snapshot(None, 416).anchors
    assert v2_config_for_snapshot(str(tmp_path), 416,
                                  external_weights=True).anchors == classic


def test_eval_cli_from_a_tf_checkpoint(bundles, tmp_root, monkeypatch):
    synthetic.make_voc(str(tmp_root / "data" / "VOCdevkit"), n_images=2)
    monkeypatch.setattr(pascal_eval_map, "IMAGE_SIZE", 64)
    out = run(pascal_eval_map.main,
              ["--tf-checkpoint", bundles["det_v2"], "--image-set",
               "trainval", "--batch-size", "2", *CPU])
    assert f"Imported TF checkpoint {bundles['det_v2']}" in out
    assert "mAP@0.5 = " in out


def test_train_darknet_starts_from_the_checkpoint(bundles, tmp_root,
                                                  monkeypatch):
    synthetic.make_voc(str(tmp_root / "data" / "VOCdevkit"), n_images=2)
    monkeypatch.setattr(pascal_train_darknet, "YoloConfig",
                        functools.partial(YoloConfig, S=1, image_size=32))
    run(pascal_train_darknet.main,
        ["--tf-checkpoint", bundles["det_v2"], "--iters", "1",
         "--batch-size", "2", "--num-workers", "1", *CPU])
    snap = read_snapshot(CheckpointManager(
        "darknet19", "voc_2007", paths=Paths(str(tmp_root))).latest_path())
    moved = max((snap["model"][k] - v).abs().max().item()
                for k, v in bundles["det"].items()
                if k.endswith(("weight", "bias")))
    assert moved <= 1e-3 * 1.001  # one Adam step at 1e-3


def test_train_resnet_warm_starts_the_trunk(bundles, tmp_root, monkeypatch):
    weights = tmp_root / "weights"
    weights.mkdir()
    for suffix in (".index", ".data-00000-of-00001"):
        os.link(bundles["trunk_v2"] + suffix,
                str(weights / "resnet_v1_50.ckpt") + suffix)
    names = chip_smoke.tf_resnet50_trunk_names(bundles["trunk"])
    stats = sum(k.endswith(("moving_mean", "moving_variance"))
                for k in names)
    warm = f"Warm-started {len(names) - stats} param + {stats} batch-stat"
    synthetic.make_voc(str(tmp_root / "data" / "VOCdevkit"), n_images=2)
    monkeypatch.setattr(pascal_train_resnet, "YoloConfig",
                        functools.partial(YoloConfig, image_size=32))
    out = run(pascal_train_resnet.main,
              ["--iters", "1", "--batch-size", "2", "--num-workers", "1",
               "--learning-rate", "1e-6", *CPU])
    assert "Importing TF checkpoint" in out and warm in out
    write_tree(tmp_root / "data" / "ILSVRC")
    monkeypatch.setattr(cls_train, "IlsvrcCls", functools.partial(
        cls_train.IlsvrcCls, image_size=64))
    out = run(cls_train.main, ["--iters", "1", "--batch-size", "2",
                               "--eval-every", "0", "--num-workers", "1",
                               *CPU])
    assert warm in out
    snap = read_snapshot(CheckpointManager(
        "resnet50", "ilsvrc_2017_cls", save_by_epoch=True,
        paths=Paths(str(tmp_root))).latest_path())["model"]
    frozen = [k for k in bundles["trunk"] if k.endswith(".weight")
              or k.endswith(".bias")]
    assert all(torch.equal(snap[k], bundles["trunk"][k]) for k in frozen)


def test_classifier_clis_from_a_tf_checkpoint(bundles, tmp_root, capsys):
    common = ["--model-name", "darknet19", "--dataset-name", "synthetic",
              "--image-size", "64", "--batch-size", "2", *CPU]
    out = run(train_classifier.main,
              ["--checkpoint-path", bundles["cls_v2"], "--iters", "1",
               "--num-workers", "1", *common])
    assert "Warm-started 76 param + 38 batch-stat tensors" in out
    out = run(eval_classifier.main,
              ["--tf-checkpoint", bundles["cls_v2"], "--max-batches", "1",
               *common])
    assert "Imported 76 param + 38 batch-stat tensors" in out
    assert "accuracy" in out
    with pytest.raises(SystemExit):
        train_classifier.main(["--checkpoint-path", bundles["cls_v2"],
                               "--model-name", "lenet", "--image-size",
                               "28", "--dataset-name", "synthetic", *CPU])
    assert "no TF importer for 'lenet'" in capsys.readouterr().err


def test_verify_skips_absent_bundles(tmp_root):
    out = run(verify.main, ["--images", DEMO, "--device", "cpu"])
    assert out.count("SKIP ") == 3
    assert json.loads(out.split("VERIFY ")[1]) == {
        "ran": [], "skipped": ["darknet19_pascal", "darknet19_imagenet",
                               "resnet50_pascal"],
        "golden_ok": None, "ok": True}


def test_verify_golden_check(bundles, tmp_root, monkeypatch):
    monkeypatch.setattr(verify, "YoloConfig",
                        functools.partial(YoloConfig, S=2, image_size=64))
    argv = ["--darknet-pascal", bundles["det_v2"], "--images", DEMO,
            "--threshold", "0.0", "--device", "cpu"]
    golden = str(tmp_root / "golden.json")
    out = run(verify.main, argv + ["--golden-out", golden])
    assert "ARTIFACT " in out and "Wrote golden file" in out
    records = json.load(open(golden))["records"]
    assert records[0]["artifact"] == "darknet19_pascal" and \
        records[0]["scores"]
    out = run(verify.main, argv + ["--golden-check", golden])
    assert '"golden_ok": true' in out
    records[0]["scores"][0] += 0.01
    json.dump({"records": records}, open(golden, "w"))
    moved = verify._check_golden(verify.RESULT["records"], golden,
                                 tol_box=1.0, tol_score=1e-3)
    assert len(moved) == 1 and "max score delta" in moved[0]
