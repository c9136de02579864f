"""The port's VOC mAP evaluation against the JAX package on the CPU: the
evaluator, ``run_eval`` over the serving path, and the
``pascal_eval_map`` CLI on a snapshot of the port's own training CLI.

Tolerances: the evaluator is a copy of the JAX package's numpy code, so
its APs equal JAX's exactly on the same inputs. ``run_eval`` of the
float32 v1 detector at 224² (S=7: XLA compiles the interpreted Pallas
decode+NMS there in ~20 s, at S=2 or 5 in minutes): per-class APs within
1e-6, the detections being held to JAX's elsewhere (kept scores rtol
1e-4, ``test_torch_port_detect.py``); the ranking only changes if two
scores within 1e-4 of each other swap, which these weights do not make.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import config as pt_config
from tensorflow_yolo2_torch.data import voc as pt_voc
from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pt_detect
from tensorflow_yolo2_torch.entries import pascal_eval_map as pt_eval
from tensorflow_yolo2_torch.eval import VocMapEvaluator
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.entries import pascal_detect_darknet as jx_detect
from tensorflow_yolo2_tpu.entries import pascal_eval_map as jx_eval
from tensorflow_yolo2_tpu.eval import VocMapEvaluator as JxVocMapEvaluator
from tensorflow_yolo2_tpu.models.darknet import Darknet19Detector
from tests import synthetic
from tests.test_torch_port_models import random_variables

THRESH = 0.005  # pascal_eval_map's default


def _grids(rng, n_images, per_slot, cfg):
    """Seeded label grids (v1 or per-slot) at 224² and the corner boxes
    and classes behind them."""
    out = []
    for _ in range(n_images):
        n = rng.randint(1, 6)
        xy = rng.uniform(0, 170, (n, 2))
        wh = rng.uniform(10, 100, (n, 2))
        corners = np.concatenate([xy, np.minimum(xy + wh, 223)],
                                 1).astype(np.float32)
        cls = rng.randint(0, 4, n).astype(np.int32)
        if per_slot:
            grid = pt_voc.build_label_grid_v2(corners, cls, cfg.S, cfg.B,
                                              cfg.anchors, 20, 224.0)
        else:
            grid = pt_voc.build_label_grid(corners, cls, cfg.S, 20, 224.0)
        out.append((grid, corners / 224.0, cls))
    return out


@pytest.mark.parametrize("use_07", [False, True], ids=["all_points", "voc07"])
@pytest.mark.parametrize("per_slot", [False, True], ids=["v1", "per_slot"])
def test_evaluator_matches_jax(per_slot, use_07):
    """Detections jittered around the ground truth (hits, near misses,
    duplicates, wrong classes, masked slots) and label grids: the same
    APs, exactly, through ``add_label_grid``."""
    rng = np.random.RandomState(3 + per_slot)
    cfg = (pt_config.yolo_v2_config(224) if per_slot
           else pt_config.YoloConfig())
    ours = VocMapEvaluator(20, use_07_metric=use_07)
    theirs = JxVocMapEvaluator(20, use_07_metric=use_07)
    for image_id, (grid, boxes, cls) in enumerate(_grids(rng, 12, per_slot,
                                                        cfg)):
        dets = np.concatenate([boxes + rng.normal(0, 0.03, boxes.shape),
                               rng.uniform(0, 1, (6, 4))]).astype(np.float32)
        scores = rng.uniform(0, 1, len(dets)).astype(np.float32)
        scores[rng.rand(len(dets)) < 0.2] = 0.0
        classes = np.concatenate([cls, rng.randint(0, 4, 6)])
        classes[rng.rand(len(classes)) < 0.2] = 5
        for ev in (ours, theirs):
            ev.add_label_grid(image_id, dets, scores, classes, grid, 224)
    got, want = ours.mean_ap(), theirs.mean_ap()
    assert got == want
    assert len(got[1]) >= 3 and 0 < got[0] < 1


def _v1_weights():
    """Seeded float32 weights of the v1 detector whose output BN makes
    every cell predict a dog (class 11) with a box of ~0.2 × 0.2 near the
    cell's centre and a varied confidence, so that the APs are not 0."""
    v = random_variables(Darknet19Detector(output_channels=30),
                         (1, 224, 224, 3), seed=21)
    bn = v["params"]["detection"]["output"]["bn"]
    bn["scale"][:] = 0.05
    bn["bias"][:20] = 0.2
    bn["bias"][11] = 1.0
    bn["bias"][20:22] = 0.4
    bn["scale"][20:22] = 0.3
    bn["bias"][22:30] = (0.5, 0.5, 0.45, 0.45, 0.5, 0.5, 0.35, 0.35)
    return v["params"], v["batch_stats"]


def test_run_eval_matches_jax(tmp_path):
    """v1 at 224²: the port's ``run_eval`` on the port's detect function
    and JAX's ``run_eval`` on JAX's, float32, the same weights, the same
    batches of one synthetic VOC split (two loaders from one seed)."""
    voc = synthetic.make_voc(str(tmp_path / "VOCdevkit"), n_images=6)
    params, stats = _v1_weights()
    pcfg, jcfg = pt_config.YoloConfig(), jx_config.YoloConfig()

    def imdb():
        return pt_voc.PascalVOC(
            "trainval", batch_size=3, data_path=voc,
            paths=pt_config.Paths(root=str(tmp_path)),
            rng=np.random.RandomState(5))

    ours = pt_eval.run_eval(
        pt_detect.make_detect_fn(pcfg, params, stats, THRESH, use_nms=True,
                                 dtype=torch.float32, device="cpu"),
        imdb(), pcfg)
    theirs = jx_eval.run_eval(
        jx_detect.make_detect_fn(jcfg, params, stats, THRESH, use_nms=True,
                                 dtype=jnp.float32),
        imdb(), jcfg)
    assert set(ours[1]) == set(theirs[1])
    for cls in theirs[1]:
        assert abs(ours[1][cls] - theirs[1][cls]) <= 1e-6, cls
    assert abs(ours[0] - theirs[0]) <= 1e-6
    assert ours[1][11] > 0  # dogs are found


def test_run_eval_v2p_per_slot_matches_jax_evaluator(tmp_path):
    """The v2p detector's detections on a per-slot VOC split, fed to the
    port's evaluator (``run_eval``) and to JAX's: equal APs."""
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19DetectorV2,
        randomize_,
    )

    voc = synthetic.make_voc(str(tmp_path / "VOCdevkit"), n_images=4)
    cfg = pt_config.yolo_v2_config(224)
    state = randomize_(Darknet19DetectorV2(cfg.cell_channels),
                       torch.Generator().manual_seed(2)).state_dict()
    state["detection.output.conv.weight"] *= 0.1
    detect = pt_detect.make_detect_fn(cfg, state, object_thresh=THRESH,
                                      use_nms=True, dtype=torch.float32,
                                      device="cpu", v2=True,
                                      passthrough=True)
    seen = []

    def recording(images):
        dets = detect(images)
        seen.append([t.numpy() for t in dets])
        return dets

    imdb = pt_voc.PascalVOC("trainval", batch_size=2, data_path=voc, yolo=cfg,
                            paths=pt_config.Paths(root=str(tmp_path)),
                            rng=np.random.RandomState(1))
    ours = pt_eval.run_eval(recording, imdb, cfg)
    again = pt_voc.PascalVOC("trainval", batch_size=2, data_path=voc,
                             yolo=cfg,
                             paths=pt_config.Paths(root=str(tmp_path)),
                             rng=np.random.RandomState(1))
    theirs = JxVocMapEvaluator(20)
    for b, (boxes, scores, classes) in enumerate(seen):
        _, labels = again.get()
        assert labels.shape == (2, 7, 7, 5, 25)
        for i in range(2):
            theirs.add_label_grid(2 * b + i, boxes[i], scores[i], classes[i],
                                  labels[i], 224)
    assert ours == theirs.mean_ap()
    assert (np.concatenate([s[1] for s in seen]) > 0).sum() > 0


def test_eval_cli_on_a_trained_v2p_snapshot(tmp_root, capsys):
    """``pascal_train_darknet --v2 --passthrough`` writes a snapshot;
    ``pascal_eval_map --v2 --passthrough`` finds it, decodes with its
    anchors.json and prints the APs and the mAP."""
    from tensorflow_yolo2_torch.entries import pascal_train_darknet

    synthetic.make_voc(str(tmp_root / "data" / "VOCdevkit"), n_images=2)
    cli = ["--batch-size", "2", "--num-workers", "1", "--device", "cpu",
           "--v2", "--passthrough"]
    assert pascal_train_darknet.main(["--iters", "1", "--multiscale", "64"]
                                     + cli) == 0
    capsys.readouterr()
    assert pt_eval.main(["--image-set", "trainval", "--batch-size", "2",
                         "--device", "cpu", "--compute-dtype", "float32",
                         "--v2", "--passthrough"]) == 0
    out = capsys.readouterr().out
    assert "darknet19_v2p/voc_2007/train_iter_1" in out
    assert "AP[" in out and "mAP@0.5 = " in out


def test_eval_cli_on_npz_weights(tmp_root, capsys):
    """v1 from ``--weights NPZ`` (the detect CLI's carrier)."""
    from tensorflow_yolo2_torch import convert

    synthetic.make_voc(str(tmp_root / "data" / "VOCdevkit"), n_images=2)
    params, stats = _v1_weights()
    npz = str(tmp_root / "v1.npz")
    convert.save_npz(npz, params, stats)
    assert pt_eval.main(["--image-set", "trainval", "--batch-size", "2",
                         "--device", "cpu", "--weights", npz,
                         "--use-07-metric"]) == 0
    assert "mAP@0.5 = " in capsys.readouterr().out


def test_eval_cli_without_a_snapshot_names_the_dir(tmp_root):
    synthetic.make_voc(str(tmp_root / "data" / "VOCdevkit"), n_images=1)
    with pytest.raises(FileNotFoundError, match="darknet19_v2"):
        pt_eval.main(["--device", "cpu", "--v2"])


@pytest.mark.parametrize("argv,match", [
    (["--int8", "--v2", "--passthrough"], "passthrough head's concat"),
    (["--tf-checkpoint", "x.ckpt"], "--tf-checkpoint x.ckpt: no TF "
                                    "checkpoint there"),
    (["--passthrough"], "requires --v2"),
])
def test_eval_cli_refuses(tmp_root, capsys, argv, match):
    import re

    with pytest.raises(SystemExit):
        pt_eval.main(argv + ["--device", "cpu"])
    assert re.search(match, capsys.readouterr().err)
