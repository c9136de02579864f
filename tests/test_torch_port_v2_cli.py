"""The port's training CLI for the YOLOv2 heads on the CPU, on synthetic
VOC trees: ``--v2``, ``--passthrough``, ``--anchors kmeans``,
``--multiscale`` and ``--profile-dir`` train, write snapshots and
anchors.json and resume; the JAX package's flag errors and the options
that wait for a later queue item are refused; the profiling helpers
against the JAX package's.

The steps run at 64² (``--multiscale 64``): the flags, not the widths,
are under test here (the full-depth v2 / v2p steps are held to JAX in
``test_torch_port_v2_train.py``).
"""

import json
import os
import re

import pytest
import torch

from tensorflow_yolo2_torch.config import yolo_v2_config
from tensorflow_yolo2_torch.data import anchors as pt_anchors
from tensorflow_yolo2_torch.data import voc as pt_voc
from tensorflow_yolo2_torch.train.checkpoint import read_snapshot
from tests import synthetic

CLI = ["--batch-size", "2", "--num-workers", "1", "--device", "cpu",
       "--log-every", "1"]


def test_train_cli_v2p_kmeans_snapshots_and_resumes(tmp_root, capsys):
    """``--v2 --passthrough --anchors kmeans``: the dimension clusters of
    the image set go to anchors.json before the first step, the per-slot
    loss trains, snapshots are written and resumed, and the serving
    config of the snapshot dir decodes with those priors."""
    from tensorflow_yolo2_torch.entries import pascal_train_darknet

    voc = synthetic.make_voc(str(tmp_root / "data" / "VOCdevkit"),
                             n_images=3)
    # the clusters come from the 224² config's grid; the steps run at 64²
    argv = ["--v2", "--passthrough", "--anchors", "kmeans",
            "--num-anchors", "4", "--multiscale", "64"] + CLI
    assert pascal_train_darknet.main(["--iters", "2", "--save-every", "2"]
                                     + argv) == 0
    out = capsys.readouterr().out
    assert "dimension clusters (k=4" in out and "burnin_loss" in out
    ckpts = tmp_root / "ckpts" / "darknet19_v2p" / "voc_2007"
    assert (ckpts / "train_iter_2").is_dir()
    wh = pt_anchors.collect_voc_wh_cells(voc, "trainval", 7, 224)
    priors = pt_anchors.iou_kmeans(wh, 4)[0]
    assert pt_anchors.load_anchors(str(ckpts), 7) == \
        tuple(tuple(float(v) for v in p) for p in priors)

    assert pascal_train_darknet.main(["--iters", "1"] + argv) == 0
    assert "Restored snapshot at iter 2" in capsys.readouterr().out
    snap = read_snapshot(str(ckpts / "train_iter_3"))
    assert snap["step"] == 3 and snap["yolo"]["B"] == 4
    assert snap["yolo"]["per_slot_classes"]
    assert snap["model"]["detection.output.conv.weight"].shape[0] == 4 * 25
    assert any(k.startswith("detection.passthrough") for k in snap["model"])
    cfg = pt_anchors.v2_config_for_snapshot(str(ckpts), 224)
    assert cfg.B == 4 and cfg.anchors == pt_anchors.load_anchors(
        str(ckpts), 7)


def test_multiscale_batches_hop_every_ten():
    from tensorflow_yolo2_torch.entries.pascal_train_darknet import (
        MULTISCALE_HOP,
        multiscale_batches,
    )

    class Fake:
        def __init__(self, size):
            self.size = size

        def get(self):
            return self.size

    get = multiscale_batches({64: Fake(64), 96: Fake(96)}, seed=0)
    seen = [get() for _ in range(8 * MULTISCALE_HOP)]
    runs = [seen[i:i + MULTISCALE_HOP]
            for i in range(0, len(seen), MULTISCALE_HOP)]
    assert all(len(set(r)) == 1 for r in runs)
    assert set(seen) == {64, 96}
    again = multiscale_batches({64: Fake(64), 96: Fake(96)}, seed=0)
    assert [again() for _ in range(len(seen))] == seen


def test_train_cli_v2_multiscale_profile_and_classic_anchors(tmp_root,
                                                             monkeypatch):
    """``--v2`` (the linear-output head) with ``--multiscale 64,96``, a
    size drawn every batch (the hop shortened from 10 to 1) with a seed
    whose first two draws differ: each size's labels at its own grid
    (S=2, S=3) and in a cache file of its own, both sizes trained; the
    classic priors in anchors.json; ``--bn-momentum`` reaching the
    BatchNorms; ``--profile-dir`` writing a Chrome trace of the loop."""
    from tensorflow_yolo2_torch.entries import pascal_train_darknet

    synthetic.make_voc(str(tmp_root / "data" / "VOCdevkit"), n_images=2)
    shapes = []

    class Recording(pt_voc.PascalVOC):
        def get(self):
            images, labels = super().get()
            shapes.append((images.shape[1], labels.shape[1:4]))
            return images, labels

    monkeypatch.setattr(pascal_train_darknet, "PascalVOC", Recording)
    monkeypatch.setattr(pascal_train_darknet, "MULTISCALE_HOP", 1)
    trace_dir = tmp_root / "trace"
    assert pascal_train_darknet.main(
        ["--v2", "--multiscale", "64,96", "--iters", "2", "--seed", "4",
         "--bn-momentum", "0.9", "--profile-dir", str(trace_dir)]
        + CLI) == 0
    assert shapes[:2] == [(64, (2, 2, 5)), (96, (3, 3, 5))]
    caches = os.listdir(tmp_root / "cache")
    for tag in ("_64x2_slots5", "_96x3_slots5"):
        assert any(c.startswith("pascal_trainval_gt_labels" + tag)
                   for c in caches), caches
    ckpts = tmp_root / "ckpts" / "darknet19_v2" / "voc_2007"
    assert pt_anchors.load_anchors(str(ckpts), 7) == \
        yolo_v2_config(224).anchors
    snap = read_snapshot(str(ckpts / "train_iter_2"))
    # two steps from mean 0, variance 1 at momentum 0.9
    var = snap["model"]["detection.conv1.bn.running_var"]
    assert float((var - 1.0).abs().max()) > 0.01
    assert "detection.output.bn.weight" not in snap["model"]
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(traces) == 1
    with open(trace_dir / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


@pytest.mark.parametrize("passthrough", [False, True], ids=["v2", "v2p"])
def test_profiling_helpers_match_jax(passthrough):
    """``conv_flops_per_image`` equals the JAX package's count on the
    detector's own schedule (v1 / ``--v2`` head) and the FLOPs of every
    conv the port's detector runs, counted by hooks at 64² and 96²."""
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Detector,
        Darknet19DetectorV2,
    )
    from tensorflow_yolo2_torch.utils import profiling as pt_prof
    from tensorflow_yolo2_tpu.models.darknet import _DARKNET19_SCHEDULE
    from tensorflow_yolo2_tpu.utils import profiling as jx_prof

    channels = yolo_v2_config(64).cell_channels
    if not passthrough:
        for size in (224, 416, 448):
            assert pt_prof.conv_flops_per_image(size, 30) == \
                jx_prof.conv_flops_per_image(
                    size, _DARKNET19_SCHEDULE + ((3, 1024),) * 3 +
                    ((1, 30),))
    net = (Darknet19DetectorV2(channels) if passthrough else
           Darknet19Detector(channels)).eval()
    flops = []

    def count(conv, _, out):
        k = conv.kernel_size[0] * conv.kernel_size[1]
        flops.append(2.0 * out[0].numel() * k * conv.in_channels)

    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(count)
    for size in (64, 96):
        flops.clear()
        with torch.no_grad():
            net(torch.zeros(1, size, size, 3))
        assert sum(flops) == pt_prof.conv_flops_per_image(
            size, channels, passthrough=passthrough)
    assert (pt_prof.BF16_FLOPS_PER_S, pt_prof.F32_OPS_PER_S) == \
        (989e12, 67e12)  # the H100's, no other chip's


@pytest.mark.parametrize("argv,match", [
    (["--passthrough"], "requires --v2"),
    (["--multiscale", "64,96"], "requires --v2"),
    (["--anchors", "kmeans"], "requires --v2"),
    (["--v2", "--multiscale", "64,100"], "multiples of 32"),
    (["--spatial", "2"], "--spatial 2 runs one process a shard: start it "
                         "with torchrun --nproc-per-node 2"),
    (["--spatial", "1"], "needs N >= 2"),
    (["--spatial", "2", "--v2", "--multiscale", "64,96"],
     "not --multiscale/--uint8-transfer"),
    (["--tf-checkpoint", "x.ckpt"], "--tf-checkpoint x.ckpt: no TF "
                                    "checkpoint there"),
])
def test_train_cli_refuses(tmp_root, capsys, argv, match):
    """The JAX package's flag errors, and a spatial run started without
    its ranks: refused before any data is read."""
    from tensorflow_yolo2_torch.entries import pascal_train_darknet

    with pytest.raises(SystemExit):
        pascal_train_darknet.main(argv + CLI)
    assert re.search(match, capsys.readouterr().err)
