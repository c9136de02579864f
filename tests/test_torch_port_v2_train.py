"""The port's YOLOv2 training path against the JAX package on the CPU: the
anchor loss and its task, the per-slot label grid and the VOC loader,
the dimension clusters and the anchors file, and whole v2 and v2p train
steps of Darknet19 (the training CLI's anchor flags are in
``test_torch_port_v2_cli.py``, a file of its own so that ``--dist
loadfile`` can run it beside the float64 steps).

Tolerances, each with its reason:

- ``yolo_v2_loss`` (value, terms) and its gradient w.r.t. the grid: rtol
  1e-5, float32 on both sides with sums in another order; atol 1e-6 on
  the gradient, whose elements reach ~10 and cancel near 0.
- ``build_label_grid_v2``, the VOC loader, ``collect_voc_wh_cells``, the
  anchors file: exact (the same numpy arithmetic). ``iou_kmeans``:
  1e-9 in float64 (measured: equal).
- whole train steps, float64, one step of each head from the same
  state (see ``v2_train_step_run``): losses and metrics rtol 1e-6, as
  the loss is float32 on both sides (measured ≤ 2.1e-7); each gradient
  tensor 1e-6 relative norm, as the float32 loss's gradient w.r.t. the
  grid (last bits differ between the two libraries) feeds the float64
  backward; BatchNorm statistics 1e-7 relative norm and atol 1e-8 on
  the running means, the v1 step's bounds; parameters: in each tensor,
  the v1 step's rtol 1e-7, atol 1e-6·lr on all but max(1, 1e-4) of the
  elements, and 2·lr (Adam's step flipped) on the rest and on the conv
  biases in front of BN, whose true gradient is 0.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import config as pt_config
from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
    yolo_v2_config,
)
from tensorflow_yolo2_torch.data import anchors as pt_anchors
from tensorflow_yolo2_torch.data import voc as pt_voc
from tensorflow_yolo2_torch.losses.yolo_v2 import yolo_v2_loss, yolo_v2_task
from tensorflow_yolo2_torch.models.darknet import (
    Darknet19Detector,
    Darknet19DetectorV2,
)
from tensorflow_yolo2_torch.train.checkpoint import load_into
from tensorflow_yolo2_torch.train.trainer import Trainer
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.data import anchors as jx_anchors
from tensorflow_yolo2_tpu.data import voc as jx_voc
from tensorflow_yolo2_tpu.losses.yolo_v2 import yolo_v2_loss as jx_v2_loss
from tensorflow_yolo2_tpu.losses.yolo_v2 import yolo_v2_task as jx_v2_task
from tensorflow_yolo2_tpu.models import darknet as jx_darknet
from tensorflow_yolo2_tpu.parallel import MeshConfig, make_mesh
from tensorflow_yolo2_tpu.train import Trainer as JxTrainer
from tensorflow_yolo2_tpu.train import optimizers as jx_opt
from tensorflow_yolo2_tpu.train.trainer import TrainState as JxTrainState
from tests import synthetic
from tests.test_torch_port_models import random_variables
from tests.test_torch_port_train import _pre_bn_bias, _scalars, rel_norm

LR = 1e-3


# -- (a) the loss and its task ------------------------------------------------


def _boxes(rng, n, size):
    """n seeded x1y1x2y2 boxes (float32) inside a size² image."""
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(size * 0.05, size * 0.6, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, size - 1)],
                          1).astype(np.float32)


def _v2_inputs(cfg, per_slot, batch=3, seed=0):
    """A head output and labels (v1 grids or per-slot grids) of seeded
    boxes. Each object's owner slot predicts a box near it, and another
    slot of its cell predicts the object's own box, so that the ignore
    threshold exempts that slot from the no-object term."""
    rng = np.random.RandomState(seed)
    S, B, C = cfg.S, cfg.B, cfg.num_class
    net = rng.normal(0, 0.5, (batch, S, S, B, 5 + C))
    labels = []
    for n in range(batch):
        corners = _boxes(rng, 5, cfg.image_size)
        cls = rng.randint(0, C, 5).astype(np.int32)
        grid = jx_voc.build_label_grid_v2(corners, cls, S, B, cfg.anchors,
                                          C, float(cfg.image_size))
        for y, x, b in zip(*np.nonzero(grid[..., 0])):
            cx, cy, w, h = grid[y, x, b, 1:5] * S / cfg.image_size
            for slot, noise in ((b, 0.1), ((b + 1) % B, 0.0)):
                p = np.clip([cx - x, cy - y], 0.02, 0.98)
                net[n, y, x, slot, :4] = (
                    np.log(p / (1 - p)) + rng.normal(0, noise, 2)).tolist() \
                    + (np.log(np.maximum([w, h], 1e-3) /
                              np.asarray(cfg.anchors[slot])) +
                       rng.normal(0, noise, 2)).tolist()
        if per_slot:
            labels.append(grid)
        else:
            labels.append(jx_voc.build_label_grid(corners, cls, S, C,
                                                  float(cfg.image_size)))
    net = net.reshape(batch, S, S, -1).astype(np.float32)
    return net, np.stack(labels).astype(np.float32)


def _both_losses(cfg_kw, per_slot, step, seed=0):
    """(JAX: total, terms, grad), (port: total, terms, grad) of one
    input; ``cfg_kw`` overrides the 224² anchor config's fields."""
    jcfg = jx_config.yolo_v2_config(224)
    jcfg = jx_config.dataclasses.replace(jcfg, **cfg_kw) if cfg_kw else jcfg
    pcfg = yolo_v2_config(224)
    pcfg = pt_config.dataclasses.replace(pcfg, **cfg_kw) if cfg_kw else pcfg
    net, labels = _v2_inputs(jcfg, per_slot, seed=seed)

    def jf(n):
        return jx_v2_loss(n, jnp.asarray(labels), jcfg,
                          None if step is None else jnp.asarray(step))

    (jtotal, jaux), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(net))
    t = torch.tensor(net, requires_grad=True)
    ptotal, paux = yolo_v2_loss(t, torch.from_numpy(labels), pcfg, step)
    (pgrad,) = torch.autograd.grad(ptotal, t)
    return ((float(jtotal), [float(v) for v in jaux[:5]], np.asarray(jgrad),
             np.asarray(jaux.ious), np.asarray(jaux.owner_mask)),
            (ptotal.item(), [v.item() for v in paux[:5]], pgrad.numpy(),
             paux.ious.detach().numpy(), paux.owner_mask.numpy()))


def _assert_losses_match(want, got):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[4], want[4])


@pytest.mark.parametrize("step", [None, 0, 5000],
                         ids=["no_step", "burn_in", "after_burn_in"])
@pytest.mark.parametrize("per_slot", [False, True],
                         ids=["v1_labels", "per_slot_labels"])
def test_yolo_v2_loss_matches_jax(per_slot, step):
    """Value, terms, IoUs, owners and the gradient w.r.t. the grid; at
    batch 3 the burn-in is on at step 0 (0 samples seen) and off at step
    5000 (15000 ≥ 12800)."""
    want, got = _both_losses({}, per_slot, step)
    _assert_losses_match(want, got)
    assert (got[1][4] > 0) == (step == 0)


@pytest.mark.parametrize("per_slot", [False, True],
                         ids=["v1_labels", "per_slot_labels"])
def test_yolo_v2_loss_without_coord_scale_matches_jax(per_slot):
    want, got = _both_losses({"v2_coord_scale": False}, per_slot, 0)
    _assert_losses_match(want, got)
    scaled = _both_losses({}, per_slot, 0)[1]
    assert got[1][3] < scaled[1][3]  # (2 − w·h) > 1 raises the term


@pytest.mark.parametrize("cfg_kw", [{"v2_prior_weight": 0.0},
                                    {"v2_burnin_samples": 0}],
                         ids=["no_prior_weight", "no_burnin_samples"])
def test_yolo_v2_loss_burn_in_off_matches_jax(cfg_kw):
    """The config switches the burn-in off: no prior term at step 0, and
    the rest as JAX's."""
    want, got = _both_losses(cfg_kw, True, 0)
    _assert_losses_match(want, got)
    assert got[1][4] == 0.0


def test_yolo_v2_loss_ignore_threshold_exempts_slots():
    """The planted duplicate of each object is not suppressed at the
    default threshold: the no-object term is smaller than with the
    exemption off, and both match JAX."""
    want, got = _both_losses({}, True, None)
    _assert_losses_match(want, got)
    want_off, got_off = _both_losses({"v2_ignore_iou": 1.0}, True, None)
    _assert_losses_match(want_off, got_off)
    assert got[1][2] < got_off[1][2] - 0.1


def test_yolo_v2_loss_refuses_the_spatial_hooks():
    """The spatial hooks are ported (held to JAX on row slices in
    test_torch_port_parallel_mesh.py): given the whole grid's own
    offsets, boxes and an all-ones mask they change nothing. The loss
    still refuses a config without the per-slot anchor layout."""
    cfg = yolo_v2_config(64)
    gen = torch.Generator().manual_seed(0)
    net = torch.randn(2, 2, 2, cfg.cell_channels, generator=gen)
    labels = torch.zeros(2, 2, 2, cfg.B, 25)
    labels[:, 0, 1, 2, :5] = torch.tensor([1.0, 40.0, 12.0, 20.0, 30.0])
    labels[:, 0, 1, 2, 7] = 1.0
    off = torch.from_numpy(cfg.offset).float()
    hooks = {"offsets": (off, off.permute(1, 0, 2)),
             "ignore_gt": (labels[..., 1:5].reshape(2, -1, 4) / 64.0,
                           labels[..., 0].reshape(2, -1)),
             "noobj_valid": torch.ones(1, 2, 1, 1)}
    want = yolo_v2_loss(net, labels, cfg, step=0)[0]
    assert float(yolo_v2_loss(net, labels, cfg, step=0, **hooks)[0]) == \
        pytest.approx(float(want), rel=1e-6)
    with pytest.raises(ValueError, match="per-slot"):
        yolo_v2_loss(net, labels, pt_config.YoloConfig(S=2, image_size=64))


@pytest.mark.parametrize("S", [7, 4])
def test_yolo_v2_task_matches_jax(S):
    """The task's metrics, on labels at the config's own grid and at
    another (the task re-grids itself by ``at_scale``)."""
    jcfg, pcfg = jx_config.yolo_v2_config(224), yolo_v2_config(224)
    net, labels = _v2_inputs(jcfg.at_scale(S), True, seed=S)
    want = jax.jit(jx_v2_task(jcfg))(jnp.asarray(net), jnp.asarray(labels),
                                     step=jnp.asarray(1))[1]
    got = yolo_v2_task(pcfg)(torch.from_numpy(net),
                             torch.from_numpy(labels), step=1)[1]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert got["burnin_loss"].item() > 0


# -- (b) the per-slot grid and the VOC loader ---------------------------------


def test_build_label_grid_v2_matches_jax():
    """Bit-equal on seeded boxes, with a cell that gets B + 1 objects:
    each takes a free slot until the cell is full, then the last is
    dropped."""
    rng = np.random.RandomState(7)
    cfg = jx_config.yolo_v2_config(224)
    for _ in range(20):
        n = rng.randint(1, 9)
        corners = _boxes(rng, n, 224)
        cls = rng.randint(0, 20, n).astype(np.int32)
        np.testing.assert_array_equal(
            pt_voc.build_label_grid_v2(corners, cls, 7, 5, cfg.anchors, 20,
                                       224.0),
            jx_voc.build_label_grid_v2(corners, cls, 7, 5, cfg.anchors, 20,
                                       224.0))
    # B + 1 objects centred in cell (3, 3), shapes from thin to square
    wh = np.array([[20, 20], [40, 40], [60, 100], [120, 140], [150, 150],
                   [80, 30]], np.float32)
    corners = np.concatenate([112 - wh / 2, 112 + wh / 2], 1)
    cls = np.arange(6, dtype=np.int32)
    got = pt_voc.build_label_grid_v2(corners, cls, 7, 5, cfg.anchors, 20,
                                     224.0)
    np.testing.assert_array_equal(
        got, jx_voc.build_label_grid_v2(corners, cls, 7, 5, cfg.anchors, 20,
                                        224.0))
    assert got[3, 3, :, 0].sum() == 5 and got[..., 0].sum() == 5
    assert got[3, 3, :, 5 + 5].sum() == 0  # the sixth object was dropped


def _voc_pair(tmp_path, monkeypatch, jcfg, pcfg, n_images=5, flipped=True):
    """The JAX package's and the port's loaders on one synthetic VOC tree,
    each shuffled from seed 11."""
    from tensorflow_yolo2_tpu.utils import native

    monkeypatch.setattr(native, "_load", lambda: None)
    voc = synthetic.make_voc(str(tmp_path / "VOCdevkit"), n_images=n_images)
    np.random.seed(11)
    jds = jx_voc.PascalVOC(
        "trainval", batch_size=2, data_path=voc, yolo=jcfg, flipped=flipped,
        uint8=True, paths=jx_config.Paths(root=str(tmp_path / "jax")))
    pds = pt_voc.PascalVOC(
        "trainval", batch_size=2, data_path=voc, yolo=pcfg, flipped=flipped,
        uint8=True, paths=Paths(root=str(tmp_path / "port")),
        rng=np.random.RandomState(11))
    return voc, jds, pds


@pytest.mark.parametrize("anchors", ["classic", "kmeans"])
def test_pascal_voc_per_slot_first_epoch_matches_jax(tmp_path, monkeypatch,
                                                     anchors):
    """Per-slot labels and images, batch by batch, over the first epoch,
    and the cache file's name: ``_slots5``, and the anchors' digest for
    priors other than the classic ones."""
    custom = None
    if anchors == "kmeans":
        custom = ((0.5, 0.7), (1.0, 1.5), (2.0, 1.8), (3.0, 4.0),
                  (5.0, 5.5))
    jcfg = jx_config.yolo_v2_config(224, anchors=custom)
    pcfg = yolo_v2_config(224, anchors=custom)
    _, jds, pds = _voc_pair(tmp_path, monkeypatch, jcfg, pcfg)
    names = [sorted(os.listdir(tmp_path / side / "cache"))
             for side in ("jax", "port")]
    assert names[0] == names[1]
    tag = "_slots5" + ("" if custom is None else "_a")
    assert names[1][0].startswith("pascal_trainval_gt_labels" + tag)
    n = len(jds.gt_labels)
    assert len(pds.gt_labels) == n == 10
    for _ in range(n // 2):
        (ji, jl), (pi, pl) = jds.get(), pds.get()
        assert pl.shape == (2, 7, 7, 5, 25)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pl, jl)


# -- (c) dimension clusters and the anchors file ------------------------------


@pytest.mark.parametrize("k,n", [(5, 200), (3, 2), (4, 40)])
def test_iou_kmeans_matches_jax(k, n):
    """Seeded shapes, and a set smaller than k (tiled), and one with
    duplicates (nudged apart)."""
    rng = np.random.RandomState(k + n)
    wh = rng.uniform(0.2, 6.0, (n, 2))
    if n == 40:
        wh[::2] = wh[1::2]
    got, got_iou = pt_anchors.iou_kmeans(wh, k)
    want, want_iou = jx_anchors.iou_kmeans(wh, k)
    assert got.dtype == np.float32 and got.shape == (k, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert abs(got_iou - want_iou) <= 1e-9
    areas = got[:, 0] * got[:, 1]
    assert np.all(np.diff(areas) >= 0)
    with pytest.raises(ValueError, match="no positive-size"):
        pt_anchors.iou_kmeans(np.zeros((3, 2)), 2)


def test_collect_voc_wh_cells_matches_jax(tmp_path):
    voc = synthetic.make_voc(str(tmp_path / "VOCdevkit"), n_images=4)
    for S, size in ((7, 224), (13, 416)):
        got = pt_anchors.collect_voc_wh_cells(voc, "trainval", S, size)
        want = jx_anchors.collect_voc_wh_cells(voc, "trainval", S, size)
        assert got.shape[1] == 2 and len(got) > 0
        np.testing.assert_array_equal(got, want)


def test_anchors_file_round_trip_and_persist_guard(tmp_path):
    """``save_anchors`` → ``load_anchors`` (rescaled to another grid) as
    the JAX package writes and reads them; ``persist_anchors`` writes
    into an empty dir, leaves matching priors alone, and refuses to
    re-prior a dir that holds snapshots (also against the classic
    priors, which snapshots without a file decode with)."""
    priors = ((0.5, 0.75), (1.25, 2.0), (3.0, 2.5))
    d = str(tmp_path / "run")
    path = pt_anchors.save_anchors(d, priors, 7)
    with open(path) as f:
        assert json.load(f) == {"S": 7, "anchors": [list(p) for p in priors]}
    for S in (7, 13):
        assert pt_anchors.load_anchors(d, S) == \
            jx_anchors.load_anchors(d, S)
    assert pt_anchors.load_anchors(str(tmp_path / "none"), 7) is None
    cfg = pt_anchors.v2_config_for_snapshot(d, 416)
    assert cfg.B == 3 and cfg.anchors == pt_anchors.load_anchors(d, 13)

    assert pt_anchors.persist_anchors(d, priors, 7, has_snapshots=True) \
        is None
    with pytest.raises(SystemExit, match="different anchor priors"):
        pt_anchors.persist_anchors(d, priors[:2], 7, has_snapshots=True)
    assert pt_anchors.persist_anchors(d, priors[:2], 7,
                                      has_snapshots=False) == path
    fresh = str(tmp_path / "fresh")
    classic = yolo_v2_config(224).anchors
    assert pt_anchors.persist_anchors(fresh, classic, 7,
                                      has_snapshots=True) is not None
    with pytest.raises(SystemExit):
        pt_anchors.persist_anchors(str(tmp_path / "old"), priors, 7,
                                   has_snapshots=True)


# -- (d) whole train steps ------------------------------------------------------


def _v2_batch(cfg):
    """Images in [-1, 1] and per-slot labels at 64² (S=2, B=5), float64."""
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (4, 64, 64, 3))
    corners = np.array([[30, 2, 50, 22], [0, 30, 30, 50], [34, 34, 60, 62],
                        [36, 36, 58, 60]], np.float32)
    cls = np.array([2, 1, 3, 3], np.int32)
    labels = np.stack([
        jx_voc.build_label_grid_v2(corners[:2 + i % 3], cls[:2 + i % 3],
                                   cfg.S, cfg.B, cfg.anchors, cfg.num_class,
                                   64.0) for i in range(4)])
    return images, labels


def _to_sd(params, stats=None):
    """``convert.state_dict_from_flax`` without its float32 rounding: its
    keys and layouts (in the order of the flattened trees), float64
    values."""
    params, stats = jax.device_get((params, stats))
    sd = convert.state_dict_from_flax(params, stats)
    keys = [k for k in sd if not k.endswith("num_batches_tracked")]
    leaves = [*convert.flatten(params).values(),
              *convert.flatten(stats or {}).values()]
    assert len(keys) == len(leaves)
    for k, leaf in zip(keys, leaves):
        t = torch.from_numpy(np.array(leaf, np.float64))
        t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t  # HWIO → OIHW
        assert t.shape == sd[k].shape, k
        sd[k] = t
    return sd


def v2_train_step_run(head):
    """One float64 train step of the v2 or v2p detector (full depth, 64²,
    S=2, B=5, batch 4, seeded weights, Adam at 1e-3, the step count 0
    passed to the loss: the burn-in is on) in the JAX package and in the
    port from the same state: the gradients, and metrics, parameters and
    statistics after the step.

    One step, not a chain: the float32 loss's exp, log and sigmoid differ
    from XLA's in the last bit (the gradients by ~1e-7, relative norm),
    and Adam's first step turns that into moves of up to ~1.8·lr for the
    few weights whose gradient is as small as that noise (~2e-5 of them),
    which would shift every output of a next step by ~1e-5."""
    jcfg = jx_config.yolo_v2_config(64)
    images, labels = _v2_batch(jcfg)
    with jax.enable_x64(True):
        kw = dict(output_channels=jcfg.cell_channels, dtype=jnp.float64,
                  param_dtype=jnp.float64)
        model = (jx_darknet.Darknet19DetectorV2(**kw) if head == "v2p" else
                 jx_darknet.Darknet19Detector(bn_on_output=False, **kw))
        trainer = JxTrainer(
            model, jx_v2_task(jcfg),
            jx_config.OptimizerConfig(
                schedule=jx_config.LRScheduleConfig(learning_rate=LR)),
            mesh=make_mesh(MeshConfig(data=1, model=1)))
        variables = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64),
            random_variables(model, (1, 64, 64, 3), seed=3))
        trainer.tx = jx_opt.make_optimizer(trainer.opt_cfg)
        state = trainer.shard_state(JxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=trainer.tx.init(variables["params"]),
            rng=jax.random.PRNGKey(1)))
        init = _to_sd(state.params, state.batch_stats)
        state, metrics = trainer.train_step(state, images, labels)
        want = (_scalars(metrics), _to_sd(state.params, state.batch_stats))
        # the gradients, from Adam's first moment (1 − b1)·g
        b1 = trainer.opt_cfg.adam_beta1
        jgrads = {k: v / (1 - b1)
                  for k, v in _to_sd(state.opt_state[0].mu).items()}

    pcfg = yolo_v2_config(64)
    net = (Darknet19DetectorV2(pcfg.cell_channels) if head == "v2p" else
           Darknet19Detector(pcfg.cell_channels, bn_on_output=False))
    port = Trainer(net.double(), yolo_v2_task(pcfg), OptimizerConfig(
        schedule=LRScheduleConfig(learning_rate=LR)), device="cpu",
        compute_dtype=torch.float32)
    pstate = port.create_state(torch.Generator().manual_seed(0), init)
    _, pgrads = port.loss_and_grads(pstate, images, labels)
    load_into(pstate.model, init)  # the statistics before that forward
    pstate, metrics = port.train_step(pstate, images, labels)
    got = (_scalars(metrics), pstate.model.state_dict())
    return {"head": head, "jgrads": jgrads,
            "pgrads": {k: v.detach() for k, v in pgrads.items()},
            "want": want, "got": got}


@pytest.fixture(scope="module", params=["v2", "v2p"])
def v2_train_step(request):
    return v2_train_step_run(request.param)


def _param_keys(run):
    return [k for k in run["pgrads"] if not _pre_bn_bias(k, run["pgrads"])]


def test_v2_train_steps_losses_and_metrics_match_jax(v2_train_step):
    got, want = v2_train_step["got"][0], v2_train_step["want"][0]
    assert set(got) == set(want)
    assert got["burnin_loss"] > 0  # step · 4 < 12800
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_v2_train_step_gradients_match_jax(v2_train_step):
    """Each tensor's relative norm (measured ≤ 5.2e-8), so that a small
    tensor's error is not lost beside the large ones."""
    keys = _param_keys(v2_train_step)
    got, want = v2_train_step["pgrads"], v2_train_step["jgrads"]
    for k in keys:
        assert rel_norm(got[k], want[k]) < 1e-6, k
    scale = max(float(want[k].abs().max()) for k in keys)
    for k in set(got) - set(keys):  # a conv bias in front of BN: 0
        assert float((got[k] - want[k]).abs().max()) < 1e-6 * scale, k


def test_v2_train_step_batch_stats_match_jax(v2_train_step):
    got, want = v2_train_step["got"][1], v2_train_step["want"][1]
    for k in want:
        if k.endswith("running_mean"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-8,
                                       err_msg=k)
        elif "running" in k:
            assert rel_norm(got[k], want[k]) < 1e-7, k


def test_v2_train_step_params_match_jax(v2_train_step):
    """In each tensor, the v1 float64 bound (rtol 1e-7, atol 1e-6·lr) on
    every element but at most max(1, 1e-4 of its elements) (measured: at
    most 0.27 of that allowance), and every element within 2·lr: where a gradient is as small as the float32
    loss's last-bit noise, Adam's step can flip (see
    ``v2_train_step_run``)."""
    keys = _param_keys(v2_train_step)
    got, want = v2_train_step["got"][1], v2_train_step["want"][1]
    for k in set(v2_train_step["pgrads"]) - set(keys):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR,
                                   err_msg=k)
    for k in keys:
        diff = (got[k] - want[k]).abs()
        assert float(diff.max()) <= 2 * LR, k
        outside = int((diff > 1e-6 * LR + 1e-7 * want[k].abs()).sum())
        assert outside <= max(1, 1e-4 * diff.numel()), (k, outside)


def test_v2p_modules_take_bn_momentum():
    """``--bn-momentum`` reaches all 22 BatchNorms of the v2p detector
    (the trunk's 18 and the head's conv1, conv2, passthrough, conv3)."""
    from tensorflow_yolo2_torch.models.layers import BatchNorm

    bns = [m for m in Darknet19DetectorV2(125, bn_momentum=0.9).modules()
           if isinstance(m, BatchNorm)]
    assert len(bns) == 22
    assert {m.flax_momentum for m in bns} == {0.9}
