"""The H-sharded detector (tensorflow_yolo2_torch/parallel/spatial.py) on 2
and 4 gloo ranks against the port's own unsharded detector, in float64:
the folded forward (v1, the stride trunk, v2p), the frozen-BN v1 loss and
its gradients, and the live-BatchNorm v1 / v2 / v2p steps (loss,
gradients, new running statistics), with the odd-S padding case. The
unsharded port is held to JAX by the other port tests; JAX's own sharded
tests are ``slow`` (each compiles a ``shard_map``).

The ranks are subprocesses running this file (``python <this file> OUT``
with torchrun's variables), one group a world size, started by one
module fixture while this process computes the references; each has its
own timeout, and the process group a finite one.

The losses compute in float32 in both packages, so a loss summed over
shards differs from the unsharded sum by float32 rounding (held at
1e-6); the gradients, computed element by element from the float32 loss
and then in float64, and the statistics are held at 1e-10.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from tests.test_torch_port_parallel_mesh import (  # noqa: E402
    assert_close_all,
    digest,
    finish_ranks,
    start_ranks,
)
from tests.test_torch_port_resnet_train import (  # noqa: E402,F401
    few_torch_threads,  # autouse
)

BATCH = 2
# (world size, S) of each case: the folded forwards and the frozen-BN loss
# need H % 32·N == 0 and S % N == 0; the live steps pad
FOLDED_S = {2: 2, 4: 4}
LIVE = {2: (("v1", 3), ("v2", 2), ("v2p", 2)),
        4: (("v1", 2), ("v2", 3), ("v2p", 4))}
LOSS_RTOL = 1e-6
TOL = 1e-10


def _cfg(head: str, S: int):
    from tensorflow_yolo2_torch.config import YoloConfig, yolo_v2_config

    if head == "v1":
        return YoloConfig(S=S, image_size=32 * S)
    return yolo_v2_config(32 * S)


def _model(head: str, cfg, downsample: str = "pool", fold: bool = False):
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Detector,
        Darknet19DetectorV2,
    )

    if head == "v2p":
        m = Darknet19DetectorV2(cfg.cell_channels, fold_bn=fold,
                                downsample=downsample)
    else:
        m = Darknet19Detector(cfg.cell_channels, bn_on_output=head == "v1",
                              fold_bn=fold, downsample=downsample)
    return m


def _weights(head: str, cfg, downsample: str, seed: int) -> dict:
    """Seeded BatchNorm weights (randomize_: statistics and affine terms
    off the identity), float64."""
    from tensorflow_yolo2_torch.models.darknet import randomize_

    m = _model(head, cfg, downsample)
    randomize_(m, torch.Generator().manual_seed(seed))
    return {k: v.double() for k, v in m.state_dict().items()}


def _batch(cfg, seed: int):
    """Seeded float64 images in [-1, 1] and their label grids."""
    from tensorflow_yolo2_torch.data.voc import (
        build_label_grid,
        build_label_grid_v2,
    )

    rng = np.random.RandomState(seed)
    size = cfg.image_size
    images = rng.uniform(-1, 1, (BATCH, size, size, 3))
    slots = (cfg.B,) if cfg.per_slot_classes else ()
    labels = np.zeros((BATCH, cfg.S, cfg.S) + slots + (5 + cfg.num_class,),
                      np.float32)
    for i in range(BATCH):
        n = rng.randint(2, 5)
        xy = rng.uniform(0, size - 12, (n, 2))
        wh = rng.uniform(6, size / 2, (n, 2))
        corners = np.concatenate([xy, np.minimum(xy + wh, size - 1)],
                                 1).astype(np.float32)
        cls = rng.randint(0, cfg.num_class, n)
        if slots:
            labels[i] = build_label_grid_v2(corners, cls, cfg.S, cfg.B,
                                            cfg.anchors, cfg.num_class,
                                            float(size))
        else:
            labels[i] = build_label_grid(corners, cls, cfg.S,
                                         cfg.num_class, float(size))
    return torch.from_numpy(images), torch.from_numpy(labels)


FOLDED = (("v1", "pool"), ("v1", "stride"), ("v2p", "pool"))


def _folded_case(head: str, downsample: str, S: int):
    from tensorflow_yolo2_torch.models.fold import fold_params

    cfg = _cfg(head, S)
    folded = fold_params(_weights(head, cfg, downsample, seed=S))
    images, labels = _batch(cfg, seed=10 + S)
    return cfg, folded, images, labels


def _live_case(head: str, S: int):
    cfg = _cfg(head, S)
    return cfg, _weights(head, cfg, "pool", seed=20 + S), *_batch(
        cfg, seed=30 + S)


# -- the ranks ----------------------------------------------------------------

def _rank_main(out: str) -> None:
    import torch.distributed as dist

    from tensorflow_yolo2_torch.parallel.mesh import (
        maybe_initialize_distributed,
    )
    from tensorflow_yolo2_torch.parallel.spatial import (
        spatial_detector_fn,
        spatial_mesh,
        spatial_yolo_loss_fn,
        spatial_yolo_train_fn,
        spatial_yolo_v2_train_fn,
    )

    torch.set_num_threads(1)
    maybe_initialize_distributed("cpu")
    n, r = dist.get_world_size(), dist.get_rank()
    mesh = spatial_mesh(n)
    res = {}
    S = FOLDED_S[n]
    for head, ds in FOLDED:
        cfg, folded, images, labels = _folded_case(head, ds, S)
        fwd = spatial_detector_fn(mesh, bn_on_output=head == "v1",
                                  downsample=ds,
                                  head="v2p" if head == "v2p" else "v1")
        with torch.no_grad():
            res[f"forward/{head}/{ds}"] = fwd(folded, images if r == 0
                                              else None)
    cfg, folded, images, labels = _folded_case("v1", "pool", S)
    params = {k: v.requires_grad_() for k, v in folded.items()}
    loss, grads = spatial_yolo_loss_fn(mesh, cfg)(
        params, images if r == 0 else None, labels if r == 0 else None)
    res["loss/v1"] = (loss, digest(grads))
    for head, s in LIVE[n]:
        cfg, weights, images, labels = _live_case(head, s)
        params = {k: v.clone().requires_grad_() for k, v in weights.items()
                  if not k.endswith(("running_mean", "running_var",
                                     "num_batches_tracked"))}
        stats = {k: v for k, v in weights.items()
                 if k.endswith(("running_mean", "running_var"))}
        feed = (images, labels) if r == 0 else (None, None)
        if head == "v1":
            got = spatial_yolo_train_fn(mesh, cfg)(params, stats, *feed)
        else:
            got = spatial_yolo_v2_train_fn(mesh, cfg, head=head)(
                params, stats, *feed, 0)
        loss, grads, stats = got
        res[f"live/{head}/{s}"] = (loss, digest(grads), stats)
    torch.save(res, os.path.join(out, f"rank{r}.pt"))
    dist.destroy_process_group()


# -- the tests ----------------------------------------------------------------

def _reference_forward(head, ds, S):
    cfg, folded, images, _ = _folded_case(head, ds, S)
    m = _model(head, cfg, ds, fold=True).double()
    m.load_state_dict(folded)
    with torch.no_grad():
        return m.eval()(images)


def _reference_loss(S):
    from tensorflow_yolo2_torch.losses.yolo import yolo_loss

    cfg, folded, images, labels = _folded_case("v1", "pool", S)
    m = _model("v1", cfg, fold=True).double()
    m.load_state_dict(folded)
    loss = yolo_loss(m.eval()(images), labels, cfg)[0]
    names = [k for k, _ in m.named_parameters()]
    return loss.detach(), dict(zip(names, torch.autograd.grad(
        loss, list(m.parameters()))))


def _reference_live(head, S):
    from tensorflow_yolo2_torch.losses.yolo import yolo_loss
    from tensorflow_yolo2_torch.losses.yolo_v2 import yolo_v2_loss

    cfg, weights, images, labels = _live_case(head, S)
    m = _model(head, cfg).double()
    m.load_state_dict(weights)
    out = m.train()(images)
    loss = (yolo_loss(out, labels, cfg)[0] if head == "v1" else
            yolo_v2_loss(out, labels, cfg, step=0)[0])
    names = [k for k, _ in m.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(m.parameters()))))
    stats = {k: v for k, v in m.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return loss.detach(), grads, stats


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' rank outputs (rank 0's and one other's) and the
    unsharded references, computed while the ranks run."""
    started = {}
    for n in (2, 4):
        out = tmp_path_factory.mktemp(f"spatial{n}")
        started[n] = (out, start_ranks(__file__, n, str(out)))
    refs = {}
    for n in (2, 4):
        S = FOLDED_S[n]
        for head, ds in FOLDED:
            refs[n, f"forward/{head}/{ds}"] = _reference_forward(head, ds, S)
        loss, grads = _reference_loss(S)
        refs[n, "loss/v1"] = loss, digest(grads)
        for head, s in LIVE[n]:
            loss, grads, stats = _reference_live(head, s)
            refs[n, f"live/{head}/{s}"] = loss, digest(grads), stats
    got = {}
    for n, (out, procs) in started.items():
        finish_ranks(procs)
        for r in (0, n - 1):
            got[n, r] = torch.load(os.path.join(out, f"rank{r}.pt"))
    return got, refs


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("head,ds", FOLDED)
def test_spatial_forward_matches_unsharded(runs, n, head, ds):
    got, refs = runs
    want = refs[n, f"forward/{head}/{ds}"]
    for r in (0, n - 1):
        grid = got[n, r][f"forward/{head}/{ds}"]
        assert grid.shape == want.shape
        assert_close_all(digest({"grid": grid}), digest({"grid": want}))


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_frozen_bn_loss_and_grads(runs, n):
    got, refs = runs
    want_loss, want_grads = refs[n, "loss/v1"]
    for r in (0, n - 1):
        loss, grads = got[n, r]["loss/v1"]
        assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
        assert_close_all(grads, want_grads)


@pytest.mark.parametrize("n,case", [(n, f"live/{h}/{s}") for n in (2, 4)
                                    for h, s in LIVE[n]])
def test_spatial_live_bn_step(runs, n, case):
    got, refs = runs
    want_loss, want_grads, want_stats = refs[n, case]
    for r in (0, n - 1):
        loss, grads, stats = got[n, r][case]
        assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
        assert_close_all(grads, want_grads)
        assert_close_all(stats, want_stats)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
