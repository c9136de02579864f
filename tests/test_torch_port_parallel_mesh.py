"""tensorflow_yolo2_torch/parallel/mesh.py, the data- and tensor-parallel
Trainer step, the spatial halo exchange and the losses' sharding hooks:

- the rule of ``make_mesh_for_batch`` and ``shard_params``'s specs
  against the JAX package's on the conftest's 8 virtual CPU devices;
- ``halo_exchange`` on 4 gloo ranks against JAX's ``halo_exchange``
  under ``shard_map``, forward and backward;
- the loss hooks (``offsets``, ``ignore_gt``, ``noobj_valid``) on row
  slices against JAX's eager losses;
- one Trainer step of the full-width Darknet19 detector at 64² in
  float64 on 2 ranks (data 2) and on 4 (data 2 × model 2, where its 512-
  and 1024-wide convs shard) against one process on the joined batch.

The ranks are subprocesses running this file (``python <this file> OUT``
with torchrun's variables), one group a world size, started by a module
fixture; each has its own timeout and the process group a finite one.
The losses compute in float32 in both packages: a loss averaged over
ranks differs from the joined batch's by float32 rounding (held at
1e-6); everything else is held at 1e-10.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from tests.test_torch_port_resnet_train import (  # noqa: E402,F401
    few_torch_threads,  # autouse
)

RANK_TIMEOUT = 150  # seconds a rank subprocess may take
TOL = 1e-10
LOSS_RTOL = 1e-6
DP_BATCH = 4  # global rows of the data-parallel step
DP_SIZE = 64
HALO_SHAPE = (2, 8, 5, 3)  # a rank's NHWC block; 4 ranks → H = 32


FLOOR = 1e-15  # of the norm of all tensors compared: the conv biases in
#               front of a BatchNorm have gradients that are 0 up to
#               rounding (1e-13 to 1e-12 at a total norm of 1.6e4)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / max(‖want‖, tiny), in float64."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / max(float(want.norm()), 1e-300))


DIGEST_K = 16  # projections a tensor
DIGEST_BLOCK = 1024


def digest(tensors: dict) -> dict:
    """A rank's large float tensors as small digests for the test process
    (saving them whole would write gigabytes a run): each flattened into
    rows of ``DIGEST_BLOCK`` values, projected onto ``DIGEST_K`` seeded
    Gaussian columns and the rows summed with seeded random signs (seeded
    by the tensor's name), scaled by 1/√K: a random projection, so that
    the digest of a difference has about the difference's norm. Small
    and integer tensors stay as they are."""
    out = {}
    for name, t in tensors.items():
        t = torch.as_tensor(t).detach()
        if not t.is_floating_point() or t.numel() <= 4096:
            out[name] = t.clone()
            continue
        flat = t.double().reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, -flat.numel() %
                                              DIGEST_BLOCK))
        rows = flat.view(-1, DIGEST_BLOCK)
        g = torch.Generator().manual_seed(zlib.crc32(name.encode()))
        cols = torch.randn(DIGEST_BLOCK, DIGEST_K, generator=g,
                           dtype=torch.float64)
        signs = torch.randint(0, 2, (rows.shape[0],), generator=g
                              ).double() * 2 - 1
        out[name] = signs @ (rows @ cols) / DIGEST_K ** 0.5
    return out


def assert_close_all(got: dict, want: dict, tol: float = TOL) -> None:
    """Every floating-point tensor of ``want`` within ``tol`` of its own
    norm plus ``FLOOR`` of all of them together, in float64; ``got``
    and ``want`` hold digests (``digest``) of a rank's tensors and of
    the reference's."""
    assert got.keys() == want.keys()
    want = {k: v for k, v in want.items() if v.is_floating_point()}
    total = float(torch.sqrt(sum((v * v).sum() for v in want.values())))
    for k, v in want.items():
        err = float((got[k].double() - v).norm())
        assert err <= tol * float(v.norm()) + FLOOR * total, \
            f"{k}: error {err:.3e}, norm {float(v.norm()):.3e}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(world: int, r: int, port: int, threads: int = 1) -> dict:
    """torchrun's variables for rank ``r``, a finite group timeout, and
    ``threads`` OpenMP threads."""
    return {**os.environ, "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
            "RANK": str(r), "LOCAL_RANK": str(r),
            "TFY2_DIST_TIMEOUT": str(RANK_TIMEOUT),
            "OMP_NUM_THREADS": str(threads)}


def start_ranks(script: str, world: int, *args: str) -> list:
    """``world`` subprocesses of ``python script *args``, one a rank."""
    port = _free_port()
    return [subprocess.Popen([sys.executable, script, *args], cwd=REPO,
                             env=rank_env(world, r, port),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def finish_ranks(procs: list, timeout: float = RANK_TIMEOUT) -> list[str]:
    """Wait for every rank (each within ``timeout``); a rank that fails
    or times out fails the caller with every rank's output."""
    outs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += f"\n[timed out after {timeout} s]"
            failed = True
        failed |= p.returncode != 0
        outs.append(out)
    if failed:
        pytest.fail("\n".join(f"--- rank {r} (rc {p.returncode}):\n{o[-3000:]}"
                              for r, (p, o) in enumerate(zip(procs, outs))))
    return outs


# -- the data-parallel case --------------------------------------------------

def _dp_case():
    """The float64 detector's weights, the global batch, the config."""
    from tensorflow_yolo2_torch.config import YoloConfig
    from tensorflow_yolo2_torch.data.voc import build_label_grid
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Detector,
        randomize_,
    )

    cfg = YoloConfig(S=DP_SIZE // 32, image_size=DP_SIZE)
    m = Darknet19Detector(cfg.cell_channels)
    randomize_(m, torch.Generator().manual_seed(7))
    weights = {k: v.double() for k, v in m.state_dict().items()}
    rng = np.random.RandomState(8)
    images = rng.uniform(-1, 1, (DP_BATCH, DP_SIZE, DP_SIZE, 3))
    labels = np.stack([build_label_grid(
        np.array([[4.0, 6.0, 40.0, 50.0], [30.0, 20.0, 60.0, 62.0]],
                 np.float32) + i, rng.randint(0, 20, 2), cfg.S,
        cfg.num_class, float(DP_SIZE)) for i in range(DP_BATCH)])
    return cfg, weights, torch.from_numpy(images), torch.from_numpy(labels)


def _dp_trainer(mesh=None):
    """A momentum trainer (the first step's trace is the gradient) on the
    float64 detector, and its state from the case's weights."""
    from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
    from tensorflow_yolo2_torch.models.darknet import Darknet19Detector
    from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task

    cfg, weights, images, labels = _dp_case()
    trainer = Trainer(Darknet19Detector(cfg.cell_channels).double(),
                      yolo_task(cfg),
                      OptimizerConfig(name="momentum", schedule=LRScheduleConfig(
                          learning_rate=1e-3), grad_clip_norm=1.0),
                      device="cpu", compute_dtype=torch.float32, mesh=mesh)
    state = trainer.create_state(torch.Generator().manual_seed(0), weights)
    return trainer, state, images, labels


def _dp_result(trainer, state, metrics) -> dict:
    whole = trainer.snapshot_state(state)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "model": {k: v.detach().clone()
                      for k, v in whole.model.state_dict().items()},
            "trace": dict(whole.opt_state.slots["trace"])}


def _halo_input(r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank r's NHWC block of the seeded global input and of the
    cotangent of its (halo-extended) output."""
    rng = np.random.RandomState(3)
    b, h, w, c = HALO_SHAPE
    x = rng.normal(size=(b, 4 * h, w, c))
    cot = rng.normal(size=(4, b, h + 2, w, c))
    return torch.from_numpy(x[:, r * h:(r + 1) * h]), torch.from_numpy(cot[r])


def _rank_main(out: str) -> None:
    import torch.distributed as dist

    from tensorflow_yolo2_torch.parallel.mesh import (
        MeshConfig,
        make_mesh,
        maybe_initialize_distributed,
    )
    from tensorflow_yolo2_torch.parallel.spatial import (
        halo_exchange,
        spatial_mesh,
    )

    torch.set_num_threads(1)
    assert maybe_initialize_distributed("cpu")
    n, r = dist.get_world_size(), dist.get_rank()
    res = {}
    if n == 4:
        group = spatial_mesh(4).get_group("spatial")
        x, cot = _halo_input(r)
        x = x.permute(0, 3, 1, 2).requires_grad_()
        y = halo_exchange(x, group)
        (dx,) = torch.autograd.grad(y, x, cot.permute(0, 3, 1, 2))
        res["halo"] = (y.permute(0, 2, 3, 1).detach(),
                       dx.permute(0, 2, 3, 1))
    model = 2 if n == 4 else 1
    mesh = make_mesh(MeshConfig(data=n // model, model=model))
    trainer, state, images, labels = _dp_trainer(mesh)
    d = mesh.get_coordinate()[0]
    rows = DP_BATCH // mesh.size(0)
    images = images[d * rows:(d + 1) * rows]
    labels = labels[d * rows:(d + 1) * rows]
    if mesh.get_coordinate()[1]:  # the model axis computes rank 0's rows
        images = torch.zeros_like(images)
    state, metrics = trainer.train_step(state, images, labels)
    full = _dp_result(trainer, state, metrics)
    res["dp"] = {**full, "model": digest(full["model"]),
                 "trace": digest(full["trace"])}
    res["sharded"] = dict(trainer._sharded)
    torch.save(res, os.path.join(out, f"rank{r}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank outputs of the 2- and 4-rank groups, and the one-process step
    on the joined batch, computed while they run."""
    started = {}
    for n in (2, 4):
        out = tmp_path_factory.mktemp(f"mesh{n}")
        started[n] = (out, start_ranks(__file__, n, str(out)))
    trainer, state, images, labels = _dp_trainer()
    state, metrics = trainer.train_step(state, images, labels)
    want = _dp_result(trainer, state, metrics)
    want.update(model=digest(want["model"]), trace=digest(want["trace"]))
    got = {}
    for n, (out, procs) in started.items():
        finish_ranks(procs)
        got[n] = [torch.load(os.path.join(out, f"rank{r}.pt"))
                  for r in range(n)]
    return got, want


# -- the tests ----------------------------------------------------------------

def test_mesh_rule_matches_jax(capsys):
    """``mesh_shape_for_batch`` (the rule of ``make_mesh_for_batch``)
    gives JAX's mesh shape and prints its warning, for 1–8 devices."""
    import jax

    from tensorflow_yolo2_torch.parallel.mesh import mesh_shape_for_batch
    from tensorflow_yolo2_tpu.parallel.mesh import make_mesh_for_batch

    devices = jax.devices()
    assert len(devices) == 8
    for world in range(1, 9):
        for model in (1, 2, 4):
            for batch in (1, 3, 4, 6, 7, 12, 24, 25, 64):
                try:
                    want = make_mesh_for_batch(batch, model,
                                               devices[:world])
                except ValueError:
                    continue  # the JAX mesh needs more devices
                jax_out = capsys.readouterr().out
                got = mesh_shape_for_batch(batch, model, world)
                assert got == (want.shape["data"], want.shape["model"])
                assert capsys.readouterr().out == jax_out


def test_make_mesh_without_a_process_group():
    """No launcher: a 1×1 mesh is None (one process), a larger one raises
    JAX's message and names torchrun."""
    from tensorflow_yolo2_torch.parallel.mesh import (
        MeshConfig,
        make_mesh,
        make_mesh_for_batch,
        maybe_initialize_distributed,
    )

    assert not torch.distributed.is_initialized()
    assert maybe_initialize_distributed("cpu") is False
    assert make_mesh_for_batch(24) is None
    assert make_mesh(MeshConfig(data=1, model=1)) is None
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"
                       ".*torchrun --nproc-per-node 2"):
        make_mesh(MeshConfig(data=2))
    with pytest.raises(ValueError, match="mesh 1x2 needs 2"):
        make_mesh_for_batch(24, model=2)


def _jax_shape(name: str, shape: tuple) -> tuple:
    """The JAX package's layout of a port parameter: HWIO convs,
    (in, out) dense kernels."""
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    if len(shape) == 2:
        return (shape[1], shape[0])
    return shape


@pytest.mark.parametrize("model_size", [2, 4, 8])
def test_shard_specs_match_jax(model_size):
    """``param_spec`` shards exactly the parameters JAX's policy shards,
    on the Darknet19 detectors, the classifier and the zoo's vgg_16 (its
    dense layers) and inception_v1 (nothing else of rank 2)."""
    from jax.sharding import PartitionSpec as P

    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Classifier,
        Darknet19Detector,
        Darknet19DetectorV2,
    )
    from tensorflow_yolo2_torch.models.registry import get_network
    from tensorflow_yolo2_torch.parallel.mesh import param_spec
    from tensorflow_yolo2_tpu.parallel.mesh import _param_spec

    with torch.device("meta"):
        nets = [Darknet19Detector(30), Darknet19DetectorV2(125),
                Darknet19Classifier(1000),
                get_network("vgg_16", num_classes=1000),
                get_network("inception_v1", num_classes=1001)]
    n_sharded = 0
    for net in nets:
        for name, p in net.named_parameters():
            jshape = _jax_shape(name, tuple(p.shape))
            want = _param_spec((), np.empty(jshape, np.int8), model_size)
            got = param_spec(tuple(p.shape), model_size)
            sharded = want != P()
            assert (got == 0) == sharded, name
            n_sharded += sharded
    assert n_sharded > 20


def test_halo_exchange_matches_jax(ranks):
    """4 ranks: the halo-extended blocks equal JAX's ``halo_exchange``
    under ``shard_map`` on 4 devices, and the backward equals JAX's VJP
    (the halo rows' cotangents added back to their owners)."""
    from functools import partial

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tensorflow_yolo2_tpu.parallel.mesh import MeshConfig, make_mesh
    from tensorflow_yolo2_tpu.parallel.spatial import halo_exchange

    got, _ = ranks
    mesh = make_mesh(MeshConfig(data=4, model=1))
    spec = P(None, "data", None, None)
    fn = jax.shard_map(partial(halo_exchange, axis_name="data"), mesh=mesh,
                       in_specs=spec, out_specs=spec)
    x = np.concatenate([_halo_input(r)[0].numpy() for r in range(4)], 1)
    cot = np.concatenate([_halo_input(r)[1].numpy() for r in range(4)], 1)
    with jax.enable_x64(True):
        xj = jax.device_put(x, NamedSharding(mesh, spec))
        y, vjp = jax.vjp(jax.jit(fn), xj)
        (dx,) = vjp(jax.device_put(cot, NamedSharding(mesh, spec)))
        y, dx = np.asarray(y), np.asarray(dx)
    h = HALO_SHAPE[1]
    for r in range(4):
        y_r, dx_r = got[4][r]["halo"]
        np.testing.assert_array_equal(y_r.numpy(),
                                      y[:, r * (h + 2):(r + 1) * (h + 2)])
        np.testing.assert_allclose(dx_r.numpy(), dx[:, r * h:(r + 1) * h],
                                   rtol=1e-15, atol=1e-15)


def _loss_inputs(cfg, per_slot: bool, seed: int):
    from tensorflow_yolo2_torch.data.voc import (
        build_label_grid,
        build_label_grid_v2,
    )

    rng = np.random.RandomState(seed)
    size = cfg.image_size
    net = rng.normal(0, 1, (2, cfg.S, cfg.S, cfg.cell_channels)
                     ).astype(np.float32)
    labels = []
    for _ in range(2):
        xy = rng.uniform(0, size - 40, (4, 2))
        corners = np.concatenate([xy, xy + rng.uniform(10, 40, (4, 2))],
                                 1).astype(np.float32)
        cls = rng.randint(0, cfg.num_class, 4)
        labels.append(build_label_grid_v2(corners, cls, cfg.S, cfg.B,
                                          cfg.anchors, cfg.num_class,
                                          float(size)) if per_slot else
                      build_label_grid(corners, cls, cfg.S, cfg.num_class,
                                       float(size)))
    return net, np.stack(labels)


def _row_offsets(cfg, lo: int, hi: int):
    off = np.asarray(cfg.offset, np.float32)
    return off[lo:hi], off.transpose(1, 0, 2)[lo:hi].copy()


@pytest.mark.parametrize("lo,hi", [(0, 3), (3, 7)])
def test_v1_loss_offsets_match_jax(lo, hi):
    """``yolo_loss_term_sums(offsets=)`` on grid rows lo:hi equals JAX's,
    and the row slices' sums add up to the whole grid's."""
    from tensorflow_yolo2_torch.config import YoloConfig
    from tensorflow_yolo2_torch.losses.yolo import yolo_loss_term_sums
    from tensorflow_yolo2_tpu.config import YoloConfig as JYoloConfig
    from tensorflow_yolo2_tpu.losses.yolo import (
        yolo_loss_term_sums as jax_sums,
    )

    cfg = YoloConfig()
    net, labels = _loss_inputs(cfg, False, seed=lo)
    off = _row_offsets(cfg, lo, hi)
    got = yolo_loss_term_sums(torch.from_numpy(net[:, lo:hi]),
                              torch.from_numpy(labels[:, lo:hi]), cfg,
                              offsets=tuple(map(torch.from_numpy, off)))
    want = jax_sums(net[:, lo:hi], labels[:, lo:hi], JYoloConfig(),
                    offsets=off)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6)
    whole = yolo_loss_term_sums(torch.from_numpy(net),
                                torch.from_numpy(labels), cfg)
    rest = [(0, lo), (hi, cfg.S)]
    parts = [got] + [yolo_loss_term_sums(
        torch.from_numpy(net[:, a:b]), torch.from_numpy(labels[:, a:b]),
        cfg, offsets=tuple(map(torch.from_numpy, _row_offsets(cfg, a, b))))
        for a, b in rest if b > a]
    for t in range(4):
        np.testing.assert_allclose(sum(p[t] for p in parts).numpy(),
                                   whole[t].numpy(), rtol=1e-5)


@pytest.mark.parametrize("pad", [False, True])
def test_v2_loss_hooks_match_jax(pad):
    """``yolo_v2_loss(offsets=, ignore_gt=, noobj_valid=)`` on grid rows
    3:7 of S=13, with the whole image's boxes for the ignore test (and
    the last two rows masked as padding), equals JAX's."""
    from tensorflow_yolo2_torch.config import yolo_v2_config
    from tensorflow_yolo2_torch.losses.yolo_v2 import yolo_v2_loss
    from tensorflow_yolo2_tpu.config import yolo_v2_config as jax_v2_config
    from tensorflow_yolo2_tpu.losses.yolo_v2 import (
        yolo_v2_loss as jax_v2_loss,
    )

    import jax.numpy as jnp

    cfg, jcfg = yolo_v2_config(416), jax_v2_config(416)
    net, labels = _loss_inputs(cfg, True, seed=5)
    lo, hi = 3, 7
    off = _row_offsets(cfg, lo, hi)
    gt_all = (labels[..., 1:5] / cfg.image_size).reshape(2, -1, 4)
    gt_valid = labels[..., 0].reshape(2, -1)
    valid = (np.arange(lo, hi) < hi - 2).astype(np.float32) if pad else \
        np.ones(hi - lo, np.float32)
    mask = valid[None, :, None, None]
    got, gaux = yolo_v2_loss(
        torch.from_numpy(net[:, lo:hi]), torch.from_numpy(labels[:, lo:hi]),
        cfg, step=3, offsets=tuple(map(torch.from_numpy, off)),
        ignore_gt=(torch.from_numpy(gt_all), torch.from_numpy(gt_valid)),
        noobj_valid=torch.from_numpy(mask))
    want, waux = jax_v2_loss(net[:, lo:hi], labels[:, lo:hi], jcfg,
                             step=jnp.asarray(3), offsets=off,
                             ignore_gt=(gt_all, gt_valid),
                             noobj_valid=mask)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for name in ("coord_loss", "object_loss", "noobject_loss",
                 "class_loss", "burnin_loss"):
        np.testing.assert_allclose(float(getattr(gaux, name)),
                                   float(getattr(waux, name)), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def _check_dp(got: dict, want: dict) -> None:
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=TOL)
    assert_close_all(got["model"], want["model"])
    assert_close_all(got["trace"], want["trace"])


def test_data_parallel_step_matches_joined_batch(ranks):
    """2 ranks, data 2: the loss, every gradient (momentum's first
    trace), the clipped update, the running statistics (BatchNorm synced
    over the ranks) equal one process's step on the joined batch, on
    both ranks."""
    got, want = ranks
    for r in range(2):
        assert got[2][r]["sharded"] == {}
        _check_dp(got[2][r]["dp"], want)


def test_data_and_model_parallel_step_matches_joined_batch(ranks):
    """4 ranks, data 2 × model 2: the 512- and 1024-wide convs are sliced
    over the model axis (their layers all-gather the channels), the
    model axis's second rank computes its first rank's rows (put_batch),
    and the gathered state equals the one-process step's."""
    got, want = ranks
    sharded = got[4][0]["sharded"]
    assert "detection.conv1.conv.weight" in sharded
    assert "backbone.conv13.conv.weight" in sharded  # 512 wide
    assert "detection.output.conv.weight" not in sharded  # 30 wide
    for r in range(4):
        _check_dp(got[4][r]["dp"], want)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
