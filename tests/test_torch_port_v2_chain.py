"""A chain of the quality recipe's train steps of the plain YOLOv2 anchor
head (``Darknet19Detector(125, bn_on_output=False)``, ``--v2``) and, as
its yardstick, of the passthrough head (``Darknet19DetectorV2``,
``--v2 --passthrough``), in the JAX package and in the port, from one
float64 state, on the CPU.

The recipe is ``pascal_train_darknet``'s with ``--bn-momentum 0.9
--grad-clip``: Adam at 1e-3 behind optax's global-norm clip, BatchNorm
momentum 0.9 in every layer, k-means-like priors (not the classic VOC
ones), the burn-in prior on for the first steps. Each side takes
``N_STEPS`` consecutive train steps on the same seeded batches (64²,
S=2, B=5, batch 4, full depth); the port saves its state after step 0
through ``train.checkpoint`` and resumes it into a fresh ``Trainer``
through ``entries.common.bootstrap_state``, as a stage process resumes,
while JAX runs straight through. The burn-in is on in step 0 and off in
step 1 (``v2_burnin_samples`` 4, one batch; the resumed step count
switches it off), and the clip binds in step 1 and not in step 0 (the
gradients' norms 2.4e4-2.9e4, then 4.3e4-4.7e4, against ``CLIP`` 3.5e4).
Two steps keep the file near 30 s of tests: both heads' float64 JAX
compiles dominate it.

Tolerances. One step is held to JAX at 1e-6 in
``test_torch_port_v2_train.py``; a chain cannot be: the float32 loss's
last bits differ between the libraries, and Adam turns them into moves of
up to ~2·lr for the weights whose gradient is as small as that noise,
which moves every output of the next steps. The bounds are the
passthrough chain's own last-bit noise, rounded up: over four steps of
this configuration, the port with one float32 ulp of noise on its head
output under one seed of three parts from the port by 1.8e-3 in the
metrics, 5.1e-4 in the parameters, 6.5e-4 in the statistics and 2.4e-2
in Adam's moments (``python -m tests.v2_chain_noise``). Both heads are
held to them; measured against JAX, plain v2 / passthrough:

- each step's loss terms and metrics: rtol 1e-3 (1.5e-5 / 4.3e-7);
- after the chain, each parameter tensor (relative norm): 1e-3 (3.6e-5 /
  3.3e-6); a conv bias in front of BatchNorm, whose true gradient is 0
  and whose Adam steps are sign noise: within 2·lr·N_STEPS (5.2e-7 /
  2.4e-7);
- each BatchNorm statistic (relative norm): 1e-3 (2.1e-5 / 5.6e-7);
- Adam's first and second moments of each trained tensor but the pre-BN
  conv biases (relative norm): 5e-2 (1.4e-4 / 3.3e-6);
- the step counts, the burn-in's on/off pattern and the clip's
  bind/no-bind pattern: equal.

The plain head's gap is the larger here, and it is last-bit noise, not a
difference of the port: over the same four steps the port with one ulp
of noise under seeds 7, 8 and 9 splits into two clusters of
trajectories, {the port, seed 8} and {JAX, seeds 7 and 9}, 4.2e-3 /
1.6e-3 / 1.5e-3 / 6.4e-2 apart, and JAX lies within 1.4e-5 of seeds 7
and 9; the passthrough head splits the same way, with JAX in the port's
cluster (``tests/v2_chain_noise.py``).
"""

import concurrent.futures
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
    yolo_v2_config,
)
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.losses.yolo_v2 import yolo_v2_task
from tensorflow_yolo2_torch.models.darknet import (
    Darknet19Detector,
    Darknet19DetectorV2,
)
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.train.trainer import Trainer
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.losses.yolo_v2 import yolo_v2_task as jx_v2_task
from tensorflow_yolo2_tpu.models import darknet as jx_darknet
from tensorflow_yolo2_tpu.parallel import MeshConfig, make_mesh
from tensorflow_yolo2_tpu.train import Trainer as JxTrainer
from tensorflow_yolo2_tpu.train import optimizers as jx_opt
from tensorflow_yolo2_tpu.train.trainer import TrainState as JxTrainState
from tests.test_torch_port_models import random_variables
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)
from tests.test_torch_port_train import _pre_bn_bias, _scalars, rel_norm

LR = 1e-3
N_STEPS = 2
RESUME_AT = 1
CLIP = 3.5e4
BN_MOMENTUM = 0.9
BURNIN_SAMPLES = 4  # the burn-in prior on step 0 alone at batch 4
# the batch, the priors (in the cells of the 2×2 grid, of k-means'
# spread, not classic) and the batches of the card's float32 chains
BATCH = chip_smoke.V2_CHAIN_BATCH
ANCHORS = chip_smoke.V2_CHAIN_ANCHORS
chain_batches = chip_smoke.v2_chain_batches

METRIC_RTOL = 1e-3
PARAM_REL = 1e-3
STAT_REL = 1e-3
MOMENT_REL = 5e-2


def sd64(params, stats=None) -> dict[str, torch.Tensor]:
    """A flax tree (params, and batch statistics) as the port's state-dict
    entries in float64, without copies: the keys of
    ``convert.state_dict_from_flax`` (from a tree of one-element arrays of
    the same paths), the values permuted to the torch layout."""
    params, stats = jax.device_get((params, stats))
    ones = jax.tree_util.tree_map(lambda a: np.zeros((1,) * np.ndim(a),
                                                     np.float32),
                                  (params, stats or {}))
    keys = [k for k in convert.state_dict_from_flax(*ones)
            if not k.endswith("num_batches_tracked")]
    leaves = [*convert.flatten(params).values(),
              *convert.flatten(stats or {}).values()]
    out = {}
    for k, leaf in zip(keys, leaves, strict=True):
        t = torch.from_numpy(np.asarray(leaf, np.float64))
        out[k] = t.permute(3, 2, 0, 1) if t.dim() == 4 else t
    return out


def jax_models(head: str):
    kw = dict(output_channels=len(ANCHORS) * 25, dtype=jnp.float64,
              param_dtype=jnp.float64, bn_momentum=BN_MOMENTUM)
    if head == "v2p":
        return jx_darknet.Darknet19DetectorV2(**kw)
    return jx_darknet.Darknet19Detector(bn_on_output=False, **kw)


def port_model(head: str, cfg) -> torch.nn.Module:
    if head == "v2p":
        return Darknet19DetectorV2(cfg.cell_channels, bn_momentum=BN_MOMENTUM)
    return Darknet19Detector(cfg.cell_channels, bn_on_output=False,
                             bn_momentum=BN_MOMENTUM)


def port_trainer(head: str, cfg) -> Trainer:
    """``pascal_train_darknet``'s trainer (``--grad-clip CLIP``) around a
    float64 model: float32 loss, no autocast."""
    return Trainer(port_model(head, cfg).double(), yolo_v2_task(cfg),
                   OptimizerConfig(name="adam", schedule=LRScheduleConfig(
                       learning_rate=LR), grad_clip_norm=CLIP),
                   device="cpu", compute_dtype=torch.float32)


def jax_chain(head: str, jcfg, variables, batches) -> dict:
    """JAX's ``Trainer.train_step`` N times from ``variables`` (the
    optimizer as ``pascal_train_darknet`` builds it: ``make_optimizer``
    of its ``OptimizerConfig``)."""
    with jax.enable_x64(True):
        trainer = JxTrainer(
            jax_models(head), jx_v2_task(jcfg),
            jx_config.OptimizerConfig(
                name="adam",
                schedule=jx_config.LRScheduleConfig(learning_rate=LR),
                grad_clip_norm=CLIP),
            mesh=make_mesh(MeshConfig(data=1, model=1)))
        trainer.tx = jx_opt.make_optimizer(trainer.opt_cfg)
        state = trainer.shard_state(JxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=trainer.tx.init(variables["params"]),
            rng=jax.random.PRNGKey(1)))
        metrics = []
        for images, labels in batches:
            state, m = trainer.train_step(state, images, labels)
            metrics.append(_scalars(m))
        # optax.chain(clip_by_global_norm, adam): adam's ScaleByAdamState
        adam = state.opt_state[1][0]
        return {"metrics": metrics, "step": int(state.step),
                "model": sd64(state.params, state.batch_stats),
                "mu": sd64(adam.mu), "nu": sd64(adam.nu)}


def one_ulp_noise(task, seed: int):
    """``task`` on the head output moved by one float32 ulp up or down, or
    left, each element at random (seeded): last-bit noise of the size by
    which two libraries' float32 losses differ."""
    gen = torch.Generator().manual_seed(seed)

    def noisy(outputs, labels, step=None):
        pick = torch.randint(-1, 2, outputs.shape, generator=gen)
        moved = torch.nextafter(outputs, pick.to(outputs.dtype) * torch.inf)
        return task(torch.where(pick == 0, outputs, moved), labels, step=step)

    return noisy


def port_chain(head: str, pcfg, init, batches, root=None,
               noise_seed: int | None = None) -> dict:
    """The port's ``Trainer.train_step`` N times from ``init``: a snapshot
    after ``RESUME_AT`` steps in ``root``, restored into a fresh trainer
    and model by ``bootstrap_state``, which the chain carries on from.
    With ``noise_seed``, no snapshot, and every step's loss on
    ``one_ulp_noise`` of the head output: the port's own sensitivity to
    last-bit noise."""
    trainer = port_trainer(head, pcfg)
    if noise_seed is not None:
        trainer.task = one_ulp_noise(trainer.task, noise_seed)
    state = trainer.create_state(torch.Generator().manual_seed(0), init)
    metrics, resumed = [], None
    for i, (images, labels) in enumerate(batches):
        if i == RESUME_AT and root is not None:
            mgr = CheckpointManager(f"darknet19_{head}", "voc_2007",
                                    paths=Paths(root=str(root)), yolo=pcfg)
            common.save_snapshot(trainer, mgr, i, state)
            trainer = port_trainer(head, pcfg)
            state, start = common.bootstrap_state(
                trainer, mgr, torch.Generator().manual_seed(1))
            resumed = (start, state.step, state.opt_state.count)
            shutil.rmtree(mgr.dir)  # ~1.2 GB of float64 state and slots
        state, m = trainer.train_step(state, images, labels)
        metrics.append(_scalars(m))
    return {"metrics": metrics, "step": state.step, "resumed": resumed,
            "model": {k: v for k, v in state.model.state_dict().items()
                      if not k.endswith("num_batches_tracked")},
            "mu": state.opt_state.slots["mu"],
            "nu": state.opt_state.slots["nu"]}


HEADS = ("v2", "v2p")


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Both heads' chains on both sides. JAX's two chains run in threads
    (XLA releases the interpreter lock) while the port's run one after
    the other here, so that JAX's compiles overlap the port's steps and
    at most three float64 states of ~1.2 GB with their slots are alive
    at once."""
    jcfg = dataclasses.replace(jx_config.yolo_v2_config(64, anchors=ANCHORS),
                               v2_burnin_samples=BURNIN_SAMPLES)
    pcfg = dataclasses.replace(yolo_v2_config(64, anchors=ANCHORS),
                               v2_burnin_samples=BURNIN_SAMPLES)
    batches = chain_batches(jcfg, N_STEPS)
    runs = {}
    with concurrent.futures.ThreadPoolExecutor(len(HEADS)) as pool:
        for head in HEADS:
            variables = jax.tree_util.tree_map(
                lambda a: a.astype(np.float64),
                random_variables(jax_models(head), (1, 64, 64, 3), seed=3))
            runs[head] = {"head": head, "want": pool.submit(
                jax_chain, head, jcfg, variables, batches), "init": sd64(
                    variables["params"], variables["batch_stats"])}
        for head, run in runs.items():
            run["got"] = port_chain(head, pcfg, run.pop("init"), batches,
                                    tmp_path_factory.mktemp(f"chain_{head}"))
        for run in runs.values():
            run["want"] = run["want"].result()
    return runs


@pytest.fixture(params=HEADS)
def chain(request, chains):
    return chains[request.param]


def _trained(run) -> list[str]:
    return list(run["got"]["mu"])


def test_chain_crosses_burn_in_the_clip_and_a_resume(chain):
    """The chain's structure on both sides: burn-in on before step
    ``BURNIN_SAMPLES / BATCH`` and off from it, the clip binding on some
    steps and not on others, the port resumed at ``RESUME_AT`` with its
    step and Adam count, both ending at step ``N_STEPS``."""
    want, got = chain["want"], chain["got"]
    off = BURNIN_SAMPLES // BATCH
    for side in (want, got):
        burn = [m["burnin_loss"] for m in side["metrics"]]
        assert all(b > 0 for b in burn[:off]), burn
        assert all(b == 0 for b in burn[off:]), burn
        clipped = [m["grad_norm"] > CLIP for m in side["metrics"]]
        assert any(clipped) and not all(clipped), clipped
    assert [m["grad_norm"] > CLIP for m in got["metrics"]] == \
        [m["grad_norm"] > CLIP for m in want["metrics"]]
    assert got["resumed"] == (RESUME_AT, RESUME_AT, RESUME_AT)
    assert got["step"] == want["step"] == N_STEPS


def test_chain_losses_and_metrics_match_jax(chain):
    """Every step's loss, terms, mean IoU and gradient norm."""
    for i, (got, want) in enumerate(zip(chain["got"]["metrics"],
                                        chain["want"]["metrics"],
                                        strict=True)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                       atol=1e-12, err_msg=f"step {i} {k}")


def test_chain_params_match_jax(chain):
    got, want = chain["got"]["model"], chain["want"]["model"]
    trained = _trained(chain)
    assert len(trained) == len([k for k in want if "running" not in k])
    for k in trained:
        if _pre_bn_bias(k, trained):
            diff = float((got[k] - want[k]).abs().max())
            assert diff <= 2 * LR * N_STEPS, k
        else:
            assert rel_norm(got[k], want[k]) < PARAM_REL, k


def test_chain_batch_stats_match_jax(chain):
    got, want = chain["got"]["model"], chain["want"]["model"]
    stats = [k for k in want if "running" in k]
    assert len(stats) == 2 * (22 if chain["head"] == "v2p" else 21)
    for k in stats:
        assert rel_norm(got[k], want[k]) < STAT_REL, k


def test_chain_adam_moments_match_jax(chain):
    trained = _trained(chain)
    for slot in ("mu", "nu"):
        got, want = chain["got"][slot], chain["want"][slot]
        assert set(got) == set(want)
        for k in trained:
            if not _pre_bn_bias(k, trained):
                assert rel_norm(got[k], want[k]) < MOMENT_REL, (slot, k)
