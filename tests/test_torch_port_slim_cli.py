"""The slim tier's CLIs on the CPU: ``train_classifier`` (snapshots,
resume, ``--save-interval-secs``, EMA and gradient accumulation in the
snapshot, activation summaries, ``--labels-offset``, every refusal),
``eval_classifier`` (``--use-ema`` with and without EMA in the snapshot,
the epoch-snapshot fallback, and top-1 / recall@5 counts equal to the
JAX package's on the same weights, carried by ``.npz``) and
``flowers_train``, on the ``synthetic`` and ``synthetic-bg`` datasets
and a ``make_flowers`` tree; in float32. The dataset factory's
refusals. The ``grad_norm`` departure under ``trainable_scopes``
(ROADMAP.md §C): on the ResNet-50 fine-tune, the port's metric is the
norm of the trained gradients alone, below the JAX package's.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import OptimizerConfig
from tensorflow_yolo2_torch.entries import datasets
from tensorflow_yolo2_torch.entries import eval_classifier as pt_eval
from tensorflow_yolo2_torch.entries import flowers_train
from tensorflow_yolo2_torch.entries import train_classifier as pt_train
from tensorflow_yolo2_torch.models import registry
from tensorflow_yolo2_torch.models.resnet import ResNet50V1
from tensorflow_yolo2_torch.train.checkpoint import (
    CheckpointManager,
    read_snapshot,
)
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task
from tests import synthetic
from tests.test_torch_port_models import random_variables
from tests.test_torch_port_resnet_train import (  # noqa: F401
    _f64,
    few_torch_threads,  # autouse
    to_sd,
)

CPU = ["--device", "cpu", "--compute-dtype", "float32"]
LENET = ["--model-name", "lenet", "--dataset-name", "synthetic",
         "--image-size", "28", "--batch-size", "4", "--num-workers", "1",
         "--log-every", "1", *CPU]


def run(main, argv: list[str]) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("TFY2_ROOT", str(tmp_path))
    return tmp_path


def _snap(name, imdb, step=None, epoch=False):
    mgr = CheckpointManager(name, imdb, save_by_epoch=epoch)
    return mgr.all_steps(), read_snapshot(mgr._path(step)[0])


def test_train_snapshots_resume_ema_and_accumulation(root):
    argv = [*LENET, "--moving-average-decay", "0.9", "--grad-accum-steps",
            "2", "--optimizer", "adam", "--learning-rate", "1e-3"]
    first = run(pt_train.main, ["--iters", "3", "--save-every", "2", *argv])
    second = run(pt_train.main, ["--iters", "2", "--save-every", "2", *argv])
    assert "Saved snapshot at iter 2 (iter 2)" in first
    assert "Saved final snapshot at iter 3 (iter 3)" in first
    assert "Restored snapshot at iter 3" in second
    steps, snap = _snap("lenet", "synthetic_10")
    assert steps == [2, 3, 4, 5]
    opt = snap["optimizer"]
    # 5 micro-steps at k = 2: 2 applied, one gradient waiting
    assert (snap["step"], opt["count"], opt["mini_step"]) == (5, 2, 1)
    assert set(opt) == {"count", "mini_step", "mu", "nu", "acc_grads"}
    assert float(opt["acc_grads"]["fc4.weight"].abs().max()) > 0
    assert set(snap["ema"]) == {k for k in snap["model"]}
    assert not torch.equal(snap["ema"]["fc4.weight"],
                           snap["model"]["fc4.weight"])


def test_save_interval_secs_and_summaries(root):
    log = run(pt_train.main, ["--iters", "3", "--save-every", "100",
                              "--save-interval-secs", "1e-9",
                              "--activation-summaries", *LENET])
    assert _snap("lenet", "synthetic_10")[0] == [1, 2, 3]
    assert "sparsity/conv1" in log and "sparsity/fc3" in log
    events = (root / "tensorboard" / "lenet" / "synthetic_10" / "train" /
              "events.jsonl").read_text()
    assert '"hist": "hist/act_conv2"' in events


def test_labels_offset(root):
    run(pt_train.main, ["--iters", "1", "--labels-offset", "1", *LENET,
                        "--dataset-name", "synthetic-bg"])
    _, snap = _snap("lenet", "synthetic_10")
    assert snap["model"]["fc4.weight"].shape == (9, 1024)
    with pytest.raises(ValueError, match="below the offset"):
        run(pt_train.main, ["--iters", "1", "--labels-offset", "1",
                            *LENET])


@pytest.mark.parametrize("argv, match", [
    (["--checkpoint-path", "model.ckpt"], "no TF checkpoint there"),
    (["--tf-checkpoint", "model.ckpt"], "reads no TF checkpoint"),
    (["--num-clones", "2"], "mesh 2x1 needs 2 devices, have 1 (start one "
                            "process a device: torchrun --nproc-per-node 2"),
    (["--model-parallel", "2"], "mesh 1x2 needs 2 devices, have 1"),
    (["--model-name", "inception_v2", "--aux-loss"],
     "inception_v2 has no auxiliary classifier head"),
    (["--aux-loss"], "no auxiliary classifier head"),
    (["--labels-offset", "10"], "out of range"),
])
def test_train_refusals(root, capsys, argv, match):
    with pytest.raises(SystemExit):
        pt_train.main(["--iters", "1", *LENET, *argv])
    assert match in capsys.readouterr().err


def test_eval_refusal_and_datasets(root, capsys):
    with pytest.raises(SystemExit):
        pt_eval.main([*CPU, "--tf-checkpoint", "model.ckpt"])
    assert "no TF checkpoint there" in capsys.readouterr().err
    for name in ("mnist", "cifar10"):  # no raw files under the root
        with pytest.raises(FileNotFoundError):
            datasets.get_dataset(name, data_path=str(root))
    with pytest.raises(ValueError, match="needs data_path"):
        datasets.get_dataset("prepared")
    with pytest.raises(ValueError, match="is not supported by dataset"):
        datasets.get_dataset("synthetic", preprocessing_name="vgg")
    with pytest.raises(ValueError, match="Name of dataset unknown"):
        datasets.get_dataset("svhn")


EVAL = ["--model-name", "lenet", "--dataset-name", "synthetic",
        "--image-size", "28", "--batch-size", "16", "--max-batches", "4",
        *CPU]


def test_eval_use_ema(root, monkeypatch):
    """With EMA in the snapshot, ``--use-ema`` scores the EMA
    parameters (the restore carried them: no warning), without it the
    raw ones."""
    run(pt_train.main, ["--iters", "2", "--moving-average-decay", "0.5",
                        *LENET])
    seen = []
    eval_outputs = Trainer.eval_outputs

    def spy(self, state, images, ema=False):
        seen.append(ema)
        return eval_outputs(self, state, images, ema)

    monkeypatch.setattr(Trainer, "eval_outputs", spy)
    ema = run(pt_eval.main, [*EVAL, "--use-ema"])
    assert "WARNING" not in ema and "over 64 images" in ema
    run(pt_eval.main, EVAL)
    assert seen == [True] * 4 + [False] * 4


def test_eval_use_ema_without_ema_falls_back(root):
    run(pt_train.main, ["--iters", "1", *LENET])
    out = run(pt_eval.main, [*EVAL, "--use-ema"])
    assert "restore carried no EMA tensors" in out
    assert out.splitlines()[-1] == run(pt_eval.main, EVAL).splitlines()[-1]


def test_eval_reads_epoch_snapshots(root):
    trainer = Trainer(registry.get_network("lenet", num_classes=10),
                      softmax_task(), OptimizerConfig(), device="cpu")
    state = trainer.create_state(torch.Generator().manual_seed(0))
    CheckpointManager("lenet", "synthetic_10", save_by_epoch=True).save(
        7, state)
    assert "eval at step 7:" in run(pt_eval.main, EVAL)


def test_eval_counts_match_jax_on_the_same_weights(tmp_path, monkeypatch):
    """The JAX package's ``eval_classifier`` on its snapshot of seeded
    random LeNet weights, and the port's on a snapshot of the same
    weights carried by ``convert.save_npz`` / ``load_npz``: the same
    accuracy and recall@5 over 64 synthetic images."""
    from tensorflow_yolo2_tpu import config as jx_config
    from tensorflow_yolo2_tpu.entries import eval_classifier as jx_eval
    from tensorflow_yolo2_tpu.models import registry as jx_registry
    from tensorflow_yolo2_tpu.parallel.mesh import make_mesh_for_batch
    from tensorflow_yolo2_tpu.train import Trainer as JxTrainer
    from tensorflow_yolo2_tpu.train.checkpoint import (
        CheckpointManager as JxManager,
    )
    from tensorflow_yolo2_tpu.train.trainer import (
        softmax_task as jx_softmax,
    )

    jx_model = jx_registry.get_network("lenet", num_classes=10)
    params = random_variables(jx_model, (1, 28, 28, 3), seed=9)["params"]
    monkeypatch.setenv("TFY2_ROOT", str(tmp_path / "jax"))
    jtrainer = JxTrainer(jx_model, jx_softmax(), jx_config.OptimizerConfig(),
                         mesh=make_mesh_for_batch(16))
    jstate = jtrainer.create_state(jax.random.PRNGKey(0),
                                   np.zeros((1, 28, 28, 3), np.float32))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          params))
    JxManager("lenet", "synthetic_10").save(1, jax.device_get(jstate))
    want = run(jx_eval.main, EVAL[:-len(CPU)] + ["--compute-dtype",
                                                  "float32"])
    npz = str(tmp_path / "lenet.npz")
    convert.save_npz(npz, params)
    monkeypatch.setenv("TFY2_ROOT", str(tmp_path / "port"))
    trainer = Trainer(registry.get_network("lenet", num_classes=10),
                      softmax_task(), OptimizerConfig(), device="cpu")
    state = trainer.create_state(torch.Generator().manual_seed(0),
                                 convert.state_dict_from_flax(
                                     *convert.load_npz(npz)))
    CheckpointManager("lenet", "synthetic_10").save(1, state)
    got = run(pt_eval.main, EVAL)
    line = [ln for ln in want.splitlines() if ln.startswith("eval at")]
    assert got.splitlines()[-1] == line[-1]
    assert "over 64 images" in line[-1]


def test_flowers_cli_chain(root):
    """``train_classifier`` on its defaults (darknet19 on flowers,
    rmsprop with weight decay 4e-5) with EMA, accumulation and
    summaries, ``eval_classifier --use-ema`` on its snapshot, and
    ``flowers_train`` resuming that run dir (its Adam is an optimizer
    swap), at 64²."""
    synthetic.make_flowers(str(root / "data" / "TF_flowers"), per_class=4)
    common = ["--image-size", "64", "--batch-size", "4", "--num-workers",
              "1", *CPU]
    run(pt_train.main, ["--iters", "2", "--moving-average-decay", "0.999",
                        "--grad-accum-steps", "2", "--activation-summaries",
                        *common])
    _, snap = _snap("darknet19", "tf_flowers")
    assert set(snap["optimizer"]) == {"count", "mini_step", "nu", "trace",
                                      "acc_grads"}
    out = run(pt_eval.main, ["--use-ema", *common])
    assert "WARNING" not in out and "eval at step 2:" in out
    out = run(flowers_train.main, ["--iters", "2", "--eval-every", "1",
                                   *common])
    assert "optimizer re-initialized" in out
    assert "Saved snapshot at iter 4 (iter 4)" in out


def test_grad_norm_leaves_out_the_frozen_gradients():
    """The fault recorded in ROADMAP.md §C: on the ResNet-50 fine-tune
    (``trainable_scopes=("logits",)``), the JAX step's ``grad_norm`` is
    the norm of every gradient, the frozen trunk's too; the port computes
    only the trained ones and reports their norm, the same as the norm of
    JAX's logits gradients, and below the JAX metric. Training is the
    same in both (``tests/test_torch_port_resnet_freeze.py``). In
    float64, at 32² and batch 2: in float32 a BatchNorm over the two
    values of a 1×1 block4 map loses most of its digits."""
    from tensorflow_yolo2_tpu.models import resnet as jx_resnet
    from tensorflow_yolo2_tpu.train.trainer import (
        softmax_task as jx_softmax,
    )

    rng = np.random.RandomState(4)
    images = rng.uniform(-1, 1, (2, 32, 32, 3))
    labels = rng.randint(0, 10, 2).astype(np.int32)
    with jax.enable_x64(True):
        variables = _f64(random_variables(
            jx_resnet.ResNet50V1(num_classes=10, global_pool=True),
            (1, 32, 32, 3), seed=11))
        jx_model = jx_resnet.ResNet50V1(
            num_classes=10, global_pool=True, dtype=jnp.float64,
            param_dtype=jnp.float64)

        def loss(params):
            out, _ = jx_model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                images, train=True, mutable=["batch_stats"])
            return jx_softmax()(out, labels)[0]

        grads = jax.jit(jax.grad(loss))(variables["params"])
        jx_all = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in
                                    jax.tree_util.tree_leaves(grads))))
        jx_logits = float(jnp.sqrt(sum(
            jnp.sum(g ** 2) for g in
            jax.tree_util.tree_leaves(grads["logits"]))))
        init = to_sd(variables["params"], variables["batch_stats"])
    trainer = Trainer(ResNet50V1(10, global_pool=True).double(),
                      softmax_task(),
                      OptimizerConfig(name="momentum",
                                      trainable_scopes=("logits",)),
                      device="cpu", compute_dtype=torch.float32)
    state = trainer.create_state(
        torch.Generator().manual_seed(0), {
            **{k: v for k, v in trainer.model.state_dict().items()
               if k.endswith("num_batches_tracked")}, **init})
    _, metrics = trainer.train_step(state, images, labels)
    port = float(metrics["grad_norm"])
    # both losses are float32 (the nets cast their logits): measured 6.8e-6
    np.testing.assert_allclose(port, jx_logits, rtol=1e-5)
    assert port < 0.99 * jx_all
