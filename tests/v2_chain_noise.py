"""The last-bit noise of the v2 chains of ``test_torch_port_v2_chain.py``,
over ``STEPS`` steps of its configuration: for each head, the chain in
the JAX package, in the port, and in the port with one float32 ulp of
noise on its head output at every step (``one_ulp_noise``) under three
seeds, all from the same float64 state on the same batches; then the
distance of every pair of them, in the chain test's measures (the largest relative difference of a step's metrics,
the largest relative norm of a parameter tensor but the pre-BN conv
biases, of a BatchNorm statistic and of an Adam moment).

Where JAX's distance from the port is of the size of the port's distance
from itself under one ulp of noise, the chain's gap is last-bit noise.
Runs on the CPU in ~3 minutes, one chain at a time (~4 GB):

    JAX_PLATFORMS=cpu python -m tests.v2_chain_noise
"""

import dataclasses
import itertools

import jax
import numpy as np
import torch

from tensorflow_yolo2_torch.config import yolo_v2_config
from tensorflow_yolo2_tpu import config as jx_config
from tests import test_torch_port_v2_chain as chain
from tests.test_torch_port_models import random_variables
from tests.test_torch_port_resnet_train import TORCH_THREADS
from tests.test_torch_port_train import _pre_bn_bias, rel_norm

NOISE_SEEDS = (7, 8, 9)
STEPS = 4  # the test's configuration, two steps further


def distances(a: dict, b: dict) -> dict[str, float]:
    """The chain test's measures between two chains' results."""
    trained = [k for k in a["mu"] if not _pre_bn_bias(k, list(a["mu"]))]
    return {
        "metrics": max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                       for x, y in zip(a["metrics"], b["metrics"])
                       for k in y),
        "params": max(rel_norm(a["model"][k], b["model"][k])
                      for k in trained),
        "stats": max(rel_norm(a["model"][k], b["model"][k])
                     for k in b["model"] if "running" in k),
        "moments": max(rel_norm(a[s][k], b[s][k])
                       for s in ("mu", "nu") for k in trained),
    }


def main() -> None:
    torch.set_num_threads(TORCH_THREADS)
    jcfg = dataclasses.replace(
        jx_config.yolo_v2_config(64, anchors=chain.ANCHORS),
        v2_burnin_samples=chain.BURNIN_SAMPLES)
    pcfg = dataclasses.replace(yolo_v2_config(64, anchors=chain.ANCHORS),
                               v2_burnin_samples=chain.BURNIN_SAMPLES)
    batches = chain.chain_batches(jcfg, STEPS)
    for head in chain.HEADS:
        variables = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64),
            random_variables(chain.jax_models(head), (1, 64, 64, 3), seed=3))
        init = chain.sd64(variables["params"], variables["batch_stats"])
        runs = {"jax": chain.jax_chain(head, jcfg, variables, batches),
                "port": chain.port_chain(head, pcfg, init, batches)}
        for seed in NOISE_SEEDS:
            runs[f"noise{seed}"] = chain.port_chain(head, pcfg, init,
                                                    batches, None, seed)
        print(f"{head}: {'pair':<18} metrics  params   stats    moments")
        for x, y in itertools.combinations(runs, 2):
            d = distances(runs[x], runs[y])
            print(f"{head}: {x + ' ' + y:<18} " +
                  " ".join(f"{d[k]:.2e}" for k in d))


if __name__ == "__main__":
    main()
