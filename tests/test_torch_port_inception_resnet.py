"""``inception_resnet_v2`` against the JAX package's on the CPU at 160²,
through the tests of ``tests/test_torch_port_inception_model.py`` (eval
mode in float32 to 1e-4, train mode and its running statistics in
float64 to 1e-9; see there): its residual blocks' scales (0.17, 0.10,
0.20) and the final ``block8_post`` without a ReLU among them.
"""

import pytest

from tests.test_torch_port_inception_model import (  # noqa: F401
    net_results,
    test_forward_eval_matches_jax,
    test_forward_train_and_statistics_match_jax,
)
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)


@pytest.fixture(scope="module", params=["inception_resnet_v2"])
def net(request):
    return net_results(request.param)
