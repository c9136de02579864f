"""``tests/test_torch_port_slim_trainer.py``'s tests on ``resnet_v2_50``
at 64² (BatchNorm: its running statistics after each micro-step, and
under ``remat`` moved once a step), in a file of their own so that each
file stays under a minute. Tolerances there."""

import pytest

from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)
from tests.test_torch_port_slim_trainer import (  # noqa: F401
    make_runs,
    test_activation_summaries_match_jax,
    test_first_micro_step_applies_nothing,
    test_losses_match,
    test_remat_step_is_bit_equal_to_the_plain_step,
    test_second_micro_step_matches_jax,
)

NETS = ["resnet_v2_50"]


@pytest.fixture(scope="module", params=NETS)
def runs(request):
    return make_runs(request.param)


def pytest_generate_tests(metafunc):
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", NETS)
