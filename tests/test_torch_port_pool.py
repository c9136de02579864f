"""The port's 2×2/2 max-pool gradient (B5's plain version and the
``MaxPool2`` autograd function) against the JAX package: the Pallas
``max_pool2`` gradient, run interpreted on the CPU as
tests/test_pallas_pool.py runs it, and flax ``nn.max_pool``'s gradient
(XLA's SelectAndScatter).

Tolerance: exact. The gradient copies dout to one element of each window
and zeros the rest, so any difference is a wrong element, ties included
(integer-valued inputs tie in every window; bf16 rounding makes ties
common).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflow_yolo2_torch.models import layers as pt_layers
from tensorflow_yolo2_torch.ops import cuda_pool
from tensorflow_yolo2_tpu.ops import pallas_pool


def _jax_grads(x, dout):
    """(Pallas max_pool2 gradient, nn.max_pool gradient), NHWC."""
    x, dout = jnp.asarray(x), jnp.asarray(dout)

    def pallas(x):
        return jnp.sum(pallas_pool.max_pool2(x) * dout)

    def xla(x):
        return jnp.sum(nn.max_pool(x, (2, 2), (2, 2), "SAME") * dout)

    return jax.grad(pallas)(x), jax.grad(xla)(x)


def _nchw(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).permute(
        0, 3, 1, 2).to(dtype)


def _port_grads(x, dout, dtype):
    """(plain version, MaxPool2 autograd, F.max_pool2d autograd), NHWC
    float32."""
    xt, dt = _nchw(x, dtype), _nchw(dout, dtype)
    y = F.max_pool2d(xt, 2, 2)
    plain = cuda_pool.max_pool2_bwd_plain(xt, y, dt)
    outs = [plain]
    for pool in (cuda_pool.MaxPool2.apply, lambda t: F.max_pool2d(t, 2, 2)):
        leaf = xt.clone().requires_grad_()
        (pool(leaf) * dt).sum().backward()
        outs.append(leaf.grad)
    return [o.float().permute(0, 2, 3, 1).numpy() for o in outs]


def _assert_all_equal(x, dout, jdtype, tdtype):
    want_pallas, want_xla = (np.asarray(g, np.float32)
                             for g in _jax_grads(jnp.asarray(x, jdtype),
                                                 jnp.asarray(dout, jdtype)))
    np.testing.assert_array_equal(want_pallas, want_xla)
    for got in _port_grads(x, dout, tdtype):
        np.testing.assert_array_equal(got, want_pallas)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 16, 4, 5),
                                   (3, 4, 12, 8)])
def test_pool_bwd_matches_jax(shape):
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, shape).astype(np.float32)
    dout = rng.normal(0, 1, (shape[0], shape[1] // 2, shape[2] // 2,
                             shape[3])).astype(np.float32)
    _assert_all_equal(x, dout, jnp.float32, torch.float32)


def test_pool_bwd_ties_match_jax():
    """Integer-valued inputs tie in every window: the first element in
    row-major window order takes the gradient, in all five versions."""
    rng = np.random.RandomState(1)
    x = rng.randint(0, 3, (2, 8, 8, 4)).astype(np.float32)
    dout = rng.normal(1, 0.5, (2, 4, 4, 4)).astype(np.float32)
    _assert_all_equal(x, dout, jnp.float32, torch.float32)


def test_pool_bwd_bf16_ties_match_jax():
    """bf16 values (exact in float32 on both sides) tie often."""
    rng = np.random.RandomState(2)
    x = np.asarray(jnp.asarray(rng.normal(0, 1, (2, 16, 16, 8)),
                               jnp.bfloat16), np.float32)
    dout = np.asarray(jnp.asarray(rng.normal(0, 1, (2, 8, 8, 8)),
                                  jnp.bfloat16), np.float32)
    _assert_all_equal(x, dout, jnp.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("shape", [(1, 8, 8, 3), (1, 7, 8, 3),
                                   (1, 8, 9, 3), (2, 2, 2, 1)])
def test_supported_matches_jax(shape):
    """Shapes where the custom pool applies: 4-D, even H and W (NHWC in
    JAX, NCHW in the port)."""
    want = pallas_pool.supported(jnp.zeros(shape), 2, 2)
    n, h, w, c = shape
    assert cuda_pool.supported(torch.zeros(n, c, h, w)) == want
    assert not cuda_pool.supported(torch.zeros(h, w, c))


def test_max_pool_routes_only_recorded_gradients(monkeypatch):
    """layers.max_pool takes MaxPool2 when a gradient is recorded on an
    even shape; serving (no gradient) and odd shapes keep the ceil-mode
    pool, whose values are the same."""
    calls = []
    apply = cuda_pool.MaxPool2.apply
    monkeypatch.setattr(cuda_pool.MaxPool2, "apply",
                        lambda x: calls.append(x.shape) or apply(x))
    x = torch.randn(2, 3, 8, 6)
    want = F.max_pool2d(x, 2, 2)
    with torch.no_grad():
        torch.testing.assert_close(pt_layers.max_pool(x.requires_grad_()),
                                   want, rtol=0, atol=0)
    assert calls == []
    got = pt_layers.max_pool(x)
    assert calls == [x.shape]
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    odd = torch.randn(1, 2, 7, 6, requires_grad=True)
    assert pt_layers.max_pool(odd).shape == (1, 2, 4, 3)
    assert calls == [x.shape]


def test_plain_version_checks_its_inputs():
    x = torch.zeros(1, 2, 4, 4)
    y = torch.zeros(1, 2, 2, 2)
    with pytest.raises(ValueError, match="even"):
        cuda_pool.max_pool2_bwd_fused(torch.zeros(1, 2, 5, 4), y, y)
    with pytest.raises(ValueError, match="dout"):
        cuda_pool.max_pool2_bwd_fused(x, y, torch.zeros(1, 2, 2, 3))
    with pytest.raises(TypeError, match="one type"):
        cuda_pool.max_pool2_bwd_fused(x, y.double(), y)
    cuda_pool.reset_launch_counts()
    cuda_pool.max_pool2_bwd_fused(x, y, y)  # the CPU takes the plain version
    assert cuda_pool.MAX_POOL2_BWD_LAUNCHES == 0
