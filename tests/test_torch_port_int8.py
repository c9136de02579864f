"""The port's int8 quantization (``ops/quant.py``) against the JAX
package's, on the CPU at 32² (S=1, the full 22- or 23-conv chain), as
``tests/test_quant.py`` runs it. (The entry points that serve it:
tests/test_torch_port_int8_serving.py.)

Tolerances:
- ``layer_plan`` and ``quantize_folded`` (from the same folded weights and
  scales): equal, bit for bit.
- ``calibrate``: each scale within 1e-4 relative of JAX's (float32 convs
  summed in other orders; measured ≤ 1.5e-6 at percentile 100, ≤ 3.3e-5
  at 99.9, where the interpolated position sits between sparse tail
  values).
- ``forward_int8`` layer by layer, each conv fed JAX's int8 input: the
  int32 sums equal; the requantized int8 within one level of JAX's and
  ≥ 99.9% equal (JAX's jitted epilogue fuses acc·scale + bias into one
  rounding, the port rounds the multiply and the add apart, as JAX does
  unjitted: a value at a .5 tie can land on either side); the final grid
  of the whole chain within 1e-6 relative norm of JAX's jitted
  ``forward_int8``.

No test here needs a compiler.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.ops import quant as pq
from tensorflow_yolo2_tpu.models.darknet import (
    Darknet19Detector,
    Darknet19DetectorV2,
)
from tensorflow_yolo2_tpu.models.fold import fold_params
from tensorflow_yolo2_tpu.models.layers import leaky_relu, space_to_depth
from tensorflow_yolo2_tpu.ops import quant as jq
from tests.test_torch_port_models import random_variables

IMG = 32
CALIB_REL_TOL = 1e-4
GRID_REL_TOL = 1e-6
INT8_EQUAL_SHARE = 0.999
HEADS = {  # name → (flax module, v2, head)
    "v1": (Darknet19Detector(output_channels=30), False, "detector"),
    "v2": (Darknet19Detector(output_channels=125, bn_on_output=False), True,
           "detector"),
    "v2p": (Darknet19DetectorV2(output_channels=125), True, "detector_v2p"),
}


@functools.cache
def _variables(name: str, seed: int, size: int):
    return random_variables(HEADS[name][0], (1, size, size, 3), seed=seed)


def variables(name: str, seed: int, size: int = IMG):
    """Seeded numpy weights of a head (``random_variables``), a fresh copy
    of a cached draw."""
    return copy.deepcopy(_variables(name, seed, size))


def images(seed: int = 0, n: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, IMG, IMG, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=list(HEADS))
def head(request):
    """A head's seeded flax variables, folded, as the port's state dict
    too, JAX's scales on ``images()`` and JAX's and the port's layers."""
    _, v2, plan_head = HEADS[request.param]
    v = variables(request.param, 5)
    # (jitted fold: both packages start from these folded weights)
    folded = jax.tree_util.tree_map(
        np.asarray, jax.jit(fold_params)(v["params"], v["batch_stats"]))
    state = convert.state_dict_from_flax(folded, None)
    scales = np.asarray(jq.calibrate(folded, jnp.asarray(images()), v2=v2,
                                     head=plan_head))
    jlayers = jq.quantize_folded(folded, scales, v2=v2, head=plan_head)
    return {"name": request.param, "variables": v, "folded": folded,
            "state": state, "v2": v2, "head": plan_head, "scales": scales,
            "jlayers": jlayers,
            "players": tuple({k: torch.from_numpy(np.array(layer[k]))
                              for k in pq.KEYS} for layer in jlayers)}


@pytest.mark.parametrize("v2,plan_head", [
    (False, "detector"), (True, "detector"), (False, "detector_v2p"),
    (False, "classifier"), (True, "classifier")])
def test_layer_plan_matches_jax(v2, plan_head):
    assert pq.layer_plan(v2, plan_head) == jq.layer_plan(v2, plan_head)


def test_quantize_folded_is_bit_equal(head):
    """From the same folded weights and scales: every array equal, with
    JAX's types and shapes (HWIO int8 kernels)."""
    got = pq.quantize_folded(head["state"], torch.from_numpy(head["scales"].copy()),
                             v2=head["v2"], head=head["head"])
    assert len(got) == len(head["jlayers"])
    for mine, theirs in zip(got, head["jlayers"]):
        for k in pq.KEYS:
            want = np.asarray(theirs[k])
            assert mine[k].numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(mine[k].numpy(), want, err_msg=k)
    assert int(got[0]["kernel"].abs().max()) == 127


@pytest.mark.parametrize("percentile", [100.0, 99.9])
def test_calibrate_matches_jax(head, percentile):
    want = np.asarray(jq.calibrate(head["folded"], jnp.asarray(images()),
                                   v2=head["v2"], head=head["head"],
                                   percentile=percentile))
    got = pq.calibrate(head["state"], torch.from_numpy(images()),
                       v2=head["v2"], head=head["head"],
                       percentile=percentile).numpy()
    assert got.shape == want.shape == (len(head["jlayers"]),)
    np.testing.assert_allclose(got, want, rtol=CALIB_REL_TOL, atol=0)
    if percentile < 100:
        full = pq.calibrate(head["state"], torch.from_numpy(images()),
                            v2=head["v2"], head=head["head"]).numpy()
        assert np.all(got <= full) and np.any(got < full)


def test_percentile_above_2_24_elements():
    """``torch.quantile`` refuses more than 2²⁴ elements; the helper
    takes them, within 1e-4 of ``np.percentile`` (whose position is in
    float64: above 2²⁴ the float32 position can be places off, and the
    tail's neighbours differ by ~1e-5 relative). On a small tensor it
    equals ``jnp.percentile``."""
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (1 << 24) + 3).astype(np.float32))
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(x, 0.999)
    np.testing.assert_allclose(float(pq.percentile_linear(x, 99.9)),
                               np.percentile(x.numpy(), 99.9), rtol=1e-4)
    small = x[:1000]
    assert float(pq.percentile_linear(small, 99.9)) == float(
        jnp.percentile(jnp.asarray(small.numpy()), 99.9))


def trace_steps(v2, plan_head):
    """Per conv of the plan: (conv index, activated, the index of the conv
    whose input scale requantizes its output, None for the last)."""
    plan, convs = jq.layer_plan(v2, plan_head)
    steps, ci = [], 0
    for si, step in enumerate(plan):
        if step == "pt":
            steps.append((ci, True, ci + 1))
            ci += 1
        elif step == "conv":
            last = ci + 1 == len(convs)
            nxt = None if last else (ci + 2 if plan[si + 1] == "pt"
                                     else ci + 1)
            steps.append((ci, convs[ci][1], nxt))
            ci += 1
    return steps


@functools.partial(jax.jit, static_argnums=(2, 3))
def jax_trace(layers, x, v2, plan_head):
    """JAX's ``forward_int8`` (jitted, as its serving path runs it), step
    by step: for each conv of ``trace_steps`` its int8 input, its int32
    sums, and the int8 map it requantizes to (the final float32 map for
    the last)."""
    plan, convs = jq.layer_plan(v2, plan_head)
    x = jq._quantize_act(jnp.asarray(x), layers[0]["inv_in"])
    out, mid, ci = [], None, 0

    def conv(x, layer):
        return lax.conv_general_dilated(
            x, layer["kernel"], (1, 1), "SAME", dimension_numbers=jq._DIMS,
            preferred_element_type=jnp.int32)

    for si, step in enumerate(plan):
        if step == "pool":
            x = jq._max_pool_int8(x)
        elif step == "mid":
            mid = x
        elif step == "pt":
            layer = layers[ci]
            ci += 1
            acc = conv(mid, layer)
            p = acc.astype(jnp.float32) * layer["scale"] + layer["bias"]
            p = jq._quantize_act(leaky_relu(p), layers[ci]["inv_in"])
            out.append((mid, acc, p))
            x = jnp.concatenate([x, space_to_depth(p)], axis=-1)
        else:
            layer = layers[ci]
            activated = convs[ci][1]
            ci += 1
            acc = conv(x, layer)
            y = acc.astype(jnp.float32) * layer["scale"] + layer["bias"]
            if activated:
                y = leaky_relu(y)
            if ci == len(layers):
                out.append((x, acc, y))
                return out
            nxt = ci + 1 if plan[si + 1] == "pt" else ci
            x_next = jq._quantize_act(y, layers[nxt]["inv_in"])
            out.append((x, acc, x_next))
            x = x_next
    raise AssertionError("no output conv")


def test_forward_int8_layer_by_layer(head):
    """Each conv fed JAX's int8 input: the int32 sums equal JAX's, the
    requantized int8 within one level (≥ 99.9% equal); the whole chain's
    grid within GRID_REL_TOL of JAX's ``forward_int8``."""
    jl, pl = head["jlayers"], head["players"]
    x = images(seed=7)
    arrays = jax_trace(jl, x, head["v2"], head["head"])
    steps = trace_steps(head["v2"], head["head"])
    assert len(steps) == len(arrays) == len(jl)
    want_grid = np.asarray(arrays[-1][-1])
    np.testing.assert_array_equal(want_grid, np.asarray(jax.jit(
        jq.forward_int8, static_argnames=("v2", "head"))(
        jl, jnp.asarray(x), v2=head["v2"], head=head["head"])))
    equal = total = 0
    for (ci, activated, nxt), (x_in, acc, out) in zip(steps, arrays):
        x_in = torch.from_numpy(np.array(x_in))
        assert x_in.dtype == torch.int8
        got = pq.conv_int8(x_in, pl[ci])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(acc),
                                      err_msg=f"conv {ci}")
        y = pq.dequantize(got, pl[ci], activated)
        if nxt is None:
            np.testing.assert_allclose(y.numpy(), np.asarray(out), rtol=1e-6,
                                       atol=1e-6)
            continue
        q = pq.quantize_act(y, pl[nxt]["inv_in"]).numpy().astype(np.int32)
        want = np.asarray(out).astype(np.int32)
        assert np.abs(q - want).max() <= 1, f"conv {ci}"
        equal += int((q == want).sum())
        total += q.size
    assert equal >= INT8_EQUAL_SHARE * total
    got_grid = pq.forward_int8(pl, torch.from_numpy(x), v2=head["v2"],
                               head=head["head"]).numpy()
    assert got_grid.shape == want_grid.shape
    rel = np.linalg.norm(got_grid - want_grid) / np.linalg.norm(want_grid)
    assert rel <= GRID_REL_TOL


def test_int8_pool_and_quantize_match_jax():
    x = np.random.RandomState(2).uniform(-3, 3, (2, 8, 6, 16)).astype(
        np.float32)
    x[0, 0, 0, :4] = [0.5, 1.5, -0.5, 2.5]  # ties round half to even
    inv = np.float32(127.0 / 3.0)
    q = pq.quantize_act(torch.from_numpy(x), torch.tensor(inv))
    want = jq._quantize_act(jnp.asarray(x), jnp.float32(inv))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        pq.quantize_act(torch.tensor([0.5, 1.5, -0.5, 2.5, 300.0]),
                        torch.tensor(1.0)).numpy(), [0, 2, 0, 2, 127])
    np.testing.assert_array_equal(
        pq.max_pool_int8(q).numpy(), np.asarray(jq._max_pool_int8(want)))
    odd = q[:, :7, :5]  # SAME pads the high edge with the type's minimum
    np.testing.assert_array_equal(
        pq.max_pool_int8(odd).numpy(),
        np.asarray(jq._max_pool_int8(jnp.asarray(odd.numpy()))))


def test_uint8_input_equals_normalized(head):
    u8 = np.random.RandomState(1).randint(0, 256, (2, IMG, IMG, 3)).astype(
        np.uint8)
    normed = (u8.astype(np.float32) / 255.0) * 2.0 - 1.0
    pl, kw = head["players"], {"v2": head["v2"], "head": head["head"]}
    np.testing.assert_array_equal(
        pq.forward_int8(pl, torch.from_numpy(u8), **kw).numpy(),
        pq.forward_int8(pl, torch.from_numpy(normed), **kw).numpy())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_artifact_moves_between_the_packages(head, tmp_path, direction):
    """An artifact written by one package loads in the other with the same
    arrays, types and meta, and serves the same grid."""
    path = str(tmp_path / "int8.npz")
    meta = {"v2": head["v2"], "passthrough": head["name"] == "v2p",
            "image_size": IMG}
    if direction == "jax_to_port":
        jq.save_quantized(path, head["jlayers"], meta)
        loaded, got_meta = pq.load_quantized(path)
        arrays = [{k: v.numpy() for k, v in layer.items()}
                  for layer in loaded]
    else:
        pq.save_quantized(path, head["players"], meta)
        loaded, got_meta = jq.load_quantized(path)
        arrays = [{k: np.asarray(v) for k, v in layer.items()}
                  for layer in loaded]
    assert got_meta == meta
    assert len(arrays) == len(head["jlayers"])
    for back, orig in zip(arrays, head["jlayers"]):
        assert set(back) == set(pq.KEYS)
        for k in pq.KEYS:
            assert back[k].dtype == np.asarray(orig[k]).dtype
            np.testing.assert_array_equal(back[k], np.asarray(orig[k]))
    if direction == "jax_to_port":
        x, kw = images(seed=3), {"v2": head["v2"], "head": head["head"]}
        np.testing.assert_array_equal(
            pq.forward_int8(loaded, torch.from_numpy(x), **kw).numpy(),
            pq.forward_int8(head["players"], torch.from_numpy(x),
                            **kw).numpy())
