"""Post-training int8 quantization of the folded Darknet19 detectors and
classifier (port of tensorflow_yolo2_tpu/ops/quant.py).

After BatchNorm folding (``models.fold``) every conv is quantized to
symmetric int8: per-output-channel weight scales, per-tensor activation
scales from one calibration pass.

- weights:      w_q[.., o] = round(w[.., o] / s_w[o]),  s_w[o] = max|w[.., o]|/127
- activations:  x_q = clip(round(x / s_x), -127, 127),  s_x = calibrated amax/127
- conv:         acc_int32 = conv(x_q, w_q);  y = acc·(s_x·s_w) + bias
- leaky ReLU on the float32 epilogue, then a requantize with the next
  conv's input scale; the 2×2 pools and the v2p reorg stay in int8.

Layouts are the JAX package's: NHWC maps, a layer chain of dicts with
``kernel`` (int8 HWIO), ``scale`` (float32 [O]), ``bias`` (float32 [O])
and ``inv_in`` (float32 scalar), and the same ``.npz`` artifact, so
artifacts move both ways between the packages.

The int8 conv (the JAX package's ``lax.conv_general_dilated`` with int32
accumulation, in XLA) has no stock CUDA counterpart in PyTorch. On the
card it is an im2col of the int8 map (3×3 SAME: zero pad 1, nine shifted
slices) times the weights by ``torch._int_mm`` (int8 × int8 → int32,
cuBLASLt), with the depth K padded to a multiple of 8, the output
channels N to a multiple of 8 and the rows M past 16 with zeros, which
``_int_mm`` needs; the im2col is taken a few images at a time
(``CHUNK_BYTES``). On the CPU the conv is ``F.conv2d`` in float64 on the
integer values, which is exact (|sum| ≤ 127·127·9·1280 < 2⁵³; float32
would not be above 2²⁴). Nothing falls back to a float conv on the card.
The classifier (``head="classifier"``) ends in its 1×1 ``conv19`` and a
float32 global mean (``forward_int8_classifier``).
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from tensorflow_yolo2_torch.models.darknet import _DARKNET19_SCHEDULE
from tensorflow_yolo2_torch.models.layers import leaky_relu, space_to_depth
from tensorflow_yolo2_torch.utils.device import device_normalize

# the artifact's arrays of a layer (save_quantized / load_quantized)
KEYS = ("kernel", "scale", "bias", "inv_in")
# im2col bytes (and the int32 / float32 epilogue's) of one chunk of images
CHUNK_BYTES = 1 << 30
# the forward's phases as profiler ranges, which a trace splits time by
PHASES = ("int8.im2col", "int8.int_mm", "int8.epilogue", "int8.pool")


def layer_plan(v2: bool = False, head: str = "detector"):
    """Static op plan of the folded Darknet19 detector or classifier:
    ``(plan, convs)``, ``plan`` the ``"conv"`` / ``"pool"`` steps (with
    ``"mid"``, the capture of the map before the last pool, and ``"pt"``,
    the passthrough conv + reorg + concat, for ``head="detector_v2p"``),
    ``convs`` the ``((scope, name), activated)`` conv entries in order.
    The v1 detector's output conv is activated (the reference's BN + leaky
    output), v2's is linear; the classifier appends the 1×1 ``conv19``,
    activated unless ``v2``."""
    plan: list = []
    convs: list = []
    i = 0
    pool_i = 0
    n_pools = sum(1 for item in _DARKNET19_SCHEDULE if item == "M")
    for item in _DARKNET19_SCHEDULE:
        if item == "M":
            pool_i += 1
            if pool_i == n_pools and head == "detector_v2p":
                plan.append("mid")
            plan.append("pool")
        else:
            i += 1
            plan.append("conv")
            convs.append((("backbone", f"conv{i}"), True))
    if head == "classifier":
        plan.append("conv")
        convs.append((("conv19",), not v2))
        return tuple(plan), tuple(convs)
    if head == "detector_v2p":
        for j in (1, 2):
            plan.append("conv")
            convs.append((("detection", f"conv{j}"), True))
        plan.append("pt")
        convs.append((("detection", "passthrough"), True))
        plan.append("conv")
        convs.append((("detection", "conv3"), True))
        plan.append("conv")
        convs.append((("detection", "output"), False))
        return tuple(plan), tuple(convs)
    for j in range(1, 4):
        plan.append("conv")
        convs.append((("detection", f"conv{j}"), True))
    plan.append("conv")
    convs.append((("detection", "output"), not v2))
    return tuple(plan), tuple(convs)


def _conv_params(state_dict: Mapping[str, torch.Tensor],
                 path) -> tuple[torch.Tensor, torch.Tensor]:
    """A folded conv's OIHW weight and bias, float32."""
    prefix = ".".join(path) + ".conv."
    return (state_dict[prefix + "weight"].float(),
            state_dict[prefix + "bias"].float())


@contextlib.contextmanager
def no_tf32():
    """cuDNN's float32 convs in full float32 (it takes TF32 by default)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def percentile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` of all of ``x`` (linear interpolation),
    by ``kthvalue``: ``torch.quantile`` refuses inputs above 2²⁴ elements.
    The position is computed in float32 as XLA computes JAX's, whose
    ``q / 100 · (n − 1)`` it folds to ``q · (0.01 · (n − 1))``. A float32
    0-d tensor on the CPU."""
    flat = x.reshape(-1)
    f32 = torch.float32
    n = torch.tensor(float(flat.numel()), dtype=f32)
    pos = torch.tensor(q, dtype=f32) * (torch.tensor(0.01, dtype=f32) *
                                        (n - 1))
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    top = flat.numel() - 1
    lo, hi = (min(max(int(v), 0), top) for v in (low, high))
    lo_v, hi_v = (flat.kthvalue(k + 1).values.float().cpu() for k in (lo, hi))
    return lo_v * low_w + hi_v * high_w


@torch.no_grad()
def calibrate(state_dict: Mapping[str, torch.Tensor], images: torch.Tensor,
              v2: bool = False, head: str = "detector",
              percentile: float = 100.0) -> torch.Tensor:
    """One-shot activation calibration: the folded float32 forward of
    ``images`` (NHWC, float in [-1, 1], on the device of the weights
    given), recording the abs-max of every conv input (the image, then
    each activated map; the pools keep it). Returns the ``[n_convs]``
    scales amax/127, float32 on the CPU. ``percentile < 100`` takes that
    percentile of |x| instead of the max. On a card, cuDNN runs without
    TF32."""
    plan, convs = layer_plan(v2, head)

    def amax(t: torch.Tensor) -> torch.Tensor:
        if percentile >= 100.0:
            return t.abs().amax().float().cpu()
        return percentile_linear(t.abs(), percentile)

    def conv(x, path):
        weight, bias = _conv_params(state_dict, path)
        return F.conv2d(x, weight, bias, padding=weight.shape[-1] // 2)

    def nhwc(t):
        return t.permute(0, 2, 3, 1)

    x = images.float().permute(0, 3, 1, 2)  # NCHW views
    amaxes = [amax(x)]
    mid = None
    ci = 0
    with no_tf32():
        for si, step in enumerate(plan):
            if step == "pool":
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
                continue
            if step == "mid":
                mid = x
                continue
            if step == "pt":
                # the passthrough conv's input is the captured mid map; its
                # scale slot sits between conv2's and conv3's
                amaxes.append(amax(mid))
                path, _ = convs[ci]
                ci += 1
                p = space_to_depth(nhwc(leaky_relu(conv(mid, path))))
                x = torch.cat([x, p.permute(0, 3, 1, 2)], dim=1)
                amaxes.append(amax(x))  # conv3's input: the concat
                continue
            path, activated = convs[ci]
            ci += 1
            x = conv(x, path)
            if activated:
                x = leaky_relu(x)
            if ci < len(convs) and plan[si + 1] != "pt":
                # (after the conv that feeds a "pt" step, the next two
                # slots, passthrough input and concat, are recorded there)
                amaxes.append(amax(x))
    scales = torch.stack(amaxes) / torch.tensor(127.0)  # on the CPU
    return torch.clamp_min(scales, 1e-8)


def quantize_folded(state_dict: Mapping[str, torch.Tensor],
                    act_scales: torch.Tensor, v2: bool = False,
                    head: str = "detector") -> tuple:
    """Quantize a folded network (``models.fold.fold_params``) to an int8
    layer chain, on the CPU: per conv ``kernel`` (int8 HWIO), ``scale``
    (input scale × per-channel weight scale: the int32 sum's dequantize
    factor), ``bias`` and ``inv_in`` (1 / input scale). Quantizing on the
    CPU keeps true division: a CUDA division by a Python number is a
    multiplication by its reciprocal, which moves ``w_q`` at .5 ties."""
    _, convs = layer_plan(v2, head)
    act_scales = torch.as_tensor(act_scales, dtype=torch.float32).cpu()
    layers = []
    for idx, (path, _) in enumerate(convs):
        weight, bias = (t.cpu() for t in _conv_params(state_dict, path))
        kernel = weight.permute(2, 3, 1, 0)  # OIHW → HWIO
        w_scale = torch.clamp_min(kernel.abs().amax(dim=(0, 1, 2)),
                                  1e-8) / 127.0
        k_q = torch.clamp(torch.round(kernel / w_scale), -127, 127)
        layers.append({
            "kernel": k_q.to(torch.int8).contiguous(),
            "scale": (w_scale * act_scales[idx]).float(),
            "bias": bias.clone(),
            "inv_in": (1.0 / act_scales[idx]).float(),
        })
    return tuple(layers)


def quantize_act(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x · inv_scale), -127, 127) as int8; rounds half to even,
    as ``jnp.round`` does."""
    return torch.clamp(torch.round(x * inv_scale), -127, 127).to(torch.int8)


def max_pool_int8(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 SAME max pool of an NHWC int8 map (exact in int8: the max
    commutes with the positive per-tensor scale)."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:  # SAME pads the high edge with the type's minimum
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2), value=-128)
        h, w = h + h % 2, w + w % 2
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def weight_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """An HWIO int8 kernel as the (N, K) matrix ``_int_mm`` takes
    transposed (column-major B: cuBLASLt refuses a row-major B at small
    M): K = kh·kw·Cin in the im2col's (dy, dx, c) order, both padded to a
    multiple of 8 with zeros."""
    kh, kw, cin, cout = kernel.shape
    k = kh * kw * cin
    mat = kernel.reshape(k, cout).t()
    return F.pad(mat, (0, _round_up(k, 8) - k,
                       0, _round_up(cout, 8) - cout)).contiguous()


def prepare(layers: Sequence[Mapping[str, torch.Tensor]],
            device: str | torch.device) -> tuple:
    """The chain on ``device``, each layer with its ``weight_matrix``
    (``wmat``) made once where the device is a card."""
    device = torch.device(device)
    out = []
    for layer in layers:
        moved = {k: torch.as_tensor(layer[k]).to(device) for k in KEYS}
        if device.type == "cuda":
            moved["wmat"] = weight_matrix(moved["kernel"])
        out.append(moved)
    return tuple(out)


def _im2col(x: torch.Tensor, kh: int, k_pad: int) -> torch.Tensor:
    """(N, H, W, C) int8 → (N·H·W, k_pad) rows of the kh×kh SAME patch in
    (dy, dx, c) order, zero-padded to k_pad columns."""
    n, h, w, c = x.shape
    if kh == 1:
        cols = [x]
    else:
        r = kh // 2
        xp = F.pad(x, (0, 0, r, r, r, r))
        cols = [xp[:, dy:dy + h, dx:dx + w, :]
                for dy in range(kh) for dx in range(kh)]
    extra = k_pad - kh * kh * c
    if extra:
        cols.append(x.new_zeros(n, h, w, extra))
    if len(cols) == 1:
        return x.reshape(n * h * w, c)
    return torch.cat(cols, dim=3).reshape(n * h * w, k_pad)


def _conv_int32_cuda(x: torch.Tensor, layer: Mapping[str, torch.Tensor]
                     ) -> torch.Tensor:
    kh, _, _, cout = layer["kernel"].shape
    wmat = layer.get("wmat")
    if wmat is None:
        wmat = weight_matrix(layer["kernel"])
    n, h, w, _ = x.shape
    with record_function("int8.im2col"):
        cols = _im2col(x.contiguous(), kh, wmat.shape[1])
        m = cols.shape[0]
        if m <= 16:  # _int_mm takes more than 16 rows
            cols = F.pad(cols, (0, 0, 0, 17 - m))
    with record_function("int8.int_mm"):
        acc = torch._int_mm(cols, wmat.t())
    return acc[:m, :cout].reshape(n, h, w, cout)


def conv_int8(x: torch.Tensor, layer: Mapping[str, torch.Tensor]
              ) -> torch.Tensor:
    """The int32 sums of a SAME, stride-1 conv of an NHWC int8 map with
    the layer's int8 HWIO kernel: im2col + ``torch._int_mm`` on a card,
    ``F.conv2d`` in float64 on the CPU (exact)."""
    if x.dtype != torch.int8 or layer["kernel"].dtype != torch.int8:
        raise TypeError(f"conv_int8 takes int8 maps and kernels, got "
                        f"{x.dtype} and {layer['kernel'].dtype}")
    if x.is_cuda:
        return _conv_int32_cuda(x, layer)
    kernel = layer["kernel"]
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   kernel.permute(3, 2, 0, 1).double(),
                   padding=kernel.shape[0] // 2)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def dequantize(acc: torch.Tensor, layer: Mapping[str, torch.Tensor],
               activated: bool) -> torch.Tensor:
    """The float32 epilogue: acc·scale + bias (a multiply, then an add:
    no fused multiply-add), then the leaky ReLU where ``activated``."""
    y = acc.to(torch.float32) * layer["scale"]
    y = y + layer["bias"]
    return leaky_relu(y) if activated else y


def _conv_step(x: torch.Tensor, layer, activated: bool,
               inv_next: torch.Tensor | None) -> torch.Tensor:
    """conv_int8 + dequantize (+ requantize with ``inv_next``), a few
    images at a time on a card so that the im2col and the epilogue's
    temporaries stay under CHUNK_BYTES."""
    n, h, w, c = x.shape
    kh, _, _, cout = layer["kernel"].shape
    per_image = h * w * (_round_up(kh * kh * c, 8) + 16 * cout)
    step = max(1, CHUNK_BYTES // per_image) if x.is_cuda else n
    outs = []
    for i in range(0, n, step):
        acc = conv_int8(x[i:i + step], layer)
        with record_function("int8.epilogue"):
            y = dequantize(acc, layer, activated)
            outs.append(y if inv_next is None else quantize_act(y, inv_next))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def forward_int8(layers: Sequence[Mapping[str, torch.Tensor]],
                 images: torch.Tensor, v2: bool = False,
                 head: str = "detector") -> torch.Tensor:
    """The quantized forward: NHWC images (float in [-1, 1], or uint8,
    normalized on their device as (x/255)·2 − 1 first) → the float32
    output map (the detection grid, or the classifier's class map).
    ``layers`` lie on the images' device (``prepare``)."""
    plan, convs = layer_plan(v2, head)
    x = device_normalize(images).float()
    x = quantize_act(x, layers[0]["inv_in"])
    mid = None
    ci = 0
    for si, step in enumerate(plan):
        if step == "pool":
            with record_function("int8.pool"):
                x = max_pool_int8(x)
            continue
        if step == "mid":
            # the int8 map before the last pool, quantized at the next
            # conv's input scale, which calibrate records on this same
            # tensor for the passthrough slot
            mid = x
            continue
        if step == "pt":
            layer = layers[ci]
            ci += 1
            # both concat halves at conv3's shared input scale; the reorg
            # is a pure layout op and stays int8
            p = _conv_step(mid, layer, True, layers[ci]["inv_in"])
            x = torch.cat([x, space_to_depth(p)], dim=-1)
            continue
        layer = layers[ci]
        _, activated = convs[ci]
        ci += 1
        if ci == len(layers):
            return _conv_step(x, layer, activated, None)
        # the next conv that reads x: past a "pt" step, conv3
        nxt = ci + 1 if plan[si + 1] == "pt" else ci
        x = _conv_step(x, layer, activated, layers[nxt]["inv_in"])
    raise AssertionError("plan ended without the output conv")


def forward_int8_classifier(layers: Sequence[Mapping[str, torch.Tensor]],
                            images: torch.Tensor) -> torch.Tensor:
    """The quantized Darknet19 classifier: the int8 chain to the float32
    (N, H/32, W/32, num_classes) class map (``conv19``'s epilogue), then
    its mean over the map in float32 → (N, num_classes) logits."""
    class_map = forward_int8(layers, images, head="classifier")
    return class_map.mean(dim=(1, 2))


def save_quantized(path: str, layers: Sequence[Mapping[str, Any]],
                   meta: Mapping[str, Any] | None = None) -> None:
    """Write a quantized chain as a serving artifact (``.npz``, the JAX
    package's format: ``i/kernel`` HWIO int8, ``i/scale``, ``i/bias``,
    ``i/inv_in`` and a JSON ``__meta__``)."""
    arrays = {f"{i}/{k}": np.asarray(torch.as_tensor(layer[k]).cpu())
              for i, layer in enumerate(layers) for k in KEYS}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(dict(meta or {}), sort_keys=True).encode(), np.uint8)
    # through a file object, so np.savez never appends ".npz" to the path
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_quantized(path: str) -> tuple:
    """A :func:`save_quantized` artifact (from either package) →
    ``(layers, meta)``, CPU tensors."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        n = 1 + max(int(key.split("/")[0]) for key in data.files
                    if key != "__meta__")
        layers = tuple(
            {key.split("/", 1)[1]: torch.from_numpy(np.array(data[key]))
             for key in data.files if key.startswith(f"{i}/")}
            for i in range(n))
    return layers, meta
