"""Weight bridge from the JAX package's flax trees to the port's state dicts.

A flax ``params`` / ``batch_stats`` pair is a nested dict; here its leaves
are numpy arrays (``jax.device_get`` of the trees, or ``load_npz``). The
port's modules carry the flax names, so a path maps by joining with ``.``
and renaming the leaf:

    <path>/conv/kernel  (HWIO)  → <path>.conv.weight  (OIHW)
    <path>/conv/bias            → <path>.conv.bias    (the bias before BN)
    <path>/bn/scale, bn/bias    → <path>.bn.weight, <path>.bn.bias
    batch_stats <path>/bn/mean  → <path>.bn.running_mean
    batch_stats <path>/bn/var   → <path>.bn.running_var

A bare ``nn.Conv`` or ``nn.Dense`` keeps its own name: ResNet50's
(``conv1`` to ``conv3``, ``shortcut_conv``, ``logits``, ``yolo_fc1``,
``yolo_fc2``), the zoo's and ResNet v2's (``conv1`` to ``conv5``, VGG's
``conv<stage>_<i>``, the conv heads' ``fc6`` to ``fc8``, the dense
``fc3``, ``fc4``, ``logits``; v2's ``shortcut_conv`` and ``conv3`` with
their biases) and YOLOv1's (``conv1`` to ``conv24``, ``fc21``, ``fc25``,
``fc26``):

    <path>/<layer>/kernel (HWIO)   → <path>.<layer>.weight (OIHW)
    <path>/<layer>/kernel (in, out) → <path>.<layer>.weight (out, in)
    <path>/<layer>/bias             → <path>.<layer>.bias

The inception family's bare layers are the residual blocks' ``up``
conv, the separable stem's ``depthwise`` (HWIO (kh, kw, 1, in·mult) →
(in·mult, 1, kh, kw), the grouped weight of ``groups = in``) and
``pointwise`` convs, v1's auxiliary heads' ``fc`` (``aux_4a/fc``,
``aux_4d/fc``; an ``fc`` anywhere else is refused) and v3's / v4's
``aux_logits`` (a 1×1 conv, a dense). Its BatchNorms have no scale: a
``bn`` child with ``bias`` alone, which maps to a BatchNorm without a
``weight``. The adversarial defence's ``ContrastInputModel`` adds the
bare ``input_transform`` conv; its net sits under ``backbone``.

A nested BatchNorm (``conv1_bn``, ``preact_bn``, ``bn1``, ``postnorm``)
is a ``bn`` child as above. Folded trees (no ``bn`` children) convert the same way and load into a
model built with ``fold_bn=True``. ``save_npz`` / ``load_npz`` carry such
a pair between machines as one ``.npz`` with ``/``-joined keys.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {("conv", "kernel"): "conv.weight",
                 ("conv", "bias"): "conv.bias",
                 ("bn", "scale"): "bn.weight",
                 ("bn", "bias"): "bn.bias"}
_STAT_LEAVES = {("bn", "mean"): "bn.running_mean",
                ("bn", "var"): "bn.running_var"}


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Nested dict → ``{"a/b/c": leaf}``."""
    out: dict[str, Any] = {}
    for key, sub in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(sub, Mapping):
            out.update(flatten(sub, path))
        else:
            out[path] = sub
    return out


def unflatten(flat: Mapping[str, Any]) -> dict[str, Any]:
    """``{"a/b/c": leaf}`` → nested dict."""
    tree: dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


_BARE_LAYERS = (
    "shortcut_conv", "logits", "yolo_fc1", "yolo_fc2",
    "up", "depthwise", "pointwise", "aux_logits", "input_transform",
    *(f"conv{i}" for i in range(1, 25)),
    *(f"conv{s}_{i}" for s in range(1, 6) for i in range(1, 5)),
    *(f"fc{i}" for i in (3, 4, 6, 7, 8, 21, 25, 26)))
_BARE_LEAVES = {(layer, leaf): f"{layer}.{name}"
                for layer in _BARE_LAYERS
                for leaf, name in (("kernel", "weight"), ("bias", "bias"))}
# a dense ``fc`` is bare only inside inception v1's auxiliary heads
_AUX_FC_LEAVES = {("fc", "kernel"): "fc.weight", ("fc", "bias"): "fc.bias"}


def _map(tree: Mapping[str, Any], leaves: Mapping[tuple, str],
         what: str) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for path, value in flatten(tree).items():
        *module, layer, leaf = path.split("/")
        name = leaves.get((layer, leaf))
        if name is None and module and module[-1].startswith("aux_") and \
                what == "params":
            name = _AUX_FC_LEAVES.get((layer, leaf))
        if name is None:
            raise ValueError(f"unknown {what} leaf {path!r}")
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        if leaf == "kernel":
            # HWIO → OIHW; a dense (in, out) → (out, in)
            t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
            t = t.contiguous()
        out[".".join(module + [name])] = t
    return out


def state_dict_from_flax(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any] | None = None
                         ) -> dict[str, torch.Tensor]:
    """Flax ``params`` (+ ``batch_stats``) of numpy arrays → state dict."""
    sd = _map(params, {**_PARAM_LEAVES, **_BARE_LEAVES}, "params")
    sd.update(_map(batch_stats or {}, _STAT_LEAVES, "batch_stats"))
    for key in [k for k in sd if k.endswith((".bn.weight", ".bn.bias"))]:
        sd[key.rpartition(".")[0] + ".num_batches_tracked"] = \
            torch.tensor(0)
    return sd


def save_npz(path: str, params: Mapping[str, Any],
             batch_stats: Mapping[str, Any] | None = None) -> None:
    """Write a params / batch_stats pair as one ``.npz`` (keys
    ``params/...`` and ``batch_stats/...``)."""
    flat = flatten({"params": params, "batch_stats": batch_stats or {}})
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_npz(path: str) -> tuple[dict[str, Any], dict[str, Any]]:
    """Read a ``save_npz`` file → (params, batch_stats) nested dicts."""
    with np.load(path) as data:
        tree = unflatten({k: data[k] for k in data.files})
    return tree.get("params", {}), tree.get("batch_stats", {})
