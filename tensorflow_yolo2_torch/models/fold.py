"""BatchNorm folding for inference (port of
tensorflow_yolo2_tpu/models/fold.py: ``fold_params`` and
``fold_params_identity``).

With frozen statistics conv→BN is one conv with rescaled weights:

    scale   = gamma / sqrt(running_var + eps)
    weight' = weight * scale          (per output channel)
    bias'   = (bias - running_mean) * scale + beta

A missing conv bias counts as 0 and a missing BN scale (gamma; the
inception nets' BatchNorm has none) as 1.
"""

from __future__ import annotations

from typing import Mapping

import torch

from tensorflow_yolo2_torch.models.layers import BN_EPSILON


def fold_params(state_dict: Mapping[str, torch.Tensor],
                epsilon: float = BN_EPSILON) -> dict[str, torch.Tensor]:
    """Fold every ``<m>.conv`` → ``<m>.bn`` pair (the ConvBN layout) of a
    state dict into a bare ``<m>.conv``.

    Returns the state dict of the same model built with ``fold_bn=True``.
    ``epsilon`` must match the BN epsilon (ConvBN: 1e-3).
    """
    out: dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        parent, _, child = module.rpartition(".")
        pair = parent + "." if parent else ""
        if pair + "conv.weight" not in state_dict or \
                pair + "bn.weight" not in state_dict:
            out[key] = value
            continue
        if child == "bn":
            continue
        bn = pair + "bn."
        scale = state_dict[bn + "weight"] / torch.sqrt(
            state_dict[bn + "running_var"] + epsilon)
        if leaf == "weight":
            out[key] = value * scale[:, None, None, None]
        else:
            out[key] = ((value - state_dict[bn + "running_mean"]) * scale
                        + state_dict[bn + "bias"])
    return out


def _pairs(state_dict: Mapping[str, torch.Tensor]) -> list[str]:
    """The prefixes ``<m>.`` (or ``""``) of every conv→BN child pair: a
    ``<m>.conv.weight`` beside a BatchNorm ``<m>.bn`` with a scale or a
    bias."""
    out = []
    for key in state_dict:
        if key == "conv.weight" or key.endswith(".conv.weight"):
            pair = key[:-len("conv.weight")]
            if pair + "bn.weight" in state_dict or \
                    pair + "bn.bias" in state_dict:
                out.append(pair)
    return out


def fold_params_identity(state_dict: Mapping[str, torch.Tensor],
                         epsilon: float = BN_EPSILON
                         ) -> dict[str, torch.Tensor]:
    """Fold the BatchNorm statistics of every conv→BN child pair into the
    conv kernel WITHOUT changing the model: the state dict of the same
    model whose BatchNorms, in eval mode, are ``x + beta'``.

    For each pair the conv weight is rescaled, the folded offset goes
    into the BN bias (into the conv bias where the BN has none; a
    ``ValueError`` where neither exists), the conv bias (where it stays)
    becomes 0, the BN scale (where there is one) 1, and the statistics
    mean 0 and variance 1 − epsilon. BatchNorms outside such a pair
    (ResNet's ``conv1`` / ``bn1`` siblings) and every other tensor pass
    through unchanged. ``epsilon`` must be the BatchNorm's own: the
    identity rests on sqrt((1 − epsilon) + epsilon) = 1.
    """
    out = dict(state_dict)
    for pair in _pairs(state_dict):
        conv, bn = pair + "conv.", pair + "bn."
        weight = state_dict[conv + "weight"]
        width = weight.shape[0]
        ones = torch.ones(width, dtype=weight.dtype, device=weight.device)
        gamma = state_dict.get(bn + "weight", ones)
        beta = state_dict.get(bn + "bias", torch.zeros_like(ones))
        conv_bias = state_dict.get(conv + "bias", torch.zeros_like(ones))
        scale = gamma / torch.sqrt(state_dict[bn + "running_var"] + epsilon)
        folded = (conv_bias - state_dict[bn + "running_mean"]) * scale + beta
        out[conv + "weight"] = weight * scale[:, None, None, None]
        if conv + "bias" in state_dict:
            out[conv + "bias"] = torch.zeros_like(conv_bias)
        if bn + "weight" in state_dict:
            out[bn + "weight"] = torch.ones_like(gamma)
        if bn + "bias" in state_dict:
            out[bn + "bias"] = folded
        elif conv + "bias" in state_dict:
            out[conv + "bias"] = folded
        else:
            raise ValueError(f"cannot fold {pair[:-1]!r}: conv has no bias "
                             "and BN has no center to carry the folded "
                             "offset")
        out[bn + "running_mean"] = torch.zeros_like(ones)
        out[bn + "running_var"] = torch.full_like(ones, 1.0 - epsilon)
    return out
