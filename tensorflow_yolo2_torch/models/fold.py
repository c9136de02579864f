"""BatchNorm folding for inference (port of
tensorflow_yolo2_tpu/models/fold.py::fold_params).

With frozen statistics conv→BN is one conv with rescaled weights:

    scale   = gamma / sqrt(running_var + eps)
    weight' = weight * scale          (per output channel)
    bias'   = (bias - running_mean) * scale + beta
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
