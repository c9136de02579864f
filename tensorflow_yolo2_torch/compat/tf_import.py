"""TF1 checkpoint → flax-shaped weight trees → the port's state dicts
(port of tensorflow_yolo2_tpu/compat/tf_import.py).

The importers are the JAX package's, name for name: each returns the same
nested ``(params, batch_stats)`` trees of numpy arrays that the JAX
importer returns, so that ``convert.state_dict_from_flax`` (through
``state_dict_for``) turns them into a state dict of the port's model.
The checkpoint is read by ``compat.tf_bundle.load_tf_checkpoint``, in
numpy alone (V1 and V2 formats); TensorFlow is not needed.

Name conventions handled:

- **darknet19 / darknet19_detection** (reference darknet.py): the convs
  use *unnamed* ``tf.Variable``s, so TF assigns sequential uniquified
  names inside the enclosing variable scope —
  ``<scope>/Variable`` (conv kernel), ``<scope>/Variable_1`` (bias),
  ``<scope>/Variable_2`` (next conv kernel) ... — and each
  ``tf.layers.batch_normalization`` gets
  ``<scope>/batch_normalization[_k]/{gamma,beta,moving_mean,
  moving_variance}``. The importer maps them positionally onto the
  layer order of ``models.darknet._DARKNET19_SCHEDULE`` (the reference
  layer schedule). The detection head's convs sit in named sub-scopes
  (``darknet19_detection/conv1..3, output`` — darknet.py:189-200).
- **slim** nets (resnet v1 / v2, inception v1–v4, Inception-ResNet-v2,
  vgg): fully named slim variables
  (``resnet_v1_50/block1/unit_1/bottleneck_v1/conv1/weights``,
  ``.../BatchNorm/gamma`` ...).

Layouts need no transposition here: TF conv kernels are HWIO and dense
kernels (in, out), as in flax; ``convert`` transposes them for torch.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tensorflow_yolo2_torch.compat.tf_bundle import load_tf_checkpoint
from tensorflow_yolo2_torch.convert import state_dict_from_flax
from tensorflow_yolo2_torch.models.darknet import _DARKNET19_SCHEDULE


def state_dict_for(trees: tuple[Mapping[str, Any], Mapping[str, Any]],
                   prefix: str | None = None) -> dict[str, torch.Tensor]:
    """An importer's ``(params, batch_stats)`` → a state dict, with every
    key under ``prefix`` (a module path such as ``"backbone"``) when
    given."""
    params, stats = trees
    if prefix:
        params, stats = {prefix: params}, {prefix: stats}
    return state_dict_from_flax(params, stats)


# ---------------------------------------------------------------------------
# darknet19 (positional mapping)
# ---------------------------------------------------------------------------


def _bn_name(scope: str, index: int) -> str:
    suffix = "batch_normalization" if index == 0 \
        else f"batch_normalization_{index}"
    return f"{scope}/{suffix}"


def _take_conv_bn(var_map: Mapping[str, np.ndarray], scope: str,
                  var_index: int, bn_index: int):
    """One reference conv_bn_layer's variables → ConvBN param/stat dicts."""
    kname = f"{scope}/Variable" if var_index == 0 \
        else f"{scope}/Variable_{var_index}"
    bname = f"{scope}/Variable_{var_index + 1}"
    bn = _bn_name(scope, bn_index)
    params = {
        "conv": {"kernel": var_map[kname], "bias": var_map[bname]},
        "bn": {"scale": var_map[f"{bn}/gamma"],
               "bias": var_map[f"{bn}/beta"]},
    }
    stats = {"bn": {"mean": var_map[f"{bn}/moving_mean"],
                    "var": var_map[f"{bn}/moving_variance"]}}
    return params, stats


def _import_backbone(var_map: Mapping[str, np.ndarray], scope: str):
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    n_convs = sum(1 for item in _DARKNET19_SCHEDULE if item != "M")
    for i in range(n_convs):
        p, s = _take_conv_bn(var_map, scope, var_index=2 * i, bn_index=i)
        params[f"conv{i + 1}"] = p
        stats[f"conv{i + 1}"] = s
    return params, stats, n_convs


def import_darknet19_checkpoint(path: str, detection: bool = True,
                                backbone_scope: str = "darknet19",
                                head_scope: str = "darknet19_detection"):
    """Import a reference darknet19 (classifier or detector) checkpoint.

    Returns (params, batch_stats) for Darknet19Detector (``detection``)
    or Darknet19Classifier.
    """
    var_map = load_tf_checkpoint(path)
    bk_params, bk_stats, n_convs = _import_backbone(var_map, backbone_scope)

    if not detection:
        # the classifier's 19th conv lives in the same flat scope
        p, s = _take_conv_bn(var_map, backbone_scope,
                             var_index=2 * n_convs, bn_index=n_convs)
        params = {"backbone": bk_params, "conv19": p}
        stats = {"backbone": bk_stats, "conv19": s}
        return params, stats

    head_params: dict[str, Any] = {}
    head_stats: dict[str, Any] = {}
    for name in ("conv1", "conv2", "conv3", "output"):
        # each head conv sits in its own named sub-scope (darknet.py:189-200)
        p, s = _take_conv_bn(var_map, f"{head_scope}/{name}",
                             var_index=0, bn_index=0)
        head_params[name] = p
        head_stats[name] = s
    params = {"backbone": bk_params, "detection": head_params}
    stats = {"backbone": bk_stats, "detection": head_stats}
    return params, stats


# ---------------------------------------------------------------------------
# slim resnet_v1_50 (named mapping)
# ---------------------------------------------------------------------------

_R50_UNITS = (3, 4, 6, 3)


def _slim_bn(var_map: Mapping[str, np.ndarray], prefix: str):
    params = {"scale": var_map[f"{prefix}/BatchNorm/gamma"],
              "bias": var_map[f"{prefix}/BatchNorm/beta"]}
    stats = {"mean": var_map[f"{prefix}/BatchNorm/moving_mean"],
             "var": var_map[f"{prefix}/BatchNorm/moving_variance"]}
    return params, stats


def _walk_resnet_v1_trunk(var_map: Mapping[str, Any], scope: str,
                          units: tuple[int, ...]):
    """Shared slim resnet_v1 trunk walk (root conv + bottleneck blocks,
    slim resnet_v1.py:119-217 naming) — the importers differ only in
    unit counts and logits-head layout."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    params["conv1"] = {"kernel": var_map[f"{scope}/conv1/weights"]}
    bnp, bns = _slim_bn(var_map, f"{scope}/conv1")
    params["conv1_bn"] = {"bn": bnp}
    stats["conv1_bn"] = {"bn": bns}

    for bi, n in enumerate(units, start=1):
        for ui in range(1, n + 1):
            src = f"{scope}/block{bi}/unit_{ui}/bottleneck_v1"
            dst = f"block{bi}_unit{ui}"
            p: dict[str, Any] = {}
            s: dict[str, Any] = {}
            for ci in (1, 2, 3):
                p[f"conv{ci}"] = {
                    "kernel": var_map[f"{src}/conv{ci}/weights"]}
                bnp, bns = _slim_bn(var_map, f"{src}/conv{ci}")
                p[f"bn{ci}"] = {"bn": bnp}
                s[f"bn{ci}"] = {"bn": bns}
            sc_key = f"{src}/shortcut/weights"
            if sc_key in var_map:
                p["shortcut_conv"] = {"kernel": var_map[sc_key]}
                bnp, bns = _slim_bn(var_map, f"{src}/shortcut")
                p["shortcut_bn"] = {"bn": bnp}
                s["shortcut_bn"] = {"bn": bns}
            params[dst] = p
            stats[dst] = s
    return params, stats


def import_resnet50_checkpoint(path: str, scope: str = "resnet_v1_50"):
    """Import a slim resnet_v1_50 checkpoint → (params, batch_stats) for
    ResNet50V1 (feature-extractor part; the logits layer is imported when
    present)."""
    return _resnet50_trees(load_tf_checkpoint(path), scope)


def _resnet50_trees(var_map: Mapping[str, Any], scope: str):
    params, stats = _walk_resnet_v1_trunk(var_map, scope, _R50_UNITS)

    logits_key = f"{scope}/logits/weights"
    if logits_key in var_map:
        # ResNet50V1 keeps slim's 1×1-conv logits layout
        params["logits"] = {"kernel": var_map[logits_key],
                            "bias": var_map[f"{scope}/logits/biases"]}
    return params, stats


_RESNET_UNITS = {
    "resnet_v1_50": (3, 4, 6, 3), "resnet_v1_101": (3, 4, 23, 3),
    "resnet_v1_152": (3, 8, 36, 3), "resnet_v1_200": (3, 24, 36, 3),
    "resnet_v2_50": (3, 4, 6, 3), "resnet_v2_101": (3, 4, 23, 3),
    "resnet_v2_152": (3, 8, 36, 3), "resnet_v2_200": (3, 24, 36, 3),
}


def import_resnet_v1_checkpoint(path: str, scope: str):
    """Import any slim resnet_v1 depth (50/101/152/200 by scope name) →
    (params, batch_stats) for models.zoo.ResNetV1 (Dense logits head).

    Same variable naming as resnet_v1_50 (slim resnet_v1.py:119-217);
    only the per-block unit counts differ. The ResNet50V1 module keeps
    its own conv-logits importer (import_resnet50_checkpoint)."""
    var_map = load_tf_checkpoint(path)
    params, stats = _walk_resnet_v1_trunk(var_map, scope,
                                          _RESNET_UNITS[scope])

    logits_key = f"{scope}/logits/weights"
    if logits_key in var_map:
        k = var_map[logits_key]  # slim 1×1-conv logits → Dense head
        params["logits"] = {"kernel": k.reshape(k.shape[-2], k.shape[-1]),
                            "bias": var_map[f"{scope}/logits/biases"]}
    return params, stats


def import_resnet_v2_checkpoint(path: str, scope: str):
    """Import any slim resnet_v2 depth (pre-activation family) →
    (params, batch_stats) for models.resnet_v2.ResNetV2.

    v2 quirks (reference resnet_v2.py:90-107,196-200): the root conv,
    projection shortcuts and conv3 have biases and no BN; each unit
    carries a ``preact`` BN and the trunk ends in ``postnorm``."""
    var_map = load_tf_checkpoint(path)
    units = _RESNET_UNITS[scope]
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    params["conv1"] = {"kernel": var_map[f"{scope}/conv1/weights"],
                       "bias": var_map[f"{scope}/conv1/biases"]}

    def bare_bn(prefix: str):
        p = {"scale": var_map[f"{prefix}/gamma"],
             "bias": var_map[f"{prefix}/beta"]}
        s = {"mean": var_map[f"{prefix}/moving_mean"],
             "var": var_map[f"{prefix}/moving_variance"]}
        return p, s

    for bi, n in enumerate(units, start=1):
        for ui in range(1, n + 1):
            src = f"{scope}/block{bi}/unit_{ui}/bottleneck_v2"
            dst = f"block{bi}_unit{ui}"
            p: dict[str, Any] = {}
            s: dict[str, Any] = {}
            bnp, bns = bare_bn(f"{src}/preact")
            p["preact_bn"] = {"bn": bnp}
            s["preact_bn"] = {"bn": bns}
            for ci in (1, 2):
                p[f"conv{ci}"] = {
                    "kernel": var_map[f"{src}/conv{ci}/weights"]}
                bnp, bns = _slim_bn(var_map, f"{src}/conv{ci}")
                p[f"bn{ci}"] = {"bn": bnp}
                s[f"bn{ci}"] = {"bn": bns}
            p["conv3"] = {"kernel": var_map[f"{src}/conv3/weights"],
                          "bias": var_map[f"{src}/conv3/biases"]}
            sc_key = f"{src}/shortcut/weights"
            if sc_key in var_map:
                p["shortcut_conv"] = {
                    "kernel": var_map[sc_key],
                    "bias": var_map[f"{src}/shortcut/biases"]}
            params[dst] = p
            stats[dst] = s

    bnp, bns = bare_bn(f"{scope}/postnorm")
    params["postnorm"] = {"bn": bnp}
    stats["postnorm"] = {"bn": bns}

    logits_key = f"{scope}/logits/weights"
    if logits_key in var_map:
        k = var_map[logits_key]
        params["logits"] = {"kernel": k.reshape(k.shape[-2], k.shape[-1]),
                            "bias": var_map[f"{scope}/logits/biases"]}
    return params, stats


# ---------------------------------------------------------------------------
# slim inception_resnet_v2 (named mapping)
# ---------------------------------------------------------------------------

# slim scope suffix → Flax ConvBNReLU module name, per structural section.
# slim names from the vendored net the reference trains
# (src/slim_dir/nets/inception_resnet_v2.py:115-216 and the modified copy
# src/yolo2_nets/inception_resnet_v2.py; restore path net_utils.py:113-134).

_IRV2_STEM = {
    "Conv2d_1a_3x3": "conv1a", "Conv2d_2a_3x3": "conv2a",
    "Conv2d_2b_3x3": "conv2b", "Conv2d_3b_1x1": "conv3b",
    "Conv2d_4a_3x3": "conv4a",
}
_IRV2_MIXED5B = {
    "Mixed_5b/Branch_0/Conv2d_1x1": "m5_b0",
    "Mixed_5b/Branch_1/Conv2d_0a_1x1": "m5_b1a",
    "Mixed_5b/Branch_1/Conv2d_0b_5x5": "m5_b1b",
    "Mixed_5b/Branch_2/Conv2d_0a_1x1": "m5_b2a",
    "Mixed_5b/Branch_2/Conv2d_0b_3x3": "m5_b2b",
    "Mixed_5b/Branch_2/Conv2d_0c_3x3": "m5_b2c",
    "Mixed_5b/Branch_3/Conv2d_0b_1x1": "m5_b3",
}
_IRV2_MIXED6A = {
    "Mixed_6a/Branch_0/Conv2d_1a_3x3": "redA_b0",
    "Mixed_6a/Branch_1/Conv2d_0a_1x1": "redA_b1a",
    "Mixed_6a/Branch_1/Conv2d_0b_3x3": "redA_b1b",
    "Mixed_6a/Branch_1/Conv2d_1a_3x3": "redA_b1c",
}
_IRV2_MIXED7A = {
    "Mixed_7a/Branch_0/Conv2d_0a_1x1": "redB_b0a",
    "Mixed_7a/Branch_0/Conv2d_1a_3x3": "redB_b0b",
    "Mixed_7a/Branch_1/Conv2d_0a_1x1": "redB_b1a",
    "Mixed_7a/Branch_1/Conv2d_1a_3x3": "redB_b1b",
    "Mixed_7a/Branch_2/Conv2d_0a_1x1": "redB_b2a",
    "Mixed_7a/Branch_2/Conv2d_0b_3x3": "redB_b2b",
    "Mixed_7a/Branch_2/Conv2d_1a_3x3": "redB_b2c",
}
# residual-block branch layout per family (slim block35/17/8 at
# inception_resnet_v2.py:33-91)
_IRV2_BLOCK_BRANCHES = {
    "block35": {
        "Branch_0/Conv2d_1x1": "b0",
        "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_3x3": "b1b",
        "Branch_2/Conv2d_0a_1x1": "b2a", "Branch_2/Conv2d_0b_3x3": "b2b",
        "Branch_2/Conv2d_0c_3x3": "b2c",
    },
    "block17": {
        "Branch_0/Conv2d_1x1": "b0",
        "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_1x7": "b1b",
        "Branch_1/Conv2d_0c_7x1": "b1c",
    },
    "block8": {
        "Branch_0/Conv2d_1x1": "b0",
        "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_1x3": "b1b",
        "Branch_1/Conv2d_0c_3x1": "b1c",
    },
}


def _slim_conv_bn_noscale(var_map: Mapping[str, np.ndarray], prefix: str):
    """One slim conv2d+batch_norm (scale=False → no gamma) → ConvBNReLU
    params/stats dicts."""
    params = {
        "conv": {"kernel": var_map[f"{prefix}/weights"]},
        "bn": {"bias": var_map[f"{prefix}/BatchNorm/beta"]},
    }
    stats = {"bn": {"mean": var_map[f"{prefix}/BatchNorm/moving_mean"],
                    "var": var_map[f"{prefix}/BatchNorm/moving_variance"]}}
    return params, stats


def import_inception_resnet_v2_checkpoint(path: str,
                                          scope: str = "InceptionResnetV2"):
    """Import a slim inception_resnet_v2 checkpoint → (params,
    batch_stats) for models.inception.InceptionResnetV2.

    Covers the capability behind the reference's
    ``restore_inception_resnet_variables_from_weight``
    (net_utils.py:113-134): load the released/trained slim weights for
    the adversarial-training classifier. AuxLogits variables are skipped
    (our model, like the reference's eval path, uses the main tower).
    """
    var_map = load_tf_checkpoint(path)
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    flat = {}
    flat.update(_IRV2_STEM)
    flat.update(_IRV2_MIXED5B)
    flat.update(_IRV2_MIXED6A)
    flat.update(_IRV2_MIXED7A)
    flat["Conv2d_7b_1x1"] = "conv7b"
    for suffix, dst in flat.items():
        p, s = _slim_conv_bn_noscale(var_map, f"{scope}/{suffix}")
        params[dst] = p
        stats[dst] = s

    def take_block(src_scope: str, family: str, dst: str):
        p: dict[str, Any] = {}
        s: dict[str, Any] = {}
        for suffix, name in _IRV2_BLOCK_BRANCHES[family].items():
            bp, bs = _slim_conv_bn_noscale(var_map, f"{src_scope}/{suffix}")
            p[name] = bp
            s[name] = bs
        # the linear up-projection has a bias and no BN
        p["up"] = {"kernel": var_map[f"{src_scope}/Conv2d_1x1/weights"],
                   "bias": var_map[f"{src_scope}/Conv2d_1x1/biases"]}
        params[dst] = p
        stats[dst] = s

    for k in range(1, 11):  # slim.repeat names units 1-based
        take_block(f"{scope}/Repeat/block35_{k}", "block35",
                   f"block35_{k - 1}")
    for k in range(1, 21):
        take_block(f"{scope}/Repeat_1/block17_{k}", "block17",
                   f"block17_{k - 1}")
    for k in range(1, 10):
        take_block(f"{scope}/Repeat_2/block8_{k}", "block8",
                   f"block8_{k - 1}")
    # the final unscaled block8(activation_fn=None) sits at top scope
    take_block(f"{scope}/Block8", "block8", "block8_post")

    logits_key = f"{scope}/Logits/Logits/weights"
    if logits_key in var_map:
        params["logits"] = {
            "kernel": var_map[logits_key],
            "bias": var_map[f"{scope}/Logits/Logits/biases"]}
    return params, stats


# ---------------------------------------------------------------------------
# slim inception_v3 (named mapping)
# ---------------------------------------------------------------------------

# slim scope suffix → Flax module name. slim names from the vendored net
# (src/slim_dir/nets/inception_v3.py:29-115 stem, :143-430 mixed blocks);
# the reference warm-starts its FGSM attack generator from released
# inception_v3 weights (src/imagenet/imagenet_train_inception_resnet.py:26-69).

_IV3_STEM = {
    "Conv2d_1a_3x3": "conv1a", "Conv2d_2a_3x3": "conv2a",
    "Conv2d_2b_3x3": "conv2b", "Conv2d_3b_1x1": "conv3b",
    "Conv2d_4a_3x3": "conv4a",
}

# 35×35 tower (Mixed_5b/5c/5d → mixed5_0..2). Mixed_5c uses slim's quirky
# Conv2d_0b_1x1 / Conv_1_0c_5x5 names (inception_v3.py:171-173).
_IV3_A = {
    "Branch_0/Conv2d_0a_1x1": "b0",
    "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_5x5": "b1b",
    "Branch_2/Conv2d_0a_1x1": "b2a", "Branch_2/Conv2d_0b_3x3": "b2b",
    "Branch_2/Conv2d_0c_3x3": "b2c",
    "Branch_3/Conv2d_0b_1x1": "b3",
}
_IV3_A_5C = dict(_IV3_A)
del _IV3_A_5C["Branch_1/Conv2d_0a_1x1"], _IV3_A_5C["Branch_1/Conv2d_0b_5x5"]
_IV3_A_5C.update({"Branch_1/Conv2d_0b_1x1": "b1a",
                  "Branch_1/Conv_1_0c_5x5": "b1b"})

# 17×17 tower (Mixed_6b..6e → mixed6_0..3)
_IV3_B = {
    "Branch_0/Conv2d_0a_1x1": "b0",
    "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_1x7": "b1b",
    "Branch_1/Conv2d_0c_7x1": "b1c",
    "Branch_2/Conv2d_0a_1x1": "b2a", "Branch_2/Conv2d_0b_7x1": "b2b",
    "Branch_2/Conv2d_0c_1x7": "b2c", "Branch_2/Conv2d_0d_7x1": "b2d",
    "Branch_2/Conv2d_0e_1x7": "b2e",
    "Branch_3/Conv2d_0b_1x1": "b3",
}

# 8×8 tower (Mixed_7b/7c → mixed7_0/1). 7b's second split conv is
# Conv2d_0b_3x1, 7c's is Conv2d_0c_3x1 (inception_v3.py:368-430).
def _iv3_c(second_split: str):
    return {
        "Branch_0/Conv2d_0a_1x1": "b0",
        "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_1x3": "b1b",
        f"Branch_1/{second_split}": "b1c",
        "Branch_2/Conv2d_0a_1x1": "b2a", "Branch_2/Conv2d_0b_3x3": "b2b",
        "Branch_2/Conv2d_0c_1x3": "b2c", "Branch_2/Conv2d_0d_3x1": "b2d",
        "Branch_3/Conv2d_0b_1x1": "b3",
    }

# grid reductions (Mixed_6a → red1_*, Mixed_7a → red2_*)
_IV3_RED1 = {
    "Branch_0/Conv2d_1a_1x1": "red1_b0",
    "Branch_1/Conv2d_0a_1x1": "red1_b1a",
    "Branch_1/Conv2d_0b_3x3": "red1_b1b",
    "Branch_1/Conv2d_1a_1x1": "red1_b1c",
}
_IV3_RED2 = {
    "Branch_0/Conv2d_0a_1x1": "red2_b0a", "Branch_0/Conv2d_1a_3x3": "red2_b0b",
    "Branch_1/Conv2d_0a_1x1": "red2_b1a", "Branch_1/Conv2d_0b_1x7": "red2_b1b",
    "Branch_1/Conv2d_0c_7x1": "red2_b1c", "Branch_1/Conv2d_1a_3x3": "red2_b1d",
}


def import_inception_v3_checkpoint(path: str, scope: str = "InceptionV3"):
    """Import a slim inception_v3 checkpoint → (params, batch_stats) for
    models.inception.InceptionV3.

    Covers the reference's pretrained-inception_v3 FGSM attack generator
    (imagenet_train_inception_resnet.py:26-69) and the slim warm-start
    path (_get_init_fn, yolo1-resnet-adv.py:146-189). AuxLogits variables
    are imported when present (for ``aux_logits=True`` models; otherwise
    the merge intersection drops them).
    """
    var_map = load_tf_checkpoint(path)
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    def take(prefix_map: Mapping[str, str], src_scope: str,
             dst: str | None = None):
        p: dict[str, Any] = params if dst is None else {}
        s: dict[str, Any] = stats if dst is None else {}
        for suffix, name in prefix_map.items():
            bp, bs = _slim_conv_bn_noscale(var_map, f"{src_scope}/{suffix}")
            p[name] = bp
            s[name] = bs
        if dst is not None:
            params[dst] = p
            stats[dst] = s

    take(_IV3_STEM, scope)
    for i, mixed in enumerate(("Mixed_5b", "Mixed_5c", "Mixed_5d")):
        take(_IV3_A_5C if mixed == "Mixed_5c" else _IV3_A,
             f"{scope}/{mixed}", f"mixed5_{i}")
    take(_IV3_RED1, f"{scope}/Mixed_6a")
    for i, mixed in enumerate(("Mixed_6b", "Mixed_6c", "Mixed_6d",
                               "Mixed_6e")):
        take(_IV3_B, f"{scope}/{mixed}", f"mixed6_{i}")
    take(_IV3_RED2, f"{scope}/Mixed_7a")
    take(_iv3_c("Conv2d_0b_3x1"), f"{scope}/Mixed_7b", "mixed7_0")
    take(_iv3_c("Conv2d_0c_3x1"), f"{scope}/Mixed_7c", "mixed7_1")

    logits_key = f"{scope}/Logits/Conv2d_1c_1x1/weights"
    if logits_key in var_map:
        # slim's 1×1-conv logits → our Dense head
        k = var_map[logits_key]
        params["logits"] = {
            "kernel": k.reshape(k.shape[-2], k.shape[-1]),
            "bias": var_map[f"{scope}/Logits/Conv2d_1c_1x1/biases"]}

    aux_proj = f"{scope}/AuxLogits/Conv2d_1b_1x1/weights"
    if aux_proj in var_map:
        p, s = _slim_conv_bn_noscale(var_map, f"{scope}/AuxLogits/Conv2d_1b_1x1")
        params["aux_proj"], stats["aux_proj"] = p, s
        p, s = _slim_conv_bn_noscale(var_map, f"{scope}/AuxLogits/Conv2d_2a_5x5")
        params["aux_conv"], stats["aux_conv"] = p, s
        params["aux_logits"] = {
            "kernel": var_map[f"{scope}/AuxLogits/Conv2d_2b_1x1/weights"],
            "bias": var_map[f"{scope}/AuxLogits/Conv2d_2b_1x1/biases"]}
    return params, stats


# ---------------------------------------------------------------------------
# slim inception_v1 (named mapping)
# ---------------------------------------------------------------------------

# slim block scope → our _MixedV1 submodule (reference inception_v1.py:83-245)
_IV1_BRANCHES = {
    "Branch_0/Conv2d_0a_1x1": "b0",
    "Branch_1/Conv2d_0a_1x1": "b1a",
    "Branch_1/Conv2d_0b_3x3": "b1b",
    "Branch_2/Conv2d_0a_1x1": "b2a",
    "Branch_2/Conv2d_0b_3x3": "b2b",
    "Branch_3/Conv2d_0b_1x1": "b3",
}

# slim Mixed_* names → our paper-style mixed_* names (same topology; the
# slim numbering counts the stage's pool as chunk "a")
_IV1_BLOCKS = {
    "Mixed_3b": "mixed_3a", "Mixed_3c": "mixed_3b",
    "Mixed_4b": "mixed_4a", "Mixed_4c": "mixed_4b",
    "Mixed_4d": "mixed_4c", "Mixed_4e": "mixed_4d",
    "Mixed_4f": "mixed_4e",
    "Mixed_5b": "mixed_5a", "Mixed_5c": "mixed_5b",
}


def import_inception_v1_checkpoint(path: str, scope: str = "InceptionV1"):
    """Import a slim inception_v1 checkpoint → (params, batch_stats) for
    models.inception.InceptionV1.

    Covers slim's released-checkpoint warm-start for the
    finetune_inception_v1_on_flowers recipe
    (reference scripts/finetune_inception_v1_on_flowers.sh and
    _get_init_fn, yolo1-resnet-adv.py:146-189).
    """
    var_map = load_tf_checkpoint(path)
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    for suffix, dst in (("Conv2d_1a_7x7", "conv1"),
                        ("Conv2d_2b_1x1", "conv2"),
                        ("Conv2d_2c_3x3", "conv3")):
        params[dst], stats[dst] = _slim_conv_bn_noscale(
            var_map, f"{scope}/{suffix}")

    for src, dst in _IV1_BLOCKS.items():
        p: dict[str, Any] = {}
        s: dict[str, Any] = {}
        for suffix, name in _IV1_BRANCHES.items():
            if src == "Mixed_5b" and suffix == "Branch_2/Conv2d_0b_3x3":
                # slim naming quirk: Mixed_5b's second Branch_2 conv is
                # scoped Conv2d_0a_3x3 (reference inception_v1.py:221)
                suffix = "Branch_2/Conv2d_0a_3x3"
            p[name], s[name] = _slim_conv_bn_noscale(
                var_map, f"{scope}/{src}/{suffix}")
        params[dst] = p
        stats[dst] = s

    logits_key = f"{scope}/Logits/Conv2d_0c_1x1/weights"
    if logits_key in var_map:
        k = var_map[logits_key]  # slim 1×1-conv logits → our Dense head
        params["logits"] = {
            "kernel": k.reshape(k.shape[-2], k.shape[-1]),
            "bias": var_map[f"{scope}/Logits/Conv2d_0c_1x1/biases"]}
    return params, stats


# ---------------------------------------------------------------------------
# slim inception_v2 (named mapping)
# ---------------------------------------------------------------------------

# mixed-block branch scope → _MixedV2 submodule (reference
# inception_v2.py:122-409); reductions use the 2-branch layout
# (:182-203, :328-349)
_IV2_BRANCHES = {
    "Branch_0/Conv2d_0a_1x1": "b0",
    "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_3x3": "b1b",
    "Branch_2/Conv2d_0a_1x1": "b2a", "Branch_2/Conv2d_0b_3x3": "b2b",
    "Branch_2/Conv2d_0c_3x3": "b2c",
    "Branch_3/Conv2d_0b_1x1": "b3",
}
_IV2_REDUCTION = {
    "Branch_0/Conv2d_0a_1x1": "b0a", "Branch_0/Conv2d_1a_3x3": "b0b",
    "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_3x3": "b1b",
    "Branch_1/Conv2d_1a_3x3": "b1c",
}


def import_inception_v2_checkpoint(path: str, scope: str = "InceptionV2"):
    """Import a slim inception_v2 checkpoint → (params, batch_stats) for
    models.inception.InceptionV2 (slim zoo warm-start capability,
    nets_factory.py:35-55 + _get_init_fn)."""
    var_map = load_tf_checkpoint(path)
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    # separable 7×7 stem (reference inception_v2.py:84-98): TF depthwise
    # kernels are [kh, kw, in, mult]; Flax grouped conv wants
    # [kh, kw, 1, in*mult] with the same in-major channel order
    dw = var_map[f"{scope}/Conv2d_1a_7x7/depthwise_weights"]
    kh, kw, cin, mult = dw.shape
    params["conv1"] = {
        "depthwise": {"kernel": dw.reshape(kh, kw, 1, cin * mult)},
        "pointwise": {
            "kernel": var_map[f"{scope}/Conv2d_1a_7x7/pointwise_weights"]},
        "bn": {"bias": var_map[f"{scope}/Conv2d_1a_7x7/BatchNorm/beta"]},
    }
    stats["conv1"] = {"bn": {
        "mean": var_map[f"{scope}/Conv2d_1a_7x7/BatchNorm/moving_mean"],
        "var": var_map[f"{scope}/Conv2d_1a_7x7/BatchNorm/moving_variance"]}}

    for suffix, dst in (("Conv2d_2b_1x1", "conv2b"),
                        ("Conv2d_2c_3x3", "conv2c")):
        params[dst], stats[dst] = _slim_conv_bn_noscale(
            var_map, f"{scope}/{suffix}")

    reductions = ("Mixed_4a", "Mixed_5a")
    for src in ("Mixed_3b", "Mixed_3c", "Mixed_4a", "Mixed_4b", "Mixed_4c",
                "Mixed_4d", "Mixed_4e", "Mixed_5a", "Mixed_5b", "Mixed_5c"):
        branches = _IV2_REDUCTION if src in reductions else _IV2_BRANCHES
        p: dict[str, Any] = {}
        s: dict[str, Any] = {}
        for suffix, name in branches.items():
            p[name], s[name] = _slim_conv_bn_noscale(
                var_map, f"{scope}/{src}/{suffix}")
        dst = f"mixed_{src[6:].lower()}"
        params[dst] = p
        stats[dst] = s

    logits_key = f"{scope}/Logits/Conv2d_1c_1x1/weights"
    if logits_key in var_map:
        k = var_map[logits_key]  # slim 1×1-conv logits → our Dense head
        params["logits"] = {
            "kernel": k.reshape(k.shape[-2], k.shape[-1]),
            "bias": var_map[f"{scope}/Logits/Conv2d_1c_1x1/biases"]}
    return params, stats


# ---------------------------------------------------------------------------
# slim inception_v4 (named mapping)
# ---------------------------------------------------------------------------

# stem convs (reference inception_v4.py:176-221)
_IV4_STEM = (
    ("Conv2d_1a_3x3", "s1"), ("Conv2d_2a_3x3", "s2"),
    ("Conv2d_2b_3x3", "s3"),
    ("Mixed_3a/Branch_1/Conv2d_0a_3x3", "s4"),
    ("Mixed_4a/Branch_0/Conv2d_0a_1x1", "s5a"),
    ("Mixed_4a/Branch_0/Conv2d_1a_3x3", "s5b"),
    ("Mixed_4a/Branch_1/Conv2d_0a_1x1", "s6a"),
    ("Mixed_4a/Branch_1/Conv2d_0b_1x7", "s6b"),
    ("Mixed_4a/Branch_1/Conv2d_0c_7x1", "s6c"),
    ("Mixed_4a/Branch_1/Conv2d_1a_3x3", "s6d"),
    ("Mixed_5a/Branch_0/Conv2d_1a_3x3", "s7"),
)
# per-family branch scope → our flat a{i}_/b{i}_/c{i}_ names (reference
# inception_v4.py:34-143)
_IV4_A = {
    "Branch_0/Conv2d_0a_1x1": "b0",
    "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_3x3": "b1b",
    "Branch_2/Conv2d_0a_1x1": "b2a", "Branch_2/Conv2d_0b_3x3": "b2b",
    "Branch_2/Conv2d_0c_3x3": "b2c",
    "Branch_3/Conv2d_0b_1x1": "b3",
}
_IV4_B = {
    "Branch_0/Conv2d_0a_1x1": "b0",
    "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_1x7": "b1b",
    "Branch_1/Conv2d_0c_7x1": "b1c",
    "Branch_2/Conv2d_0a_1x1": "b2a", "Branch_2/Conv2d_0b_7x1": "b2b",
    "Branch_2/Conv2d_0c_1x7": "b2c", "Branch_2/Conv2d_0d_7x1": "b2d",
    "Branch_2/Conv2d_0e_1x7": "b2e",
    "Branch_3/Conv2d_0b_1x1": "b3",
}
_IV4_C = {
    "Branch_0/Conv2d_0a_1x1": "b0",
    "Branch_1/Conv2d_0a_1x1": "b1a", "Branch_1/Conv2d_0b_1x3": "b1b",
    "Branch_1/Conv2d_0c_3x1": "b1c",
    "Branch_2/Conv2d_0a_1x1": "b2a", "Branch_2/Conv2d_0b_3x1": "b2b",
    "Branch_2/Conv2d_0c_1x3": "b2c", "Branch_2/Conv2d_0d_1x3": "b2d",
    "Branch_2/Conv2d_0e_3x1": "b2e",
    "Branch_3/Conv2d_0b_1x1": "b3",
}
_IV4_REDA = {
    "Mixed_6a/Branch_0/Conv2d_1a_3x3": "redA_b0",
    "Mixed_6a/Branch_1/Conv2d_0a_1x1": "redA_b1a",
    "Mixed_6a/Branch_1/Conv2d_0b_3x3": "redA_b1b",
    "Mixed_6a/Branch_1/Conv2d_1a_3x3": "redA_b1c",
}
_IV4_REDB = {
    "Mixed_7a/Branch_0/Conv2d_0a_1x1": "redB_b0a",
    "Mixed_7a/Branch_0/Conv2d_1a_3x3": "redB_b0b",
    "Mixed_7a/Branch_1/Conv2d_0a_1x1": "redB_b1a",
    "Mixed_7a/Branch_1/Conv2d_0b_1x7": "redB_b1b",
    "Mixed_7a/Branch_1/Conv2d_0c_7x1": "redB_b1c",
    "Mixed_7a/Branch_1/Conv2d_1a_3x3": "redB_b1d",
}


def import_inception_v4_checkpoint(path: str, scope: str = "InceptionV4"):
    """Import a slim inception_v4 checkpoint → (params, batch_stats) for
    models.inception.InceptionV4. AuxLogits variables (reference
    inception_v4.py:287-305) are imported when present — for
    ``aux_logits=True`` models; the merge intersection drops them
    otherwise."""
    var_map = load_tf_checkpoint(path)
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    def take(suffix: str, dst: str):
        params[dst], stats[dst] = _slim_conv_bn_noscale(
            var_map, f"{scope}/{suffix}")

    for suffix, dst in _IV4_STEM:
        take(suffix, dst)
    for flat in (_IV4_REDA, _IV4_REDB):
        for suffix, dst in flat.items():
            take(suffix, dst)
    towers = (("5", 4, _IV4_A, "a"), ("6", 7, _IV4_B, "b"),
              ("7", 3, _IV4_C, "c"))
    for stage, count, branches, prefix in towers:
        for i in range(count):
            src = f"Mixed_{stage}{chr(ord('b') + i)}"
            for suffix, name in branches.items():
                take(f"{src}/{suffix}", f"{prefix}{i}_{name}")

    logits_key = f"{scope}/Logits/Logits/weights"
    if logits_key in var_map:
        # slim.fully_connected: 2-D (in, out) kernel, same as our Dense
        params["logits"] = {
            "kernel": var_map[logits_key],
            "bias": var_map[f"{scope}/Logits/Logits/biases"]}

    aux_proj = f"{scope}/AuxLogits/Conv2d_1b_1x1/weights"
    if aux_proj in var_map:
        p, s = _slim_conv_bn_noscale(var_map,
                                     f"{scope}/AuxLogits/Conv2d_1b_1x1")
        params["aux_proj"], stats["aux_proj"] = p, s
        p, s = _slim_conv_bn_noscale(var_map, f"{scope}/AuxLogits/Conv2d_2a")
        params["aux_conv"], stats["aux_conv"] = p, s
        # slim's aux head ends in a fully_connected on the flattened map —
        # 2-D (in, out) kernel, same as our Dense
        params["aux_logits"] = {
            "kernel": var_map[f"{scope}/AuxLogits/Aux_logits/weights"],
            "bias": var_map[f"{scope}/AuxLogits/Aux_logits/biases"]}
    return params, stats


# ---------------------------------------------------------------------------
# slim vgg family (named mapping)
# ---------------------------------------------------------------------------

_VGG_STAGES = {"vgg_a": (1, 1, 2, 2, 2), "vgg_16": (2, 2, 3, 3, 3),
               "vgg_19": (2, 2, 4, 4, 4)}


def import_vgg_checkpoint(path: str, scope: str = "vgg_16"):
    """Import a slim vgg checkpoint (vgg_a/vgg_16/vgg_19 by scope name) →
    (params, {}) for models.zoo.VGG (no BN in the vgg family).

    slim names: ``vgg_16/conv1/conv1_1/{weights,biases}`` ...,
    ``vgg_16/fc{6,7,8}/{weights,biases}`` (src/slim_dir/nets/vgg.py;
    fc layers are 7×7/1×1 convs in both slim and models.zoo.VGG).
    """
    var_map = load_tf_checkpoint(path)
    stages = _VGG_STAGES[scope]
    params: dict[str, Any] = {}
    for si, n in enumerate(stages, start=1):
        for ci in range(1, n + 1):
            src = f"{scope}/conv{si}/conv{si}_{ci}"
            params[f"conv{si}_{ci}"] = {
                "kernel": var_map[f"{src}/weights"],
                "bias": var_map[f"{src}/biases"]}
    for fc in ("fc6", "fc7", "fc8"):
        key = f"{scope}/{fc}/weights"
        if key in var_map:
            params[fc] = {"kernel": var_map[key],
                          "bias": var_map[f"{scope}/{fc}/biases"]}
    return params, {}


def import_resnet_detector_checkpoint(path: str, scope: str = "resnet_v1_50"):
    """Import the full pascal resnet detector (backbone + yolo_fc heads,
    pascal_train_resnet.py:41-50 / net_utils.py:177-199)."""
    var_map = load_tf_checkpoint(path)  # read once, for trunk and heads
    bk_params, bk_stats = _resnet50_trees(var_map, scope)
    params: dict[str, Any] = {"backbone": bk_params}
    stats = {"backbone": bk_stats}
    for fc in ("yolo_fc1", "yolo_fc2"):
        if f"{fc}/weights" in var_map:
            params[fc] = {"kernel": var_map[f"{fc}/weights"],
                          "bias": var_map[f"{fc}/biases"]}
    return params, stats


# ---------------------------------------------------------------------------
# family dispatch
# ---------------------------------------------------------------------------

_IMPORTERS = {
    "darknet19": lambda p: import_darknet19_checkpoint(p, detection=False),
    "darknet19_detection": import_darknet19_checkpoint,
    "resnet_v1_50": import_resnet50_checkpoint,
    "inception_v1": import_inception_v1_checkpoint,
    "inception_v2": import_inception_v2_checkpoint,
    "inception_v3": import_inception_v3_checkpoint,
    "inception_v4": import_inception_v4_checkpoint,
    "inception_resnet_v2": import_inception_resnet_v2_checkpoint,
    "vgg_a": lambda p: import_vgg_checkpoint(p, "vgg_a"),
    "vgg_16": lambda p: import_vgg_checkpoint(p, "vgg_16"),
    "vgg_19": lambda p: import_vgg_checkpoint(p, "vgg_19"),
}
for _name in ("resnet_v1_101", "resnet_v1_152", "resnet_v1_200"):
    _IMPORTERS[_name] = (
        lambda p, _s=_name: import_resnet_v1_checkpoint(p, _s))
for _name in ("resnet_v2_50", "resnet_v2_101", "resnet_v2_152",
              "resnet_v2_200"):
    _IMPORTERS[_name] = (
        lambda p, _s=_name: import_resnet_v2_checkpoint(p, _s))


def import_checkpoint_for(model_name: str, path: str):
    """Import a released TF checkpoint for a registry model name →
    (params, batch_stats). Families with released slim/reference weights
    the reference workflow consumes (net_utils.py:64-219 and the slim
    _get_init_fn warm-start)."""
    if model_name not in _IMPORTERS:
        raise ValueError(
            f"no TF importer for {model_name!r}; have "
            f"{sorted(_IMPORTERS)}")
    return _IMPORTERS[model_name](path)
