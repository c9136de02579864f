"""The model registry, name → constructor (port of
tensorflow_yolo2_tpu/models/registry.py): ``register``, ``get_network``,
``default_image_size`` and ``list_networks``, with the JAX package's
names and default input sizes, so trainers and evaluators are
model-agnostic.

A constructor takes keyword overrides (``num_classes``, ``image_size``
for the nets whose dense layer follows a flatten, ``output_channels``
for the detectors) and returns a fresh ``nn.Module``; an override it
does not know raises ``TypeError``. The port runs in float32 parameters
and takes bf16 from autocast, so there is no ``dtype`` override.

The inception family (``models.inception``: ``inception_v1`` …
``inception_v4``, ``inception_resnet_v2``) builds at 224, 224, 299, 299
and 299; v1, v3 and v4 also take ``aux_logits``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

from torch import nn

class NetworkSpec(NamedTuple):
    build: Callable[..., nn.Module]
    default_image_size: int


_REGISTRY: Dict[str, NetworkSpec] = {}


def register(name: str, default_image_size: int = 224):
    """Decorator: register ``fn(**kwargs) -> nn.Module`` under ``name``."""

    def deco(fn: Callable[..., nn.Module]):
        _REGISTRY[name] = NetworkSpec(fn, default_image_size)
        return fn

    return deco


def get_network(name: str, **kwargs: Any) -> nn.Module:
    """Build a registered network; ``ValueError`` for an unknown name."""
    if name not in _REGISTRY:
        raise ValueError(
            f"Name of network unknown {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name].build(**kwargs)


def default_image_size(name: str) -> int:
    return _REGISTRY[name].default_image_size


def list_networks() -> list[str]:
    return sorted(_REGISTRY)


def _register_builtins() -> None:
    from tensorflow_yolo2_torch.models import darknet, resnet, yolo1
    from tensorflow_yolo2_torch.models.inception import INCEPTION_ZOO
    from tensorflow_yolo2_torch.models.resnet_v2 import RESNET_V2_ZOO
    from tensorflow_yolo2_torch.models.zoo import ZOO

    @register("darknet19", 224)
    def _darknet19(num_classes: int = 1000,
                   image_size: int = 224) -> nn.Module:
        return darknet.Darknet19Classifier(num_classes=num_classes)

    @register("darknet19_detection", 224)
    def _darknet19_det(output_channels: int = 30) -> nn.Module:
        return darknet.Darknet19Detector(output_channels=output_channels)

    @register("darknet19_detection_v2", 416)
    def _darknet19_det_v2(output_channels: int = 125) -> nn.Module:
        return darknet.Darknet19DetectorV2(output_channels=output_channels)

    @register("resnet_v1_50", 224)
    def _resnet50(num_classes: int | None = None,
                  image_size: int = 224) -> nn.Module:
        # a classifier needs the global pool (→ (b, C) logits)
        return resnet.ResNet50V1(num_classes=num_classes,
                                 global_pool=num_classes is not None)

    @register("resnet_v1_50_detection", 224)
    def _resnet50_det(output_channels: int = 30,
                      image_size: int = 224) -> nn.Module:
        return resnet.ResNet50Detector(output_channels=output_channels,
                                       image_size=image_size)

    @register("yolo1", 448)
    def _yolo1(S: int = 7, output_channels: int = 30,
               dropout_rate: float = 0.5, image_size: int = 448
               ) -> nn.Module:
        return yolo1.Yolo1Net(S=S, output_channels=output_channels,
                              dropout_rate=dropout_rate,
                              image_size=image_size)

    @register("yolo1_pretrain", 448)
    def _yolo1_pre(num_classes: int = 1000,
                   image_size: int = 448) -> nn.Module:
        return yolo1.Yolo1PretrainNet(num_classes=num_classes,
                                      image_size=image_size)

    for zoo_name, (build, size) in {**ZOO, **RESNET_V2_ZOO,
                                    **INCEPTION_ZOO}.items():
        _REGISTRY[zoo_name] = NetworkSpec(build, size)


_register_builtins()
