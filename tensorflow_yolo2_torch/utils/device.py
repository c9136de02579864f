"""Where the port's entry points run."""

from __future__ import annotations

import functools

import torch


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches → float32 in [-1, 1] as (x/255)·2 − 1, on the
    batch's device; float batches pass through.

    Divides by a 0-d tensor on the batch's device, not by a Python
    number: on CUDA PyTorch turns division by a host scalar into a
    multiplication by its reciprocal, which is not the IEEE quotient of
    the host normalize (``data.augment``) and of the JAX package's device
    normalize."""
    if images.dtype != torch.uint8:
        return images
    return images.float() / _255(images.device) * 2.0 - 1.0


@functools.cache
def _255(device: torch.device) -> torch.Tensor:
    # made once a device, as an ordinary tensor even when the first call
    # runs under inference mode
    with torch.inference_mode(False):
        return torch.full((), 255.0, dtype=torch.float32, device=device)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names another device.

    Raises when CUDA is asked for (explicitly or by default) and there is
    no card: an entry point never carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
