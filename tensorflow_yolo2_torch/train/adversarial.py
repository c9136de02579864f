"""Adversarial training (port of tensorflow_yolo2_tpu/train/adversarial.py).

- :func:`fgsm`: the fast gradient sign method, ``x + ε·sign(∇ₓ loss)``
  clipped to [−1, 1], with ``torch.autograd.grad`` of the loss with
  respect to the images;
- :func:`random_sign_noise`: ±ε noise of random signs, ε drawn from
  {4, 8, 12, 16}/255·2, from an explicit generator;
- :func:`make_attack_loss` / :func:`make_attack`: the attacked model's
  mean softmax cross-entropy as a function of the images (the forward in
  eval mode: running statistics, no dropout), and FGSM on it;
- :func:`adversarial_train_step_pair`: the reference's pair a step, a
  clean train step, the attack on the updated model, then a train step
  on the adversarial images.

On the card the Darknet trunk's pools run backward through B5
(``ops.cuda_pool``) in both train steps and in the attack's input
gradient.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_yolo2_torch.utils.device import device_normalize

EPSILONS = (4, 8, 12, 16)


def fgsm(loss_fn: Callable[[torch.Tensor], torch.Tensor],
         images: torch.Tensor, epsilon: float,
         clip: tuple[float, float] = (-1.0, 1.0)) -> torch.Tensor:
    """One-step FGSM: perturb ``images`` to raise ``loss_fn``."""
    x = images.detach().requires_grad_(True)
    with torch.enable_grad():
        (grads,) = torch.autograd.grad(loss_fn(x), x)
    return torch.clamp(images.detach() + epsilon * torch.sign(grads), *clip)


def random_sign_noise(generator: torch.Generator, images: torch.Tensor,
                      epsilons=EPSILONS,
                      clip: tuple[float, float] = (-1.0, 1.0)
                      ) -> torch.Tensor:
    """``images`` + ε·s, clipped: one ε from ``epsilons``/255·2 for the
    batch, a sign s ∈ {−1, 1} for every value (the scipy loader's
    ``random_noise``)."""
    device = generator.device
    eps = torch.tensor(epsilons, dtype=torch.float32, device=device)
    eps = eps[torch.randint(len(epsilons), (), generator=generator,
                            device=device)] / 255.0 * 2.0
    u = torch.rand(images.shape, generator=generator, device=device)
    signs = torch.sign(u * 2.0 - 1.0).to(images.device)
    return torch.clamp(images + eps.to(images.device) * signs, *clip)


@contextlib.contextmanager
def _eval_mode(model: nn.Module) -> Iterator[None]:
    training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(training)


def make_attack_loss(model: nn.Module, labels: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The classification loss as a function of the image batch: the
    model in eval mode (under bf16 autocast when ``compute_dtype`` is
    bfloat16, as the train step), mean sparse softmax cross-entropy of its
    float32 logits (the main head's where it returns an aux head too)."""
    labels = labels.long()

    def loss_of_images(images: torch.Tensor) -> torch.Tensor:
        with _eval_mode(model), torch.autocast(
                images.device.type, dtype=torch.bfloat16,
                enabled=compute_dtype == torch.bfloat16):
            logits = model(images)
        if isinstance(logits, tuple):
            logits = logits[0]
        return F.cross_entropy(logits.float(), labels)

    return loss_of_images


def make_attack(model: nn.Module, epsilon: float,
                compute_dtype: torch.dtype = torch.float32
                ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """(images, labels) → FGSM images against ``model`` as it is at the
    call (its weights are read then, so a trained model is attacked as
    the latest step left it)."""

    def attack(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return fgsm(make_attack_loss(model, labels, compute_dtype), images,
                    epsilon)

    return attack


def adversarial_train_step_pair(trainer, state, images, labels,
                                epsilon: float = 8 / 255 * 2,
                                attack_fn: Callable | None = None):
    """One clean step, then one step on FGSM images of the same batch
    made against the updated model (or by ``attack_fn(images, labels)``,
    a transfer attack). Returns (state, clean metrics, adversarial
    metrics)."""
    images = device_normalize(torch.as_tensor(images).to(trainer.device))
    labels = trainer._labels(labels)
    state, clean_metrics = trainer.train_step(state, images, labels)
    if attack_fn is None:
        attack_fn = make_attack(state.model, epsilon, trainer.compute_dtype)
    adv_images = attack_fn(images, labels)
    state, adv_metrics = trainer.train_step(state, adv_images, labels)
    return state, clean_metrics, adv_metrics
