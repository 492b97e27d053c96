"""Train and eval steps on a raw batch (counterpart of
scae_tpu/parallel/train_step.py: ``decode_images``, ``make_raw_train_step``,
``make_fused_train_step`` and ``make_raw_eval_step``).

The model holds its parameters and the optimizer its state, so a step is
``(images, labels) -> metrics`` where the JAX step is ``(state, images,
labels) -> (state, metrics)``: a train step updates its ``TrainState`` in
place. JAX's ``make_train_scan`` (K steps per dispatch) has no counterpart
yet; CUDA graphs would be its analogue.
"""

import dataclasses
from typing import Callable

import torch
from torch import nn

from scae_tpu_torch.optim import Optimizer
from scae_tpu_torch.train.data import pad_to_canvas
from scae_tpu_torch.utils.device import check_model_device, resolve_device

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class TrainState:
    """What a train step updates: the model's parameters and the
    optimizer's state in place, and the step count. ``seed`` keys the
    noise and augmentation of every step."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    seed: int = 0


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _fold_in(seed: int, *data: int) -> int:
    """A seed derived from ``seed`` and each of ``data`` in turn (the role
    of ``jax.random.fold_in``; the numbers differ from JAX's)."""
    for d in data:
        seed = _splitmix64(seed ^ _splitmix64(d & _MASK64))
    return seed & ((1 << 63) - 1)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def decode_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> f32 in [0, 1]; (B, H, W) -> (B, 1, H, W); (B, H, W, C) ->
    NCHW."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    if images.dim() == 3:
        images = images[:, None]
    elif images.shape[-1] in (1, 3, 4):
        images = images.permute(0, 3, 1, 2)
    return images


def make_raw_eval_step(model, canvas: int = 0, device=None) -> Callable:
    """``eval_step(images, labels) -> metrics`` on ``device`` (CUDA unless
    given), where ``model`` must already live.

    images: raw batch (uint8 or float, storage layout) as a numpy array or
    tensor; labels: (B,) ints. Decodes on the device, centre-pads to
    ``canvas`` when given, runs the deterministic forward and returns every
    loss term, the loss and, with classifiers, the accuracy, as 0-d
    tensors on the device.
    """
    device = resolve_device(device)
    check_model_device(model, device)

    @torch.inference_mode()
    def eval_step(images, labels):
        images = decode_images(torch.as_tensor(images).to(device))
        if canvas and images.shape[-1] != canvas:
            images = pad_to_canvas(images, canvas)
        labels = torch.as_tensor(labels).to(device=device, dtype=torch.long)
        res = model(images, deterministic=True)
        loss, log = model.loss(res, images, labels)
        metrics = dict(log)
        metrics["loss"] = loss
        if model.n_classes:
            metrics["accuracy"] = model.calculate_accuracy(res, labels)
        return metrics

    return eval_step


def make_raw_train_step(state: TrainState, augment_fn=None,
                        device=None) -> Callable:
    """``train_step(images, labels) -> metrics`` on ``device`` (CUDA unless
    given), where ``state.model`` must already live.

    images: raw batch (uint8 or float, storage layout) as a numpy array or
    tensor; labels: (B,) ints. The step decodes on the device, applies
    ``augment_fn(batch, generator)`` with a generator seeded from
    (seed, step, 7), runs the forward with its noise drawn from a generator
    seeded from (seed, step), the loss, the backward and the optimizer
    step, and adds 1 to ``state.step``. It returns every loss term, the
    loss and, with classifiers, the accuracy (from detached
    probabilities), as 0-d tensors on the device.
    """
    device = resolve_device(device)
    model, optimizer = state.model, state.optimizer
    check_model_device(model, device)

    def train_step(images, labels):
        images = decode_images(torch.as_tensor(images).to(device))
        labels = torch.as_tensor(labels).to(device=device, dtype=torch.long)
        batch = {"image": images, "label": labels}
        if augment_fn is not None:
            batch = augment_fn(batch, _generator(
                device, _fold_in(state.seed, state.step, 7)))
        images = batch["image"]
        res = model(images, deterministic=False, generator=_generator(
            device, _fold_in(state.seed, state.step)))
        loss, log = model.loss(res, images, labels)
        metrics = {k: v.detach() for k, v in log.items()}
        if model.n_classes:
            with torch.no_grad():
                metrics["accuracy"] = model.calculate_accuracy(res, labels)
        grads = torch.autograd.grad(loss, optimizer.params,
                                    allow_unused=True)
        optimizer.step(grads)
        metrics["loss"] = loss.detach()
        state.step += 1
        return metrics

    return train_step


def make_fused_train_step(state: TrainState, augment_fn=None,
                          device=None) -> Callable:
    """``train_step(data, idx) -> metrics``: the raw step on the batch
    gathered by the index vector ``idx`` (B,) from device-resident
    ``data`` = {"image": (N, ...), "label": (N,)}, so only the indices
    cross from the host per step."""
    device = resolve_device(device)
    raw_step = make_raw_train_step(state, augment_fn, device)

    def train_step(data, idx):
        idx = torch.as_tensor(idx).to(device=device, dtype=torch.long)
        return raw_step(data["image"].index_select(0, idx),
                        data["label"].index_select(0, idx))

    return train_step

