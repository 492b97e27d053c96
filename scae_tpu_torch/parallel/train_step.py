"""Eval step on a raw batch (counterpart of
scae_tpu/parallel/train_step.py: ``decode_images`` and
``make_raw_eval_step``; the train steps come with the training slice).

The model holds its parameters, so the step is ``(images, labels) ->
metrics`` where the JAX step is ``(params, images, labels) -> metrics``.
"""

from typing import Callable

import torch

from scae_tpu_torch.train.data import pad_to_canvas
from scae_tpu_torch.utils.device import check_model_device, resolve_device


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
