"""The training loop's device-side batch functions (counterpart of
scae_tpu/train/loop.py: ``make_augment_fn`` and ``make_center_pad_fn``;
the ``Trainer`` comes with the training harness)."""

import torch

from scae_tpu_torch.train import data as data_lib


def make_augment_fn(canvas: int, max_shift: int, degrees: float = 0.0,
                    scale_jitter: float = 0.0):
    """``augment(batch, generator) -> batch``: pad to ``canvas``, then a
    random rotation and zoom when ``degrees`` or ``scale_jitter`` is set,
    then a random translation by up to ``max_shift`` pixels, all drawn from
    ``generator`` in that order. ``batch`` is {"image": (B, C, h, w), ...};
    other entries pass through."""

    def augment(batch, generator: torch.Generator):
        images = batch["image"]
        if canvas and images.shape[-1] != canvas:
            images = data_lib.pad_to_canvas(images, canvas)
        if degrees or scale_jitter:
            images = data_lib.random_affine(images, generator, degrees,
                                            scale_jitter)
        if max_shift:
            images = data_lib.random_translate(images, generator, max_shift)
        return {**batch, "image": images}

    return augment


def make_center_pad_fn(canvas: int):
    """``pad(batch) -> batch``: centre-pad the images to ``canvas``."""

    def pad(batch):
        images = batch["image"]
        if canvas and images.shape[-1] != canvas:
            images = data_lib.pad_to_canvas(images, canvas)
        return {**batch, "image": images}

    return pad
