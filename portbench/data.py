"""Inputs made from the run's seed: the training job's dataset on the
device, its epoch permutations, and the serving traffic's host images.

The pixels are synthetic (uniform bytes) at the dataset's own sizes and
storage layout; the configurations list that under ``assumed``.
"""

import numpy as np
import torch
import torch.nn.functional as F

STREAMS = {"train": 1, "val": 2, "labels": 3, "serve": 4}


def generator(seed, stream, device):
    """A generator for one of the run's input streams."""
    return torch.Generator(device=device).manual_seed(
        (seed * 16 + STREAMS[stream]) & ((1 << 63) - 1))


def raw_images(n, raw_shape, gen, device):
    """(n, *raw_shape) uint8, the dataset's storage layout ((H, W) or
    (H, W, C)), in one draw."""
    shape = (n, *raw_shape) if raw_shape[-1] != 1 else (n, *raw_shape[:-1])
    return torch.randint(0, 256, shape, generator=gen, device=device,
                         dtype=torch.uint8)


def dataset(data, seed, device):
    """{"train": {image, label}, "val": {image, label}} on ``device``."""
    lab = generator(seed, "labels", device)
    out = {}
    for split in ("train", "val"):
        n = data[split]
        out[split] = {
            "image": raw_images(n, data["raw_shape"],
                                generator(seed, split, device), device),
            "label": torch.randint(0, data["classes"], (n,), generator=lab,
                                   device=device, dtype=torch.long),
        }
    return out


def epoch_rows(seed, epoch, n, batch):
    """(n // batch, batch) int64: epoch ``epoch``'s permutation of ``n``
    examples, drawn from (seed, epoch), cut to whole batches."""
    perm = np.random.default_rng([seed, epoch]).permutation(n)
    steps = n // batch
    return perm[:steps * batch].reshape(steps, batch)


def serving_pool(n, data, image_shape, seed):
    """(n, C, H, W) float32 host images in [0, 1]: the dataset's raw
    images, centre-padded to the model's canvas."""
    gen = generator(seed, "serve", "cpu")
    raw = raw_images(n, data["raw_shape"], gen, "cpu").to(torch.float32)
    raw = raw / 255.0
    raw = raw[:, None] if raw.dim() == 3 else raw.permute(0, 3, 1, 2)
    h, w = raw.shape[-2:]
    H, W = image_shape[1:]
    top, left = (H - h) // 2, (W - w) // 2
    return F.pad(raw, (left, W - w - left, top, H - h - top)).contiguous()
