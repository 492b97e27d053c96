"""Device-side data helpers (counterpart of scae_tpu/train/data.py; this
slice needs only ``pad_to_canvas``)."""

import torch
import torch.nn.functional as F


def pad_to_canvas(images: torch.Tensor, canvas: int) -> torch.Tensor:
    """Centre-pad (or centre-crop) (B, C, h, w) images to canvas x canvas."""
    h, w = images.shape[-2:]
    if h > canvas:
        top = (h - canvas) // 2
        images = images[..., top:top + canvas, :]
        h = canvas
    if w > canvas:
        left = (w - canvas) // 2
        images = images[..., left:left + canvas]
        w = canvas
    top, left = (canvas - h) // 2, (canvas - w) // 2
    return F.pad(images, (left, canvas - w - left, top, canvas - h - top))
