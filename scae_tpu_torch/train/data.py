"""Device-side data helpers (counterpart of scae_tpu/train/data.py):
``pad_to_canvas`` and the training augmentations ``random_translate`` and
``random_affine``.

Each augmentation is a draw from an explicit ``torch.Generator`` followed
by a deterministic apply, so that a test can hand the apply the JAX
package's own draws.
"""

import math

import torch
import torch.nn.functional as F

from scae_tpu_torch.ops.warp import affine_warp


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


def draw_translation(batch_size: int, max_shift: int,
                     generator: torch.Generator):
    """Per-sample window offsets (ox, oy), each (B,) int64 in
    [0, 2 max_shift], on the generator's device."""
    shape = (batch_size,)
    kw = dict(generator=generator, device=generator.device)
    ox = torch.randint(0, 2 * max_shift + 1, shape, **kw)
    oy = torch.randint(0, 2 * max_shift + 1, shape, **kw)
    return ox, oy


def translate(images: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
              max_shift: int) -> torch.Tensor:
    """Pad (B, C, H, W) images by ``max_shift`` and take each sample's
    H x W window at (oy, ox): ``padded[b, :, oy:oy+H, ox:ox+W]``, as two
    batched gathers, one per spatial axis."""
    B, C, H, W = images.shape
    padded = F.pad(images, (max_shift,) * 4)
    rows = oy[:, None] + torch.arange(H, device=images.device)   # (B, H)
    cols = ox[:, None] + torch.arange(W, device=images.device)   # (B, W)
    out = torch.gather(padded, 2, rows[:, None, :, None].expand(
        B, C, H, padded.shape[-1]))
    return torch.gather(out, 3, cols[:, None, None, :].expand(B, C, H, W))


def random_translate(images: torch.Tensor, generator: torch.Generator,
                     max_shift: int) -> torch.Tensor:
    """Random per-sample integer translation by up to +-``max_shift``
    pixels, zeros shifted in (the reference's pad + RandomAffine(translate)
    augmentation, mnist/experiment.py:27-36)."""
    ox, oy = draw_translation(images.shape[0], max_shift, generator)
    return translate(images, ox, oy, max_shift)


def draw_affine(batch_size: int, degrees: float, scale_jitter: float,
                generator: torch.Generator):
    """Per-sample rotation (radians, from U(-degrees, degrees) degrees) and
    scale (from U(1 - scale_jitter, 1 + scale_jitter)), each (B,) f32."""
    kw = dict(generator=generator, device=generator.device)
    u_th = torch.rand((batch_size,), **kw)
    u_sc = torch.rand((batch_size,), **kw)
    theta = (u_th * (2.0 * degrees) - degrees) * (math.pi / 180.0)
    scale = u_sc * (2.0 * scale_jitter) + (1.0 - scale_jitter)
    return theta, scale


def rotate_scale(images: torch.Tensor, theta: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Rotate by ``theta`` and zoom by ``scale`` about the image centre,
    bilinear with zero padding (the part decoder's ``affine_warp``). The
    pose is the inverse map, output pixel to source pixel:
    (1/s) R(-theta), no translation."""
    B, C, H, W = images.shape
    c = torch.cos(theta) / scale
    sn = torch.sin(theta) / scale
    zero = torch.zeros_like(c)
    pose = torch.stack([c, sn, zero, -sn, c, zero], dim=-1)      # (B, 6)
    return affine_warp(images.to(torch.float32), pose, (H, W))


def random_affine(images: torch.Tensor, generator: torch.Generator,
                  degrees: float = 0.0,
                  scale_jitter: float = 0.0) -> torch.Tensor:
    """Random per-sample rotation and isotropic zoom (the torchvision
    RandomAffine surface; integer translation stays in
    ``random_translate``)."""
    theta, scale = draw_affine(images.shape[0], degrees, scale_jitter,
                               generator)
    return rotate_scale(images, theta, scale)
