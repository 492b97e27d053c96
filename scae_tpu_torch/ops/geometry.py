"""Pose vector -> affine / similarity transform (counterpart of
scae_tpu/ops/geometry.py).

Nonlinearities: sigmoid + 1e-2 for scales, tanh(5x) for translations and
shear, theta * 2pi; affine rows (a b tx; c d ty); optional 3x3 matrix.
"""

import math

import torch


def geometric_transform(pose: torch.Tensor, similarity: bool = False,
                        nonlinear: bool = True,
                        as_matrix: bool = False) -> torch.Tensor:
    """[..., 6] pose (scale_x, scale_y, theta, shear, tx, ty) -> [..., 6]
    flat row-major 2x3 affine, or [..., 3, 3] if ``as_matrix``."""
    scale_x, scale_y, theta, shear, trans_x, trans_y = torch.split(
        pose, 1, dim=-1)

    if nonlinear:
        scale_x = torch.sigmoid(scale_x) + 1e-2
        scale_y = torch.sigmoid(scale_y) + 1e-2
        trans_x = torch.tanh(trans_x * 5.0)
        trans_y = torch.tanh(trans_y * 5.0)
        shear = torch.tanh(shear * 5.0)
        theta = theta * (2.0 * math.pi)
    else:
        # |x| as a where: slope +1 at exactly 0, as jnp.abs has it
        scale_x = torch.where(scale_x >= 0, scale_x, -scale_x) + 1e-2
        scale_y = torch.where(scale_y >= 0, scale_y, -scale_y) + 1e-2

    c, s = torch.cos(theta), torch.sin(theta)

    if similarity:
        scale = scale_x
        flat = [scale * c, -scale * s, trans_x,
                scale * s, scale * c, trans_y]
    else:
        flat = [
            scale_x * c + shear * scale_y * s,
            -scale_x * s + shear * scale_y * c,
            trans_x,
            scale_y * s,
            scale_y * c,
            trans_y,
        ]

    out = torch.cat(flat, dim=-1)
    if as_matrix:
        out = affine_to_matrix(out)
    return out


def affine_to_matrix(flat: torch.Tensor) -> torch.Tensor:
    """[..., 6] row-major 2x3 affine -> [..., 3, 3] homogeneous matrix."""
    mat2x3 = flat.reshape(*flat.shape[:-1], 2, 3)
    # the identity's last row, made on the device (no host copy, which a
    # CUDA graph could not capture)
    last = torch.eye(3, dtype=flat.dtype, device=flat.device)[2].expand(
        *flat.shape[:-1], 1, 3)
    return torch.cat([mat2x3, last], dim=-2)


def compose_affines(outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """matrix(outer) @ matrix(inner) on flat [..., 6] affines, written out
    on the six coefficients (the homogeneous row adds only exact 0/1
    terms). Broadcasts like the matmul would."""
    a1, b1, tx1, c1, d1, ty1 = torch.split(outer, 1, dim=-1)
    a2, b2, tx2, c2, d2, ty2 = torch.split(inner, 1, dim=-1)
    return torch.cat([
        a1 * a2 + b1 * c2,
        a1 * b2 + b1 * d2,
        a1 * tx2 + b1 * ty2 + tx1,
        c1 * a2 + d1 * c2,
        c1 * b2 + d1 * d2,
        c1 * tx2 + d1 * ty2 + ty1,
    ], dim=-1)
