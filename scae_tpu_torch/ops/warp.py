"""Affine template warping as bilinear tap-weight matrices (counterpart of
scae_tpu/ops/warp.py).

The bilinearly sampled value at output pixel p of an affine warp of a
template T (Ht x Wt) is

    out[p] = sum_a sum_b  Wy[p, a] * T[a, b] * Wx[p, b]

with ``Wx[p, b] = relu(1 - |ix(p) - b|)`` and ``Wy[p, a] = relu(1 -
|iy(p) - a|)``; taps outside the template get zero weight, which is
``grid_sample``'s zero padding. Coordinates follow ``F.affine_grid`` /
``F.grid_sample`` with ``align_corners=False``:

  base grid      x_j = (2j+1)/W_out - 1,   y_i = (2i+1)/H_out - 1
  source coords  gx  = a*x + b*y + tx,     gy  = c*x + d*y + ty
  pixel coords   ix  = ((gx+1)*Wt - 1)/2,  iy = ((gy+1)*Ht - 1)/2

The part decoder uses ``affine_warp`` only to render its components
(``transformed_templates`` and the alpha logits); its likelihood goes
through the 4-tap gather kernel in ``kernels/decoder_ll_gather.py``.
"""

import torch


def _base_grid(out_size, dtype=torch.float32, device=None):
    """Normalized output pixel-centre coordinates, (H, W) each."""
    H, W = out_size
    xs = (2.0 * torch.arange(W, dtype=dtype, device=device) + 1.0) / W - 1.0
    ys = (2.0 * torch.arange(H, dtype=dtype, device=device) + 1.0) / H - 1.0
    gx = xs[None, :].expand(H, W)
    gy = ys[:, None].expand(H, W)
    return gx, gy


def source_coordinates(pose, template_size, out_size):
    """Per-output-pixel source coordinates (ix, iy), each [..., P], in
    template-pixel units."""
    Ht, Wt = template_size
    gx, gy = _base_grid(out_size, pose.dtype, pose.device)
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)
    a, b, tx, c, d, ty = [pose[..., i, None] for i in range(6)]
    sx = a * gx + b * gy + tx
    sy = c * gx + d * gy + ty
    ix = ((sx + 1.0) * Wt - 1.0) * 0.5
    iy = ((sy + 1.0) * Ht - 1.0) * 0.5
    return ix, iy


def bilinear_weight_matrices(pose, template_size, out_size):
    """Tap-weight matrices (Wx, Wy): ([..., Wt, P], [..., Ht, P])."""
    Ht, Wt = template_size
    ix, iy = source_coordinates(pose, template_size, out_size)
    cols = torch.arange(Wt, dtype=pose.dtype, device=pose.device)[:, None]
    rows = torch.arange(Ht, dtype=pose.dtype, device=pose.device)[:, None]
    Wx = torch.clamp(1.0 - torch.abs(ix[..., None, :] - cols), min=0.0)
    Wy = torch.clamp(1.0 - torch.abs(iy[..., None, :] - rows), min=0.0)
    return Wx, Wy


def affine_warp(templates, pose, out_size):
    """Warp [..., C, Ht, Wt] templates by [..., 6] poses onto an (H, W)
    canvas: [..., C, H, W], zero outside the source."""
    *lead, C, Ht, Wt = templates.shape
    H, W = out_size
    Wx, Wy = bilinear_weight_matrices(pose, (Ht, Wt), (H, W))
    S = torch.einsum("...chw,...wp->...chp", templates, Wx)
    out = torch.einsum("...chp,...hp->...cp", S, Wy)
    return out.reshape(*lead, C, H, W)
