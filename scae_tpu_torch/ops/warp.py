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
(``transformed_templates`` and the alpha logits) and for the likelihood of
its unfused paths; the fused likelihood goes through the 4-tap gather
kernel (``kernels/decoder_ll_gather.py``) or the dense one
(``kernels/decoder_ll_dense.py``, ``ops/decoder_ll.py``), each with its own
hand-derived or kernel backward.
"""

import torch


def _axis(n, dtype, device):
    """(2j + 1)/n - 1 for j < n. The quotient is taken in float64 and
    rounded once to ``dtype``, which is IEEE division's result: PyTorch's
    CUDA division by a scalar multiplies by the reciprocal instead, one ulp
    off for some j, and the gather kernels' taps and gradients must see the
    same coordinates on every device (a bilinear sample's derivative jumps
    at texel boundaries)."""
    q = (2.0 * torch.arange(n, dtype=torch.float64, device=device) + 1.0) / n
    return q.to(dtype) - 1.0


def _base_grid(out_size, dtype=torch.float32, device=None):
    """Normalized output pixel-centre coordinates, (H, W) each."""
    H, W = out_size
    xs = _axis(W, dtype, device)
    ys = _axis(H, dtype, device)
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
    zero = torch.zeros((), dtype=pose.dtype, device=pose.device)
    return _tap(ix[..., None, :] - cols, zero), _tap(iy[..., None, :] - rows,
                                                    zero)


def _tap(d, zero):
    """relu(1 - |d|) with JAX's slopes at the kinks, as
    ``jnp.maximum(0, 1 - jnp.abs(d))`` has them: the binary ``maximum``
    splits a tie at |d| = 1 evenly between its two sides, and |d| written
    as a ``where`` has slope +1 at d = 0, where ``torch.abs`` has 0. A
    source coordinate that lands on a texel centre or edge (a zero or
    identity pose) hits both kinks."""
    return torch.maximum(1.0 - torch.where(d >= 0, d, -d), zero)


def affine_warp(templates, pose, out_size):
    """Warp [..., C, Ht, Wt] templates by [..., 6] poses onto an (H, W)
    canvas: [..., C, H, W], zero outside the source."""
    *lead, C, Ht, Wt = templates.shape
    H, W = out_size
    Wx, Wy = bilinear_weight_matrices(pose, (Ht, Wt), (H, W))
    S = torch.einsum("...chw,...wp->...chp", templates, Wx)
    out = torch.einsum("...chp,...hp->...cp", S, Wy)
    return out.reshape(*lead, C, H, W)
