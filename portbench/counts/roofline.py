"""The least time of the likelihood kernels K1 (the gather forward) and
K2+K3 (its backward) on one H100: the larger of the bytes they must move
over the memory rate and the float32 operations they must do over the
float32 rate. The operation counts per (capsule, pixel) pair are the
function's work as fixed when the kernels were first ported, so that
every design's share compares; integer index and address arithmetic is
not counted. Shapes are (B, M, C, Ht, Wt, H, W).
"""

import torch

from portbench.counts import peaks


def _bound(n_bytes, ops):
    t_bytes = n_bytes / peaks.HBM_BYTES_S * 1e3
    t_ops = ops / peaks.F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, ops


def k1_bound_ms(shape, alpha_batch=1):
    """(ms, what bounds it, bytes, operations) of K1.

    Bytes: each input read once (templates, alpha, pose, presence, target,
    3 scalars), each output written once (ll, num, den). Operations per
    (capsule, pixel): 16 source coordinates, 14 taps, 9 per plane for the
    4-tap blend (C planes + alpha), 5 for the mixing logit and den's
    streaming LSE step, 9 per channel for the residual, square, scale,
    offset, mixing and num's LSE step."""
    B, M, C, Ht, Wt, H, W = shape
    P, T = H * W, Ht * Wt
    n_bytes = 4 * (B * M * C * T + alpha_batch * M * T + B * M * 6 + B * M
                   + B * C * P + 3 + 2 * B * C * P + B * P)
    ops = B * M * P * (16 + 14 + 9 * (C + 1) + 5 + 9 * C)
    return _bound(n_bytes, ops)


def hits(pose, template_size, out_size):
    """(capsule, pixel) pairs whose bilinear taps touch the template."""
    Ht, Wt = template_size
    H, W = out_size
    xs = ((2.0 * torch.arange(W, dtype=torch.float64) + 1.0) / W).to(
        pose.dtype) - 1.0
    ys = ((2.0 * torch.arange(H, dtype=torch.float64) + 1.0) / H).to(
        pose.dtype) - 1.0
    gx = xs.to(pose.device)[None, :].expand(H, W).reshape(-1)
    gy = ys.to(pose.device)[:, None].expand(H, W).reshape(-1)
    a, b, tx, c, d, ty = [pose[..., i, None] for i in range(6)]
    ix = ((a * gx + b * gy + tx + 1.0) * Wt - 1.0) * 0.5
    iy = ((c * gx + d * gy + ty + 1.0) * Ht - 1.0) * 0.5
    h0, w0 = torch.floor(iy), torch.floor(ix)
    return int(((h0 >= -1) & (h0 <= Ht - 1) & (w0 >= -1)
                & (w0 <= Wt - 1)).sum())


def k23_bound_ms(shape, n_hit, alpha_batch=1, target_grad=False):
    """(ms, what bounds it, bytes, operations) of K2+K3 for a batch whose
    poses put ``n_hit`` pairs on the template (``hits``).

    Bytes: each input read once (templates, alpha, pose, presence, target,
    3 scalars, g, num, den), each output written once (the template
    gradient table, alpha's, pose's, presence's, 3 scalars', the target's
    where asked for). Operations per pair: 42 (coordinates, taps, the hit
    test, mixing, the pixel sum) + 9 per plane + 16 per channel; per hit
    pair 30 per plane + 14; per pixel 18 per channel + 13; and the alpha
    sum over the batch."""
    B, M, C, Ht, Wt, H, W = shape
    P, T, CC = H * W, Ht * Wt, C + 1
    A = alpha_batch
    ops = (B * M * P * (42 + 9 * CC + 16 * C) + n_hit * (30 * CC + 14)
           + B * P * (18 * C + 13) + (B * M * T if A == 1 else 0))
    n_bytes = 4 * (B * M * C * T + A * M * T + B * M * 6 + B * M
                   + B * C * P + 3 + 2 * B * C * P + B * P
                   + B * M * CC * T + A * M * T + B * M * 6 + B * M + 3
                   + (B * C * P if target_grad else 0))
    return _bound(n_bytes, ops)
