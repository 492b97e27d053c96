"""Fused template-decoder reconstruction log-likelihood with a
hand-derived backward (counterpart of scae_tpu/ops/decoder_ll.py).

With components m = 1..M (warped templates) and a background:

    value_m[c,p]  = sum_{h,w} T_m[c,h,w] * Wy_m[h,p] * Wx_m[w,p]
    alogit_m[p]   = sum_{h,w} A_m[h,w]   * Wy_m[h,p] * Wx_m[w,p]
    mix_m[p]      = alogit_m[p] + log_safe(presence_m)
    lp_m[c,p]     = -(t[c,p]-value_m[c,p])^2/(2 s^2) - log s - log sqrt(2pi)
    ll[c,p]       = LSE_m(mix_m[p] + lp_m[c,p]) - LSE_m(mix_m[p])

with the dense bilinear taps Wx[w,p] = relu(1 - |ix[p] - w|) (and Wy the
same in y), every template row and column evaluated for every pixel.
Backward (g = dL/dll):

    q_m[c,p] = exp(mix+lp-num_lse),  r_m[p] = exp(mix-den_lse)
    d/dvalue_m = g * q_m * (t-value)/s^2
    d/dmix_m   = sum_c g*q_m - (sum_c g) * r_m

then the warp transposes through Wx and Wy, and the pose chain through
dWx/dix = -sign(ix - w) * 1{|ix - w| < 1} (``_dtaps``). That slope is 0 at
a texel centre and at |ix - w| = 1: it is this module's own rule, not the
slope of autograd through ``ops/warp.py::affine_warp``.

``fused_decoder_ll`` is an autograd Function whose backward is this
hand-derived one, as ``jax.custom_vjp`` makes it in the JAX package. The
tap weights and the partial products S = T (x) Wx, Sa = A (x) Wx are kept
in ``tap_dtype`` (float32 or bfloat16) and products accumulate in float32,
as there. The decoder's ``fused_impl="xla"`` calls it on any device, and
``decoder_ll_terms`` / ``decoder_ll_backward`` with float32 taps are the
plain version of the dense CUDA kernels (``kernels/decoder_ll_dense.py``).
"""

import math

import torch

from scae_tpu_torch.ops.math_ops import log_safe
from scae_tpu_torch.ops.warp import _base_grid, source_coordinates

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_F32 = torch.float32


def _taps(ix, n, dtype):
    """relu(1 - |ix - w|) -> (..., n, P) in dtype (taps 2nd-to-last)."""
    w = torch.arange(n, dtype=ix.dtype, device=ix.device)[:, None]
    return torch.clamp(1.0 - torch.abs(ix[..., None, :] - w),
                       min=0.0).to(dtype)


def _dtaps(ix, n, dtype):
    """dW/dix = -sign(ix - w) * 1{|ix - w| < 1} -> (..., n, P); the values
    are 0 and +-1, exact in bfloat16."""
    w = torch.arange(n, dtype=ix.dtype, device=ix.device)[:, None]
    diff = ix[..., None, :] - w
    return torch.where(torch.abs(diff) < 1.0, -torch.sign(diff),
                       torch.zeros_like(diff)).to(dtype)


def _mm(equation, a, b, dtype):
    """einsum of two operands held in the tap dtype, accumulated in f32 and
    rounded once to ``dtype``: the MXU's contract, the same on every
    device (a bf16 einsum would leave the accumulation to the backend)."""
    return torch.einsum(equation, a.to(_F32), b.to(_F32)).to(dtype)


def _scalar(v, like):
    return torch.as_tensor(v, dtype=_F32, device=like.device)


def _warp_values(templates, alpha, Wx, Wy):
    """(V, Alogit, S, Sa): V (B, M, C, P) and Alogit (B, M, P) in f32, the
    partial products S (B, M, C, Ht, P) and Sa (B, M, Ht, P) in the taps'
    dtype."""
    tap = Wx.dtype
    S = _mm("bmchw,bmwp->bmchp", templates.to(tap), Wx, tap)
    V = _mm("bmchp,bmhp->bmcp", S, Wy, _F32)
    Sa = _mm("bmhw,bmwp->bmhp", alpha.to(tap), Wx, tap)
    Alogit = _mm("bmhp,bmhp->bmp", Sa, Wy, _F32)
    return V, Alogit, S, Sa


def _mixture_ll(V, Alogit, presence, bg_value, bg_mixing_logit, scale,
                target_flat):
    """Per-pixel ll (B, C, P) and its two LSEs, num (B, C, P) and den
    (B, P)."""
    inv_2var = 1.0 / (2.0 * scale * scale)
    log_scale = torch.log(scale)
    B, M, C, P = V.shape

    mix = Alogit + log_safe(presence)[..., None]            # (B, M, P)
    mix_bg = bg_mixing_logit.reshape(()).expand(B, 1, P)    # (B, 1, P)
    lp = -((target_flat[:, None] - V) ** 2) * inv_2var - log_scale \
        - _LOG_SQRT_2PI                                     # (B, M, C, P)
    d_bg = target_flat - bg_value.reshape(())
    lp_bg = -(d_bg * d_bg) * inv_2var - log_scale - _LOG_SQRT_2PI
    num_terms = torch.cat([mix[:, :, None] + lp,
                           (mix_bg[:, :, None] + lp_bg[:, None])], dim=1)
    num_lse = torch.logsumexp(num_terms, dim=1)             # (B, C, P)
    den_lse = torch.logsumexp(torch.cat([mix, mix_bg], dim=1), dim=1)
    return num_lse - den_lse[:, None], num_lse, den_lse


def _forward(templates, alpha, pose, presence, bg_value, bg_mixing_logit,
             scale, target, out_size, tap_dtype):
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    P = H * W
    ix, iy = source_coordinates(pose.to(_F32), (Ht, Wt), out_size)
    Wx = _taps(ix, Wt, tap_dtype)
    Wy = _taps(iy, Ht, tap_dtype)
    alpha_b = alpha[:, :, 0].expand(B, M, Ht, Wt)
    V, Alogit, S, Sa = _warp_values(templates, alpha_b, Wx, Wy)
    ll, num_lse, den_lse = _mixture_ll(
        V, Alogit, presence, bg_value, bg_mixing_logit, scale,
        target.reshape(B, C, P))
    return ll.reshape(B, C, H, W), (V, Alogit, num_lse, den_lse, Wx, Wy, S,
                                    Sa)


def _bwd(inputs, saved, g, out_size, tap_dtype):
    """Gradients of sum(g * ll) for the 8 array inputs, from the inputs
    and the forward's saved values; each in its input's shape."""
    (templates, alpha, pose, presence, bg_value, bg_mixing_logit, scale,
     target) = inputs
    V, Alogit, num_lse, den_lse, Wx, Wy, S, Sa = saved
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    P = H * W
    g = g.reshape(B, C, P).to(_F32)                         # dL/dll
    tgt = target.reshape(B, C, P)
    bg_value_s = bg_value.reshape(())
    bg_mix_s = bg_mixing_logit.reshape(())

    inv_2var = 1.0 / (2.0 * scale * scale)
    log_scale = torch.log(scale)
    presq = log_safe(presence)

    # the taps and S/Sa are saved; only the (B, M, P) source coordinates
    # are recomputed for the tap derivative
    ix, iy = source_coordinates(pose.to(_F32), (Ht, Wt), out_size)
    gx, gy = (v.reshape(-1) for v in _base_grid(out_size, _F32,
                                                 templates.device))

    mix = Alogit + presq[..., None]                         # (B, M, P)
    diff = tgt[:, None] - V                                 # (B, M, C, P)
    lp = -(diff * diff) * inv_2var - log_scale - _LOG_SQRT_2PI
    q = torch.exp(mix[:, :, None] + lp - num_lse[:, None])  # (B, M, C, P)
    r = torch.exp(mix - den_lse[:, None])                   # (B, M, P)

    gq = g[:, None] * q                                     # (B, M, C, P)
    g_sum_c = torch.sum(g, dim=1)                           # (B, P)

    # component-parameter gradients
    gV = gq * diff * (2.0 * inv_2var)                       # (B, M, C, P)
    gmix = torch.sum(gq, dim=2) - g_sum_c[:, None] * r      # (B, M, P)

    # background component
    diff_bg = tgt - bg_value_s                              # (B, C, P)
    lp_bg = -(diff_bg * diff_bg) * inv_2var - log_scale - _LOG_SQRT_2PI
    q_bg = torch.exp(bg_mix_s + lp_bg - num_lse)            # (B, C, P)
    r_bg = torch.exp(bg_mix_s - den_lse)                    # (B, P)
    gq_bg = g * q_bg
    g_bg_value = torch.sum(gq_bg * diff_bg) * 2.0 * inv_2var
    g_bg_mix = torch.sum(gq_bg) - torch.sum(g_sum_c * r_bg)

    # dlp/dscale = diff^2 / s^3 - 1 / s for every component
    g_scale = (torch.sum(gq * (diff * diff))
               + torch.sum(gq_bg * (diff_bg * diff_bg))) / (scale ** 3) \
        - (torch.sum(gq) + torch.sum(gq_bg)) / scale

    # presence through log_safe (derivative 1/p where p >= eps)
    g_presq = torch.sum(gmix, dim=-1)                       # (B, M)
    g_presence = torch.where(presence < 1e-16, torch.zeros_like(presence),
                             g_presq / presence)

    # dlp/dt = -2 (t - v) inv_2var
    g_target = ((torch.sum(gq * diff, dim=1) + gq_bg * diff_bg)
                * (-2.0 * inv_2var)).reshape(B, C, H, W)

    # warp transposes (tap dtype, f32 accumulation)
    gV_t = gV.to(tap_dtype)
    gmix_t = gmix.to(tap_dtype)
    U = _mm("bmcp,bmhp->bmchp", gV_t, Wy, tap_dtype)
    g_templates = _mm("bmchp,bmwp->bmchw", U, Wx, _F32)
    Ua = (gmix_t.to(_F32)[:, :, None] * Wy.to(_F32)).to(tap_dtype)
    g_alpha_full = _mm("bmhp,bmwp->bmhw", Ua, Wx, _F32)
    if alpha.shape[0] == 1:
        g_alpha = torch.sum(g_alpha_full, dim=0, keepdim=True)[:, :, None]
    else:
        g_alpha = g_alpha_full[:, :, None]

    # g_Wx[w,p] = sum_{c,h} gV*T*Wy + gmix*A*Wy, reusing U and Ua
    T_t = templates.to(tap_dtype)
    alpha_t = alpha[:, :, 0].expand(B, M, Ht, Wt).to(tap_dtype)
    g_Wx = (_mm("bmchp,bmchw->bmwp", U, T_t, tap_dtype).to(_F32)
            + _mm("bmhp,bmhw->bmwp", Ua, alpha_t, tap_dtype).to(_F32)
            ).to(tap_dtype)
    g_ix = torch.sum(g_Wx.to(_F32) * _dtaps(ix, Wt, tap_dtype).to(_F32),
                     dim=2)                                 # (B, M, P)

    # g_Wy from the forward's partial products S and Sa
    g_Wy = (_mm("bmcp,bmchp->bmhp", gV_t, S, tap_dtype).to(_F32)
            + (gmix_t.to(_F32)[:, :, None] * Sa.to(_F32)).to(tap_dtype)
            .to(_F32)).to(tap_dtype)
    g_iy = torch.sum(g_Wy.to(_F32) * _dtaps(iy, Ht, tap_dtype).to(_F32),
                     dim=2)                                 # (B, M, P)

    # pose chain: ix = ((a x + b y + tx + 1) Wt - 1)/2
    cx = 0.5 * Wt
    cy = 0.5 * Ht
    g_pose = torch.stack([
        torch.einsum("bmp,p->bm", g_ix, gx) * cx,
        torch.einsum("bmp,p->bm", g_ix, gy) * cx,
        torch.sum(g_ix, dim=-1) * cx,
        torch.einsum("bmp,p->bm", g_iy, gx) * cy,
        torch.einsum("bmp,p->bm", g_iy, gy) * cy,
        torch.sum(g_iy, dim=-1) * cy,
    ], dim=-1)

    return (g_templates, g_alpha, g_pose, g_presence,
            g_bg_value.reshape(bg_value.shape),
            g_bg_mix.reshape(bg_mixing_logit.shape),
            g_scale.reshape(scale.shape), g_target)


class FusedDecoderLL(torch.autograd.Function):
    """The forward's values, the hand-derived backward (``_bwd``)."""

    @staticmethod
    def forward(ctx, templates, alpha, pose, presence, bg_value,
                bg_mixing_logit, scale, target, out_size, tap_dtype):
        inputs = (templates, alpha, pose, presence, bg_value,
                  bg_mixing_logit, scale, target)
        ll, saved = _forward(*inputs, out_size, tap_dtype)
        ctx.save_for_backward(*inputs, *saved)
        ctx.out_size = out_size
        ctx.tap_dtype = tap_dtype
        return ll

    @staticmethod
    def backward(ctx, g):
        tensors = ctx.saved_tensors
        grads = _bwd(tensors[:8], tensors[8:], g, ctx.out_size,
                     ctx.tap_dtype)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad[:8])),
                None, None)


def fused_decoder_ll(templates, alpha, pose, presence, bg_value,
                     bg_mixing_logit, scale, target, out_size,
                     tap_dtype=torch.bfloat16):
    """Per-pixel reconstruction mixture log-likelihood (B, C, H, W), f32.

    Arguments as the decoder computes them, after their nonlinearities:
    bg_value = sigmoid(bg_param), bg_mixing_logit = softplus(param), scale
    the final scalar (each a scalar tensor or number); alpha (1 or B, M, 1,
    Ht, Wt) alpha-channel logits; tap_dtype torch.float32 or
    torch.bfloat16.
    """
    return FusedDecoderLL.apply(
        templates, alpha, pose, presence,
        *(_scalar(v, templates) for v in (bg_value, bg_mixing_logit, scale)),
        target, tuple(out_size), tap_dtype)


def decoder_ll_terms(templates, alpha, pose, presence, bg_value,
                     bg_mixing_logit, scale, target, out_size,
                     tap_dtype=_F32):
    """(ll (B, C, H, W), num (B, C, P), den (B, 1, P)) without a graph."""
    B, C = templates.shape[0], templates.shape[2]
    with torch.no_grad():
        ll, saved = _forward(
            templates, alpha, pose, presence,
            *(_scalar(v, templates) for v in (bg_value, bg_mixing_logit,
                                               scale)),
            target, tuple(out_size), tap_dtype)
    return ll, saved[2], saved[3].reshape(B, 1, -1)


def decoder_ll_backward(g, num, den, templates, alpha, pose, presence,
                        bg_value, bg_mixing_logit, scale, target, out_size,
                        tap_dtype=_F32, target_grad=True):
    """The hand-derived backward from the inputs and the forward's LSEs
    num (B, C, P) and den (B, 1, P): the warp is recomputed. Returns the 8
    gradients (g_target None unless ``target_grad``); the three scalar
    gradients in their inputs' shapes (0-d for a number)."""
    B = templates.shape[0]
    scalars = [_scalar(v, templates) for v in (bg_value, bg_mixing_logit,
                                               scale)]
    inputs = (templates, alpha, pose, presence, *scalars, target)
    with torch.no_grad():
        _, saved = _forward(*inputs, tuple(out_size), tap_dtype)
        saved = saved[:2] + (num, den.reshape(B, -1)) + saved[4:]
        grads = _bwd(inputs, saved, g, tuple(out_size), tap_dtype)
    return (*grads[:7], grads[7] if target_grad else None)
