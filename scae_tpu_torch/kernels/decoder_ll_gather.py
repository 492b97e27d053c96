"""Gather-form fused decoder log-likelihood: the CUDA kernels K1
(forward) and K2+K3 (backward) and their plain PyTorch versions.

Replaces the Pallas kernels of ``scae_tpu/ops/pallas_decoder_ll_gather.py``:
``_fwd_kernel`` (K1) and the backward pair ``_bwd_kernel`` + ``_gt_kernel``
(K2, K3), which one CUDA kernel does here. Argument contract of
``scae_tpu/ops/decoder_ll.py::fused_decoder_ll``: templates (B, M, C, Ht,
Wt), alpha logits (1 or B, M, 1, Ht, Wt), pose (B, M, 6) flat affines,
presence (B, M), then bg_value, bg_mixing_logit and scale as
post-nonlinearity scalars, target (B, C, H, W) and out_size (H, W).
Returns ``(ll, num, den)``: the per-pixel mixture log-likelihood (B, C,
H, W) and the two log-sum-exps it is the difference of, num (B, C, P) and
den (B, 1, P), kept for the backward.

``decoder_ll_gather`` runs the plain version for CPU tensors, which
autograd differentiates, and for CUDA tensors ``DecoderLLFunction``
(``_common.py``), whose forward launches K1 (``csrc/decoder_ll_gather.cu``)
and whose backward launches the backward kernel
(``csrc/decoder_ll_gather_bwd.cu``). A CUDA
wrapper raises on anything its kernel does not take rather than falling
back. The plain backward is ``torch.autograd.grad`` of the plain forward.
See the sources for each kernel's bound on the H100 and how its design
meets it.
"""

import math

import torch

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.kernels._common import (
    RUN_SCATTER_WARPS,
    SMEM_LIMIT,
    DecoderLLFunction,
    check_inputs,
    check_smem,
    likelihood_forward,
    pad4,
    run_scatter_backward,
    run_scatter_shared_memory_bytes,
    scalar_tensor,
    scatter_keys,
)
from scae_tpu_torch.ops.math_ops import as_scalar, log_safe
from scae_tpu_torch.ops.warp import source_coordinates

SOURCE = "decoder_ll_gather.cu"
BWD_SOURCE = "decoder_ll_gather_bwd.cu"
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def decoder_ll_gather(templates, alpha, pose, presence, bg_value,
                      bg_mixing_logit, scale, target, out_size):
    """Per-pixel reconstruction mixture log-likelihood and its LSE terms.

    CPU tensors take the plain version; CUDA tensors go through
    ``DecoderLLFunction``, which launches K1 and, in the backward, the
    backward kernel.
    """
    if templates.device.type == "cpu":
        return decoder_ll_gather_plain(templates, alpha, pose, presence,
                                       bg_value, bg_mixing_logit, scale,
                                       target, out_size)
    device = templates.device
    return DecoderLLFunction.apply(
        _launch, _bwd_launch, templates, alpha, pose, presence,
        *(as_scalar(v, torch.float32, device)
          for v in (bg_value, bg_mixing_logit, scale)),
        target, tuple(out_size))


def decoder_ll_gather_plain(templates, alpha, pose, presence, bg_value,
                            bg_mixing_logit, scale, target, out_size):
    """The kernel's function in plain PyTorch, f32: the same 4-tap gather
    (``torch.gather`` on the flattened tables) and the same mixture terms,
    with whole-axis log-sum-exps in place of the kernel's streaming ones."""
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    P = H * W
    CC = C + 1
    f32 = torch.float32
    tab = torch.cat([templates.to(f32),
                     alpha.to(f32).expand(B, M, 1, Ht, Wt)], dim=2)
    tab = tab.reshape(B, M, CC, Ht * Wt)

    ix, iy = source_coordinates(pose.to(f32), (Ht, Wt), (H, W))  # (B, M, P)
    h0 = torch.floor(iy)
    w0 = torch.floor(ix)
    fy = iy - h0
    fx = ix - w0

    def valid(v, n):
        return ((v >= 0.0) & (v <= n - 1.0)).to(f32)

    def clip(v, n):
        return torch.clamp(v, 0.0, n - 1.0).to(torch.int64)

    wy = [(1.0 - fy) * valid(h0, Ht), fy * valid(h0 + 1.0, Ht)]
    wx = [(1.0 - fx) * valid(w0, Wt), fx * valid(w0 + 1.0, Wt)]
    rows = [clip(h0, Ht) * Wt, clip(h0 + 1.0, Ht) * Wt]
    cols = [clip(w0, Wt), clip(w0 + 1.0, Wt)]

    def texels(a, b):  # (B, M, CC, P) texels at tap (row a, column b)
        idx = (rows[a] + cols[b])[:, :, None, :].expand(B, M, CC, P)
        return torch.gather(tab, 3, idx)

    V = (wy[0][:, :, None] * (wx[0][:, :, None] * texels(0, 0)
                              + wx[1][:, :, None] * texels(0, 1))
         + wy[1][:, :, None] * (wx[0][:, :, None] * texels(1, 0)
                                + wx[1][:, :, None] * texels(1, 1)))

    bg_value, bg_mix, scale = (scalar_tensor(v, templates.device)
                               for v in (bg_value, bg_mixing_logit, scale))
    inv_2var = 1.0 / (2.0 * scale * scale)
    neg_const = -torch.log(scale) - _LOG_SQRT_2PI

    mix = V[:, :, C] + log_safe(presence.to(f32))[..., None]        # (B, M, P)
    mix_bg = bg_mix.expand(B, 1, P)
    den = torch.logsumexp(torch.cat([mix, mix_bg], dim=1), dim=1,
                          keepdim=True)                              # (B, 1, P)

    tgt = target.to(f32).reshape(B, C, P)
    d = tgt[:, None] - V[:, :, :C]                                   # (B, M, C, P)
    lp = -(d * d) * inv_2var + neg_const
    d_bg = tgt - bg_value
    lp_bg = -(d_bg * d_bg) * inv_2var + neg_const                    # (B, C, P)
    terms = torch.cat([mix[:, :, None] + lp, (bg_mix + lp_bg)[:, None]],
                      dim=1)
    num = torch.logsumexp(terms, dim=1)                              # (B, C, P)
    ll = num - den
    return ll.reshape(B, C, H, W), num, den


FWD_THREADS = 256      # K1's threads per block: one pixel each
BWD_WARPS = RUN_SCATTER_WARPS  # backward warps, each with its own table


def shared_memory_bytes(M, C, Ht, Wt, alpha_batched=False, buffers=2) -> int:
    """Dynamic shared memory of one K1 block: a batch-shared alpha table
    (alpha of batch 1), then ``buffers`` example buffers, each holding an
    example's templates, its alpha where alpha is per example, poses,
    presences and log-presences; every region padded to 4 floats."""
    T = Ht * Wt
    buf = (pad4(M * C * T) + (pad4(M * T) if alpha_batched else 0)
           + pad4(6 * M) + 2 * pad4(M))
    return 4 * ((0 if alpha_batched else pad4(M * T)) + buffers * buf)


def forward_buffers(M, C, Ht, Wt, alpha_batched=False) -> int:
    """K1's example buffers: 2 (the next example loaded while the current
    one is computed) where they fit in a block's shared memory, else 1; 0
    where not even one does."""
    for buffers in (2, 1):
        if shared_memory_bytes(M, C, Ht, Wt, alpha_batched,
                               buffers) <= SMEM_LIMIT:
            return buffers
    return 0


def forward_tiles(P) -> int:
    """K1's pixel tiles per example: as few as hold P pixels at one per
    thread; the tiles are of equal size."""
    return -(-P // FWD_THREADS)


# one backward block's shared memory (the layout K4b and K5b share)
bwd_shared_memory_bytes = run_scatter_shared_memory_bytes


# the backward's scatter keys (the rule K4b and K5b share)
bwd_tap_keys = scatter_keys


# symbol, pointer arguments and int arguments of each library's launcher
_SIGNATURES = {
    SOURCE: ("scae_decoder_ll_gather_fwd", 11, 10),
    BWD_SOURCE: ("scae_decoder_ll_gather_bwd", 17, 8),
}


def _library(source):
    """Build (at first use) and load a kernel's shared library; its
    launcher, error-string function and build record."""
    return _build.load(source, *_SIGNATURES[source])


def build_info(source=SOURCE) -> _build.BuiltLibrary:
    """Build a kernel (``SOURCE`` for K1, ``BWD_SOURCE`` for the backward)
    now if needed; the path, ``-Xptxas -v`` report and build seconds of its
    library."""
    return _library(source)[2]


def blocks_per_sm(source, *sizes) -> int:
    """Blocks of a kernel that fit on one SM of the current card
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the kernel's
    registers and shared memory). K1 (``SOURCE``) takes (M, C, Ht, Wt,
    alpha_batched, buffers), the backward (``BWD_SOURCE``) (C, Ht, Wt);
    builds the kernel if needed."""
    return _build.query(source, _SIGNATURES[source][0] + "_occupancy",
                        *sizes)


def _launch(templates, alpha, pose, presence, bg_value, bg_mixing_logit,
            scale, target, out_size):
    """Launch K1 on CUDA tensors: (ll, num, den)."""
    check_inputs(templates, alpha, pose, presence, target, out_size)
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    batched = alpha.shape[0] != 1
    buffers = forward_buffers(M, C, Ht, Wt, batched)
    if buffers == 0:
        check_smem(shared_memory_bytes(M, C, Ht, Wt, batched, 1),
                   "K1's capsule tables")
    return likelihood_forward(
        "K1", _library(SOURCE), None,
        (int(batched), forward_tiles(H * W), buffers), templates, alpha,
        pose, presence, bg_value, bg_mixing_logit, scale, target, out_size)


# ------------------------------------------------------------- backward

def decoder_ll_gather_bwd(g, num, den, templates, alpha, pose, presence,
                          bg_value, bg_mixing_logit, scale, target, out_size,
                          target_grad=True):
    """Gradients of ``sum(g * ll)`` with respect to the 8 array inputs.

    ``g`` (B, C, H, W) is the upstream gradient of ll, ``num`` and ``den``
    the forward's log-sum-exps. Returns (g_templates, g_alpha, g_pose,
    g_presence, g_bg_value, g_bg_mixing_logit, g_scale, g_target): each
    array gradient in its input's shape (alpha's summed to its own batch of
    1 or B), the three scalar gradients 0-d, and g_target None unless
    ``target_grad``. CPU tensors take the plain backward; CUDA tensors
    launch the backward kernel.
    """
    fn = decoder_ll_gather_bwd_plain if templates.device.type == "cpu" \
        else _bwd_launch
    return fn(g, num, den, templates, alpha, pose, presence, bg_value,
              bg_mixing_logit, scale, target, out_size, target_grad)


def decoder_ll_gather_bwd_plain(g, num, den, templates, alpha, pose,
                                presence, bg_value, bg_mixing_logit, scale,
                                target, out_size, target_grad=True):
    """The backward kernel's function as ``torch.autograd.grad`` of the
    plain forward: the same 4-tap form, differentiated by autograd, so no
    hand-derived copy has to be kept in step. ``num`` and ``den`` are not
    read (the plain forward recomputes them)."""
    del num, den
    device = templates.device
    with torch.enable_grad():
        arrays = [t.detach().requires_grad_()
                  for t in (templates, alpha, pose, presence)]
        scals = [scalar_tensor(v, device).detach().requires_grad_()
                 for v in (bg_value, bg_mixing_logit, scale)]
        tgt = target.detach().requires_grad_(target_grad)
        ll = decoder_ll_gather_plain(*arrays, *scals, tgt, out_size)[0]
        wrt = arrays + scals + ([tgt] if target_grad else [])
        grads = torch.autograd.grad(ll, wrt, g.reshape(ll.shape))
    return (*grads[:7], grads[7] if target_grad else None)


def _bwd_launch(g, num, den, templates, alpha, pose, presence, bg_value,
                bg_mixing_logit, scale, target, out_size, target_grad=True):
    """Launch the backward kernel on CUDA tensors; returns what
    ``decoder_ll_gather_bwd`` does."""
    return run_scatter_backward(
        "K2+K3", _library(BWD_SOURCE), check_inputs, None,
        int(alpha.shape[0] != 1), g, num, den, templates, alpha, pose,
        presence, bg_value, bg_mixing_logit, scale, target, out_size,
        target_grad)
