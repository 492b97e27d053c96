"""Gather-form fused decoder log-likelihood: the CUDA kernels K1
(forward) and K2+K3 (backward), their plain PyTorch versions, and the
autograd Function that joins them.

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
autograd differentiates, and for CUDA tensors the autograd Function whose
forward launches K1 (``csrc/decoder_ll_gather.cu``) and whose backward
launches the backward kernel (``csrc/decoder_ll_gather_bwd.cu``). A CUDA
wrapper raises on anything its kernel does not take rather than falling
back. The plain backward is ``torch.autograd.grad`` of the plain forward.
See the sources for each kernel's bound on the H100 and how its design
meets it.
"""

import ctypes
import math

import torch

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.kernels._common import (
    RUN_SCATTER_WARPS,
    SMEM_LIMIT,
    check_inputs,
    check_smem,
    output_grid,
    raise_on,
    run_scatter_shared_memory_bytes,
    scalar_tensor,
    scalars,
    scatter_keys,
)
from scae_tpu_torch.ops.math_ops import log_safe
from scae_tpu_torch.ops.warp import source_coordinates

SOURCE = "decoder_ll_gather.cu"
BWD_SOURCE = "decoder_ll_gather_bwd.cu"
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

# Kernel launches since a counter was last set to 0: ``launches`` for K1,
# ``bwd_launches`` for the backward kernel. Only the CUDA paths add to them,
# once per launch; the plain versions never do.
launches = 0
bwd_launches = 0


def decoder_ll_gather(templates, alpha, pose, presence, bg_value,
                      bg_mixing_logit, scale, target, out_size):
    """Per-pixel reconstruction mixture log-likelihood and its LSE terms.

    CPU tensors take the plain version; CUDA tensors go through
    ``DecoderLLGather``, which launches K1 and, in the backward, the
    backward kernel.
    """
    if templates.device.type == "cpu":
        return decoder_ll_gather_plain(templates, alpha, pose, presence,
                                       bg_value, bg_mixing_logit, scale,
                                       target, out_size)
    device = templates.device
    return DecoderLLGather.apply(
        templates, alpha, pose, presence,
        *(torch.as_tensor(v, dtype=torch.float32, device=device)
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


def _pad4(n):
    return -(-n // 4) * 4


def shared_memory_bytes(M, C, Ht, Wt, alpha_batched=False, buffers=2) -> int:
    """Dynamic shared memory of one K1 block: a batch-shared alpha table
    (alpha of batch 1), then ``buffers`` example buffers, each holding an
    example's templates, its alpha where alpha is per example, poses,
    presences and log-presences; every region padded to 4 floats."""
    T = Ht * Wt
    buf = (_pad4(M * C * T) + (_pad4(M * T) if alpha_batched else 0)
           + _pad4(6 * M) + 2 * _pad4(M))
    return 4 * ((0 if alpha_batched else _pad4(M * T)) + buffers * buf)


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
    lib = ctypes.CDLL(build_info(source).path)
    fn = getattr(lib, _SIGNATURES[source][0] + "_occupancy")
    fn.argtypes = [ctypes.c_int] * len(sizes)
    fn.restype = ctypes.c_int
    blocks = fn(*(int(a) for a in sizes))
    if blocks <= 0:
        raise RuntimeError(f"occupancy query failed ({blocks})")
    return blocks


def _launch(templates, alpha, pose, presence, bg_value, bg_mixing_logit,
            scale, target, out_size):
    """Launch K1 on CUDA tensors: (ll, num, den)."""
    global launches
    check_inputs(templates, alpha, pose, presence, target, out_size)
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    P = H * W
    device = templates.device
    batched = alpha.shape[0] != 1
    buffers = forward_buffers(M, C, Ht, Wt, batched)
    if buffers == 0:
        check_smem(shared_memory_bytes(M, C, Ht, Wt, batched, 1),
                   "K1's capsule tables")
    scal = scalars(device, bg_value, bg_mixing_logit, scale)
    grid_x, grid_y = output_grid(out_size, device)

    f32 = dict(dtype=torch.float32, device=device)
    ll = torch.empty((B, C, H, W), **f32)
    num = torch.empty((B, C, P), **f32)
    den = torch.empty((B, 1, P), **f32)
    fn, err, _ = _library(SOURCE)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(templates.data_ptr(), alpha.data_ptr(), pose.data_ptr(),
                presence.data_ptr(), target.data_ptr(), scal.data_ptr(),
                grid_x.data_ptr(), grid_y.data_ptr(), ll.data_ptr(),
                num.data_ptr(), den.data_ptr(), B, M, C, Ht, Wt, H, W,
                int(batched), forward_tiles(P), buffers, stream)
    raise_on(rc, err, "decoder_ll_gather")
    launches += 1
    return ll, num, den



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
    ``decoder_ll_gather_bwd`` does. The scalar gradients and alpha's batch
    sum are taken here, over the kernel's per-capsule terms, in a fixed
    order; every buffer is written in full by the kernel, so none is
    zeroed."""
    global bwd_launches
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    P = H * W
    check_inputs(templates, alpha, pose, presence, target, out_size,
                  g=(g, (B, C, H, W)),
                  num=(num, (B, C, P)), den=(den, (B, 1, P)))
    check_smem(bwd_shared_memory_bytes(C, Ht, Wt),
               "the backward's capsule and gradient tables")
    device = templates.device
    scal = scalars(device, bg_value, bg_mixing_logit, scale)
    grid_x, grid_y = output_grid(out_size, device)
    f32 = dict(dtype=torch.float32, device=device)
    gtab = torch.empty((B, M, C + 1, Ht, Wt), **f32)
    gpose = torch.empty((B, M, 6), **f32)
    gpres = torch.empty((B, M), **f32)
    cscal = torch.empty((B, M + 1, 3), **f32)
    tpart = torch.empty((B, M, C, P), **f32) if target_grad else None
    gtarget = torch.empty((B, C, H, W), **f32) if target_grad else None
    fn, err, _ = _library(BWD_SOURCE)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(templates.data_ptr(), alpha.data_ptr(), pose.data_ptr(),
                presence.data_ptr(), target.data_ptr(), scal.data_ptr(),
                g.data_ptr(), num.data_ptr(), den.data_ptr(),
                grid_x.data_ptr(), grid_y.data_ptr(), gtab.data_ptr(),
                gpose.data_ptr(), gpres.data_ptr(), cscal.data_ptr(),
                tpart.data_ptr() if target_grad else None,
                gtarget.data_ptr() if target_grad else None,
                B, M, C, Ht, Wt, H, W, int(alpha.shape[0] != 1), stream)
    raise_on(rc, err, "decoder_ll_gather backward")
    bwd_launches += 1
    g_alpha = gtab[:, :, C:]
    if alpha.shape[0] == 1:
        g_alpha = g_alpha.sum(dim=0, keepdim=True)
    gscal = cscal.sum(dim=(0, 1))
    return (gtab[:, :, :C], g_alpha, gpose, gpres, gscal[0], gscal[1],
            gscal[2], gtarget)


class DecoderLLGather(torch.autograd.Function):
    """K1 forward, backward-kernel backward, on CUDA tensors.

    The forward saves num and den, as ``_core_fwd`` does in the JAX
    package; the backward returns a gradient for every array input that
    needs one (None elsewhere), each in its input's shape.
    """

    @staticmethod
    def forward(ctx, templates, alpha, pose, presence, bg_value,
                bg_mixing_logit, scale, target, out_size):
        ll, num, den = _launch(templates, alpha, pose, presence, bg_value,
                               bg_mixing_logit, scale, target, out_size)
        ctx.save_for_backward(templates, alpha, pose, presence, bg_value,
                              bg_mixing_logit, scale, target, num, den)
        ctx.out_size = out_size
        ctx.mark_non_differentiable(num, den)
        return ll, num, den

    @staticmethod
    def backward(ctx, g, _g_num, _g_den):
        needs = ctx.needs_input_grad[:8]
        *inputs, num, den = ctx.saved_tensors
        # the gradient of a sum or a mean arrives expanded, with zero strides
        grads = _bwd_launch(g.contiguous(), num, den, *inputs, ctx.out_size,
                            target_grad=needs[7])
        return (*(gr.reshape(x.shape) if need else None
                  for gr, x, need in zip(grads, inputs, needs)), None)
