"""Dense fused decoder log-likelihood: the CUDA kernels K4f (forward) and
K4b (backward), their plain PyTorch version, and the autograd Function
that joins them.

Replaces the Pallas kernels of ``scae_tpu/ops/pallas_decoder_ll.py``,
``_fwd_kernel`` (K4f) and ``_bwd_kernel`` (K4b), which the decoder reaches
with ``fused_impl="pallas"``. The argument contract is that of
``kernels/decoder_ll_gather.py`` and of
``scae_tpu/ops/decoder_ll.py::fused_decoder_ll``; ``decoder_ll_dense``
returns ``(ll, num, den)`` as ``decoder_ll_gather`` does.

The plain version is ``ops/decoder_ll.py`` with float32 taps: the dense
warp, the mixture and its hand-derived backward, whose tap derivative is
``_dtaps`` (0 at a texel centre), as the TPU kernel's ``_dtap`` is. The
TPU kernel contracts its template and alpha gradients in bfloat16 on the
MXU; these kernels and their plain version are float32 throughout.

``decoder_ll_dense`` goes through ``DecoderLLDense`` on every device: its
forward and backward take the plain version for CPU tensors and launch
K4f and K4b (``csrc/decoder_ll_dense.cu``, ``csrc/decoder_ll_dense_bwd.cu``)
for CUDA tensors. A CUDA wrapper raises on anything its kernel does not
take rather than falling back. K4b is the run scatter of
``csrc/decoder_ll_tap_bwd.cuh``, which K5b shares: one block per (capsule,
example), no floating-point atomics, so its results are the same bit for
bit from run to run; ``bwd_tap_keys`` computes its scatter keys on the
CPU. See the sources for each kernel's bound on the H100 and how its
design meets it.
"""

import torch

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.kernels._common import (
    check_inputs,
    check_smem,
    output_grid,
    raise_on,
    run_scatter_shared_memory_bytes,
    scalar_tensor,
    scalars,
    scatter_keys,
)
from scae_tpu_torch.ops.decoder_ll import decoder_ll_backward, decoder_ll_terms

SOURCE = "decoder_ll_dense.cu"
BWD_SOURCE = "decoder_ll_dense_bwd.cu"
_SIGNATURES = {
    SOURCE: ("scae_decoder_ll_dense_fwd", 11, 8),
    BWD_SOURCE: ("scae_decoder_ll_dense_bwd", 17, 8),
}

# Kernel launches since a counter was last set to 0: ``launches`` for K4f,
# ``bwd_launches`` for K4b (one per backward call, which with a target
# gradient is two CUDA kernels from the one source). Only the CUDA paths add
# to them; the plain version never does.
launches = 0
bwd_launches = 0


def decoder_ll_dense(templates, alpha, pose, presence, bg_value,
                     bg_mixing_logit, scale, target, out_size):
    """Per-pixel reconstruction mixture log-likelihood (B, C, H, W) and its
    LSE terms num (B, C, P) and den (B, 1, P), through ``DecoderLLDense``:
    the plain version on CPU tensors, K4f and K4b on CUDA tensors."""
    device = templates.device
    return DecoderLLDense.apply(
        templates, alpha, pose, presence,
        *(torch.as_tensor(v, dtype=torch.float32, device=device)
          for v in (bg_value, bg_mixing_logit, scale)),
        target, tuple(out_size))


def decoder_ll_dense_fwd(templates, alpha, pose, presence, bg_value,
                         bg_mixing_logit, scale, target, out_size):
    """(ll, num, den) without a graph: the plain version for CPU tensors,
    K4f for CUDA tensors."""
    fn = decoder_ll_dense_plain if templates.device.type == "cpu" \
        else _launch
    return fn(templates, alpha, pose, presence, bg_value, bg_mixing_logit,
              scale, target, out_size)


def decoder_ll_dense_plain(templates, alpha, pose, presence, bg_value,
                           bg_mixing_logit, scale, target, out_size):
    """K4f's function in plain PyTorch: ``ops/decoder_ll.py``'s dense
    forward with float32 taps."""
    return decoder_ll_terms(templates, alpha, pose, presence, bg_value,
                            bg_mixing_logit, scale, target, out_size,
                            torch.float32)


def decoder_ll_dense_bwd(g, num, den, templates, alpha, pose, presence,
                         bg_value, bg_mixing_logit, scale, target, out_size,
                         target_grad=True):
    """Gradients of ``sum(g * ll)`` with respect to the 8 array inputs,
    from the forward's num and den: (g_templates, g_alpha, g_pose,
    g_presence, g_bg_value, g_bg_mixing_logit, g_scale, g_target), each
    array gradient in its input's shape (alpha's summed to its own batch of
    1 or B), the three scalar gradients 0-d, g_target None unless
    ``target_grad``. CPU tensors take the plain backward; CUDA tensors
    launch K4b."""
    fn = decoder_ll_dense_bwd_plain if templates.device.type == "cpu" \
        else _bwd_launch
    return fn(g, num, den, templates, alpha, pose, presence, bg_value,
              bg_mixing_logit, scale, target, out_size, target_grad)


def decoder_ll_dense_bwd_plain(g, num, den, templates, alpha, pose,
                               presence, bg_value, bg_mixing_logit, scale,
                               target, out_size, target_grad=True):
    """K4b's function in plain PyTorch: ``ops/decoder_ll.py``'s
    hand-derived backward with float32 taps, the warp recomputed."""
    return decoder_ll_backward(
        g, num, den, templates, alpha, pose, presence,
        *(scalar_tensor(v, templates.device)
          for v in (bg_value, bg_mixing_logit, scale)),
        target, out_size, torch.float32, target_grad)


def shared_memory_bytes(C, Ht, Wt) -> int:
    """Dynamic shared memory of one K4f block: two capsules' tables (the
    one being read and the next), each with its pose and log-presence."""
    return 4 * 2 * ((C + 1) * Ht * Wt + 8)


# one K4b block's shared memory: K2+K3's layout (csrc/decoder_ll_tap_bwd.cuh)
bwd_shared_memory_bytes = run_scatter_shared_memory_bytes


# K4b's scatter keys: K2+K3's rule (csrc/decoder_ll_tap_bwd.cuh)
bwd_tap_keys = scatter_keys


def build_info(source=SOURCE) -> _build.BuiltLibrary:
    """Build a kernel (``SOURCE`` for K4f, ``BWD_SOURCE`` for K4b) now if
    needed; the path, ``-Xptxas -v`` report and build seconds of its
    library."""
    return _build.load(source, *_SIGNATURES[source])[2]



def _launch(templates, alpha, pose, presence, bg_value, bg_mixing_logit,
            scale, target, out_size):
    """Launch K4f on CUDA tensors: (ll, num, den)."""
    global launches
    check_inputs(templates, alpha, pose, presence, target, out_size)
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    P = H * W
    device = templates.device
    check_smem(shared_memory_bytes(C, Ht, Wt),
                "K4f's two staged capsule tables")
    scal = scalars(device, bg_value, bg_mixing_logit, scale)
    grid_x, grid_y = output_grid(out_size, device)

    f32 = dict(dtype=torch.float32, device=device)
    ll = torch.empty((B, C, H, W), **f32)
    num = torch.empty((B, C, P), **f32)
    den = torch.empty((B, 1, P), **f32)
    fn, err, _ = _build.load(SOURCE, *_SIGNATURES[SOURCE])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(templates.data_ptr(), alpha.data_ptr(), pose.data_ptr(),
                presence.data_ptr(), target.data_ptr(), scal.data_ptr(),
                grid_x.data_ptr(), grid_y.data_ptr(), ll.data_ptr(),
                num.data_ptr(), den.data_ptr(),
                B, M, C, Ht, Wt, H, W, int(alpha.shape[0] != 1), stream)
    raise_on(rc, err, "decoder_ll_dense")
    launches += 1
    return ll, num, den


def _bwd_launch(g, num, den, templates, alpha, pose, presence, bg_value,
                bg_mixing_logit, scale, target, out_size, target_grad=True):
    """Launch K4b on CUDA tensors; returns what ``decoder_ll_dense_bwd``
    does. The scalar gradients and alpha's batch sum are taken here, over
    the kernel's per-capsule terms, in a fixed order."""
    global bwd_launches
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    P = H * W
    check_inputs(templates, alpha, pose, presence, target, out_size,
                  g=(g, (B, C, H, W)),
                  num=(num, (B, C, P)), den=(den, (B, 1, P)))
    check_smem(bwd_shared_memory_bytes(C, Ht, Wt),
                "K4b's capsule table and warp tables")
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
    fn, err, _ = _build.load(BWD_SOURCE, *_SIGNATURES[BWD_SOURCE])
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
    raise_on(rc, err, "decoder_ll_dense backward")
    bwd_launches += 1
    g_alpha = gtab[:, :, C:]
    if alpha.shape[0] == 1:
        g_alpha = g_alpha.sum(dim=0, keepdim=True)
    gscal = cscal.sum(dim=(0, 1))
    return (gtab[:, :, :C], g_alpha, gpose, gpres, gscal[0], gscal[1],
            gscal[2], gtarget)


class DecoderLLDense(torch.autograd.Function):
    """K4f forward, K4b backward on CUDA tensors; the plain version's
    forward and backward on CPU tensors.

    The forward saves num and den, as the JAX package's ``_pallas_fwd``
    does; the backward returns a gradient for every array input that needs
    one (None elsewhere), each in its input's shape.
    """

    @staticmethod
    def forward(ctx, templates, alpha, pose, presence, bg_value,
                bg_mixing_logit, scale, target, out_size):
        ll, num, den = decoder_ll_dense_fwd(
            templates, alpha, pose, presence, bg_value, bg_mixing_logit,
            scale, target, out_size)
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
        grads = decoder_ll_dense_bwd(g.contiguous(), num, den, *inputs,
                                     ctx.out_size, target_grad=needs[7])
        return (*(gr.reshape(x.shape) if need else None
                  for gr, x, need in zip(grads, inputs, needs)), None)
