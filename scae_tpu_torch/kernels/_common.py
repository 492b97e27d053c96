"""The seam between the hand-written kernels and PyTorch, and the checks
and launch helpers the kernel wrappers share.

A kernel meets PyTorch one of two ways:

  * an op that an exported program calls by name (K6, V1f, V1b) is defined
    with ``define_op`` in the package's one ``torch.library`` fragment
    (``LIB``), with its CUDA launch, its plain version for CPU tensors, its
    fake and, where it has one, its backward;
  * every other kernel is called by its wrapper, and the three
    decoder-likelihood routes (gather K1 / K2+K3, dense K4f / K4b, banded
    K5f / K5b) take autograd through the one ``DecoderLLFunction``.

Every decoder-likelihood kernel takes the argument contract of
``scae_tpu/ops/decoder_ll.py::fused_decoder_ll``; these helpers check it
on the host before a launch, pack the three scalars for the kernel, pass
it the plain version's output grid, and turn a launcher's error code into
an exception. The three run-scatter backwards (K2+K3, K4b, K5b) share a
block layout, a key rule and one launch (``run_scatter_backward``).
"""

import torch

from scae_tpu_torch.ops.math_ops import as_scalar
from scae_tpu_torch.ops.warp import _base_grid, source_coordinates
from scae_tpu_torch.utils import trace

MAX_CHANNELS = 4                 # the kernels are instantiated for C = 1..4
SMEM_LIMIT = 232448              # 227 KB: the most a block can have on Hopper
MAX_GRID_Y = 65535
RUN_SCATTER_WARPS = 4            # warps of a run-scatter backward block

# A fragment, not ``torch.library.custom_op``, whose kernels run inside
# ``torch._dynamo``'s disable wrapper: an op's first call would import
# torch._dynamo, seconds of every training and serving process's set-up.
LIB = torch.library.Library("scae_tpu_torch", "FRAGMENT")


def define_op(schema, cuda, cpu, fake, backward=None, setup_context=None):
    """Define ``scae_tpu_torch::<schema>`` in ``LIB``: ``cuda`` launches
    its kernel on CUDA tensors and raises on anything it does not take,
    ``cpu`` is its plain version (None: no CPU implementation), ``fake``
    gives its outputs' shapes, so that ``torch.export`` records a call to
    the op rather than tracing into either, and ``backward`` with
    ``setup_context`` its gradient (``torch.library.register_autograd``).
    Defining builds nothing: a kernel is built at its first launch.
    Returns the op's qualified name."""
    name = schema[:schema.index("(")]
    qualname = f"scae_tpu_torch::{name}"
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    if cpu is not None:
        LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(qualname, fake, lib=LIB)
    if backward is not None:
        torch.library.register_autograd(qualname, backward,
                                        setup_context=setup_context, lib=LIB)
    return qualname


def pad4(n):
    """``n`` floats rounded up to whole 16-byte chunks."""
    return -(-n // 4) * 4


def run_scatter_shared_memory_bytes(C, Ht, Wt) -> int:
    """Dynamic shared memory of one block of a run-scatter backward (K2+K3,
    K4b and K5b: one capsule of one example): the capsule table (C + 1
    planes a texel, padded to 2, 4 or 8 floats), and for each warp a
    gradient table (C + 1 planes) and a scratch of its 32 pixels' 4 (C + 1)
    tap values and keys."""
    T, CC = Ht * Wt, C + 1
    tex = 2 if CC <= 2 else (4 if CC <= 4 else 8)
    return 4 * (T * tex + RUN_SCATTER_WARPS * (CC * T + (4 * CC + 1) * 32))


def scatter_keys(pose, tex_size, out_size, rows=None):
    """A run-scatter backward's keys, as the .cu sources compute them: for
    each capsule and output pixel, (row (Ht + 1) + floor(iy) + 1) (Wt + 1)
    + floor(ix) + 1, the output row and the cell of the pixel's two taps on
    each axis; -1 where neither row tap lies in the rows [lo, hi) or
    neither column tap in the template. ``rows``: (lo, hi), each
    broadcastable to (B, M, P), the rows a tap may land on (K5b's windows);
    the template's rows (K2+K3, K4b) where None. (B, M, P) int64. Pixels
    of one warp pass with equal keys must be neighbours: each run is summed
    by one lane."""
    Ht, Wt = tex_size
    H, W = out_size
    lo, hi = (torch.as_tensor(v) for v in (rows or (0, Ht)))
    ix, iy = source_coordinates(pose.to(torch.float32), tex_size, out_size)
    h0, w0 = torch.floor(iy), torch.floor(ix)
    hit = ((lo < hi) & (h0 >= lo - 1) & (h0 <= hi - 1)
           & (w0 >= -1) & (w0 <= Wt - 1))
    row = torch.arange(H * W, device=pose.device) // W
    key = ((row * (Ht + 1) + h0.clamp(-1, Ht - 1).long() + 1) * (Wt + 1)
           + w0.clamp(-1, Wt - 1).long() + 1)
    return torch.where(hit, key, torch.full_like(key, -1))


def scalar_tensor(v, device):
    """``v`` as a 0-d float32 tensor on ``device``; raises unless it holds
    one value."""
    t = as_scalar(v, torch.float32, device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.reshape(())


def scalars(device, *values):
    """The scalars as one contiguous float32 vector, as the kernels read
    them."""
    return torch.stack([scalar_tensor(v, device) for v in values]) \
        .contiguous()


def check_inputs(templates, alpha, pose, presence, target, out_size,
                 **extra):
    """Raise unless every array is a contiguous float32 tensor of the
    expected shape on the templates' device, and the sizes fit the
    kernels. ``extra``: more (tensor, shape) pairs to check."""
    if templates.dim() != 5:
        raise ValueError(f"templates must be (B, M, C, Ht, Wt), got "
                         f"{tuple(templates.shape)}")
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    P = H * W
    device = templates.device
    expected = {
        "templates": (templates, (B, M, C, Ht, Wt)),
        "alpha": (alpha, (alpha.shape[0], M, 1, Ht, Wt)),
        "pose": (pose, (B, M, 6)),
        "presence": (presence, (B, M)),
        "target": (target, (B, C, H, W)),
        **extra,
    }
    for name, (t, shape) in expected.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, templates on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if alpha.shape[0] not in (1, B):
        raise ValueError(f"alpha's batch must be 1 or {B}, got {alpha.shape[0]}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"the kernel takes 1..{MAX_CHANNELS} channels, got {C}")
    if B > MAX_GRID_Y or M < 1 or P < 1:
        raise ValueError(f"unsupported sizes B={B}, M={M}, P={P}")


def output_grid(out_size, device):
    """The plain version's output grid (x, then y), each flattened to (P,),
    so that a kernel computes the same source coordinates and picks the
    same taps."""
    return [v.reshape(-1).contiguous()
            for v in _base_grid(out_size, torch.float32, device)]


def check_smem(smem, what):
    """Raise if ``what`` needs more shared memory than a block has."""
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: {smem} bytes of shared memory needed, "
                         f"more than the {SMEM_LIMIT} a block has")


def raise_on(rc, err, what):
    """Raise if a launcher returned a CUDA error code; ``err`` is the
    library's ``scae_cuda_error_string``."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")


def launch(kernel, library, *args):
    """Launch ``kernel`` (its id: K1, K2+K3, ..., P2) by its launcher
    (``library``: the launcher and the library's error string, as
    ``_build.load`` returns them) on the current stream of its first
    argument's device. ``args``: tensors, passed by address (None: a null
    pointer), then ints. Raises on the error code the launcher returns;
    counts the launch (``trace.LAUNCHES``), so that a launch into a graph
    capture counts once and a replay, which calls no wrapper, nothing."""
    fn, err = library[:2]
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    raise_on(rc, err, kernel)
    trace.count(trace.LAUNCHES + kernel)


def likelihood_forward(kernel, library, win, ints, templates, alpha, pose,
                       presence, bg_value, bg_mixing_logit, scale, target,
                       out_size):
    """Launch a likelihood forward (``kernel``: K1, K4f or K5f) on checked
    CUDA tensors: (ll, num, den). ``win``: K5f's windows, None for the
    kernels that take none; ``ints``: the launcher's ints after (B, M, C,
    Ht, Wt, H, W)."""
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    device = templates.device
    f32 = dict(dtype=torch.float32, device=device)
    ll = torch.empty((B, C, H, W), **f32)
    num = torch.empty((B, C, H * W), **f32)
    den = torch.empty((B, 1, H * W), **f32)
    launch(kernel, library, templates, alpha, pose, presence, target,
           scalars(device, bg_value, bg_mixing_logit, scale),
           *output_grid(out_size, device), *([] if win is None else [win]),
           ll, num, den, B, M, C, Ht, Wt, H, W, *ints)
    return ll, num, den


def run_scatter_backward(kernel, library, check, win, last, g, num, den,
                         templates, alpha, pose, presence, bg_value,
                         bg_mixing_logit, scale, target, out_size,
                         target_grad):
    """Launch a run-scatter backward (``kernel``: K2+K3, K4b or K5b) on
    CUDA tensors. ``library``: its launcher and error string
    (``_build.load``); ``check``: its route's input checks, which also get
    g, num and den; ``win``: K5b's windows, None for the kernels that take
    none; ``last``: the launcher's last int (K5b's band rows, the others'
    alpha_batched). Returns (g_templates, g_alpha, g_pose, g_presence,
    g_bg_value, g_bg_mixing_logit, g_scale, g_target): alpha's gradient
    summed to its own batch of 1 or B, the scalar gradients 0-d, g_target
    None unless ``target_grad``. The scalar gradients and alpha's batch
    sum are taken here, over the kernel's per-capsule terms, in a fixed
    order; every buffer is written in full by the kernel, so none is
    zeroed."""
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    P = H * W
    check(templates, alpha, pose, presence, target, out_size,
          g=(g, (B, C, H, W)), num=(num, (B, C, P)), den=(den, (B, 1, P)))
    check_smem(run_scatter_shared_memory_bytes(C, Ht, Wt),
               f"{kernel}, the backward's capsule and gradient tables")
    device = templates.device
    f32 = dict(dtype=torch.float32, device=device)
    gtab = torch.empty((B, M, C + 1, Ht, Wt), **f32)
    gpose = torch.empty((B, M, 6), **f32)
    gpres = torch.empty((B, M), **f32)
    cscal = torch.empty((B, M + 1, 3), **f32)
    tpart = torch.empty((B, M, C, P), **f32) if target_grad else None
    gtarget = torch.empty((B, C, H, W), **f32) if target_grad else None
    launch(kernel, library, templates, alpha, pose, presence, target,
           scalars(device, bg_value, bg_mixing_logit, scale), g, num, den,
           *output_grid(out_size, device), *([] if win is None else [win]),
           gtab, gpose, gpres, cscal, tpart, gtarget, B, M, C, Ht, Wt, H, W,
           last)
    g_alpha = gtab[:, :, C:]
    if alpha.shape[0] == 1:
        g_alpha = g_alpha.sum(dim=0, keepdim=True)
    gscal = cscal.sum(dim=(0, 1))
    return (gtab[:, :, :C], g_alpha, gpose, gpres, gscal[0], gscal[1],
            gscal[2], gtarget)


class DecoderLLFunction(torch.autograd.Function):
    """One decoder-likelihood route under autograd: ``fwd`` gives (ll,
    num, den) and ``bwd`` the gradients of ``sum(g * ll)`` from num and
    den, each with the argument contract of ``fused_decoder_ll`` and each
    taking the plain version on CPU tensors and launching its kernel on
    CUDA tensors; ``apply(fwd, bwd, templates, alpha, pose, presence,
    bg_value, bg_mixing_logit, scale, target, out_size)``.

    The forward saves num and den, as the JAX package's ``_core_fwd`` and
    ``_pallas_fwd`` do; the backward returns a gradient for every array
    input that needs one (None elsewhere), each in its input's shape, and
    asks ``bwd`` for the target's only where the target needs one.
    """

    @staticmethod
    def forward(ctx, fwd, bwd, templates, alpha, pose, presence, bg_value,
                bg_mixing_logit, scale, target, out_size):
        ll, num, den = fwd(templates, alpha, pose, presence, bg_value,
                           bg_mixing_logit, scale, target, out_size)
        ctx.save_for_backward(templates, alpha, pose, presence, bg_value,
                              bg_mixing_logit, scale, target, num, den)
        ctx.bwd, ctx.out_size = bwd, out_size
        ctx.mark_non_differentiable(num, den)
        return ll, num, den

    @staticmethod
    def backward(ctx, g, _g_num, _g_den):
        needs = ctx.needs_input_grad[2:10]
        *inputs, num, den = ctx.saved_tensors
        # the gradient of a sum or a mean arrives expanded, with zero strides
        grads = ctx.bwd(g.contiguous(), num, den, *inputs, ctx.out_size,
                        target_grad=needs[7])
        return (None, None, *(gr.reshape(x.shape) if need else None
                              for gr, x, need in zip(grads, inputs, needs)),
                None)
