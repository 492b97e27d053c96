"""Banded, row-windowed fused decoder log-likelihood: the CUDA kernels K5f
(forward) and K5b (backward), their plain PyTorch version, and the
autograd Function that joins them.

Replaces the Pallas kernels of ``scae_tpu/ops/pallas_decoder_ll_banded.py``,
``_fwd_kernel`` (K5f) and ``_bwd_kernel`` (K5b), which the decoder reaches
with ``fused_impl="pallas_banded"``. The function and the argument contract
are those of ``kernels/decoder_ll_dense.py`` (K4) and of
``scae_tpu/ops/decoder_ll.py::fused_decoder_ll``; ``decoder_ll_banded``
returns ``(ll, num, den)`` as the other wrappers do. What makes it another
kernel is the work plan, kept from the TPU kernel:

  * the capsules are padded to a multiple of 8 with presence-0 ones and
    sorted by their vertical translation ty (a stable sort, as JAX's), so
    that a group of 8 consecutive capsules lands on nearby canvas rows;
    the gather that sorts them unsorts their gradients under autograd;
  * the canvas is cut into bands of R rows (``band_rows``);
  * for every (example, band, group) ``h_windows`` bounds, outside the
    kernels, the template rows ``[lo, lo + trips)`` that any capsule of the
    group can touch from any pixel of the band, and the kernels read only
    those rows.

The windows are exact only through their bounds: a template row left out
of a window drops its mass without a sound. The plain version makes that
testable. It sorts and pads as the wrapper does and runs
``ops/decoder_ll.py`` with float32 taps and its hand-derived backward, with
the y-taps and their slope zeroed outside each capsule's window for the
pixel's band (``window_row_mask``): it equals the unwindowed dense version
exactly when the windows hold every touched row. The TPU kernel warps
through a block-diagonal bfloat16 matrix product on its MXU; these kernels
and their plain version are float32 throughout.

``decoder_ll_banded`` goes through ``DecoderLLBanded`` on every device: the
plain version for CPU tensors, K5f and K5b (``csrc/decoder_ll_banded.cu``,
``csrc/decoder_ll_banded_bwd.cu``) for CUDA tensors, which raise on
anything the kernels do not take. K5f is K4f's design with the windows: a
block per (band, example), the capsules' window rows streamed through a
two-buffer ``cp.async`` ring of capsule chunks that ``forward_plan`` sizes
by the blocks per SM that the registers allow.
K5b is K4b's run scatter (``csrc/decoder_ll_tap_bwd.cuh``) with the y-taps
masked by the windows: one block per (capsule, example), no
floating-point atomics, so its results repeat bit for bit;
``bwd_tap_keys`` computes its scatter keys on the CPU.
"""

import functools

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
from scae_tpu_torch.ops.math_ops import as_scalar
from scae_tpu_torch.ops.warp import _axis

SOURCE = "decoder_ll_banded.cu"
BWD_SOURCE = "decoder_ll_banded_bwd.cu"
GROUP = 8                 # capsules per group (kGroup in the sources)
MAX_BAND_PIXELS = 512     # pixels of a band, at most (kMaxBandPixels)
_SIGNATURES = {
    SOURCE: ("scae_decoder_ll_banded_fwd", 12, 11),
    BWD_SOURCE: ("scae_decoder_ll_banded_bwd", 18, 8),
}

# Kernel launches since a counter was last set to 0: ``launches`` for K5f,
# ``bwd_launches`` for K5b. Only the CUDA paths add to them.
launches = 0
bwd_launches = 0


def band_rows(H: int, W: int) -> int:
    """The band height: the divisor r of H whose band of r * W pixels is
    nearest 320 (the first such r on a tie). JAX ``_band_rows``."""
    best, best_score = H, float("inf")
    for r in range(1, H + 1):
        if H % r:
            continue
        score = abs(r * W - 320)
        if score < best_score:
            best, best_score = r, score
    return best


def h_windows(pose, Ht, H, W, rows):
    """Per (example, band, group) template-row windows, int32 (B, NB, G, 2)
    of [lo, trips], from the sorted, padded poses (B, M, 6): JAX
    ``_h_windows``, in float32 in the same order, with the same 1e-3 pads.

    sy is affine in the pixel, so over a band it is extreme at the band's
    corners; a row h has a nonzero tap where |iy - h| < 1, so the rows
    [floor(iy_min - 1) + 1, ceil(iy_max + 1) - 1] hold every touched one.
    A capsule whose band lies off the template contributes no row; a group
    with none gets trips = 0. (JAX's takes the template width too, unused.)"""
    B, M, _ = pose.shape
    NB = H // rows
    G = M // GROUP
    pose = pose.detach().to(torch.float32)
    xs = _axis(W, torch.float32, pose.device)
    ys = _axis(H, torch.float32, pose.device)
    x0, x1 = xs[0], xs[-1]
    y0 = ys[0::rows]                          # (NB,) band first rows
    y1 = ys[rows - 1::rows]                   # (NB,) band last rows
    c = pose[..., 3, None]                    # (B, M, 1)
    d = pose[..., 4, None]
    ty = pose[..., 5, None]
    corners = [c * x + d * y + ty for x in (x0, x1) for y in (y0, y1)]
    sy_min = torch.minimum(torch.minimum(corners[0], corners[1]),
                           torch.minimum(corners[2], corners[3]))
    sy_max = torch.maximum(torch.maximum(corners[0], corners[1]),
                           torch.maximum(corners[2], corners[3]))
    iy_min = ((sy_min + 1.0) * Ht - 1.0) * 0.5     # (B, M, NB)
    iy_max = ((sy_max + 1.0) * Ht - 1.0) * 0.5
    lo_m = torch.floor(iy_min - 1.0 - 1e-3) + 1.0
    hi_m = torch.ceil(iy_max + 1.0 + 1e-3) - 1.0
    empty = (iy_max < -1.0 - 1e-3) | (iy_min > float(Ht) + 1e-3)
    lo_m = torch.where(empty, float(Ht), torch.clamp(lo_m, 0, Ht - 1))
    hi_m = torch.where(empty, -1.0, torch.clamp(hi_m, 0, Ht - 1))
    lo_g = torch.amin(lo_m.reshape(B, G, GROUP, NB), dim=2)   # (B, G, NB)
    hi_g = torch.amax(hi_m.reshape(B, G, GROUP, NB), dim=2)
    trips = torch.clamp(hi_g - lo_g + 1.0, min=0.0)
    lo = torch.clamp(lo_g, 0, Ht - 1)
    win = torch.stack([lo, trips], dim=-1)                    # (B, G, NB, 2)
    return win.permute(0, 2, 1, 3).to(torch.int32).contiguous()


def window_row_mask(win, Ht, H, W, rows):
    """(B, M, Ht, P) float32: 1 where template row h lies in the window of
    the capsule's group for the pixel's band, else 0."""
    B, NB, G, _ = win.shape
    lo = win[..., 0, None].long()                              # (B, NB, G, 1)
    trips = win[..., 1, None].long()
    h = torch.arange(Ht, device=win.device)
    inside = (h >= lo) & (h < lo + trips)                      # (B, NB, G, Ht)
    inside = inside.repeat_interleave(GROUP, dim=2)            # (B, NB, M, Ht)
    mask = inside.permute(0, 2, 3, 1)[..., None].expand(
        B, G * GROUP, Ht, NB, rows * W)
    return mask.reshape(B, G * GROUP, Ht, H * W).to(torch.float32)


def sort_and_pad(templates, alpha, pose, presence):
    """The wrapper's layout: capsules padded to a multiple of 8 with
    presence-0 ones, alpha broadcast to the batch, all sorted by ty (a
    stable sort). Differentiable: the gathers unsort the gradients and sum
    a shared alpha's over the batch."""
    B, M, C, Ht, Wt = templates.shape
    pad = (-M) % GROUP
    alpha = alpha.reshape(-1, M, 1, Ht, Wt).expand(B, M, 1, Ht, Wt)
    if pad:
        def zeros(x, n):
            return x.new_zeros((B, n, *x.shape[2:]))

        templates = torch.cat([templates, zeros(templates, pad)], dim=1)
        alpha = torch.cat([alpha, zeros(alpha, pad)], dim=1)
        pose = torch.cat([pose, zeros(pose, pad)], dim=1)
        presence = torch.cat([presence, zeros(presence, pad)], dim=1)
    order = torch.argsort(pose[..., 5].detach(), dim=1, stable=True)

    def take(x):
        index = order.reshape(B, -1, *(1,) * (x.dim() - 2))
        return torch.take_along_dim(x, index, dim=1).contiguous()

    return take(templates), take(alpha), take(pose), take(presence)


def decoder_ll_banded(templates, alpha, pose, presence, bg_value,
                      bg_mixing_logit, scale, target, out_size):
    """Per-pixel reconstruction mixture log-likelihood (B, C, H, W) and its
    LSE terms num (B, C, P) and den (B, 1, P): the capsules sorted and
    padded, then ``DecoderLLBanded``: the plain version on CPU tensors, K5f
    and K5b on CUDA tensors."""
    device = templates.device
    return DecoderLLBanded.apply(
        *sort_and_pad(templates, alpha, pose, presence),
        *(as_scalar(v, torch.float32, device)
          for v in (bg_value, bg_mixing_logit, scale)),
        target.contiguous(), tuple(out_size))


def _windows(pose, templates, out_size, win=None):
    """(rows, win): the band height and the windows of the sorted, padded
    inputs; ``win`` when given (``DecoderLLBanded`` computes it once for
    the forward and the backward), else computed here."""
    H, W = out_size
    rows = band_rows(H, W)
    if win is None:
        win = h_windows(pose, templates.shape[3], H, W, rows)
    return rows, win


def decoder_ll_banded_fwd(templates, alpha, pose, presence, bg_value,
                          bg_mixing_logit, scale, target, out_size,
                          win=None):
    """(ll, num, den) of the sorted, padded inputs without a graph: the
    plain version for CPU tensors, K5f for CUDA tensors. ``win``: the
    windows (``h_windows``), computed from the poses when None."""
    fn = decoder_ll_banded_plain if templates.device.type == "cpu" \
        else _launch
    return fn(templates, alpha, pose, presence, bg_value, bg_mixing_logit,
              scale, target, out_size, win)


def decoder_ll_banded_plain(templates, alpha, pose, presence, bg_value,
                            bg_mixing_logit, scale, target, out_size,
                            win=None):
    """K5f's function in plain PyTorch, on sorted, padded inputs:
    ``ops/decoder_ll.py``'s dense forward with float32 taps, the y-taps
    zeroed outside the windows."""
    rows, win = _windows(pose, templates, out_size, win)
    mask = window_row_mask(win, templates.shape[3], *out_size, rows)
    return decoder_ll_terms(templates, alpha, pose, presence, bg_value,
                            bg_mixing_logit, scale, target, out_size,
                            torch.float32, row_mask=mask)


def decoder_ll_banded_bwd(g, num, den, templates, alpha, pose, presence,
                          bg_value, bg_mixing_logit, scale, target, out_size,
                          target_grad=True, win=None):
    """Gradients of ``sum(g * ll)`` with respect to the 8 array inputs of
    the sorted, padded call, from the forward's num and den, each in its
    input's shape, the three scalar gradients 0-d, g_target None unless
    ``target_grad``. CPU tensors take the plain backward; CUDA tensors
    launch K5b. ``win`` as for ``decoder_ll_banded_fwd``."""
    fn = decoder_ll_banded_bwd_plain if templates.device.type == "cpu" \
        else _bwd_launch
    return fn(g, num, den, templates, alpha, pose, presence, bg_value,
              bg_mixing_logit, scale, target, out_size, target_grad, win)


def decoder_ll_banded_bwd_plain(g, num, den, templates, alpha, pose,
                                presence, bg_value, bg_mixing_logit, scale,
                                target, out_size, target_grad=True,
                                win=None):
    """K5b's function in plain PyTorch: ``ops/decoder_ll.py``'s
    hand-derived backward with float32 taps, the y-taps and their slope
    zeroed outside the windows."""
    rows, win = _windows(pose, templates, out_size, win)
    mask = window_row_mask(win, templates.shape[3], *out_size, rows)
    return decoder_ll_backward(
        g, num, den, templates, alpha, pose, presence,
        *(scalar_tensor(v, templates.device)
          for v in (bg_value, bg_mixing_logit, scale)),
        target, out_size, torch.float32, target_grad, row_mask=mask)


FWD_PIXELS = 1             # pixels of a K5f thread (the kernel takes 1 or 2)
FWD_CHUNK = 64             # capsules of a K5f ring buffer, at most (kMaxChunk)
SM_SHARED = 233472         # shared memory an SM holds for its blocks (228 KB)
BLOCK_RESERVED = 1024      # of which the runtime takes per block
SM_REGISTERS = 65536       # registers of an SM, allocated 256 a warp
SM_THREADS = 2048
SM_BLOCKS = 32


def _pad4(n):
    return -(-n // 4) * 4


def threads_per_block(H, W, pixels=FWD_PIXELS) -> int:
    """Threads of a K5f block: its band's pixels over ``pixels`` a thread,
    rounded up to whole warps."""
    return -(-band_rows(H, W) * W // (32 * pixels)) * 32


def shared_memory_bytes(C, Ht, Wt, chunk, M) -> int:
    """Dynamic shared memory of one K5f block: a ring of buffers of
    ``chunk`` capsules (two, one when a chunk holds all M), each the
    capsules' template and alpha tables (texel-major: C + 1 floats a texel;
    only the window rows are written), then from a 16-byte boundary their
    poses and presences; then one texel of zeros, which a tap outside its
    window reads."""
    buffers = 2 if M > chunk else 1
    return 4 * (buffers * _pad4(_pad4(chunk * (C + 1) * Ht * Wt) + 7 * chunk)
                + _pad4(C + 1))


def blocks_by_registers(registers, threads) -> int:
    """Blocks of ``threads`` threads of ``registers`` registers each that
    one SM holds, by its registers, threads and blocks."""
    per_warp = -(-registers * 32 // 256) * 256
    return max(1, min(SM_BLOCKS, SM_THREADS // threads,
                      SM_REGISTERS // per_warp // (threads // 32)))


@functools.cache
def forward_chunk(C, Ht, Wt, M, blocks):
    """Capsules of a buffer of K5f's ring when ``blocks`` blocks share an
    SM: the most (up to ``FWD_CHUNK`` and M) whose ring fits their share of
    its shared memory, then evened out over the chunks they take; one
    capsule at the least. Two one-capsule buffers take less than the
    earlier design's group of 8 tables, so every size it ran still runs; a
    size whose floor does not fit a block is refused by the wrapper."""
    budget = SM_SHARED // blocks - BLOCK_RESERVED
    chunk = min(M, FWD_CHUNK)
    while chunk > 1 and shared_memory_bytes(C, Ht, Wt, chunk, M) > budget:
        chunk -= 1
    chunks = -(-M // chunk)
    return -(-M // chunks)


def forward_plan(shape, registers, pixels=FWD_PIXELS):
    """K5f's launch plan for (B, M, C, Ht, Wt, H, W), M a multiple of 8,
    and a thread's ``registers``: the band (rows, bands), threads of
    ``pixels`` pixels each, the blocks per SM that the registers allow, the
    chunk for that many blocks (``forward_chunk``) and the chunks M takes,
    the blocks (bands x B) and smem (bytes)."""
    B, M, C, Ht, Wt, H, W = shape
    rows = band_rows(H, W)
    threads = threads_per_block(H, W, pixels)
    per_sm = blocks_by_registers(registers, threads)
    chunk = forward_chunk(C, Ht, Wt, M, per_sm)
    return dict(rows=rows, bands=H // rows, threads=threads, pixels=pixels,
                register_blocks=per_sm, chunk=chunk, chunks=-(-M // chunk),
                blocks=B * (H // rows),
                smem=shared_memory_bytes(C, Ht, Wt, chunk, M))


@functools.cache
def fwd_registers(C, pixels=FWD_PIXELS) -> int:
    """Registers a thread of K5f takes on the current card (its built
    library's cudaFuncGetAttributes); builds K5f if needed."""
    return _build.query(SOURCE, "scae_decoder_ll_banded_fwd_registers", C,
                        pixels)


def blocks_per_sm(C, M, Ht, Wt, threads, pixels, chunk) -> int:
    """Blocks of K5f that fit on one SM of the current card for this plan
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); builds K5f if
    needed."""
    return _build.query(SOURCE, "scae_decoder_ll_banded_fwd_occupancy", C, M,
                        Ht, Wt, threads, pixels, chunk)


# one K5b block's shared memory: K4b's (csrc/decoder_ll_tap_bwd.cuh)
bwd_shared_memory_bytes = run_scatter_shared_memory_bytes


def window_rows(win, Ht, H, W):
    """(lo, hi), each (B, M, P) int64: the template rows [lo, hi) a tap of
    each pixel may land on in K5b, the window of the capsule's group for
    the pixel's band (``win``, ``h_windows``) clipped to the template."""
    rows = band_rows(H, W)
    w = win.long().repeat_interleave(GROUP, dim=2)            # (B, NB, M, 2)
    w = w.transpose(1, 2).repeat_interleave(rows * W, dim=2)  # (B, M, P, 2)
    return w[..., 0].clamp(min=0), (w[..., 0] + w[..., 1]).clamp(max=Ht)


def bwd_tap_keys(pose, tex_size, out_size, win):
    """K5b's scatter keys for the sorted, padded poses (B, M, 6): K4b's
    rule with the row taps limited to ``window_rows``. (B, M, P) int64."""
    return scatter_keys(pose, tex_size, out_size,
                        rows=window_rows(win, tex_size[0], *out_size))


def build_info(source=SOURCE) -> _build.BuiltLibrary:
    """Build a kernel (``SOURCE`` for K5f, ``BWD_SOURCE`` for K5b) now if
    needed; the path, ``-Xptxas -v`` report and build seconds of its
    library."""
    return _build.load(source, *_SIGNATURES[source])[2]


def _check(templates, alpha, pose, presence, target, out_size, **extra):
    """The dense kernels' checks, and what the banded ones add: capsules
    in whole groups, alpha per example, a band of at most 512 pixels."""
    check_inputs(templates, alpha, pose, presence, target, out_size, **extra)
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    if M % GROUP:
        raise ValueError(f"the banded kernels take the capsules in groups of "
                         f"{GROUP} (decoder_ll_banded pads them), got M={M}")
    if alpha.shape[0] != B:
        raise ValueError("the banded kernels take alpha per example "
                         "(decoder_ll_banded broadcasts it)")
    pixels = band_rows(H, W) * W
    if pixels > MAX_BAND_PIXELS:
        raise ValueError(f"a band of {pixels} pixels ({band_rows(H, W)} rows "
                         f"of {W}) is more than the {MAX_BAND_PIXELS} the "
                         "banded kernels take")
    return B, M, C, Ht, Wt, H, W



def _launch(templates, alpha, pose, presence, bg_value, bg_mixing_logit,
            scale, target, out_size, win=None, plan=None):
    """Launch K5f on sorted, padded CUDA tensors: (ll, num, den), with the
    planner's plan (``forward_plan``) unless ``plan`` gives the threads,
    pixels and chunk (chip_plans.py and the card's tests time and check
    other plans)."""
    global launches
    B, M, C, Ht, Wt, H, W = _check(templates, alpha, pose, presence, target,
                                   out_size)
    # the planner's ring fits a block whenever its floor, two one-capsule
    # buffers, does
    check_smem(shared_memory_bytes(C, Ht, Wt, 1, M),
               "K5f's ring of one-capsule buffers")
    if plan is None:
        plan = forward_plan((B, M, C, Ht, Wt, H, W), fwd_registers(C))
    device = templates.device
    rows, win = _windows(pose, templates, out_size, win)
    scal = scalars(device, bg_value, bg_mixing_logit, scale)
    grid_x, grid_y = output_grid(out_size, device)
    f32 = dict(dtype=torch.float32, device=device)
    ll = torch.empty((B, C, H, W), **f32)
    num = torch.empty((B, C, H * W), **f32)
    den = torch.empty((B, 1, H * W), **f32)
    fn, err, _ = _build.load(SOURCE, *_SIGNATURES[SOURCE])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(templates.data_ptr(), alpha.data_ptr(), pose.data_ptr(),
                presence.data_ptr(), target.data_ptr(), scal.data_ptr(),
                grid_x.data_ptr(), grid_y.data_ptr(), win.data_ptr(),
                ll.data_ptr(), num.data_ptr(), den.data_ptr(),
                B, M, C, Ht, Wt, H, W, rows, plan["threads"], plan["pixels"],
                plan["chunk"], stream)
    raise_on(rc, err, "decoder_ll_banded")
    launches += 1
    return ll, num, den


def _bwd_launch(g, num, den, templates, alpha, pose, presence, bg_value,
                bg_mixing_logit, scale, target, out_size, target_grad=True,
                win=None):
    """Launch K5b on sorted, padded CUDA tensors; returns what
    ``decoder_ll_banded_bwd`` does. The scalar gradients are taken here,
    over the kernel's per-capsule terms, in a fixed order."""
    global bwd_launches
    B, M, C, Ht, Wt = templates.shape
    H, W = out_size
    P = H * W
    _check(templates, alpha, pose, presence, target, out_size,
           g=(g, (B, C, H, W)), num=(num, (B, C, P)), den=(den, (B, 1, P)))
    check_smem(bwd_shared_memory_bytes(C, Ht, Wt),
               "K5b's capsule table and warp tables")
    device = templates.device
    rows, win = _windows(pose, templates, out_size, win)
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
                grid_x.data_ptr(), grid_y.data_ptr(), win.data_ptr(),
                gtab.data_ptr(), gpose.data_ptr(), gpres.data_ptr(),
                cscal.data_ptr(),
                tpart.data_ptr() if target_grad else None,
                gtarget.data_ptr() if target_grad else None,
                B, M, C, Ht, Wt, H, W, rows, stream)
    raise_on(rc, err, "decoder_ll_banded backward")
    bwd_launches += 1
    gscal = cscal.sum(dim=(0, 1))
    return (gtab[:, :, :C], gtab[:, :, C:], gpose, gpres, gscal[0], gscal[1],
            gscal[2], gtarget)


class DecoderLLBanded(torch.autograd.Function):
    """K5f forward, K5b backward on sorted, padded CUDA tensors; the plain
    version's forward and backward on CPU tensors.

    The forward saves num and den, as the JAX package's ``_core_fwd``
    does, and the windows, which it computes once for both kernels; the
    backward returns a gradient for every array input that needs
    one (None elsewhere), each in its input's shape.
    """

    @staticmethod
    def forward(ctx, templates, alpha, pose, presence, bg_value,
                bg_mixing_logit, scale, target, out_size):
        _, win = _windows(pose, templates, out_size)
        ll, num, den = decoder_ll_banded_fwd(
            templates, alpha, pose, presence, bg_value, bg_mixing_logit,
            scale, target, out_size, win)
        ctx.save_for_backward(templates, alpha, pose, presence, bg_value,
                              bg_mixing_logit, scale, target, num, den)
        ctx.out_size, ctx.win = out_size, win
        ctx.mark_non_differentiable(num, den)
        return ll, num, den

    @staticmethod
    def backward(ctx, g, _g_num, _g_den):
        needs = ctx.needs_input_grad[:8]
        *inputs, num, den = ctx.saved_tensors
        # the gradient of a sum or a mean arrives expanded, with zero strides
        grads = decoder_ll_banded_bwd(g.contiguous(), num, den, *inputs,
                                      ctx.out_size, target_grad=needs[7],
                                      win=ctx.win)
        return (*(gr.reshape(x.shape) if need else None
                  for gr, x, need in zip(grads, inputs, needs)), None)
