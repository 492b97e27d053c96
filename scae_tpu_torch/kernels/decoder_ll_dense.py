"""Dense fused decoder log-likelihood: the CUDA kernels K4f (forward) and
K4b (backward) and their plain PyTorch version.

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

``decoder_ll_dense`` goes through ``DecoderLLFunction`` (``_common.py``) on
every device: its forward and backward take the plain version for CPU
tensors and launch K4f and K4b (``csrc/decoder_ll_dense.cu``,
``csrc/decoder_ll_dense_bwd.cu``) for CUDA tensors. A CUDA wrapper raises
on anything its kernel does not take rather than falling back. K4b is the
run scatter of ``csrc/decoder_ll_tap_bwd.cuh``, which K5b shares: one block
per (capsule, example), no floating-point atomics, so its results are the
same bit for bit from run to run; ``bwd_tap_keys`` computes its scatter
keys on the CPU. See the sources for each kernel's bound on the H100 and
how its design meets it.
"""

import functools

import torch

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.kernels._common import (
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
from scae_tpu_torch.ops.decoder_ll import decoder_ll_backward, decoder_ll_terms
from scae_tpu_torch.ops.math_ops import as_scalar

SOURCE = "decoder_ll_dense.cu"
BWD_SOURCE = "decoder_ll_dense_bwd.cu"
_SIGNATURES = {
    SOURCE: ("scae_decoder_ll_dense_fwd", 11, 11),
    BWD_SOURCE: ("scae_decoder_ll_dense_bwd", 17, 8),
}


def decoder_ll_dense(templates, alpha, pose, presence, bg_value,
                     bg_mixing_logit, scale, target, out_size):
    """Per-pixel reconstruction mixture log-likelihood (B, C, H, W) and its
    LSE terms num (B, C, P) and den (B, 1, P), through
    ``DecoderLLFunction``: the plain version on CPU tensors, K4f and K4b on
    CUDA tensors."""
    device = templates.device
    return DecoderLLFunction.apply(
        decoder_ll_dense_fwd, decoder_ll_dense_bwd, templates, alpha, pose,
        presence,
        *(as_scalar(v, torch.float32, device)
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


FWD_MAX_THREADS = 512          # threads of a K4f block, at most
FWD_PIXELS = 2                 # pixels of a K4f thread (kPixels)
FWD_CHUNK = 32                 # capsules of a K4f ring buffer, at most
FWD_STAGES = 2                 # buffers of the ring (kStages)
FWD_SMEM_BUDGET = 100 * 1024   # the ring's bytes (two blocks to an SM),
                               # where one capsule allows


def shared_memory_bytes(C, Ht, Wt, chunk=None) -> int:
    """Dynamic shared memory of one K4f block: a ring of ``FWD_STAGES``
    buffers of ``chunk`` capsules, each buffer the capsules' template and
    alpha tables (texel-major: C + 1 floats a texel), then from a 16-byte
    boundary their poses and presences. It does not depend on M. Without a
    chunk, the planner's (``forward_ring``)."""
    if chunk is None:
        chunk = forward_ring(C, Ht, Wt)
    T = Ht * Wt
    return 4 * FWD_STAGES * pad4(pad4(chunk * (C + 1) * T) + 7 * chunk)


@functools.cache
def forward_ring(C, Ht, Wt):
    """Capsules of a buffer of K4f's ring: ``FWD_CHUNK``, halved while the
    ring exceeds ``FWD_SMEM_BUDGET``, down to 1. Two one-capsule buffers
    take what the earlier double-buffered design took, so every size it
    ran still runs; a size whose two one-capsule buffers do not fit is
    refused by the wrapper."""
    chunk = FWD_CHUNK
    while chunk > 1 and shared_memory_bytes(C, Ht, Wt, chunk) \
            > FWD_SMEM_BUDGET:
        chunk //= 2
    return chunk


@functools.cache
def pixel_tiling(P):
    """K4f's pixel tiling of one example's P pixels: (tiles, threads),
    threads a multiple of 32 up to ``FWD_MAX_THREADS``, each with
    ``FWD_PIXELS`` pixels of a tile of ceil(P / tiles): the fewest tiles
    (each tile reads every capsule) whose idle pixel slots are at most an
    eighth of P, else the tiling with the fewest idle slots."""
    best = None
    for tiles in range(1, P + 1):
        tile_px = -(-P // tiles)
        threads = max(32, -(-tile_px // (32 * FWD_PIXELS)) * 32)
        if threads > FWD_MAX_THREADS:
            continue
        idle = tiles * threads * FWD_PIXELS - P
        if 8 * idle <= P:
            return tiles, threads
        if best is None or idle < best[0]:
            best = (idle, tiles, threads)
        if threads == 32:
            break
    return best[1], best[2]


def forward_plan(shape):
    """K4f's launch plan for (B, M, C, Ht, Wt, H, W): tiles and threads
    (``pixel_tiling``), chunk (``forward_ring``), blocks (B x tiles) and
    smem (bytes, the same for every M)."""
    B, M, C, Ht, Wt, H, W = shape
    tiles, threads = pixel_tiling(H * W)
    chunk = forward_ring(C, Ht, Wt)
    return dict(tiles=tiles, threads=threads, chunk=chunk, blocks=B * tiles,
                smem=shared_memory_bytes(C, Ht, Wt, chunk))


# one K4b block's shared memory: K2+K3's layout (csrc/decoder_ll_tap_bwd.cuh)
bwd_shared_memory_bytes = run_scatter_shared_memory_bytes


# K4b's scatter keys: K2+K3's rule (csrc/decoder_ll_tap_bwd.cuh)
bwd_tap_keys = scatter_keys


def build_info(source=SOURCE) -> _build.BuiltLibrary:
    """Build a kernel (``SOURCE`` for K4f, ``BWD_SOURCE`` for K4b) now if
    needed; the path, ``-Xptxas -v`` report and build seconds of its
    library."""
    return _build.load(source, *_SIGNATURES[source])[2]


def blocks_per_sm(C, Ht, Wt, threads, chunk) -> int:
    """Blocks of K4f that fit on one SM of the current card for this plan
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); builds K4f if
    needed."""
    return _build.query(SOURCE, "scae_decoder_ll_dense_fwd_occupancy",
                        C, Ht, Wt, threads, chunk)


def _launch(templates, alpha, pose, presence, bg_value, bg_mixing_logit,
            scale, target, out_size):
    """Launch K4f on CUDA tensors: (ll, num, den), with the planner's
    plan (``forward_plan``)."""
    check_inputs(templates, alpha, pose, presence, target, out_size)
    B, M, C, Ht, Wt = templates.shape
    p = forward_plan((B, M, C, Ht, Wt, *out_size))
    check_smem(p["smem"], "K4f's ring of staged capsule tables")
    return likelihood_forward(
        "K4f", _build.load(SOURCE, *_SIGNATURES[SOURCE]), None,
        (int(alpha.shape[0] != 1), p["tiles"], p["threads"], p["chunk"]),
        templates, alpha, pose, presence, bg_value, bg_mixing_logit, scale,
        target, out_size)


def _bwd_launch(g, num, den, templates, alpha, pose, presence, bg_value,
                bg_mixing_logit, scale, target, out_size, target_grad=True):
    """Launch K4b on CUDA tensors; returns what ``decoder_ll_dense_bwd``
    does. One launch with a target gradient is two CUDA kernels from the
    one source."""
    return run_scatter_backward(
        "K4b", _build.load(BWD_SOURCE, *_SIGNATURES[BWD_SOURCE]),
        check_inputs, None, int(alpha.shape[0] != 1), g, num, den,
        templates, alpha, pose, presence, bg_value, bg_mixing_logit, scale,
        target, out_size, target_grad)
