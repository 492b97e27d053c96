"""Presence-masked set attention: the CUDA kernel K6 and its plain PyTorch
version.

Replaces the Pallas kernel ``scae_tpu/ops/pallas_attention.py``
(``_attention_kernel``, its ``pallas_call`` at line 99), which
``qkv_attention(..., use_pallas=True)`` and the set transformer's
``use_pallas_attention`` reach. It computes, per batch row,

    softmax((Q K^T - (1 - presence) * 1e9) / sqrt(d_k)) V

with the mask subtracted before the scaling. Forward only: the backward
recomputes the plain path (``ops/attention.py::AttentionFunction``), as the
JAX package's custom VJP does. The TPU kernel pads N to 8 and M, d_k, d_v
to 128; this one takes the sizes as they are.

K6 is the operator ``torch.ops.scae_tpu_torch.attention_fwd`` (``OP``), a
``torch.library`` custom op registered when this module is imported: its
CUDA implementation launches K6 (``csrc/attention.cu``) and raises on
anything the kernel does not take, its CPU implementation is the plain
version, and its fake implementation gives the output's shape, so that
``torch.export`` records a call to the op (a serving artifact calls K6 by
name) rather than tracing into either. Registering builds nothing: K6 is
built at its first launch. ``attention`` calls the op. K6 has no atomics:
its results repeat bit for bit.
"""

import functools

import torch

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.kernels._common import SMEM_LIMIT, raise_on
from scae_tpu_torch.ops.attention import qkv_attention_plain

SOURCE = "attention.cu"
_SIGNATURE = ("scae_attention_fwd", 5, 8)
OP = "scae_tpu_torch::attention_fwd"

# K6 launches since the counter was last set to 0; only the CUDA path adds.
launches = 0


@torch.library.custom_op(OP, mutates_args=(), device_types="cuda")
def attention_fwd(queries: torch.Tensor, keys: torch.Tensor,
                  values: torch.Tensor, presence: torch.Tensor
                  ) -> torch.Tensor:
    """(B, N, d_v): K6 on CUDA tensors, the plain version on CPU ones."""
    return _launch(queries, keys, values, presence)


@attention_fwd.register_kernel("cpu")
def _attention_fwd_cpu(queries, keys, values, presence):
    return attention_plain(queries, keys, values, presence)


@attention_fwd.register_fake
def _attention_fwd_fake(queries, keys, values, presence):
    return queries.new_empty((*queries.shape[:-1], values.shape[-1]))


def attention(queries, keys, values, presence):
    """(B, N, d_v) through the op: the plain version for CPU tensors, K6
    for CUDA ones."""
    return torch.ops.scae_tpu_torch.attention_fwd(queries, keys, values,
                                                  presence)


# K6's function in plain PyTorch: ``ops/attention.py``'s plain path
attention_plain = qkv_attention_plain


MAX_WARPS = 8                # warps of a K6 block


def _pad4(n):
    return -(-n // 4) * 4


def ld_k(d_k, vec):
    """Shared row stride of K, in floats: an odd number of 16-byte chunks
    (vec) or of floats, so that 32 lanes loading 32 keys meet 32 banks."""
    if not vec:
        return d_k | 1
    return d_k if (d_k // 4) % 2 else d_k + 4


def team_width(chunks):
    """Lanes of a team in the value pass: the power of two at or above the
    value row's chunks, at most 32 (then one team takes every key)."""
    g = 1
    while g < chunks and g < 32:
        g *= 2
    return g


def ld_v(d_v, vec):
    """Shared row stride of V, in floats: where a team is narrower than 8
    lanes (d_v of 16 or less, 16-byte chunks), a number of chunks that puts
    neighbouring teams' keys on other banks."""
    if not vec:
        return d_v
    chunks = d_v // 4
    g2 = team_width(chunks)
    if g2 >= 8:
        return d_v
    x = chunks
    while x % 8 != g2:
        x += 1
    return 4 * x


def shared_memory_bytes(N, M, d_k, d_v, rows_per_warp=None, warps=None,
                        vec=None) -> int:
    """Dynamic shared memory of one K6 block of a plan: the tile's Q rows,
    K and V (rows padded as ``ld_k`` and ``ld_v`` say), the M penalties
    and the tile's N x M logits, then weights. Without a plan, the
    planner's for these sizes (16-byte vectors where d_k and d_v allow)."""
    if rows_per_warp is None:
        p = plan(N, M, d_k, d_v, d_k % 4 == 0 and d_v % 4 == 0)
        rows_per_warp, warps, vec = p["rows_per_warp"], p["warps"], p["vec"]
    tile = rows_per_warp * warps
    return 4 * (tile * d_k + M * ld_k(d_k, vec) + M * ld_v(d_v, vec)
                + (_pad4(M) if vec else M) + tile * M)


@functools.cache
def plan(N, M, d_k, d_v, aligned=True):
    """K6's tile plan: 2 rows per warp (each key or value chunk loaded
    from shared memory feeds both), 8 warps where d_k or d_v is 64 or more
    (K and V fill most of the block's shared memory, and more rows share
    them), else 4 (small blocks, more of them to an SM), fewer where N has
    fewer rows; 16-byte vectors where d_k and d_v are multiples of 4 and
    the inputs ``aligned``. Where the block's shared memory would exceed a
    block's, fewer warps, then one row per warp, then scalar rows (whose
    strides pad no row by more than one float: every shape the
    one-block-per-row design took fits); None where nothing fits. Returns
    rows_per_warp, warps, vec, tile (query rows of a block), tiles (blocks
    per batch row) and smem (bytes)."""
    vecs = [True, False] if aligned and d_k % 4 == 0 and d_v % 4 == 0 \
        else [False]
    most = MAX_WARPS if max(d_k, d_v) >= 64 else MAX_WARPS // 2
    for vec in vecs:
        for r in (2, 1) if N > 1 else (1,):
            for warps in range(min(most, -(-N // r)), 0, -1):
                smem = shared_memory_bytes(N, M, d_k, d_v, r, warps, vec)
                if smem <= SMEM_LIMIT:
                    tile = r * warps
                    return dict(rows_per_warp=r, warps=warps, vec=vec,
                                tile=tile, tiles=-(-N // tile), smem=smem)
    return None


def build_info() -> _build.BuiltLibrary:
    """Build K6 now if needed; the path, ``-Xptxas -v`` report and build
    seconds of its library."""
    return _build.load(SOURCE, *_SIGNATURE)[2]


def blocks_per_sm(N, M, d_k, d_v, rows_per_warp, warps, vec) -> int:
    """Blocks of K6 that fit on one SM of the current card for this plan
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); builds K6 if needed."""
    return _build.query(SOURCE, "scae_attention_fwd_occupancy",
                        N, M, d_k, d_v, rows_per_warp, warps, int(vec))


def _check(queries, keys, values, presence):
    if queries.dim() != 3 or keys.dim() != 3 or values.dim() != 3:
        raise ValueError("queries, keys and values must be (B, N, d_k), "
                         "(B, M, d_k) and (B, M, d_v)")
    B, N, d_k = queries.shape
    M, d_v = values.shape[1:]
    expected = {"queries": (queries, (B, N, d_k)),
                "keys": (keys, (B, M, d_k)),
                "values": (values, (B, M, d_v)),
                "presence": (presence, (B, M))}
    for name, (t, shape) in expected.items():
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{queries.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(B, N, M, d_k, d_v) < 1:
        raise ValueError(f"unsupported sizes B={B}, N={N}, M={M}, "
                         f"d_k={d_k}, d_v={d_v}")
    aligned = all(t.data_ptr() % 16 == 0 for t in (queries, keys, values))
    p = plan(N, M, d_k, d_v, aligned)
    if p is None:
        smem = shared_memory_bytes(N, M, d_k, d_v, 1, 1, False)
        raise ValueError(f"K6's staged K, V and a query row: {smem} bytes "
                         f"of shared memory needed, more than the "
                         f"{SMEM_LIMIT} a block has")
    return B, N, M, d_k, d_v, p


def _launch(queries, keys, values, presence):
    """Launch K6 on CUDA tensors with the planner's tile plan."""
    global launches
    B, N, M, d_k, d_v, p = _check(queries, keys, values, presence)
    out = torch.empty((B, N, d_v), dtype=torch.float32, device=queries.device)
    fn, err, _ = _build.load(SOURCE, *_SIGNATURE)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        rc = fn(queries.data_ptr(), keys.data_ptr(), values.data_ptr(),
                presence.data_ptr(), out.data_ptr(), B, N, M, d_k, d_v,
                p["rows_per_warp"], p["warps"], int(p["vec"]), stream)
    raise_on(rc, err, "attention")
    launches += 1
    return out
