"""The toolchain probes P1 and P2: CUDA kernels and their plain PyTorch
versions.

P1 replaces the Pallas kernel ``tools/pallas_probe.py::kernel`` (its
``pallas_call`` at line 17), ``x * 2 + 1`` on one (8, 128) float32 block;
P2 replaces ``tools/pallas_probe.py::mm_kernel`` (its ``pallas_call`` at
line 39), a (256, 128) x (128, 256) float32 product summed in float32. They
probe that a kernel builds, and that one with a grid and shared memory
launches and computes what it should: both live in ``csrc/probe.cu``.
P2 computes a tile of the output a block, several outputs a thread, with
the K axis staged by ``cp.async`` in chunks through a ring of two
shared-memory buffers and each chunk's depths split over slices of
threads; ``matmul_plan`` picks the tile and the chunk.

``affine_probe`` and ``matmul_probe`` check their inputs (device, float32,
2-D, contiguous, and P2's inner sizes), then launch the kernel for CUDA
tensors and raise on anything it does not take; for CPU tensors they run
the plain version. P2's plain version is ``torch.matmul``, which on the
card is exact float32 while ``torch.backends.cuda.matmul.allow_tf32`` is
False, PyTorch's default.
"""

import torch

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.kernels._common import raise_on

SOURCE = "probe.cu"
_AFFINE = ("scae_probe_affine", 2, 1)
_MATMUL = ("scae_probe_matmul", 3, 9)
MAX_GRID_Y = 65535
MAX_INT = 2 ** 31 - 1
# the tiles P2 is built for, (bm, bn, tm, tn, ks): a block's bm x bn
# outputs, tm x tn a thread, each chunk's depths split over ks slices of
# threads (SCAE_MATMUL_TILES in csrc/probe.cu, in its order)
MATMUL_TILES = ((16, 32, 2, 2, 1), (16, 32, 2, 2, 2), (16, 32, 2, 2, 4),
                (32, 32, 2, 2, 2), (32, 32, 2, 4, 4), (16, 16, 2, 2, 4),
                (16, 64, 2, 4, 4))
MATMUL_TILE = (16, 32, 2, 2, 4)  # the planner's tile
MATMUL_KC = 128                 # depths of a staged chunk, at most

# launches since the counters were last set to 0; only the CUDA paths add
affine_launches = 0
matmul_launches = 0


def affine_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """P1's function in plain PyTorch: x * 2 + 1."""
    return x * 2 + 1


def matmul_probe_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P2's function in plain PyTorch: a @ b."""
    return torch.matmul(a, b)


def build_info() -> _build.BuiltLibrary:
    """Build the probes now if needed; the path, ``-Xptxas -v`` report and
    build seconds of their library."""
    return _build.load(SOURCE, *_AFFINE)[2]


def matmul_plan(M, K, N, tile=MATMUL_TILE, kc=MATMUL_KC):
    """P2's launch plan for (M, K) x (K, N): the tile (bm, bn, tm, tn,
    ks), threads a block, kc (``kc`` depths a chunk, cut to K rounded up to
    4), the chunks K takes, the grid (tiles along N, along M), blocks, and
    shared memory (bytes: one buffer of both tiles, two when K takes more
    than one chunk, or the ks - 1 partial output tiles if more)."""
    bm, bn, tm, tn, ks = tile
    kc = min(kc, -(-K // 4) * 4)
    chunks = -(-K // kc)
    grid = (-(-N // bn), -(-M // bm))
    return dict(bm=bm, bn=bn, tm=tm, tn=tn, ks=ks,
                threads=(bm // tm) * (bn // tn) * ks, kc=kc, chunks=chunks,
                grid=grid, blocks=grid[0] * grid[1],
                smem=4 * max(min(chunks, 2) * (bm + bn) * kc,
                             (ks - 1) * bm * bn))


def matmul_blocks_per_sm(plan, K) -> int:
    """Blocks of P2 that fit on one SM of the current card for this plan
    at depth K; builds the probes if needed."""
    return _build.query(SOURCE, "scae_probe_matmul_occupancy",
                        *_tile(plan), K, plan["kc"])


def matmul_registers(plan) -> int:
    """Registers a thread of P2 takes for the plan's tile; builds the
    probes if needed."""
    return _build.query(SOURCE, "scae_probe_matmul_registers", *_tile(plan))


def _tile(plan):
    return plan["bm"], plan["bn"], plan["tm"], plan["tn"], plan["ks"]


def _check(name, t, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the first input on "
                         f"{device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() < 1 or t.numel() > MAX_INT:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels take "
                         f"1 to {MAX_INT}")


def affine_probe(x: torch.Tensor) -> torch.Tensor:
    """x * 2 + 1 for a 2-D float32 tensor: the plain version on the CPU, P1
    on a CUDA tensor."""
    global affine_launches
    _check("x", x, x.device)
    if x.device.type == "cpu":
        return affine_probe_plain(x)
    out = torch.empty_like(x)
    fn, err, _ = _build.load(SOURCE, *_AFFINE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    raise_on(rc, err, "P1 (affine probe)")
    affine_launches += 1
    return out


def matmul_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for float32 a (M, K) and b (K, N): the plain version on the
    CPU, P2 on CUDA tensors."""
    _check("a", a, a.device)
    _check("b", b, a.device)
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2:
        raise ValueError(f"inner sizes differ: a is {tuple(a.shape)}, b is "
                         f"{tuple(b.shape)}")
    plan = matmul_plan(M, K, N)
    if M * N > MAX_INT or plan["grid"][1] > MAX_GRID_Y:
        raise ValueError(f"output ({M}, {N}) too large for P2's grid: "
                         f"{plan['grid'][1]} rows of {plan['bm']}-row tiles, "
                         f"at most {MAX_GRID_Y}")
    if a.device.type == "cpu":
        return matmul_probe_plain(a, b)
    return _matmul_launch(a, b, plan)


def _matmul_launch(a, b, plan):
    """Launch P2 on checked CUDA tensors with ``plan`` (``matmul_plan``'s;
    chip_plans.py and the card's tests take the other tiles)."""
    global matmul_launches
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    fn, err, _ = _build.load(SOURCE, *_MATMUL)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                *_tile(plan), plan["kc"], stream)
    raise_on(rc, err, "P2 (matmul probe)")
    matmul_launches += 1
    return out
