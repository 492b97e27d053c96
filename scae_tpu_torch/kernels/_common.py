"""Input checks and launch helpers shared by the kernel wrappers.

Every decoder-likelihood kernel takes the argument contract of
``scae_tpu/ops/decoder_ll.py::fused_decoder_ll``; these helpers check it
on the host before a launch, pack the three scalars for the kernel, pass
it the plain version's output grid, and turn a launcher's error code into
an exception. The three run-scatter backwards (K2+K3, K4b, K5b) share a
block layout and a key rule, given here for their planners and tests.
"""

import torch

from scae_tpu_torch.ops.math_ops import as_scalar
from scae_tpu_torch.ops.warp import _base_grid, source_coordinates

MAX_CHANNELS = 4                 # the kernels are instantiated for C = 1..4
SMEM_LIMIT = 232448              # 227 KB: the most a block can have on Hopper
MAX_GRID_Y = 65535
RUN_SCATTER_WARPS = 4            # warps of a run-scatter backward block


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
