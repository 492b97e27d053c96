"""Input checks and launch helpers shared by the kernel wrappers.

Every decoder-likelihood kernel takes the argument contract of
``scae_tpu/ops/decoder_ll.py::fused_decoder_ll``; these helpers check it
on the host before a launch, pack the three scalars for the kernel, and
turn a launcher's error code into an exception.
"""

import torch

MAX_CHANNELS = 4                 # the kernels are instantiated for C = 1..4
SMEM_LIMIT = 232448              # 227 KB: the most a block can have on Hopper
MAX_GRID_Y = 65535


def scalar_tensor(v, device):
    """``v`` as a 0-d float32 tensor on ``device``; raises unless it holds
    one value."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
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
