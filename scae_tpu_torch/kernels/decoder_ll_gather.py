"""Gather-form fused decoder log-likelihood, forward: the CUDA kernel K1
and its plain PyTorch version.

Replaces the Pallas kernel ``scae_tpu/ops/pallas_decoder_ll_gather.py``
(``_fwd_kernel``, launched by ``_fwd_call``). Argument contract of
``scae_tpu/ops/decoder_ll.py::fused_decoder_ll``: templates (B, M, C, Ht,
Wt), alpha logits (1 or B, M, 1, Ht, Wt), pose (B, M, 6) flat affines,
presence (B, M), then bg_value, bg_mixing_logit and scale as
post-nonlinearity scalars, target (B, C, H, W) and out_size (H, W).
Returns ``(ll, num, den)``: the per-pixel mixture log-likelihood (B, C,
H, W) and the two log-sum-exps it is the difference of, num (B, C, P) and
den (B, 1, P), kept for the backward.

``decoder_ll_gather`` runs the plain version for CPU tensors and the CUDA
kernel (``csrc/decoder_ll_gather.cu``) for CUDA tensors, where it raises
on anything the kernel does not take rather than falling back. See the
source for the kernel's bound on the H100 and how its design meets it.
"""

import ctypes
import functools
import math

import torch

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.ops.math_ops import log_safe
from scae_tpu_torch.ops.warp import source_coordinates

SOURCE = "decoder_ll_gather.cu"
MAX_CHANNELS = 4                 # the kernel is instantiated for C = 1..4
SMEM_LIMIT = 232448              # 227 KB: the most a block can have on Hopper
_MAX_GRID_Y = 65535
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

# Kernel launches since the counter was last set to 0. Only the CUDA path
# adds to it, once per launch; the plain version never does.
launches = 0


def decoder_ll_gather(templates, alpha, pose, presence, bg_value,
                      bg_mixing_logit, scale, target, out_size):
    """Per-pixel reconstruction mixture log-likelihood and its LSE terms.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if templates.device.type == "cpu":
        return decoder_ll_gather_plain(templates, alpha, pose, presence,
                                       bg_value, bg_mixing_logit, scale,
                                       target, out_size)
    return _launch(templates, alpha, pose, presence, bg_value,
                   bg_mixing_logit, scale, target, out_size)


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

    bg_value, bg_mix, scale = (_scalar_tensor(v, templates.device)
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


def _scalar_tensor(v, device):
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.reshape(())


def shared_memory_bytes(M, C, Ht, Wt) -> int:
    """Dynamic shared memory of one block: the capsule tables, poses and
    log-presences of one example."""
    return 4 * (M * (C + 1) * Ht * Wt + M * 7)


@functools.cache
def _library():
    """Build (at first use) and load the kernel's shared library."""
    built = _build.build(SOURCE)
    lib = ctypes.CDLL(built.path)
    fn = lib.scae_decoder_ll_gather_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.scae_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib, built


def build_info() -> _build.BuiltLibrary:
    """Build the kernel now if needed; the path, ``-Xptxas -v`` report and
    build seconds of its library."""
    return _library()[1]


def _launch(templates, alpha, pose, presence, bg_value, bg_mixing_logit,
            scale, target, out_size):
    global launches
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
    if B > _MAX_GRID_Y or M < 1 or P < 1:
        raise ValueError(f"unsupported sizes B={B}, M={M}, P={P}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t, _ in expected.values()):
        raise NotImplementedError(
            "the CUDA kernel has no backward yet: run it under "
            "torch.no_grad() or torch.inference_mode()")
    smem = shared_memory_bytes(M, C, Ht, Wt)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the capsule tables need {smem} bytes of shared "
                         f"memory, more than the {SMEM_LIMIT} a block has")
    scal = torch.stack([_scalar_tensor(v, device) for v in
                        (bg_value, bg_mixing_logit, scale)]).contiguous()

    ll = torch.empty((B, C, H, W), dtype=torch.float32, device=device)
    num = torch.empty((B, C, P), dtype=torch.float32, device=device)
    den = torch.empty((B, 1, P), dtype=torch.float32, device=device)
    lib, _ = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.scae_decoder_ll_gather_fwd(
            templates.data_ptr(), alpha.data_ptr(), pose.data_ptr(),
            presence.data_ptr(), target.data_ptr(), scal.data_ptr(),
            ll.data_ptr(), num.data_ptr(), den.data_ptr(),
            B, M, C, Ht, Wt, H, W, int(alpha.shape[0] != 1),
            stream)
    if rc != 0:
        raise RuntimeError("decoder_ll_gather kernel launch failed: "
                           f"{lib.scae_cuda_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    launches += 1
    return ll, num, den
