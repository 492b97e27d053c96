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

``attention`` launches K6 (``csrc/attention.cu``) for CUDA tensors, and
raises on anything the kernel does not take; for CPU tensors it runs the
plain version. K6 has no atomics: its results repeat bit for bit.
"""

import torch

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.kernels._common import check_smem, raise_on
from scae_tpu_torch.ops.attention import qkv_attention_plain

SOURCE = "attention.cu"
_SIGNATURE = ("scae_attention_fwd", 5, 5)

# K6 launches since the counter was last set to 0; only the CUDA path adds.
launches = 0


def attention(queries, keys, values, presence):
    """(B, N, d_v): the plain version for CPU tensors, K6 for CUDA ones."""
    if queries.device.type == "cpu":
        return attention_plain(queries, keys, values, presence)
    return _launch(queries, keys, values, presence)


# K6's function in plain PyTorch: ``ops/attention.py``'s plain path
attention_plain = qkv_attention_plain


def shared_memory_bytes(N, M, d_k, d_v) -> int:
    """Dynamic shared memory of one K6 block: Q and K with rows padded by
    one float (no bank conflicts in the score loop), V, the presence row
    and the N x M attention weights."""
    return 4 * ((N + M) * (d_k + 1) + M * d_v + M + N * M)


def build_info() -> _build.BuiltLibrary:
    """Build K6 now if needed; the path, ``-Xptxas -v`` report and build
    seconds of its library."""
    return _build.load(SOURCE, *_SIGNATURE)[2]


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
    check_smem(shared_memory_bytes(N, M, d_k, d_v),
               "K6's staged Q, K, V and attention weights")
    return B, N, M, d_k, d_v


def _launch(queries, keys, values, presence):
    """Launch K6 on CUDA tensors."""
    global launches
    B, N, M, d_k, d_v = _check(queries, keys, values, presence)
    out = torch.empty((B, N, d_v), dtype=torch.float32, device=queries.device)
    fn, err, _ = _build.load(SOURCE, *_SIGNATURE)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        rc = fn(queries.data_ptr(), keys.data_ptr(), values.data_ptr(),
                presence.data_ptr(), out.data_ptr(), B, N, M, d_k, d_v,
                stream)
    raise_on(rc, err, "attention")
    launches += 1
    return out
