"""Presence-masked scaled dot-product attention (counterpart of
scae_tpu/ops/attention.py).

The presence mask is subtracted BEFORE the 1/sqrt(d_k) scaling, with a
penalty of 1e9, exactly as the JAX package does. ``use_pallas=True`` takes
the attention kernel's route, the op ``scae_tpu_torch::attention_fwd``
(``kernels/attention.py``, K6, the port of
``scae_tpu/ops/pallas_attention.py``): K6 forward on CUDA tensors, the
plain path on CPU tensors, and on either device a backward that recomputes
the plain path, as the JAX package's custom VJP does (it has no backward
kernel).
"""

import math

import torch

MASK = 1e9


def qkv_attention(queries, keys, values, presence=None, use_pallas=False):
    """softmax((Q K^T - (1 - presence) * 1e9) / sqrt(d_k)) V.

    queries [B, N, d_k], keys [B, M, d_k], values [B, M, d_v], presence
    an optional [B, M] soft mask in [0, 1]. Returns [B, N, d_v].
    ``use_pallas``: through K6's op (K6 on CUDA tensors), with presence
    ones where none is given.
    """
    if use_pallas:
        from scae_tpu_torch.kernels.attention import attention

        if presence is None:
            presence = torch.ones(keys.shape[:2], dtype=queries.dtype,
                                  device=queries.device)
        return attention(queries.contiguous(), keys.contiguous(),
                         values.contiguous(), presence.contiguous())
    return qkv_attention_plain(queries, keys, values, presence)


def qkv_attention_plain(queries, keys, values, presence=None):
    """The plain path (JAX ``_qkv_attention_jnp``); K6's plain version."""
    d_k = queries.shape[-1]
    routing = torch.einsum("bnd,bmd->bnm", queries, keys)
    if presence is not None:
        routing = routing - (1.0 - presence[..., None, :]) * MASK
    routing = torch.softmax(routing / math.sqrt(d_k), dim=-1)
    return torch.einsum("bnm,bmv->bnv", routing, values)

