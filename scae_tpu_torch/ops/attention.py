"""Presence-masked scaled dot-product attention (counterpart of
scae_tpu/ops/attention.py, plain path ``_qkv_attention_jnp``).

The presence mask is subtracted BEFORE the 1/sqrt(d_k) scaling, with a
penalty of 1e9, exactly as the JAX package does. The JAX package's Pallas
attention kernel (``use_pallas=True``) is not ported yet.
"""

import math

import torch

MASK = 1e9


def qkv_attention(queries, keys, values, presence=None):
    """softmax((Q K^T - (1 - presence) * 1e9) / sqrt(d_k)) V.

    queries [B, N, d_k], keys [B, M, d_k], values [B, M, d_v], presence
    an optional [B, M] soft mask in [0, 1]. Returns [B, N, d_v].
    """
    d_k = queries.shape[-1]
    routing = torch.einsum("bnd,bmd->bnm", queries, keys)
    if presence is not None:
        routing = routing - (1.0 - presence[..., None, :]) * MASK
    routing = torch.softmax(routing / math.sqrt(d_k), dim=-1)
    return torch.einsum("bnm,bmv->bnv", routing, values)
