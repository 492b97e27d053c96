"""Presence-masked scaled dot-product attention (counterpart of
scae_tpu/ops/attention.py).

The presence mask is subtracted BEFORE the 1/sqrt(d_k) scaling, with a
penalty of 1e9, exactly as the JAX package does. ``use_pallas=True`` takes
the attention kernel's route (``kernels/attention.py``, K6, the port of
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
    ``use_pallas``: through ``AttentionFunction`` (K6 on CUDA tensors),
    with presence ones where none is given.
    """
    if use_pallas:
        if presence is None:
            presence = torch.ones(keys.shape[:2], dtype=queries.dtype,
                                  device=queries.device)
        return AttentionFunction.apply(queries, keys, values, presence)
    return qkv_attention_plain(queries, keys, values, presence)


def qkv_attention_plain(queries, keys, values, presence=None):
    """The plain path (JAX ``_qkv_attention_jnp``); K6's plain version."""
    d_k = queries.shape[-1]
    routing = torch.einsum("bnd,bmd->bnm", queries, keys)
    if presence is not None:
        routing = routing - (1.0 - presence[..., None, :]) * MASK
    routing = torch.softmax(routing / math.sqrt(d_k), dim=-1)
    return torch.einsum("bnm,bmv->bnv", routing, values)


class AttentionFunction(torch.autograd.Function):
    """The forward is K6's op, ``scae_tpu_torch::attention_fwd``: K6 for
    CUDA tensors, the plain path for CPU tensors, and a call by name in an
    exported program. The backward is the plain path's autograd, recomputed
    from the inputs (JAX ``_pallas_attn_bwd``), and launches no kernel."""

    @staticmethod
    def forward(ctx, queries, keys, values, presence):
        from scae_tpu_torch.kernels.attention import attention

        ctx.save_for_backward(queries, keys, values, presence)
        return attention(queries.contiguous(), keys.contiguous(),
                         values.contiguous(), presence.contiguous())

    @staticmethod
    def backward(ctx, g):
        inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = qkv_attention_plain(*inputs)
        grads = torch.autograd.grad(out, inputs, g)
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad))
