"""Attention-weighted pooling (counterpart of scae_tpu/ops/pooling.py).

Each of A capsules owns a contiguous channel group whose last channel is
an attention logit; a softmax over pixels of that logit weights the other
channels of the group, which are then summed over pixels. The explicit
forms take the attention logit as a map of its own, or as one channel of
the features. NCHW layout.
"""

import torch


def soft_attention(feature_map, attention_map):
    """Weight ``feature_map`` (B, C, H, W) by the softmax over pixels of
    ``attention_map`` (B, 1, H, W)."""
    B, C, H, W = feature_map.shape
    mask = torch.softmax(attention_map.reshape(B, 1, -1), dim=-1)
    return (feature_map.reshape(B, C, -1) * mask).reshape(B, C, H, W)


def multiple_soft_attention(feature_map, n_attention_map):
    """(B, C, H, W) with C = A * (k+1) -> (B, C - A, H, W)."""
    B, C, H, W = feature_map.shape
    A = n_attention_map
    if not (A > 0 and C > A and C % A == 0):
        raise ValueError("Incompatible attention map count")
    fm = feature_map.reshape(B, A, C // A, H * W)
    real, att = fm[:, :, :-1, :], fm[:, :, -1:, :]
    mask = torch.softmax(att, dim=-1)
    return (real * mask).reshape(B, C - A, H, W)


def multiple_attention_pooling_2d(feature_map, n_attention_map):
    """Attention-weighted global pooling: (B, C - A, 1, 1)."""
    x = multiple_soft_attention(feature_map, n_attention_map)
    B, C = x.shape[:2]
    return torch.sum(x.reshape(B, C, -1), dim=-1)[..., None, None]


def attention_pooling_2d_explicit(feature_map, attention_map):
    """Pool ``feature_map`` (B, C, H, W) by an explicit attention map
    (B, 1, H, W): (B, C, 1, 1)."""
    x = soft_attention(feature_map, attention_map)
    B, C = x.shape[:2]
    return torch.sum(x.reshape(B, C, -1), dim=-1)[..., None, None]


def attention_pooling_2d(feature_map, attention_channel_index):
    """Pool with channel ``attention_channel_index`` (taken modulo C) of
    ``feature_map`` as the attention logit: (B, C - 1, 1, 1)."""
    C = feature_map.shape[1]
    i = attention_channel_index % C
    real = torch.cat([feature_map[:, :i], feature_map[:, i + 1:]], dim=1)
    return attention_pooling_2d_explicit(real, feature_map[:, i:i + 1])
