"""Presence-masked Set Transformer, the OCAE encoder (counterpart of
scae_tpu/models/set_transformer.py).

MultiHeadQKVAttention pads head dims up to a multiple of n_heads, fuses
the projections that share an input (q, k, v in self-attention: one
``qkv_projector``; k, v otherwise: one ``kv_projector``) and subtracts the
presence mask (1e9) before the 1/sqrt(d_head) scaling. MAB is a residual
attention block with presence re-masking of aligned rows, optional
LayerNorm (eps 1e-5) and an ``h + relu(fc(h))`` feed-forward; SAB, ISAB
and PMA wrap it. SetTransformer is fc1 -> n_layers x SAB/ISAB -> fc2 ->
learned seeds -> a final multi-head attention.

Input widths are constructor arguments here (flax infers them at the
first call). Heads are a tensor axis contracted with einsums; with
``use_pallas`` (``use_pallas_attention`` on SetTransformer, which sets it on
every attention of the model) they fold into the batch, (B*H, N, d/H),
presence repeated per head, and go through ``qkv_attention(...,
use_pallas=True)``: the attention kernel K6 on CUDA tensors. The flag adds
no parameters.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scae_tpu_torch.models.layers import TorchLinear, uniform_, xavier_bound
from scae_tpu_torch.ops.attention import MASK, qkv_attention


class MultiHeadQKVAttention(nn.Module):
    """Multi-head attention with the mask-before-scale order.

    ``self_attention=True``: queries, keys and values are one tensor.
    Otherwise keys and values are one tensor and queries another.
    """

    def __init__(self, d_q_in: int, d_kv_in: int, d_k: int, d_v: int,
                 n_heads: int, self_attention: bool,
                 use_pallas: bool = False):
        super().__init__()
        H = n_heads
        self.n_heads = H
        self.use_pallas = use_pallas
        self.d_k_p = -(-d_k // H) * H        # padded to a multiple of heads
        self.d_v_p = -(-d_v // H) * H
        self.self_attention = self_attention
        if self_attention:
            self.qkv_projector = TorchLinear(d_q_in,
                                             2 * self.d_k_p + self.d_v_p)
        else:
            self.q_projector = TorchLinear(d_q_in, self.d_k_p)
            self.kv_projector = TorchLinear(d_kv_in, self.d_k_p + self.d_v_p)
        self.o_projector = TorchLinear(self.d_v_p, d_v)

    def forward(self, queries, keys, presence=None):
        H, dk, dv = self.n_heads, self.d_k_p, self.d_v_p
        if self.self_attention:
            qkv = self.qkv_projector(queries)
            q, k, v = qkv[..., :dk], qkv[..., dk:2 * dk], qkv[..., 2 * dk:]
        else:
            q = self.q_projector(queries)
            kv = self.kv_projector(keys)
            k, v = kv[..., :dk], kv[..., dk:]

        B, N, _ = q.shape
        M = k.shape[1]
        q = q.reshape(B, N, H, dk // H)
        k = k.reshape(B, M, H, dk // H)
        v = v.reshape(B, M, H, dv // H)
        if self.use_pallas:
            def fold(x):
                return x.transpose(1, 2).reshape(B * H, x.shape[1], -1)

            ph = None if presence is None else \
                presence.repeat_interleave(H, dim=0)
            oh = qkv_attention(fold(q), fold(k), fold(v), ph,
                               use_pallas=True)
            o = oh.reshape(B, H, N, dv // H).transpose(1, 2).reshape(B, N, dv)
        else:
            routing = torch.einsum("bnhd,bmhd->bhnm", q, k)
            if presence is not None:
                routing = routing - (1.0 - presence[:, None, None, :]) * MASK
            routing = torch.softmax(routing / math.sqrt(dk // H), dim=-1)
            o = torch.einsum("bhnm,bmhd->bnhd", routing, v).reshape(B, N, dv)
        return self.o_projector(o)


class MAB(nn.Module):
    """Multihead Attention Block: residual attention + rFF."""

    def __init__(self, d: int, n_heads: int, layer_norm: bool = False,
                 self_attention: bool = False, use_pallas: bool = False):
        super().__init__()
        self.mqkv = MultiHeadQKVAttention(d, d, d, d, n_heads,
                                          self_attention=self_attention,
                                          use_pallas=use_pallas)
        self.layer_norm = layer_norm
        if layer_norm:
            self.ln0 = nn.LayerNorm(d, eps=1e-5)
            self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.fc = TorchLinear(d, d)

    def forward(self, queries, keys, presence=None):
        h = self.mqkv(queries, keys, presence) + queries
        # the row re-mask applies only where presence rows align with the
        # queries (self-attention); the key mask above always applies
        if presence is not None and presence.shape[1] == queries.shape[1]:
            h = h * presence[..., None]
        if self.layer_norm:
            h = self.ln0(h)
        h = h + F.relu(self.fc(h))
        if self.layer_norm:
            h = self.ln1(h)
        return h


class SAB(nn.Module):
    def __init__(self, d: int, n_heads: int, layer_norm: bool = False,
                 use_pallas: bool = False):
        super().__init__()
        self.mab = MAB(d, n_heads, layer_norm, self_attention=True,
                       use_pallas=use_pallas)

    def forward(self, x, presence=None):
        return self.mab(x, x, presence)


class ISAB(nn.Module):
    """Induced SAB: O(N*m) attention through m inducing points."""

    def __init__(self, d: int, n_heads: int, n_inducing_points: int,
                 layer_norm: bool = False, use_pallas: bool = False):
        super().__init__()
        self.I = nn.Parameter(torch.empty(1, n_inducing_points, d))
        self.mab0 = MAB(d, n_heads, layer_norm, use_pallas=use_pallas)
        self.mab1 = MAB(d, n_heads, layer_norm, use_pallas=use_pallas)

    def init_own_parameters(self, generator):
        _, m, d = self.I.shape
        uniform_(self.I, xavier_bound(m * d, d), generator)

    def forward(self, x, presence=None):
        B = x.shape[0]
        h = self.mab0(self.I.expand(B, *self.I.shape[1:]), x, presence)
        return self.mab1(x, h)


class PMA(nn.Module):
    """Pooling by Multihead Attention over learned seed queries."""

    def __init__(self, d: int, n_heads: int, n_seeds: int,
                 layer_norm: bool = False, use_pallas: bool = False):
        super().__init__()
        self.S = nn.Parameter(torch.empty(1, n_seeds, d))
        self.mab = MAB(d, n_heads, layer_norm, use_pallas=use_pallas)

    def init_own_parameters(self, generator):
        _, k, d = self.S.shape
        uniform_(self.S, xavier_bound(k * d, d), generator)

    def forward(self, x, presence=None):
        B = x.shape[0]
        return self.mab(self.S.expand(B, *self.S.shape[1:]), x, presence)


class SetTransformer(nn.Module):
    """Permutation-invariant encoder: M part tokens -> O object encodings."""

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int,
                 n_outputs: int, n_layers: int, n_heads: int,
                 layer_norm: bool = False,
                 n_inducing_points: Optional[int] = None,
                 use_pallas_attention: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.fc1 = TorchLinear(dim_in, dim_hidden)
        for i in range(n_layers):
            if n_inducing_points is None:
                block = SAB(dim_hidden, n_heads, layer_norm,
                            use_pallas_attention)
            else:
                block = ISAB(dim_hidden, n_heads, n_inducing_points,
                             layer_norm, use_pallas_attention)
            self.add_module(f"sab_{i}", block)
        self.fc2 = TorchLinear(dim_hidden, dim_out)
        self.seeds = nn.Parameter(torch.empty(1, n_outputs, dim_out))
        self.multi_head_attention = MultiHeadQKVAttention(
            dim_out, dim_out, dim_out, dim_out, n_heads,
            self_attention=False, use_pallas=use_pallas_attention)

    @property
    def use_pallas_attention(self) -> bool:
        """Whether the attentions go through K6 (``qkv_attention(...,
        use_pallas=True)``); setting it sets every attention of the model,
        as the JAX package's testing-only flag does."""
        return self.multi_head_attention.use_pallas

    @use_pallas_attention.setter
    def use_pallas_attention(self, flag: bool):
        for module in self.modules():
            if isinstance(module, MultiHeadQKVAttention):
                module.use_pallas = bool(flag)

    def init_own_parameters(self, generator):
        # torch xavier on (1, n_outputs, dim_out): fan_in = n_outputs *
        # dim_out, fan_out = dim_out
        _, n, d = self.seeds.shape
        uniform_(self.seeds, xavier_bound(n * d, d), generator)

    def forward(self, x, presence=None):
        B = x.shape[0]
        h = self.fc1(x)
        for i in range(self.n_layers):
            h = getattr(self, f"sab_{i}")(h, presence)
        z = self.fc2(h)
        s = self.seeds.expand(B, *self.seeds.shape[1:])
        return self.multi_head_attention(s, z, presence)
