"""Numerically guarded math primitives (counterpart of scae_tpu/ops/math_ops.py).

log floor at -1e8 below eps=1e-16; normalize eps 1e-8; l2 = sum(x^2)/2;
relu1 = clip(x, 0, 1).
"""

import torch


def log_safe(x: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    """log(x) with values below ``eps`` mapped to -1e8 (never -inf/NaN).

    The masked-out branch takes log(1) = 0, so no NaN flows back through
    the zero branch under autograd.
    """
    is_small = x < eps
    safe_x = torch.where(is_small, torch.ones_like(x), x)
    return torch.where(is_small, torch.full_like(x, -1e8), torch.log(safe_x))


def cross_entropy_safe(true_probs, probs, dim: int = -1) -> torch.Tensor:
    """Mean over leading dims of -sum(true_probs * log_safe(probs), dim)."""
    return torch.mean(-torch.sum(true_probs * log_safe(probs), dim=dim))


def normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x / (sum(x, dim) + 1e-8), keeping dims."""
    return x / (torch.sum(x, dim=dim, keepdim=True) + 1e-8)


def l2_loss(x: torch.Tensor) -> torch.Tensor:
    """sum(x**2) / 2."""
    return torch.sum(x * x) / 2


def relu1(x: torch.Tensor) -> torch.Tensor:
    """Saturating ReLU in [0, 1]: relu6(6x)/6 == clip(x, 0, 1).

    Written with the binary ``maximum`` and ``minimum``, which split a tie
    evenly, so the gradient at exactly 0 and 1 is 0.5, as ``jnp.clip``'s
    is; ``torch.clamp``'s is 1 there."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)
