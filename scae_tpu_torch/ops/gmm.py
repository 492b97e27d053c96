"""Pixel-wise Gaussian mixture over template components (counterpart of
scae_tpu/ops/gmm.py).

log_prob = LSE over components of the Normal log-density plus the mixing
log-probability; mean = softmax-weighted component means; mode = the
argmax component's mean, with an optional straight-through gradient.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F

from scae_tpu_torch.ops.math_ops import as_scalar

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def normal_log_prob(x, loc, scale):
    """Element-wise Normal(loc, scale) log-density."""
    scale = as_scalar(scale, loc.dtype, loc.device)
    return -((x - loc) ** 2) / (2.0 * scale * scale) - torch.log(scale) \
        - _LOG_SQRT_2PI


@dataclasses.dataclass
class GaussianMixture:
    """Mixture of Gaussians with the component axis at dim 1: [B, K, ...]."""

    loc: torch.Tensor            # [B, K, ...] component means
    scale: torch.Tensor          # broadcastable to loc
    mixing_logits: torch.Tensor  # [B, K, ...]

    @property
    def n_components(self) -> int:
        return self.mixing_logits.shape[1]

    def mixing_log_prob(self):
        return F.log_softmax(self.mixing_logits, dim=1)

    def mean(self):
        return torch.sum(F.softmax(self.mixing_logits, dim=1) * self.loc,
                         dim=1)

    def log_prob(self, x):
        """x: [B, ...] -> per-element mixture log-density [B, ...]."""
        lp = normal_log_prob(x[:, None], self.loc, self.scale)
        return torch.logsumexp(lp + self.mixing_log_prob(), dim=1)

    def mode(self, straight_through_gradient: bool = False,
             maximum: bool = False):
        """The argmax component's value per element."""
        mixing_log_prob = self.mixing_log_prob()
        if maximum:
            mixing_log_prob = mixing_log_prob + normal_log_prob(
                self.loc, self.loc, self.scale)
        idx = torch.argmax(mixing_log_prob, dim=1, keepdim=True)
        mask = torch.zeros_like(mixing_log_prob).scatter_(1, idx, 1.0)
        if straight_through_gradient:
            soft = F.softmax(mixing_log_prob, dim=1)
            mask = (mask - soft).detach() + soft
        return torch.sum(mask * self.loc, dim=1)

    @classmethod
    def make_from_stats(cls, loc, scale, mixing_logits):
        return cls(loc=loc,
                   scale=as_scalar(scale, loc.dtype, loc.device),
                   mixing_logits=mixing_logits)
