"""Result containers, dataclasses of tensors (counterpart of
scae_tpu/models/results.py).

One difference in kind: ``PartDecoderResult`` computes its likelihood
(``target_ll``) and renders its components (``transformed_templates``,
``mixing_logits``, ``pdf``) on first access. Under ``jit`` the JAX package
never computes what its caller does not read: the eval step reads only
the likelihood, the infer function neither. Eager PyTorch has no
dead-code elimination: at the flagship size the dense warp behind the
components would materialise tap-weight tensors of hundreds of megabytes
for nothing, and every infer call would launch the likelihood kernel.
"""

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from scae_tpu_torch.ops.gmm import GaussianMixture


@dataclasses.dataclass
class PartEncoderResult:
    pose: torch.Tensor                  # (B, M, 6) constrained poses
    presence: torch.Tensor              # (B, M)
    feature: Optional[torch.Tensor]     # (B, M, S) or None


@dataclasses.dataclass
class TemplateResult:
    raw_templates: torch.Tensor         # (1, M, C, Ht, Wt)
    templates: torch.Tensor             # (B, M, C, Ht, Wt)


@dataclasses.dataclass
class PartDecoderResult:
    # the reconstruction target (B, C, H, W) given to the decoder, or None
    target: Optional[torch.Tensor] = dataclasses.field(repr=False)
    # () -> (transformed_templates (B, M+1, C, H, W),
    #        mixing_logits (B, M+1, 1 or C, H, W), pdf)
    render: Callable[[], Tuple[torch.Tensor, torch.Tensor, GaussianMixture]] \
        = dataclasses.field(repr=False)
    # () -> the fused likelihood of the target; None where it comes from pdf.
    # Neither closure may hold the result itself: a reference cycle would
    # keep every step's tensors alive until the cyclic garbage collector ran.
    fused_likelihood: Optional[Callable[[], torch.Tensor]] = \
        dataclasses.field(default=None, repr=False)

    @functools.cached_property
    def target_ll(self) -> Optional[torch.Tensor]:
        """Per-pixel mixture log-likelihood of the target (B, C, H, W), or
        None without a target."""
        if self.target is None:
            return None
        if self.fused_likelihood is not None:
            return self.fused_likelihood()
        return self.pdf.log_prob(self.target)

    @functools.cached_property
    def _rendered(self):
        return self.render()

    @property
    def transformed_templates(self) -> torch.Tensor:
        return self._rendered[0]

    @property
    def mixing_logits(self) -> torch.Tensor:
        return self._rendered[1]

    @property
    def pdf(self) -> GaussianMixture:
        return self._rendered[2]


@dataclasses.dataclass
class CapsuleLayerResult:
    vote: torch.Tensor                      # (B, O, V, 3, 3)
    scale: torch.Tensor                     # (B, O, V)
    vote_presence: torch.Tensor             # (B, O, V)
    presence_logit_per_caps: torch.Tensor   # (B, O, 1)
    presence_logit_per_vote: torch.Tensor   # (B, O, V)
    cpr_dynamic_reg_loss: torch.Tensor      # scalar


@dataclasses.dataclass
class CapsuleLikelihoodResult:
    log_prob: torch.Tensor                  # scalar
    vote_presence_binary: torch.Tensor      # (B, O, M)
    winner: torch.Tensor                    # (B, M, 6)
    winner_presence: torch.Tensor           # (B, M)
    soft_winner: torch.Tensor               # (B, M, 6)
    soft_winner_presence: torch.Tensor      # (B, M)
    posterior_mixing_prob: torch.Tensor     # (B, O, M)
    mixing_log_prob: torch.Tensor           # (B, O+1, M)
    mixing_logit: torch.Tensor              # (B, O+1, M)
    is_from_capsule: torch.Tensor           # (B, M)


@dataclasses.dataclass
class ObjectDecoderResult:
    # capsule-layer outputs (vote flattened to (B, O, V, 6))
    vote: torch.Tensor
    scale: torch.Tensor
    vote_presence: torch.Tensor
    presence_logit_per_caps: torch.Tensor
    presence_logit_per_vote: torch.Tensor
    cpr_dynamic_reg_loss: torch.Tensor
    caps_presence: torch.Tensor             # (B, O) = max over votes
    # likelihood outputs
    log_prob: torch.Tensor
    vote_presence_binary: torch.Tensor
    winner: torch.Tensor
    winner_presence: torch.Tensor
    soft_winner: torch.Tensor
    soft_winner_presence: torch.Tensor
    posterior_mixing_prob: torch.Tensor
    mixing_log_prob: torch.Tensor
    mixing_logit: torch.Tensor
    is_from_capsule: torch.Tensor


@dataclasses.dataclass
class SCAEResult:
    # part encoder
    part_pose: torch.Tensor
    part_presence: torch.Tensor
    part_feature: Optional[torch.Tensor]
    # templates
    templates: torch.Tensor
    template_presence: torch.Tensor
    raw_templates: torch.Tensor
    # object decoder + likelihood
    obj: ObjectDecoderResult
    # reconstruction
    rec: PartDecoderResult
    # classifiers
    prior_cls_prob: Optional[torch.Tensor] = None
    posterior_cls_prob: Optional[torch.Tensor] = None
    prior_cls_logit: Optional[torch.Tensor] = None
    posterior_cls_logit: Optional[torch.Tensor] = None

    @property
    def transformed_templates(self) -> torch.Tensor:
        return self.rec.transformed_templates
