"""OCAE decoder: per-object-capsule votes + capsule likelihood (counterpart
of scae_tpu/models/object_decoder.py).

CapsuleLayer: two StackedMLP banks (one batched matmul per layer over the
O capsules), output split into OPR-dynamic / OVR / presences / scales,
cpr = transform(static + dynamic) with an l2 reg on the dynamic part,
vote = OVR @ OPR on the six affine coefficients, softplus vote scale;
a parent's transform and presence may replace the OVR and the capsule
presence. Everything after the second bank (the vote head) is the custom
op ``scae_tpu_torch::capsule_votes_fwd`` (``kernels/capsule_votes.py``:
the CUDA kernels V1f and V1b on the card, the plain version on the CPU);
a given parent transform or presence takes the plain version.
When not deterministic, capsule dropout and presence-logit noise draw from
an explicit ``torch.Generator``; the eval and serving path is
deterministic. capsule_likelihood: Gaussian vote pdf, dummy component at
log(0.01), posterior mixing, hard winner by argmax + gather, soft winner;
it is the custom op ``scae_tpu_torch::capsule_likelihood_fwd``
(``kernels/capsule_likelihood.py``: the CUDA kernels L1f and L1b on the
card, the plain version on the CPU).
Sparsity losses: l2, entropy and kl.

Under a mesh (``parallel/mesh.py``) the random draws are the global
batch's, the between-example sparsity terms take the column sum of the
global batch, and with its banks split over a model group
(``parallel/train_step.py::shard_state``) the layer runs its share of the
capsules and gathers their outputs before the first reduction over them.
"""

import math
from typing import Optional, Sequence

import torch
from torch import nn

from scae_tpu_torch.kernels import capsule_likelihood as capsule_likelihood_op
from scae_tpu_torch.kernels import capsule_votes
from scae_tpu_torch.models.layers import StackedMLP
from scae_tpu_torch.models.results import (
    CapsuleLayerResult,
    CapsuleLikelihoodResult,
    ObjectDecoderResult,
)
from scae_tpu_torch.ops.math_ops import (
    cross_entropy_safe,
    normalize,
)
from scae_tpu_torch.parallel import mesh

class CapsuleLayer(nn.Module):
    """Predicts per-object-capsule candidate part poses ("votes")."""

    def __init__(self, n_caps: int, dim_feature: int, n_votes: int,
                 dim_caps: int, hidden_sizes: Sequence[int] = (128,),
                 caps_dropout_rate: float = 0.0,
                 learn_vote_scale: bool = False,
                 allow_deformations: bool = True,
                 noise_type: Optional[str] = None, noise_scale: float = 0.0,
                 similarity_transform: bool = True,
                 n_transform_params: int = 6):
        super().__init__()
        O, V, P = n_caps, n_votes, n_transform_params
        self.n_caps = O
        self.n_votes = V
        self.n_transform_params = P
        self.caps_dropout_rate = caps_dropout_rate
        self.learn_vote_scale = learn_vote_scale
        self.allow_deformations = allow_deformations
        self.noise_type = noise_type
        self.noise_scale = noise_scale
        self.similarity_transform = similarity_transform
        self.output_shapes = (
            (V, P),   # OPR-dynamic
            (1, P),   # OVR
            (1,),     # per-object presence logit
            (V,),     # per-vote presence logit
            (V,),     # per-vote scale
        )
        self.splits = [math.prod(s) for s in self.output_shapes]
        hidden = list(hidden_sizes)
        self.mlps = StackedMLP(O, (dim_feature, *hidden, dim_caps))
        # bias-free bank so static and dynamic OP parts stay separable
        self.caps_mlps = StackedMLP(O, (dim_caps + 1, *hidden,
                                        sum(self.splits)), use_bias=False)
        self.cpr_static = nn.Parameter(torch.empty(1, O, V, P))
        for i, s in enumerate(self.output_shapes[1:]):
            self.register_parameter(f"caps_bias_{i}",
                                    nn.Parameter(torch.empty(1, O, *s)))

    def init_own_parameters(self, generator):
        with torch.no_grad():
            self.cpr_static.zero_()
            for i in range(len(self.output_shapes) - 1):
                getattr(self, f"caps_bias_{i}").zero_()

    def _own_capsules(self):
        """(lo, hi): the capsules whose banks this process holds, all O
        unless ``train_step.shard_state`` split them over a model group,
        whose mesh must then be active."""
        held = self.mlps.kernel_0.shape[0]
        if held == self.n_caps:
            return 0, held
        active = mesh.active()
        if active is None or active.n_model * held != self.n_caps:
            raise RuntimeError(
                f"the capsule banks hold {held} of {self.n_caps} capsules: "
                "run the layer under the mesh they were split over")
        return active.m * held, (active.m + 1) * held

    def forward(self, feature, parent_transform=None, parent_presence=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """feature: (B, O, F) object encodings. ``parent_transform``
        (B, O, 1, 3, 3), a homogeneous matrix, replaces the predicted OVR;
        ``parent_presence`` (B, O, 1) replaces the per-capsule presence
        (its logit, noise included, is still returned)."""
        B = feature.shape[0]
        O = self.n_caps
        lo, hi = self._own_capsules()
        if hi - lo < O:
            # the banks split over the model group: this rank's capsules
            feature = mesh.to_model_ranks(feature)[:, lo:hi]
        raw_caps_param = self.mlps(feature)                   # (B, O, D)

        caps_exist = None
        if self.caps_dropout_rate == 0.0:
            own_exist = torch.ones_like(raw_caps_param[..., :1])
        else:
            # drawn for the global batch under a mesh, this rank's rows kept
            keep = torch.full((mesh.global_rows(B), O, 1),
                              1.0 - self.caps_dropout_rate,
                              dtype=raw_caps_param.dtype,
                              device=raw_caps_param.device)
            caps_exist = mesh.local_rows(
                torch.bernoulli(keep, generator=generator))
            own_exist = caps_exist[:, lo:hi]
        caps_param = torch.cat([raw_caps_param, own_exist], dim=-1)
        all_param = self.caps_mlps(caps_param)               # (B, O, A)
        statics = [self.cpr_static] + [getattr(self, f"caps_bias_{i}")
                                       for i in range(4)]
        if hi - lo < O:
            # every capsule's outputs before the first reduction over them
            all_param, *statics = mesh.gather_capsules([all_param, *statics])
        cpr_static, caps_bias = statics[0], statics[1:]

        noise = (None, None)
        if not deterministic and self.noise_type:
            if self.noise_type not in ("uniform", "logistic"):
                raise ValueError(f"Invalid noise type: {self.noise_type}")
            # the capsule's then the votes' presence-logit noise, drawn for
            # the global batch under a mesh, this rank's rows kept
            noise = tuple(mesh.local_rows(torch.rand(
                (mesh.global_rows(B), O, n), generator=generator,
                dtype=all_param.dtype, device=all_param.device))
                for n in (1, self.n_votes))
        args = (all_param, cpr_static, *caps_bias, caps_exist, *noise,
                self.similarity_transform, self.allow_deformations,
                self.learn_vote_scale, self.noise_type, self.noise_scale)
        if parent_transform is None and parent_presence is None:
            out = capsule_votes.capsule_votes(*args)
        else:
            out = capsule_votes.capsule_votes_plain(
                *args, parent_transform=parent_transform,
                parent_presence=parent_presence)
        (vote, scale_per_vote, vote_presence, presence_logit_per_caps,
         presence_logit_per_vote, cpr_dynamic_reg_loss) = out

        return CapsuleLayerResult(
            vote=vote,
            scale=scale_per_vote,
            vote_presence=vote_presence,
            presence_logit_per_caps=presence_logit_per_caps,
            presence_logit_per_vote=presence_logit_per_vote,
            cpr_dynamic_reg_loss=cpr_dynamic_reg_loss,
        )


def capsule_likelihood(vote, scale, vote_presence, dummy_vote, x,
                       presence=None) -> CapsuleLikelihoodResult:
    """Capsule mixture likelihood + winner routing, through the op
    ``scae_tpu_torch::capsule_likelihood_fwd`` (the kernels L1f and L1b on
    the card, the plain version on the CPU).

    vote (B, O, M, P), scale (B, O, M), vote_presence (B, O, M),
    dummy_vote (1, 1, M, P), x (B, M, P) target part poses, presence
    (B, M) or None.
    """
    return CapsuleLikelihoodResult(*capsule_likelihood_op.capsule_likelihood(
        vote, scale, vote_presence, dummy_vote, x, presence))


class CapsuleObjectDecoder(nn.Module):
    """CapsuleLayer + capsule likelihood."""

    def __init__(self, capsule_layer: CapsuleLayer):
        super().__init__()
        self.capsule_layer = capsule_layer
        self.dummy_vote = nn.Parameter(torch.empty(
            1, 1, capsule_layer.n_votes, capsule_layer.n_transform_params))

    @property
    def n_obj_capsules(self) -> int:
        return self.capsule_layer.n_caps

    def init_own_parameters(self, generator):
        nn.init.zeros_(self.dummy_vote)

    def forward(self, obj_encoding, part_pose, part_presence=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """obj_encoding (B, O, F), part_pose (B, M, P), part_presence
        (B, M) or None."""
        B, O = obj_encoding.shape[:2]
        V = part_pose.shape[1]
        P = self.capsule_layer.n_transform_params
        res = self.capsule_layer(obj_encoding, deterministic=deterministic,
                                 generator=generator)
        vote_flat = res.vote[..., :-1, :].reshape(B, O, V, P)
        caps_presence = torch.amax(res.vote_presence, dim=-1)    # (B, O)
        ll = capsule_likelihood(vote_flat, res.scale, res.vote_presence,
                                self.dummy_vote, part_pose, part_presence)
        return ObjectDecoderResult(
            vote=vote_flat,
            scale=res.scale,
            vote_presence=res.vote_presence,
            presence_logit_per_caps=res.presence_logit_per_caps,
            presence_logit_per_vote=res.presence_logit_per_vote,
            cpr_dynamic_reg_loss=res.cpr_dynamic_reg_loss,
            caps_presence=caps_presence,
            log_prob=ll.log_prob,
            vote_presence_binary=ll.vote_presence_binary,
            winner=ll.winner,
            winner_presence=ll.winner_presence,
            soft_winner=ll.soft_winner,
            soft_winner_presence=ll.soft_winner_presence,
            posterior_mixing_prob=ll.posterior_mixing_prob,
            mixing_log_prob=ll.mixing_log_prob,
            mixing_logit=ll.mixing_logit,
            is_from_capsule=ll.is_from_capsule,
        )


# capsule-presence sparsity regularisers

def capsule_l2_loss(caps_presence, n_classes: int,
                    within_example_constant=None, **unused_kwargs):
    """Prior sparsity: l2(aggregated presence - constant)."""
    B, num_caps = caps_presence.shape
    if within_example_constant is None:
        within_example_constant = float(num_caps) / n_classes
    within = torch.mean(
        (torch.sum(caps_presence, 1) - within_example_constant) ** 2)
    # the column sum and the constant of the global batch under a mesh
    between = torch.mean(
        (mesh.batch_sum(torch.sum(caps_presence, 0))
         - float(mesh.global_rows(B)) / n_classes) ** 2)
    return within, between


def capsule_entropy_loss(caps_presence, k=1, **unused_kwargs):
    """Posterior sparsity: within / between normalised cross-entropy."""
    within_prob = normalize(caps_presence, 1)
    within = cross_entropy_safe(within_prob, within_prob * k)
    between_prob = normalize(mesh.batch_sum(torch.sum(caps_presence, 0)), 0)
    between = cross_entropy_safe(between_prob, between_prob * k)
    return within, -between


def neg_capsule_kl(caps_presence, **unused_kwargs):
    return capsule_entropy_loss(caps_presence, k=int(caps_presence.shape[-1]))


def sparsity_loss(loss_type, *args, **kwargs):
    if loss_type == "l2":
        return capsule_l2_loss(*args, **kwargs)
    if loss_type == "entropy":
        return capsule_entropy_loss(*args, **kwargs)
    if loss_type == "kl":
        return neg_capsule_kl(*args, **kwargs)
    raise ValueError(f"Invalid sparsity loss: {loss_type}")
