"""SCAE composite model, 8-term loss and accuracy (counterpart of
scae_tpu/models/scae.py).

The forward mirrors the JAX module. With ``reconstruct_alternatives`` it
adds the three visualisation-only reconstructions (bottom-up, top-down and
the B*O-tiled per-capsule decode): part-decoder calls with no target, on
detached inputs, which render only when read and then under
``torch.no_grad``; with no target they never compute the likelihood, so
they launch no kernel. Stop-gradients become ``detach``; the classifier
heads run in exact f32 (``TorchLinear(precision="highest")``). The
``compat_*`` flags replicate the reference's defects as in the JAX
package.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scae_tpu_torch.models.layers import TorchLinear
from scae_tpu_torch.models.object_decoder import (
    CapsuleObjectDecoder,
    sparsity_loss,
)
from scae_tpu_torch.models.part_decoder import (
    TemplateBasedImageDecoder,
    TemplateGenerator,
)
from scae_tpu_torch.models.part_encoder import CapsuleImageEncoder
from scae_tpu_torch.models.results import SCAEResult
from scae_tpu_torch.models.set_transformer import SetTransformer
from scae_tpu_torch.parallel import mesh


class SCAE(nn.Module):
    """Stacked Capsule Auto-Encoder."""

    def __init__(self, part_encoder: CapsuleImageEncoder,
                 template_generator: TemplateGenerator,
                 part_decoder: TemplateBasedImageDecoder,
                 obj_encoder: SetTransformer,
                 obj_decoder: CapsuleObjectDecoder,
                 n_classes: Optional[int] = None,
                 vote_type: str = "soft",
                 presence_type: str = "enc",
                 stop_grad_caps_input: bool = True,
                 stop_grad_caps_target: bool = True,
                 recon_mse_weight: float = 0.0,
                 part_caps_sparsity_weight: float = 0.0,
                 cpr_dynamic_reg_weight: float = 0.0,
                 caps_ll_weight: float = 0.0,
                 prior_sparsity_loss_type: str = "l2",
                 prior_within_example_sparsity_weight: float = 0.0,
                 prior_between_example_sparsity_weight: float = 0.0,
                 prior_within_example_constant: Optional[float] = None,
                 posterior_sparsity_loss_type: str = "entropy",
                 posterior_within_example_sparsity_weight: float = 0.0,
                 posterior_between_example_sparsity_weight: float = 0.0,
                 reconstruct_alternatives: bool = False,
                 compat_posterior_cls_bug: bool = False,
                 compat_posterior_gate_bug: bool = False,
                 compat_double_softmax_xe: bool = False):
        super().__init__()
        if vote_type not in ("enc", "soft", "hard"):
            raise ValueError(f"Invalid vote_type: {vote_type}")
        if presence_type not in ("enc", "soft", "hard"):
            raise ValueError(f"Invalid presence_type: {presence_type}")
        self.part_encoder = part_encoder
        self.template_generator = template_generator
        self.part_decoder = part_decoder
        self.obj_encoder = obj_encoder
        self.obj_decoder = obj_decoder
        self.n_classes = n_classes
        self.vote_type = vote_type
        self.presence_type = presence_type
        self.stop_grad_caps_input = stop_grad_caps_input
        self.stop_grad_caps_target = stop_grad_caps_target
        self.recon_mse_weight = recon_mse_weight
        self.part_caps_sparsity_weight = part_caps_sparsity_weight
        self.cpr_dynamic_reg_weight = cpr_dynamic_reg_weight
        self.caps_ll_weight = caps_ll_weight
        self.prior_sparsity_loss_type = prior_sparsity_loss_type
        self.prior_within_example_sparsity_weight = \
            prior_within_example_sparsity_weight
        self.prior_between_example_sparsity_weight = \
            prior_between_example_sparsity_weight
        self.prior_within_example_constant = prior_within_example_constant
        self.posterior_sparsity_loss_type = posterior_sparsity_loss_type
        self.posterior_within_example_sparsity_weight = \
            posterior_within_example_sparsity_weight
        self.posterior_between_example_sparsity_weight = \
            posterior_between_example_sparsity_weight
        self.reconstruct_alternatives = reconstruct_alternatives
        self.compat_posterior_cls_bug = compat_posterior_cls_bug
        self.compat_posterior_gate_bug = compat_posterior_gate_bug
        self.compat_double_softmax_xe = compat_double_softmax_xe
        if n_classes is not None:
            n_obj = obj_decoder.n_obj_capsules
            self.prior_classifier = TorchLinear(n_obj, n_classes,
                                                precision="highest")
            self.posterior_classifier = TorchLinear(n_obj, n_classes,
                                                    precision="highest")

    def forward(self, image, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> SCAEResult:
        """image: (B, C, H, W) -> SCAEResult. ``generator`` feeds the
        noise of a non-deterministic forward."""
        B = image.shape[0]
        part_enc = self.part_encoder(image, deterministic=deterministic,
                                     generator=generator)
        template_res = self.template_generator(feature=part_enc.feature,
                                               batch_size=B)
        templates = template_res.templates

        # OCAE input
        input_part_param = torch.cat(
            [part_enc.pose, 1.0 - part_enc.presence[..., None]], dim=-1)
        input_presence = part_enc.presence
        input_templates = templates
        if self.stop_grad_caps_input:
            input_part_param = input_part_param.detach()
            input_presence = input_presence.detach()
            input_templates = input_templates.detach()
        if part_enc.feature is not None:
            input_part_param = torch.cat(
                [input_part_param, part_enc.feature], dim=-1)
        input_templates = input_templates.reshape(
            *input_templates.shape[:2], -1)
        parts_with_templates = torch.cat(
            [input_part_param, input_templates], dim=-1)

        obj_encoding = self.obj_encoder(parts_with_templates, input_presence)

        # OCAE decode
        target_pose, target_presence = part_enc.pose, part_enc.presence
        if self.stop_grad_caps_target:
            target_pose = target_pose.detach()
            target_presence = target_presence.detach()
        obj = self.obj_decoder(obj_encoding, target_pose, target_presence,
                               deterministic=deterministic,
                               generator=generator)

        # PCAE decode: the reconstruction target is always the input image
        part_dec_vote = {"enc": part_enc.pose, "soft": obj.soft_winner,
                         "hard": obj.winner}[self.vote_type]
        part_dec_presence = {"enc": part_enc.presence,
                             "soft": obj.soft_winner_presence,
                             "hard": obj.winner_presence}[self.presence_type]
        rec = self.part_decoder(templates=templates, pose=part_dec_vote,
                                presence=part_dec_presence, target=image)

        bottom_up_rec = top_down_rec = top_down_per_caps_rec = None
        if self.reconstruct_alternatives:
            templates_sg = templates.detach()
            presence_sg = part_enc.presence.detach()
            bottom_up_rec = self._decode_without_grad(
                templates_sg, part_enc.pose.detach(), presence_sg)
            top_down_rec = self._decode_without_grad(
                templates_sg, obj.winner.detach(), presence_sg)
            n_obj_caps = obj.vote.shape[1]
            td_pose = obj.vote.detach().reshape(-1, *obj.vote.shape[2:])
            td_enc_presence = presence_sg.repeat_interleave(n_obj_caps, 0)
            td_dec_presence = obj.vote_presence_binary.detach().reshape(
                -1, obj.vote_presence.shape[2])
            top_down_per_caps_rec = self._decode_without_grad(
                templates_sg.repeat_interleave(n_obj_caps, 0), td_pose,
                td_enc_presence * td_dec_presence)

        prior_prob = posterior_prob = prior_logits = posterior_logits = None
        if self.n_classes is not None:
            prior_logits = self.prior_classifier(obj.caps_presence.detach())
            prior_prob = torch.softmax(prior_logits, dim=-1)
            mass = torch.sum(obj.posterior_mixing_prob, dim=-1).detach()
            if self.compat_posterior_cls_bug:
                # reference defect: posterior probs from the PRIOR head
                posterior_logits = self.prior_classifier(mass)
            else:
                posterior_logits = self.posterior_classifier(mass)
            posterior_prob = torch.softmax(posterior_logits, dim=-1)

        return SCAEResult(
            part_pose=part_enc.pose,
            part_presence=part_enc.presence,
            part_feature=part_enc.feature,
            templates=templates,
            template_presence=part_enc.presence,
            raw_templates=template_res.raw_templates,
            obj=obj,
            rec=rec,
            bottom_up_rec=bottom_up_rec,
            top_down_rec=top_down_rec,
            top_down_per_caps_rec=top_down_per_caps_rec,
            prior_cls_prob=prior_prob,
            posterior_cls_prob=posterior_prob,
            prior_cls_logit=prior_logits,
            posterior_cls_logit=posterior_logits,
        )

    def _decode_without_grad(self, templates, pose, presence):
        """A part-decoder call with no target whose components render
        under ``torch.no_grad`` when first read."""
        rec = self.part_decoder(templates=templates, pose=pose,
                                presence=presence)
        rec.render = torch.no_grad()(rec.render)
        return rec

    def loss(self, res: SCAEResult, reconstruction_target, label=None):
        """Composite 8-term loss; returns (loss, log dict)."""
        log = {}
        B = reconstruction_target.shape[0]
        if res.rec.target_ll is not None:
            rec_ll_per_pixel = res.rec.target_ll
        else:
            rec_ll_per_pixel = res.rec.pdf.log_prob(reconstruction_target)
        rec_ll = torch.mean(torch.sum(rec_ll_per_pixel.reshape(B, -1),
                                      dim=-1))
        loss = -rec_ll
        log["rec_ll_loss"] = -rec_ll

        if self.recon_mse_weight > 0:
            mse_pp = (reconstruction_target - res.rec.pdf.mode()) ** 2
            mse = torch.mean(torch.sum(mse_pp.reshape(B, -1), dim=-1))
            loss = loss + self.recon_mse_weight * mse
            log["mse"] = mse

        if self.part_caps_sparsity_weight > 0:
            part_caps_l1 = torch.mean(torch.sum(res.part_presence, dim=-1))
            loss = loss + self.part_caps_sparsity_weight * part_caps_l1
            log["part_caps_loss"] = part_caps_l1

        loss = loss - self.caps_ll_weight * res.obj.log_prob
        log["log_prob_loss"] = -res.obj.log_prob

        if (self.prior_within_example_sparsity_weight > 0
                or self.prior_between_example_sparsity_weight > 0):
            prior_within, prior_between = sparsity_loss(
                self.prior_sparsity_loss_type, res.obj.caps_presence,
                n_classes=self.n_classes,
                within_example_constant=self.prior_within_example_constant)
            loss = loss + (self.prior_within_example_sparsity_weight
                           * prior_within
                           + self.prior_between_example_sparsity_weight
                           * prior_between)
            log["prior_within_sparsity_loss"] = prior_within
            log["prior_between_sparsity_loss"] = prior_between

        if self.compat_posterior_gate_bug:
            # reference defect: gated on the prior weights
            posterior_gate = (self.prior_within_example_sparsity_weight > 0
                              or self.prior_between_example_sparsity_weight
                              > 0)
        else:
            posterior_gate = (
                self.posterior_within_example_sparsity_weight > 0
                or self.posterior_between_example_sparsity_weight > 0)
        if posterior_gate:
            n_points = res.obj.posterior_mixing_prob.shape[-1]
            mass = torch.sum(res.obj.posterior_mixing_prob, dim=-1)
            post_within, post_between = sparsity_loss(
                self.posterior_sparsity_loss_type, mass / n_points,
                n_classes=self.n_classes)
            loss = loss + (self.posterior_within_example_sparsity_weight
                           * post_within
                           + self.posterior_between_example_sparsity_weight
                           * post_between)
            log["posterior_within_sparsity_loss"] = post_within
            log["posterior_between_sparsity_loss"] = post_between

        loss = loss + self.cpr_dynamic_reg_weight \
            * res.obj.cpr_dynamic_reg_loss
        log["cpr_dynamic_reg_loss"] = res.obj.cpr_dynamic_reg_loss

        if label is not None:
            if self.n_classes is None:
                raise ValueError("labels given to a model without classifiers")
            if self.compat_double_softmax_xe:
                # reference defect: cross-entropy on softmaxed probabilities
                prior_in, posterior_in = (res.prior_cls_prob,
                                          res.posterior_cls_prob)
            else:
                prior_in, posterior_in = (res.prior_cls_logit,
                                          res.posterior_cls_logit)
            prior_cls_xe = F.cross_entropy(prior_in, label)
            posterior_cls_xe = F.cross_entropy(posterior_in, label)
            loss = loss + prior_cls_xe + posterior_cls_xe
            log["prior_cls_xe"] = prior_cls_xe
            log["posterior_cls_xe"] = posterior_cls_xe

        return loss, log

    def calculate_accuracy(self, res: SCAEResult, label):
        """The better head's accuracy: the larger of the two heads' means
        (under a mesh, the global batch's means)."""
        prior_acc = torch.mean(
            (torch.argmax(res.prior_cls_prob, dim=-1) == label).float())
        posterior_acc = torch.mean(
            (torch.argmax(res.posterior_cls_prob, dim=-1) == label).float())
        if mesh.active() is not None:
            prior_acc, posterior_acc = mesh.batch_mean(
                torch.stack([prior_acc, posterior_acc])).unbind()
        return torch.maximum(prior_acc, posterior_acc)
