"""PCAE decoder: learned templates + affine warp -> pixel Gaussian mixture
(counterpart of scae_tpu/models/part_decoder.py).

TemplateGenerator: template logits (1, M, C, Ht, Wt) from a QR-orthogonal
min-max-normalised init, optional per-capsule colour MLP [F, 32, C] with
the +0.99 pre-shift for relu1.

TemplateBasedImageDecoder: M warped templates plus a background component,
alpha-channel or temperature mixing logits, presence folded into the
mixing logits through log_safe, scalar output scale. With a target, the
per-pixel log-likelihood comes from the fused path, by ``fused_impl``:

  * "gather", and "auto" where the template has at most ``TBL_MAX``
    texels (``gather_supports``, as the reference's auto picks): the
    gather likelihood (``kernels/decoder_ll_gather.py``): for CUDA tensors
    its autograd Function, K1 forward and K2+K3 backward; for CPU tensors
    its plain version, which autograd differentiates;
  * "pallas": the dense likelihood (``kernels/decoder_ll_dense.py``): K4f
    forward and K4b backward for CUDA tensors, the plain version
    (``ops/decoder_ll.py`` with float32 taps and its hand-derived
    backward) for CPU tensors;
  * "pallas_banded": the banded, row-windowed likelihood
    (``kernels/decoder_ll_banded.py``): the capsules padded and sorted, K5f
    forward and K5b backward for CUDA tensors, the plain version (the dense
    one with the y-taps masked by the row windows) for CPU tensors;
  * "xla", and "auto" above ``TBL_MAX`` texels:
    ``ops/decoder_ll.py::fused_decoder_ll`` with ``fused_tap_dtype`` taps,
    on any device.

The likelihood, like the rendered components, is computed when it is
first read, so a forward whose caller never reads it (the infer function)
launches no kernel.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scae_tpu_torch.kernels.decoder_ll_banded import decoder_ll_banded
from scae_tpu_torch.kernels.decoder_ll_dense import decoder_ll_dense
from scae_tpu_torch.kernels.decoder_ll_gather import decoder_ll_gather
from scae_tpu_torch.models.layers import MLP, choose_activation
from scae_tpu_torch.models.results import PartDecoderResult, TemplateResult
from scae_tpu_torch.ops.decoder_ll import fused_decoder_ll
from scae_tpu_torch.ops.gmm import GaussianMixture
from scae_tpu_torch.ops.math_ops import log_safe
from scae_tpu_torch.ops.warp import affine_warp

# the most texels a template may have for "auto" to take the gather route:
# the reference's gather kernel holds a template in two 128-lane vector
# registers (scae_tpu/ops/pallas_decoder_ll_gather.py, TBL_MAX), and its
# auto takes "xla" above that
TBL_MAX = 256


def gather_supports(template_size) -> bool:
    """Whether "auto" takes the gather route for templates of this size."""
    return template_size[0] * template_size[1] <= TBL_MAX


def qr_template_init(n_templates, n_channels, template_size, generator):
    """QR-orthogonal template init: (1, M, C, Ht, Wt) in [0, 1]."""
    shape = (1, n_templates, n_channels, *template_size)
    n_elems = n_channels * template_size[0] * template_size[1]
    n = max(n_templates, n_elems)
    q = torch.rand((n, n), generator=generator, dtype=torch.float32)
    q = torch.linalg.qr(q)[0]
    q = q[:n_templates, :n_elems].reshape(shape)
    return (q - q.min()) / (q.max() - q.min())


class TemplateGenerator(nn.Module):
    """Learns M part templates; optionally colourises them per input."""

    def __init__(self, n_templates: int, n_channels: int,
                 template_size: Tuple[int, int],
                 template_nonlin: str = "relu1",
                 dim_feature: Optional[int] = None,
                 colorize_templates: bool = False,
                 color_nonlin: str = "relu1"):
        super().__init__()
        self.n_templates = n_templates
        self.n_channels = n_channels
        self.template_size = tuple(template_size)
        self.template_nonlin_name = template_nonlin
        self.template_nonlin = choose_activation(template_nonlin)
        self.colorize_templates = colorize_templates
        self.color_nonlin_name = color_nonlin
        self.color_nonlin = choose_activation(color_nonlin)
        self.template_logits = nn.Parameter(
            torch.empty(1, n_templates, n_channels, *self.template_size))
        if colorize_templates:
            self.templates_color_mlp = MLP((dim_feature, 32, n_channels))

    def init_own_parameters(self, generator):
        with torch.no_grad():
            self.template_logits.copy_(qr_template_init(
                self.n_templates, self.n_channels, self.template_size,
                generator))

    def forward(self, feature=None, batch_size=None):
        if feature is not None:
            batch_size = feature.shape[0]
        raw_templates = self.template_nonlin(self.template_logits)

        if self.colorize_templates and feature is not None:
            template_color = self.templates_color_mlp(feature)  # (B, M, C)
            if self.color_nonlin_name == "relu1":
                template_color = template_color + 0.99
            template_color = self.color_nonlin(template_color)
            templates = raw_templates * template_color[:, :, :, None, None]
        else:
            templates = raw_templates.expand(batch_size,
                                             *raw_templates.shape[1:])
        return TemplateResult(raw_templates=raw_templates,
                              templates=templates)


class TemplateBasedImageDecoder(nn.Module):
    """Renders part capsules to an image as a per-pixel Gaussian mixture."""

    def __init__(self, n_templates: int, template_size: Tuple[int, int],
                 output_size: Tuple[int, int],
                 learn_output_scale: bool = False,
                 use_alpha_channel: bool = False,
                 background_value: bool = True,
                 use_fused_ll: bool = True,
                 fused_impl: str = "auto",
                 fused_tap_dtype: str = "float32"):
        super().__init__()
        if fused_impl not in ("auto", "gather", "pallas", "pallas_banded",
                              "xla"):
            raise ValueError(f"unknown fused_impl {fused_impl!r}")
        if fused_tap_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown fused_tap_dtype {fused_tap_dtype!r}")
        self.n_templates = n_templates
        self.template_size = tuple(template_size)
        self.output_size = tuple(output_size)
        self.learn_output_scale = learn_output_scale
        self.use_alpha_channel = use_alpha_channel
        self.use_fused_ll = use_fused_ll
        self.fused_impl = fused_impl
        self.fused_tap_dtype = getattr(torch, fused_tap_dtype)
        M = n_templates
        self.bg_value = nn.Parameter(torch.empty(1))
        if use_alpha_channel:
            self.templates_alpha = nn.Parameter(
                torch.empty(1, M, 1, *self.template_size))
            self.bg_mixing_logit = nn.Parameter(torch.empty(1))
        else:
            self.temperature_logit = nn.Parameter(torch.empty(1))
        if learn_output_scale:
            self.scale = nn.Parameter(torch.empty(1))

    def init_own_parameters(self, generator):
        nn.init.zeros_(self.bg_value)
        with torch.no_grad():
            if self.use_alpha_channel:
                self.templates_alpha.zero_()
                self.bg_mixing_logit.zero_()
            else:  # torch init: temperature_logit ~ U[0, 1)
                self.temperature_logit.uniform_(0.0, 1.0,
                                                generator=generator)
            if self.learn_output_scale:
                self.scale.uniform_(0.0, 1.0, generator=generator)

    def _scale(self, like):
        if self.learn_output_scale:
            return F.softplus(self.scale) + 1e-4
        return torch.ones(1, dtype=like.dtype, device=like.device)

    def forward(self, templates, pose, presence=None, bg_image=None,
                target=None):
        """templates (B, M, C, Ht, Wt), pose (B, M, 6) flat affines,
        presence (B, M) or None, bg_image (B, C, H, W) or None, target
        (B, C, H, W) or None. Returns a PartDecoderResult with M+1 mixture
        components, background last."""
        B, M, C, Ht, Wt = templates.shape
        H, W = self.output_size
        scale = self._scale(templates)

        def render():
            if bg_image is not None:
                bg = bg_image[:, None]
            else:
                bg = torch.sigmoid(self.bg_value)[0].expand(B, 1, C, H, W)
            transformed = torch.cat(
                [affine_warp(templates, pose, (H, W)), bg], dim=1)

            if self.use_alpha_channel:
                alpha_logits = affine_warp(
                    self.templates_alpha.expand(B, M, 1, Ht, Wt), pose,
                    (H, W))
                bg_logit = F.softplus(self.bg_mixing_logit)[0].expand(
                    B, 1, 1, H, W)
                mixing = torch.cat([alpha_logits, bg_logit], dim=1)
            else:
                temperature = F.softplus(self.temperature_logit + 0.5) + 1e-4
                mixing = transformed / temperature

            if presence is not None:
                full_presence = torch.cat(
                    [presence, torch.ones_like(presence[:, :1])], dim=1)
                mixing = mixing + log_safe(full_presence).reshape(
                    B, M + 1, *(1,) * (mixing.dim() - 2))
            pdf = GaussianMixture.make_from_stats(
                loc=transformed, scale=scale, mixing_logits=mixing)
            return transformed, mixing, pdf

        def fused_likelihood():
            full_presence = presence if presence is not None else \
                torch.ones((B, M), dtype=templates.dtype,
                           device=templates.device)
            args = (templates.contiguous(), self.templates_alpha,
                    pose.contiguous(), full_presence.contiguous(),
                    torch.sigmoid(self.bg_value)[0],
                    F.softplus(self.bg_mixing_logit)[0], scale,
                    target.contiguous(), self.output_size)
            impl = self.fused_impl
            if impl == "auto":
                impl = "gather" if gather_supports((Ht, Wt)) else "xla"
            if impl == "xla":
                return fused_decoder_ll(*args, self.fused_tap_dtype)
            if impl == "pallas":
                return decoder_ll_dense(*args)[0]
            if impl == "pallas_banded":
                return decoder_ll_banded(*args)[0]
            return decoder_ll_gather(*args)[0]

        fused = (target is not None and self.use_fused_ll
                 and self.use_alpha_channel and bg_image is None)
        return PartDecoderResult(
            target=target, render=render,
            fused_likelihood=fused_likelihood if fused else None)
