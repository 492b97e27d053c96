"""Model factory: the typed ModelConfig tree and ``make_scae``
(counterpart of scae_tpu/factory.py).

The config dataclasses, their defaults, the derived keys and the override
rules are copied from the JAX package (field names and default values
identical, derived keys computed by ``prepare_model_config`` and rejected
as overrides, unknown keys rejected). The flagship configuration is the
Python literal ``FLAGSHIP_MODEL_PARAMS``; no YAML is read.

``make_scae`` builds the torch modules, initialises every parameter from a
seeded ``torch.Generator`` on the CPU (so a seed gives the same weights on
every device) and moves the model to ``device``: CUDA unless the caller
passes another device.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from scae_tpu_torch.models.layers import init_parameters
from scae_tpu_torch.models.object_decoder import (
    CapsuleLayer,
    CapsuleObjectDecoder,
)
from scae_tpu_torch.models.part_decoder import (
    TemplateBasedImageDecoder,
    TemplateGenerator,
)
from scae_tpu_torch.models.part_encoder import CNNEncoder, CapsuleImageEncoder
from scae_tpu_torch.models.scae import SCAE
from scae_tpu_torch.models.set_transformer import SetTransformer
from scae_tpu_torch.utils.device import resolve_device

# The flagship: the paper-scale MNIST SCAE (1x40x40 images, M=40 part
# capsules, O=32 object capsules, 11x11 templates with an alpha channel),
# factory defaults otherwise.
FLAGSHIP_MODEL_PARAMS = dict(
    image_shape=(1, 40, 40),
    n_classes=10,
    n_part_caps=40,
    n_obj_caps=32,
    scae_params=dict(reconstruct_alternatives=False),
)


@dataclass
class CNNEncoderConfig:
    input_shape: Tuple[int, ...] = ()          # derived
    out_channels: Tuple[int, ...] = (128, 128, 128, 128)
    kernel_sizes: Tuple[int, ...] = (3, 3, 3, 3)
    strides: Tuple[int, ...] = (2, 2, 1, 1)
    activate_final: bool = True
    compute_dtype: Optional[str] = None

    _derived = ("input_shape",)


@dataclass
class PCAEEncoderConfig:
    input_shape: Tuple[int, ...] = ()          # derived
    n_caps: int = 0                            # derived (n_part_caps)
    n_poses: int = 6
    n_special_features: int = 16
    similarity_transform: bool = False
    noise_scale: float = 4.0

    _derived = ("input_shape", "n_caps")


@dataclass
class TemplateGeneratorConfig:
    n_templates: int = 0                       # derived (= n_part_caps)
    n_channels: int = 0                        # derived (image channels)
    dim_feature: int = 0                       # derived (special features)
    template_size: Tuple[int, int] = (11, 11)
    template_nonlin: str = "sigmoid"
    colorize_templates: bool = True
    color_nonlin: str = "sigmoid"

    _derived = ("n_templates", "n_channels", "dim_feature")


@dataclass
class PCAEDecoderConfig:
    n_templates: int = 0                       # derived
    template_size: Tuple[int, int] = (0, 0)    # derived
    output_size: Tuple[int, int] = (0, 0)      # derived
    learn_output_scale: bool = False
    use_alpha_channel: bool = True
    background_value: bool = True
    use_fused_ll: bool = True
    fused_tap_dtype: str = "float32"
    fused_impl: str = "auto"

    _derived = ("n_templates", "template_size", "output_size")


@dataclass
class SetTransformerConfig:
    dim_in: int = 0                            # derived (P+S+1+C*Ht*Wt)
    n_outputs: int = 0                         # derived (n_obj_caps)
    n_layers: int = 3
    n_heads: int = 1
    dim_hidden: int = 16
    dim_out: int = 256
    layer_norm: bool = True
    n_inducing_points: Optional[int] = None

    _derived = ("dim_in", "n_outputs")


@dataclass
class CapsuleLayerConfig:
    n_caps: int = 0                            # derived (n_obj_caps)
    dim_feature: int = 0                       # derived (st dim_out)
    n_votes: int = 0                           # derived (n_templates)
    dim_caps: int = 32
    hidden_sizes: Tuple[int, ...] = (128,)
    caps_dropout_rate: float = 0.0
    learn_vote_scale: bool = True
    allow_deformations: bool = True
    noise_type: Optional[str] = "uniform"
    noise_scale: float = 4.0
    similarity_transform: bool = False

    _derived = ("n_caps", "dim_feature", "n_votes")


@dataclass
class SCAEConfig:
    n_classes: Optional[int] = None            # derived
    vote_type: str = "enc"
    presence_type: str = "enc"
    stop_grad_caps_input: bool = True
    stop_grad_caps_target: bool = True
    recon_mse_weight: float = 0.0
    part_caps_sparsity_weight: float = 0.0
    caps_ll_weight: float = 1.0
    cpr_dynamic_reg_weight: float = 10.0
    prior_sparsity_loss_type: str = "l2"
    prior_within_example_sparsity_weight: float = 2.0
    prior_between_example_sparsity_weight: float = 0.35
    prior_within_example_constant: Optional[float] = None
    posterior_sparsity_loss_type: str = "entropy"
    posterior_within_example_sparsity_weight: float = 0.7
    posterior_between_example_sparsity_weight: float = 0.2
    reconstruct_alternatives: bool = True
    compat_posterior_cls_bug: bool = False
    compat_posterior_gate_bug: bool = False
    compat_double_softmax_xe: bool = False

    _derived = ("n_classes",)


@dataclass
class ModelConfig:
    image_shape: Tuple[int, ...]
    n_classes: Optional[int]
    n_part_caps: int
    n_obj_caps: int
    pcae_cnn_encoder: CNNEncoderConfig = field(
        default_factory=CNNEncoderConfig)
    pcae_encoder: PCAEEncoderConfig = field(
        default_factory=PCAEEncoderConfig)
    pcae_template_generator: TemplateGeneratorConfig = field(
        default_factory=TemplateGeneratorConfig)
    pcae_decoder: PCAEDecoderConfig = field(
        default_factory=PCAEDecoderConfig)
    ocae_encoder_set_transformer: SetTransformerConfig = field(
        default_factory=SetTransformerConfig)
    ocae_decoder_capsule: CapsuleLayerConfig = field(
        default_factory=CapsuleLayerConfig)
    scae: SCAEConfig = field(default_factory=SCAEConfig)


def _apply_overrides(cfg, overrides, where: str):
    """dataclasses.replace with derived-key and unknown-key rejection.

    Tuple-typed fields accept lists (YAML gives lists); values are
    otherwise taken verbatim — the reference's dict.update semantics.
    """
    if not overrides:
        return cfg
    overrides = dict(overrides)
    names = {f.name for f in dataclasses.fields(cfg)}
    for key, value in list(overrides.items()):
        if key in type(cfg)._derived:
            raise ValueError(
                f"{where}.{key} is derived and cannot be overridden")
        if key not in names:
            raise TypeError(f"unknown config key {where}.{key}")
        if isinstance(getattr(cfg, key), tuple) and isinstance(value, list):
            overrides[key] = tuple(value)
    return dataclasses.replace(cfg, **overrides)


def prepare_model_config(
        image_shape,
        n_classes,
        n_part_caps,
        n_obj_caps,
        pcae_cnn_encoder_params=None,
        pcae_encoder_params=None,
        pcae_template_generator_params=None,
        pcae_decoder_params=None,
        ocae_encoder_set_transformer_params=None,
        ocae_decoder_capsule_params=None,
        scae_params=None,
) -> ModelConfig:
    """User overrides onto the canonical defaults, derived keys computed
    across components (reference factory.py:10-149)."""
    image_shape = tuple(image_shape)

    cnn = _apply_overrides(CNNEncoderConfig(), pcae_cnn_encoder_params,
                           "pcae_cnn_encoder")
    cnn = dataclasses.replace(cnn, input_shape=image_shape)

    enc = _apply_overrides(PCAEEncoderConfig(), pcae_encoder_params,
                           "pcae_encoder")
    enc = dataclasses.replace(enc, input_shape=image_shape,
                              n_caps=n_part_caps)

    tg = _apply_overrides(TemplateGeneratorConfig(),
                          pcae_template_generator_params,
                          "pcae_template_generator")
    tg = dataclasses.replace(tg, n_templates=enc.n_caps,
                             n_channels=image_shape[0],
                             dim_feature=enc.n_special_features)

    dec = _apply_overrides(PCAEDecoderConfig(), pcae_decoder_params,
                           "pcae_decoder")
    dec = dataclasses.replace(dec, n_templates=tg.n_templates,
                              template_size=tg.template_size,
                              output_size=tuple(image_shape[1:]))

    # dim_in = P + S + 1 + C*Ht*Wt (reference :79-86; non-square fix)
    dim_in = (enc.n_poses + tg.dim_feature + 1
              + tg.n_channels * tg.template_size[0] * tg.template_size[1])
    st = _apply_overrides(SetTransformerConfig(),
                          ocae_encoder_set_transformer_params,
                          "ocae_encoder_set_transformer")
    st = dataclasses.replace(st, dim_in=dim_in, n_outputs=n_obj_caps)

    caps = _apply_overrides(CapsuleLayerConfig(),
                            ocae_decoder_capsule_params,
                            "ocae_decoder_capsule")
    caps = dataclasses.replace(caps, n_caps=st.n_outputs,
                               dim_feature=st.dim_out,
                               n_votes=dec.n_templates)

    scae = _apply_overrides(SCAEConfig(), scae_params, "scae")
    scae = dataclasses.replace(scae, n_classes=n_classes)

    return ModelConfig(
        image_shape=image_shape,
        n_classes=n_classes,
        n_part_caps=n_part_caps,
        n_obj_caps=n_obj_caps,
        pcae_cnn_encoder=cnn,
        pcae_encoder=enc,
        pcae_template_generator=tg,
        pcae_decoder=dec,
        ocae_encoder_set_transformer=st,
        ocae_decoder_capsule=caps,
        scae=scae,
    )


def prepare_model_params(**kwargs) -> dict:
    """Back-compat view: the typed tree as nested dicts (the reference's
    return convention, factory.py:135-149)."""
    return dataclasses.asdict(prepare_model_config(**kwargs))


def make_scae(model_params, device=None, seed: int = 0) -> SCAE:
    """Build the SCAE on ``device`` (CUDA unless given), its parameters
    drawn from ``torch.Generator().manual_seed(seed)``.

    Accepts the kwargs dict handed to ``prepare_model_config`` or a
    prebuilt ``ModelConfig``.
    """
    device = resolve_device(device)
    if isinstance(model_params, ModelConfig):
        cfg = model_params
    else:
        cfg = prepare_model_config(**dict(model_params))

    cnn = cfg.pcae_cnn_encoder
    cnn_encoder = CNNEncoder(
        input_shape=tuple(cnn.input_shape),
        out_channels=tuple(cnn.out_channels),
        kernel_sizes=tuple(cnn.kernel_sizes),
        strides=tuple(cnn.strides),
        activate_final=cnn.activate_final,
        compute_dtype=cnn.compute_dtype,
    )

    pe = cfg.pcae_encoder
    part_encoder = CapsuleImageEncoder(
        input_shape=tuple(pe.input_shape),
        encoder=cnn_encoder,
        n_caps=pe.n_caps,
        n_poses=pe.n_poses,
        n_special_features=pe.n_special_features,
        noise_scale=pe.noise_scale,
        similarity_transform=pe.similarity_transform,
    )

    tg = cfg.pcae_template_generator
    template_generator = TemplateGenerator(
        n_templates=tg.n_templates,
        n_channels=tg.n_channels,
        template_size=tuple(tg.template_size),
        template_nonlin=tg.template_nonlin,
        dim_feature=tg.dim_feature,
        colorize_templates=tg.colorize_templates,
        color_nonlin=tg.color_nonlin,
    )

    pd = cfg.pcae_decoder
    if pd.fused_tap_dtype != "float32":
        raise NotImplementedError(
            f"fused_tap_dtype={pd.fused_tap_dtype!r} is not ported: the "
            "port's likelihood (kernel K1) takes its taps in float32")
    part_decoder = TemplateBasedImageDecoder(
        n_templates=pd.n_templates,
        template_size=tuple(pd.template_size),
        output_size=tuple(pd.output_size),
        learn_output_scale=pd.learn_output_scale,
        use_alpha_channel=pd.use_alpha_channel,
        background_value=pd.background_value,
        use_fused_ll=pd.use_fused_ll,
        fused_impl=pd.fused_impl,
    )

    st = cfg.ocae_encoder_set_transformer
    obj_encoder = SetTransformer(
        dim_in=st.dim_in,
        dim_hidden=st.dim_hidden,
        dim_out=st.dim_out,
        n_outputs=st.n_outputs,
        n_layers=st.n_layers,
        n_heads=st.n_heads,
        layer_norm=st.layer_norm,
        n_inducing_points=st.n_inducing_points,
    )

    oc = cfg.ocae_decoder_capsule
    capsule_layer = CapsuleLayer(
        n_caps=oc.n_caps,
        dim_feature=oc.dim_feature,
        n_votes=oc.n_votes,
        dim_caps=oc.dim_caps,
        hidden_sizes=tuple(oc.hidden_sizes),
        caps_dropout_rate=oc.caps_dropout_rate,
        learn_vote_scale=oc.learn_vote_scale,
        allow_deformations=oc.allow_deformations,
        noise_type=oc.noise_type,
        noise_scale=oc.noise_scale,
        similarity_transform=oc.similarity_transform,
    )
    obj_decoder = CapsuleObjectDecoder(capsule_layer=capsule_layer)

    model = SCAE(
        part_encoder=part_encoder,
        template_generator=template_generator,
        part_decoder=part_decoder,
        obj_encoder=obj_encoder,
        obj_decoder=obj_decoder,
        **dataclasses.asdict(cfg.scae),
    )
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
