"""PCAE encoder: image -> part capsules (counterpart of
scae_tpu/models/part_encoder.py).

Valid-padded conv stack, learned additive bias on the embedding, 1x1 conv
to M*(P+1+S+1) channels, per-capsule attention pooling, split into pose /
presence logit / features, optional uniform presence-logit noise
(rand - 0.5) * noise_scale when not deterministic, sigmoid presence and
``geometric_transform`` on the pose.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from scae_tpu_torch.models.layers import Conv2dStack, TorchConv2d
from scae_tpu_torch.models.results import PartEncoderResult
from scae_tpu_torch.ops.geometry import geometric_transform
from scae_tpu_torch.ops.pooling import multiple_attention_pooling_2d
from scae_tpu_torch.parallel import mesh
from scae_tpu_torch.utils.shapes import conv_output_size


class CNNEncoder(nn.Module):
    """Stack of valid-padded convs; NCHW in and out."""

    def __init__(self, input_shape: Tuple[int, int, int],
                 out_channels: Sequence[int], kernel_sizes: Sequence[int],
                 strides: Sequence[int], activate_final: bool = True,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.out_channels = tuple(out_channels)
        self.kernel_sizes = tuple(kernel_sizes)
        self.strides = tuple(strides)
        self.network = Conv2dStack(
            input_shape[0], out_channels, kernel_sizes, strides,
            activate_final=activate_final, compute_dtype=compute_dtype)

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        _, h, w = self.input_shape
        for k, s in zip(self.kernel_sizes, self.strides):
            h = conv_output_size(h, k, s)
            w = conv_output_size(w, k, s)
        return (self.out_channels[-1], h, w)

    def forward(self, image):
        return self.network(image)


class CapsuleImageEncoder(nn.Module):
    """Image -> M part capsules with 6-d pose, presence and S features."""

    def __init__(self, input_shape: Tuple[int, int, int],
                 encoder: CNNEncoder, n_caps: int, n_poses: int = 6,
                 n_special_features: int = 16, noise_scale: float = 4.0,
                 similarity_transform: bool = False):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.encoder = encoder
        self.n_caps = n_caps
        self.n_poses = n_poses
        self.n_special_features = n_special_features
        self.noise_scale = noise_scale
        self.similarity_transform = similarity_transform
        out_shape = encoder.output_shape
        if min(out_shape) < 1:
            raise ValueError(f"image {input_shape} is too small for the "
                             f"encoder (output {out_shape})")
        self.img_embedding_bias = nn.Parameter(torch.empty(out_shape))
        n_dims = n_poses + 1 + n_special_features
        self.att_conv = TorchConv2d(out_shape[0], n_caps * (n_dims + 1),
                                    kernel_size=1)

    def init_own_parameters(self, generator):
        nn.init.zeros_(self.img_embedding_bias)

    def forward(self, image, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        B = image.shape[0]
        M, P, S = self.n_caps, self.n_poses, self.n_special_features
        n_dims = P + 1 + S

        h = self.encoder(image) + self.img_embedding_bias[None]
        h = self.att_conv(h)                          # (B, M*(n_dims+1), G, G)
        h = multiple_attention_pooling_2d(h, M)       # (B, M*n_dims, 1, 1)
        h = h.reshape(B, M, n_dims)

        pose = h[..., :P]
        presence_logit = h[..., P]
        feature = h[..., P + 1:] if S > 0 else None

        if not deterministic and self.noise_scale > 0.0:
            # drawn for the global batch under a mesh, this rank's rows kept
            noise = mesh.local_rows(torch.rand(
                (mesh.global_rows(B), M), generator=generator,
                dtype=presence_logit.dtype,
                device=presence_logit.device)) - 0.5
            presence_logit = presence_logit + noise * self.noise_scale

        presence = torch.sigmoid(presence_logit)
        pose = geometric_transform(pose, self.similarity_transform)
        return PartEncoderResult(pose=pose, presence=presence,
                                 feature=feature)
