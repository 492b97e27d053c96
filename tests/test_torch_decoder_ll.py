"""K1's plain PyTorch version (scae_tpu_torch/kernels/decoder_ll_gather.py)
against scae_tpu: the XLA-path ``fused_decoder_ll`` with f32 taps, and the
Pallas gather kernel ``pallas_decoder_ll_gather`` run in interpret mode on
the CPU, as tests/test_pallas_decoder_impls.py runs it.

Tolerance 1e-5 absolute on the per-pixel log-likelihood, whose values are
of order 1-10: both references compute the same f32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu.ops.decoder_ll import fused_decoder_ll as j_fused
from scae_tpu.ops.geometry import geometric_transform
from scae_tpu.ops.pallas_decoder_ll_gather import pallas_decoder_ll_gather
from scae_tpu_torch.kernels import decoder_ll_gather as k1

torch.set_num_threads(1)
TOL = 1e-5


def make_inputs(shape, seed=0, pose_noise=0.6, edge=False,
                alpha_batched=False):
    """numpy inputs: templates, alpha, pose, presence, bg_value,
    bg_mixing_logit, scale, target."""
    B, M, C, Ht, Wt, H, W = shape
    rng = np.random.RandomState(seed)
    pose = np.asarray(geometric_transform(
        jnp.asarray(rng.randn(B, M, 6) * pose_noise, jnp.float32)))
    presence = rng.rand(B, M)
    if edge:
        pose = pose.copy()
        pose[:, 0] = [0.01, 0.0, 1.0, 0.0, 0.01, 1.0]
        pose[:, 1] = [1.01, 0.0, -1.0, 0.0, 1.01, 0.0]
        presence[:, ::3] = 0.0
    arrays = (rng.rand(B, M, C, Ht, Wt),
              rng.randn(B if alpha_batched else 1, M, 1, Ht, Wt), pose,
              presence, 0.3, 0.7, 1.0, rng.rand(B, C, H, W))
    return [np.asarray(a, np.float32) for a in arrays]


def jax_args(arrays):
    return [jnp.asarray(a) for a in arrays]


def torch_args(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def check(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


SHAPES = [
    ((2, 8, 1, 5, 5, 16, 16), 0.6, False, False),   # the JAX test's small shape
    ((2, 13, 1, 7, 6, 12, 20), 4.0, True, False),   # extreme poses, zero presences
    ((2, 6, 3, 14, 14, 16, 16), 0.6, False, False),  # colour, two-table size
    ((3, 5, 2, 4, 4, 9, 11), 0.6, False, True),     # per-example alpha
]


@pytest.mark.parametrize("shape,noise,edge,alpha_batched", SHAPES)
def test_plain_matches_xla_path(shape, noise, edge, alpha_batched):
    arrays = make_inputs(shape, pose_noise=noise, edge=edge,
                         alpha_batched=alpha_batched)
    H, W = shape[-2:]
    want = j_fused(*jax_args(arrays), (H, W), jnp.float32)
    ll, num, den = k1.decoder_ll_gather(*torch_args(arrays), (H, W))
    check(ll, want)
    B, C = shape[0], shape[2]
    assert num.shape == (B, C, H * W) and den.shape == (B, 1, H * W)
    check(num - den, np.asarray(want).reshape(B, C, H * W))


@pytest.mark.parametrize("shape,noise,edge", [
    ((2, 8, 1, 5, 5, 16, 16), 0.6, False),
    ((2, 8, 1, 5, 5, 16, 16), 4.0, True),
])
def test_plain_matches_interpret_mode_gather_kernel(shape, noise, edge):
    arrays = make_inputs(shape, seed=3, pose_noise=noise, edge=edge)
    H, W = shape[-2:]
    want = pallas_decoder_ll_gather(*jax_args(arrays), (H, W))
    ll, _, _ = k1.decoder_ll_gather(*torch_args(arrays), (H, W))
    check(ll, want)


def test_plain_matches_interpret_mode_gather_kernel_multichannel():
    # 3 channels, 14x14 = 196 texels: the JAX kernel's two-vreg tables
    shape = (1, 8, 3, 14, 14, 8, 8)
    arrays = make_inputs(shape, seed=4)
    want = pallas_decoder_ll_gather(*jax_args(arrays), (8, 8))
    check(k1.decoder_ll_gather(*torch_args(arrays), (8, 8))[0], want)


@pytest.mark.parametrize("bg_value,bg_mix,scale", [
    (0.0, -2.0, 0.25), (0.9, 3.0, 2.5), (0.5, 0.0, 0.08)])
def test_plain_matches_xla_path_other_scalars(bg_value, bg_mix, scale):
    # a scale away from 1 gives the Gaussian's -log(scale) term weight
    shape = (2, 8, 2, 5, 5, 12, 12)
    arrays = make_inputs(shape, seed=6)
    arrays[4:7] = [np.float32(v) for v in (bg_value, bg_mix, scale)]
    H, W = shape[-2:]
    want = j_fused(*jax_args(arrays), (H, W), jnp.float32)
    check(k1.decoder_ll_gather(*torch_args(arrays), (H, W))[0], want)


def test_plain_never_counts_a_launch():
    arrays = make_inputs((1, 4, 1, 5, 5, 8, 8))
    k1.launches = 0
    k1.decoder_ll_gather(*torch_args(arrays), (8, 8))
    k1.decoder_ll_gather_plain(*torch_args(arrays), (8, 8))
    assert k1.launches == 0


def test_shared_memory_size():
    # the flagship's capsule tables, poses and log-presences: 39,840 bytes
    assert k1.shared_memory_bytes(40, 1, 11, 11) == 4 * (40 * 2 * 121 + 280)
    assert k1.shared_memory_bytes(16, 3, 14, 14) > 48 * 1024


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
