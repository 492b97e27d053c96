"""The port's tensor ops (scae_tpu_torch/ops, utils/shapes) against their
scae_tpu counterparts, on the same numpy inputs, in f32 on the CPU.

Tolerance: 1e-5 relative and absolute, as tests/test_parity_golden.py
holds scae_tpu to the torch reference; the same goldens feed the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu.ops import attention as j_attention
from scae_tpu.ops import geometry as j_geometry
from scae_tpu.ops import gmm as j_gmm
from scae_tpu.ops import math_ops as j_math
from scae_tpu.ops import pooling as j_pooling
from scae_tpu.ops import warp as j_warp
from scae_tpu.utils import shapes as j_shapes
from scae_tpu_torch.ops import attention as t_attention
from scae_tpu_torch.ops import geometry as t_geometry
from scae_tpu_torch.ops import gmm as t_gmm
from scae_tpu_torch.ops import math_ops as t_math
from scae_tpu_torch.ops import pooling as t_pooling
from scae_tpu_torch.ops import warp as t_warp
from scae_tpu_torch.utils import shapes as t_shapes

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-5


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def both(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def golden(name):
    return dict(np.load(os.path.join(GOLDEN, f"{name}.npz")))


# ---------------------------------------------------------------- math_ops

def test_math_ops_match():
    rng = np.random.RandomState(0)
    x = rng.rand(3, 7).astype(np.float32)
    x[0, :3] = [0.0, 1e-20, 1e-16]
    xj, xt = both(x)
    close(t_math.log_safe(xt), j_math.log_safe(xj))
    close(t_math.normalize(xt, 1), j_math.normalize(xj, 1))
    close(t_math.normalize(xt, 0), j_math.normalize(xj, 0))
    close(t_math.l2_loss(xt), j_math.l2_loss(xj))
    yj, yt = both(rng.randn(3, 7) * 2)
    close(t_math.relu1(yt), j_math.relu1(yj))
    pj, pt = both(rng.rand(3, 7))
    close(t_math.cross_entropy_safe(pt, xt), j_math.cross_entropy_safe(pj, xj))
    close(t_math.cross_entropy_safe(pt, xt, dim=0),
          j_math.cross_entropy_safe(pj, xj, axis=0))


def test_log_safe_floor():
    out = t_math.log_safe(torch.tensor([0.0, 1e-17, 1.0]))
    assert out.tolist() == [-1e8, -1e8, 0.0]


@pytest.mark.parametrize("size,kernel,stride,padding,dilation", [
    (28, 3, 2, 0, 1), (40, 3, 1, 1, 1), (13, 5, 2, 2, 2)])
def test_conv_output_size_matches(size, kernel, stride, padding, dilation):
    assert t_shapes.conv_output_size(size, kernel, stride, padding,
                                     dilation) == \
        j_shapes.conv_output_size(size, kernel, stride, padding, dilation)


# ---------------------------------------------------------------- geometry

@pytest.mark.parametrize("similarity", [False, True])
@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("as_matrix", [False, True])
def test_geometric_transform_matches(similarity, nonlinear, as_matrix):
    pj, pt = both(np.random.RandomState(1).randn(4, 5, 6))
    close(t_geometry.geometric_transform(pt, similarity, nonlinear,
                                         as_matrix),
          j_geometry.geometric_transform(pj, similarity, nonlinear,
                                         as_matrix))


def test_compose_affines_matches():
    rng = np.random.RandomState(2)
    oj, ot = both(rng.randn(2, 3, 1, 6))
    ij, it = both(rng.randn(2, 3, 5, 6))
    close(t_geometry.compose_affines(ot, it),
          j_geometry.compose_affines(oj, ij))
    close(t_geometry.affine_to_matrix(it), j_geometry.affine_to_matrix(ij))


def test_geometric_transform_golden():
    g = golden("geometric_transform")
    pose = torch.from_numpy(g["pose"])
    close(t_geometry.geometric_transform(pose), g["flat"])
    close(t_geometry.geometric_transform(pose, as_matrix=True), g["matrix"])
    close(t_geometry.geometric_transform(pose, similarity=True),
          g["similarity"])
    close(t_geometry.geometric_transform(pose, nonlinear=False), g["linear"])


# -------------------------------------------------------------------- warp

def test_warp_matches():
    rng = np.random.RandomState(3)
    pose = j_geometry.geometric_transform(
        jnp.asarray(rng.randn(2, 3, 6).astype(np.float32)))
    pj, pt = both(np.asarray(pose))
    gx_j, gy_j = j_warp._base_grid((6, 9))
    gx_t, gy_t = t_warp._base_grid((6, 9))
    close(gx_t, gx_j)
    close(gy_t, gy_j)
    for a, b in zip(t_warp.source_coordinates(pt, (5, 7), (12, 10)),
                    j_warp.source_coordinates(pj, (5, 7), (12, 10))):
        close(a, b)
    for a, b in zip(t_warp.bilinear_weight_matrices(pt, (5, 7), (12, 10)),
                    j_warp.bilinear_weight_matrices(pj, (5, 7), (12, 10))):
        close(a, b)
    tj, tt = both(rng.rand(2, 3, 2, 5, 7))
    close(t_warp.affine_warp(tt, pt, (12, 10)),
          j_warp.affine_warp(tj, pj, (12, 10)))


def test_grid_sample_golden():
    """affine_warp == F.affine_grid + F.grid_sample(align_corners=False)."""
    g = golden("grid_sample")
    H, W = [int(v) for v in g["out_size"]]
    pose = torch.from_numpy(g["theta"].reshape(-1, 6))
    close(t_warp.affine_warp(torch.from_numpy(g["templates"]), pose, (H, W)),
          g["out"])


# --------------------------------------------------------------------- gmm

def _gmm_inputs(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(2, 5, 1, 4, 4), np.float32(0.7),
            rng.randn(2, 5, 1, 4, 4), rng.rand(2, 1, 4, 4))


def test_gmm_matches():
    loc, scale, logits, x = _gmm_inputs()
    gj = j_gmm.GaussianMixture.make_from_stats(
        jnp.asarray(loc, jnp.float32), scale,
        jnp.asarray(logits, jnp.float32))
    gt = t_gmm.GaussianMixture.make_from_stats(
        torch.tensor(loc, dtype=torch.float32), scale,
        torch.tensor(logits, dtype=torch.float32))
    xj, xt = both(x)
    close(gt.log_prob(xt), gj.log_prob(xj))
    close(gt.mean(), gj.mean())
    close(gt.mode(), gj.mode())
    close(gt.mode(maximum=True), gj.mode(maximum=True))
    close(gt.mode(straight_through_gradient=True),
          gj.mode(straight_through_gradient=True))
    assert gt.n_components == gj.n_components
    close(t_gmm.normal_log_prob(xt, xt * 0.5, 0.3),
          j_gmm.normal_log_prob(xj, xj * 0.5, 0.3))


def test_gmm_golden():
    g = golden("gmm")
    gmm = t_gmm.GaussianMixture.make_from_stats(
        torch.from_numpy(g["loc"]), torch.from_numpy(g["scale"]),
        torch.from_numpy(g["logits"]))
    close(gmm.log_prob(torch.from_numpy(g["x"])), g["log_prob"])
    close(gmm.mean(), g["mean"])
    close(gmm.mode(), g["mode"])


# ----------------------------------------------------------------- pooling

def test_attention_pooling_matches():
    fj, ft = both(np.random.RandomState(5).randn(2, 12, 5, 5))
    close(t_pooling.multiple_soft_attention(ft, 3),
          j_pooling.multiple_soft_attention(fj, 3))
    close(t_pooling.multiple_attention_pooling_2d(ft, 4),
          j_pooling.multiple_attention_pooling_2d(fj, 4))
    with pytest.raises(ValueError):
        t_pooling.multiple_soft_attention(ft, 5)


def test_attention_pooling_golden():
    g = golden("attention_pooling")
    close(t_pooling.multiple_attention_pooling_2d(torch.from_numpy(g["fm"]),
                                                  3), g["out"])


# --------------------------------------------------------------- attention

def test_qkv_attention_matches():
    rng = np.random.RandomState(6)
    qj, qt = both(rng.randn(2, 3, 8))
    kj, kt = both(rng.randn(2, 5, 8))
    vj, vt = both(rng.randn(2, 5, 4))
    pres = rng.rand(2, 5)
    pres[0, 1] = 0.0
    pj, pt = both(pres)
    close(t_attention.qkv_attention(qt, kt, vt),
          j_attention._qkv_attention_jnp(qj, kj, vj, None))
    close(t_attention.qkv_attention(qt, kt, vt, pt),
          j_attention._qkv_attention_jnp(qj, kj, vj, pj))
    assert t_attention.MASK == j_attention._MASK


def test_qkv_attention_golden():
    g = golden("qkv_attention")
    q, k, v = [torch.from_numpy(g[n]) for n in "qkv"]
    close(t_attention.qkv_attention(q, k, v), g["out"])
    close(t_attention.qkv_attention(q, k, v, torch.from_numpy(g["presence"])),
          g["out_masked"])


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
