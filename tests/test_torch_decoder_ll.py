"""K1's plain PyTorch version and the plain backward
(scae_tpu_torch/kernels/decoder_ll_gather.py) against scae_tpu: the
XLA-path ``fused_decoder_ll`` with f32 taps, and the Pallas gather kernel
``pallas_decoder_ll_gather`` run in interpret mode on the CPU, as
tests/test_pallas_decoder_impls.py runs it. Also the autograd Function's
plumbing, with its kernel launches swapped for the plain versions.

Tolerances:
  * 1e-5 absolute on the per-pixel log-likelihood, whose values are of
    order 1-10: both references compute the same f32 sums in another order;
  * gradients against the f32 XLA path: 1e-4 of each tensor's largest
    |gradient| (sums over up to B*P terms in another order, in f32), and
    for the three scalar gradients at least 1e-4 absolute: each is a sum
    over B*P pixels of terms of order 1 that nearly cancel (bg_mixing_logit's
    is sum(g q_bg) - sum(g r_bg)), so its f32 rounding is of the terms' size,
    not of the result's;
  * gradients against the interpret-mode gather kernel: 3e-2 of the
    largest, that kernel's own tolerance (its template-gradient contraction
    takes bf16 operands; tests/test_pallas_decoder_impls.py:36-64).
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
from scae_tpu_torch.utils import trace

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
    counted = trace.Since()
    k1.decoder_ll_gather(*torch_args(arrays), (8, 8))
    k1.decoder_ll_gather_plain(*torch_args(arrays), (8, 8))
    assert counted.launches("K1") == (0,)


def test_shared_memory_size():
    # the flagship's batch-shared alpha table, then two example buffers of
    # templates, poses, presences and log-presences: 60,640 bytes
    assert k1.shared_memory_bytes(40, 1, 11, 11) == \
        4 * (40 * 121 + 2 * (40 * 121 + 240 + 80))
    # one buffer: the earlier design's 39,840 bytes and one float per capsule
    assert k1.shared_memory_bytes(40, 1, 11, 11, buffers=1) == \
        4 * (40 * 2 * 121 + 280) + 4 * 40
    assert k1.shared_memory_bytes(16, 3, 14, 14) > 48 * 1024


GRAD_NAMES = ["templates", "alpha", "pose", "presence", "bg_value",
              "bg_mixing_logit", "scale", "target"]


def upstream(shape, seed=5):
    B, C, H, W = shape[0], shape[2], shape[5], shape[6]
    return np.random.RandomState(seed).randn(B, C, H, W).astype(np.float32)


def jax_grads(ll_fn, arrays, g):
    def loss(*a):
        return jnp.sum(jnp.asarray(g) * ll_fn(*a))
    return jax.grad(loss, argnums=tuple(range(8)))(*jax_args(arrays))


def check_grads(got, want, tol):
    for name, a, b in zip(GRAD_NAMES, got, want):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max())
        if b.ndim == 0:
            scale = max(scale, 1.0)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale + 1e-30, \
            f"grad {name}: max abs err {err:.3e}, largest |grad| {scale:.3e}"


@pytest.mark.parametrize("shape,noise,edge,alpha_batched", SHAPES)
def test_plain_backward_matches_xla_path(shape, noise, edge, alpha_batched):
    arrays = make_inputs(shape, pose_noise=noise, edge=edge,
                         alpha_batched=alpha_batched)
    H, W = shape[-2:]
    g = upstream(shape)
    want = jax_grads(lambda *a: j_fused(*a, (H, W), jnp.float32), arrays, g)
    got = k1.decoder_ll_gather_bwd(torch.from_numpy(g), None, None,
                                   *torch_args(arrays), (H, W))
    check_grads(got, want, 1e-4)


@pytest.mark.parametrize("bg_value,bg_mix,scale", [
    (0.0, -2.0, 0.25), (0.9, 3.0, 2.5)])
def test_plain_backward_matches_xla_path_other_scalars(bg_value, bg_mix,
                                                       scale):
    shape = (2, 8, 2, 5, 5, 12, 12)
    arrays = make_inputs(shape, seed=6)
    arrays[4:7] = [np.float32(v) for v in (bg_value, bg_mix, scale)]
    g = upstream(shape, seed=7)
    want = jax_grads(lambda *a: j_fused(*a, (12, 12), jnp.float32), arrays,
                     g)
    got = k1.decoder_ll_gather_bwd(torch.from_numpy(g), None, None,
                                   *torch_args(arrays), (12, 12))
    check_grads(got, want, 1e-4)


def test_plain_backward_matches_interpret_mode_gather_kernel():
    shape = (2, 8, 1, 5, 5, 16, 16)
    arrays = make_inputs(shape, seed=3)
    g = upstream(shape)
    want = jax_grads(lambda *a: pallas_decoder_ll_gather(*a, (16, 16)),
                     arrays, g)
    got = k1.decoder_ll_gather_bwd(torch.from_numpy(g), None, None,
                                   *torch_args(arrays), (16, 16))
    check_grads(got, want, 3e-2)


def test_plain_backward_without_target_gradient():
    shape = (2, 5, 1, 4, 4, 8, 8)
    args = torch_args(make_inputs(shape))
    g = torch.from_numpy(upstream(shape))
    full = k1.decoder_ll_gather_bwd(g, None, None, *args, (8, 8))
    part = k1.decoder_ll_gather_bwd(g, None, None, *args, (8, 8),
                                    target_grad=False)
    assert part[7] is None
    for a, b in zip(full[:7], part[:7]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture
def plain_launches(monkeypatch):
    """The Function with its two launches swapped for the plain versions;
    records what the backward launch is given."""
    seen = []

    def bwd(g, num, den, *rest, target_grad=True):
        seen.append(dict(g=g, num=num, den=den, target_grad=target_grad))
        return k1.decoder_ll_gather_bwd_plain(g, num, den, *rest,
                                              target_grad=target_grad)

    monkeypatch.setattr(k1, "_launch", k1.decoder_ll_gather_plain)
    monkeypatch.setattr(k1, "_bwd_launch", bwd)
    return seen


def leaves(arrays, grad_mask, scalar_shapes=((1,), (), ())):
    """Torch leaves of the 8 array inputs, the scalars in the given shapes,
    those in ``grad_mask`` requiring gradients."""
    out = []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(np.array(a))
        if 4 <= i <= 6:
            t = t.reshape(scalar_shapes[i - 4])
        out.append(t.requires_grad_(bool(grad_mask[i])))
    return out


@pytest.mark.parametrize("alpha_batched", [False, True])
def test_function_plumbing(plain_launches, alpha_batched):
    """Gradients through the Function equal autograd's through the plain
    forward, for an upstream gradient with zero strides (the backward of a
    sum), alpha reduced to its own batch, the scalars in their own shapes,
    and no target gradient asked for."""
    shape = (3, 6, 2, 5, 5, 9, 10)
    arrays = make_inputs(shape, seed=8, alpha_batched=alpha_batched)
    mask = [1, 1, 1, 1, 1, 1, 0, 0]
    ours = leaves(arrays, mask)
    ll, num, den = k1.DecoderLLFunction.apply(k1._launch, k1._bwd_launch,
                                              *ours, (9, 10))
    assert not num.requires_grad and not den.requires_grad
    ll.sum().backward()
    ref = leaves(arrays, mask)
    k1.decoder_ll_gather_plain(*ref, (9, 10))[0].sum().backward()
    for name, a, b in zip(GRAD_NAMES, ours, ref):
        if b.grad is None:
            assert a.grad is None, name
            continue
        assert a.grad.shape == a.shape, name
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    assert ours[1].grad.shape[0] == (shape[0] if alpha_batched else 1)
    (call,) = plain_launches
    assert call["g"].is_contiguous() and bool((call["g"] == 1).all())
    assert call["num"] is num and call["den"] is den
    assert call["target_grad"] is False


def test_function_returns_only_the_gradients_asked_for(plain_launches):
    shape = (2, 4, 1, 4, 4, 8, 8)
    arrays = make_inputs(shape, seed=9)
    mask = [0, 0, 1, 0, 0, 0, 0, 1]
    ours = leaves(arrays, mask)
    ll, _, _ = k1.DecoderLLFunction.apply(k1._launch, k1._bwd_launch, *ours,
                                          (8, 8))
    g = torch.from_numpy(upstream(shape))
    grads = torch.autograd.grad(ll, [ours[2], ours[7]], g)
    ctx_grads = k1.decoder_ll_gather_bwd_plain(g, None, None, *ours, (8, 8))
    torch.testing.assert_close(grads[0], ctx_grads[2], rtol=0, atol=0)
    torch.testing.assert_close(grads[1], ctx_grads[7], rtol=0, atol=0)
    assert plain_launches[0]["target_grad"] is True
    # nothing asked for: the backward launches nothing
    none = leaves(arrays, [0] * 8)
    ll, _, _ = k1.DecoderLLFunction.apply(k1._launch, k1._bwd_launch, *none,
                                          (8, 8))
    assert not ll.requires_grad
    assert len(plain_launches) == 1


def test_cpu_tensors_never_reach_the_function(monkeypatch):
    def refuse(*args):
        raise AssertionError("the Function ran on CPU tensors")

    monkeypatch.setattr(k1, "_launch", refuse)
    monkeypatch.setattr(k1, "_bwd_launch", refuse)
    shape = (2, 4, 1, 4, 4, 8, 8)
    ours = leaves(make_inputs(shape), [1] * 6 + [0, 0])
    k1.decoder_ll_gather(*ours, (8, 8))[0].sum().backward()
    assert ours[0].grad is not None


def test_backward_shared_memory_size():
    # one block per (capsule, example): the table (2 floats a texel), then
    # for each of 4 warps a gradient table and a scratch of 32 pixels'
    # 8 tap values and keys: 9,448 bytes
    assert k1.bwd_shared_memory_bytes(1, 11, 11) == 9448
    assert k1.BWD_WARPS == 4
    # the shapes whose tables of all capsules did not fit in one block of
    # the earlier design (it split their capsules into groups): every
    # capsule now has its own block, whatever M is
    for M, C, Ht, Wt in ((60, 3, 15, 15), (64, 3, 11, 11)):   # cifar10
        assert k1.forward_buffers(M, C, Ht, Wt) >= 1   # K1 fits
        smem = k1.bwd_shared_memory_bytes(C, Ht, Wt)
        assert smem <= k1.SMEM_LIMIT
        assert smem == 4 * (Ht * Wt * 4 + 4 * (4 * Ht * Wt + 17 * 32))
    assert k1.bwd_shared_memory_bytes(3, 11, 11) == 18384
    # a colour template of 40x40 texels still fits
    assert k1.bwd_shared_memory_bytes(4, 40, 40) <= k1.SMEM_LIMIT
    # not even one capsule's tables fit
    assert k1.bwd_shared_memory_bytes(4, 77, 77) > k1.SMEM_LIMIT


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
