"""The dense decoder likelihood against scae_tpu: the port's
``ops/decoder_ll.py::fused_decoder_ll`` against the JAX module it ports
(float32 and bfloat16 taps), K4's plain version
(``kernels/decoder_ll_dense.py``, which CPU tensors take) against the
Pallas kernel ``pallas_decoder_ll`` run in interpret mode on the CPU, and
the decoder's ``fused_impl="pallas"`` and ``"xla"`` against the JAX
decoder on weights carried across from flax.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances:
  * float32 taps: values 2e-5 absolute (the same f32 sums in another
    order); every gradient within 1e-4 of its largest |entry|, the three
    scalar gradients within 1e-4 of max(|value|, 1) (each a sum over B*P
    pixels of terms of order 1);
  * against the interpret-mode Pallas kernel: values 2e-5, the template
    and alpha gradients 1e-2 (that kernel contracts them in bfloat16 on the
    MXU), the others 1e-4: tests/test_pallas_decoder_ll.py's bars;
  * bfloat16 taps: values 2e-2 relative and 5e-2 absolute, the bar
    tests/test_decoder_ll.py holds the JAX module's bf16 taps to; the
    gradients within 2e-2 of their largest |entry| (both sides round the
    same tap-sized tensors to bf16, ~3.9e-3 relative each, but not always
    on the same side where an f32 sum lands near a rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu.ops.decoder_ll import fused_decoder_ll as j_fused
from scae_tpu.ops.pallas_decoder_ll import pallas_decoder_ll
from scae_tpu_torch.kernels import decoder_ll_dense as k4
from scae_tpu_torch.kernels._common import SMEM_LIMIT
from scae_tpu_torch.ops import decoder_ll as t_dll

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
GRAD_NAMES = ["templates", "alpha", "pose", "presence", "bg_value",
              "bg_mixing_logit", "scale", "target"]


def make_inputs(shape, batch_alpha=False, seed=0, pose=None):
    """numpy inputs as tests/test_pallas_decoder_ll.py draws them: uniform
    templates and target, alpha N(0, 0.25), pose entries uniform in
    [-0.8, 1.2], one presence at exactly 0, scale 1.2 of shape (1,)."""
    B, M, C, Ht, Wt, H, W = shape
    rng = np.random.RandomState(seed)
    presence = rng.rand(B, M)
    presence[0, 0] = 0.0                      # the log_safe floor
    if pose is None:
        pose = rng.uniform(-0.8, 1.2, (B, M, 6))
    arrays = (rng.rand(B, M, C, Ht, Wt),
              rng.randn(B if batch_alpha else 1, M, 1, Ht, Wt) * 0.5,
              pose, presence, np.float32(0.3), np.float32(0.7),
              np.asarray([1.2]), rng.rand(B, C, H, W))
    return [np.asarray(a, np.float32) for a in arrays]


def cotangent(shape):
    B, C, H, W = shape[0], shape[2], shape[5], shape[6]
    return np.cos(np.arange(B * C * H * W, dtype=np.float32)).reshape(
        B, C, H, W)


def jax_value_and_grads(fn, arrays, out_size, g, jit=True):
    """The JAX side's ll and 8 gradients. Under ``jit`` (one compiled
    program; op by op, JAX compiles each op on its own, seconds per shape)
    XLA may fuse a*x + b*y into one multiply-add, which moves a coordinate
    that lies exactly on a texel centre by an ulp and so changes its tap
    derivative: at the kinks the JAX side runs op by op, each operation
    rounded on its own, as PyTorch runs."""
    def loss(*a):
        ll = fn(*a, out_size)
        return jnp.sum(ll * g), ll

    grad_fn = jax.grad(loss, argnums=tuple(range(8)), has_aux=True)
    grads, ll = (jax.jit(grad_fn) if jit else grad_fn)(
        *[jnp.asarray(a) for a in arrays])
    return np.asarray(ll), [np.asarray(x) for x in grads]


def torch_value_and_grads(fn, arrays, out_size, g):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    ll = fn(*leaves, out_size)
    (ll * torch.from_numpy(g)).sum().backward()
    return ll.detach().numpy(), [x.grad.numpy() for x in leaves]


def check(got, want, value_tol, grad_tol):
    (ll, grads), (ll_ref, grads_ref) = got, want
    np.testing.assert_allclose(ll, ll_ref, rtol=0, atol=value_tol)
    for name, a, b in zip(GRAD_NAMES, grads, grads_ref):
        assert a.shape == b.shape, name
        tol = grad_tol.get(name, 1e-4) if isinstance(grad_tol, dict) \
            else grad_tol
        scale = float(np.abs(b).max())
        if b.size == 1:
            scale = max(scale, 1.0)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, \
            f"d{name}: max abs err {err:.3e}, largest |grad| {scale:.3e}"


def port_f32(*args):
    *a, out_size = args
    return t_dll.fused_decoder_ll(*a, out_size, torch.float32)


def jax_f32(*args):
    *a, out_size = args
    return j_fused(*a, out_size, jnp.float32)


def dense_plain(*args):
    return k4.decoder_ll_dense(*args)[0]


SHAPES = [((4, 5, 1, 7, 7, 12, 12), False),   # MNIST-like, shared alpha
          ((3, 4, 3, 6, 5, 10, 8), False),    # colour, non-square
          ((2, 3, 1, 5, 5, 9, 9), True)]      # per-example alpha


@pytest.mark.parametrize("shape,batch_alpha", SHAPES)
def test_f32_taps_match_jax_module(shape, batch_alpha):
    arrays = make_inputs(shape, batch_alpha)
    out_size, g = shape[-2:], cotangent(shape)
    want = jax_value_and_grads(jax_f32, arrays, out_size, g)
    check(torch_value_and_grads(port_f32, arrays, out_size, g), want,
          2e-5, 1e-4)
    # K4's plain version is the same module with float32 taps
    check(torch_value_and_grads(dense_plain, arrays, out_size, g), want,
          2e-5, 1e-4)


@pytest.mark.parametrize("kind,out_size", [("zero", (8, 8)),
                                           ("identity", (5, 5))])
def test_f32_taps_match_jax_module_on_texel_centres(kind, out_size):
    """Every coordinate on a texel centre or edge: the tap derivative's
    kinks, where both sides use -sign(d) on |d| < 1."""
    one = [1, 0, 0, 0, 1, 0] if kind == "identity" else [0] * 6
    shape = (2, 3, 1, 5, 5, *out_size)
    arrays = make_inputs(shape, seed=1,
                         pose=np.tile(np.asarray(one, np.float32), (2, 3, 1)))
    g = cotangent(shape)
    want = jax_value_and_grads(jax_f32, arrays, out_size, g, jit=False)
    for fn in (port_f32, dense_plain):
        check(torch_value_and_grads(fn, arrays, out_size, g), want, 2e-5,
              1e-4)


@pytest.mark.parametrize("shape,batch_alpha", SHAPES[:2])
def test_bf16_taps_match_jax_module(shape, batch_alpha):
    arrays = make_inputs(shape, batch_alpha, seed=2)
    out_size, g = shape[-2:], cotangent(shape)

    def port(*a):
        *a, size = a
        return t_dll.fused_decoder_ll(*a, size, torch.bfloat16)

    def jax_bf16(*a):
        *a, size = a
        return j_fused(*a, size, jnp.bfloat16)

    got = torch_value_and_grads(port, arrays, out_size, g)
    want = jax_value_and_grads(jax_bf16, arrays, out_size, g)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=5e-2)
    check(got, want, np.inf, 2e-2)
    # the default tap dtype is bfloat16, as in the JAX module
    ll = t_dll.fused_decoder_ll(
        *[torch.from_numpy(np.array(a)) for a in arrays], out_size)
    np.testing.assert_array_equal(ll.detach().numpy(), got[0])


def test_plain_matches_interpret_mode_pallas_kernel():
    shape = (2, 3, 1, 5, 5, 9, 9)
    arrays = make_inputs(shape, seed=3)
    out_size, g = shape[-2:], cotangent(shape)
    want = jax_value_and_grads(pallas_decoder_ll, arrays, out_size, g)
    check(torch_value_and_grads(dense_plain, arrays, out_size, g), want,
          2e-5, {"templates": 1e-2, "alpha": 1e-2})


def test_plain_forward_returns_the_lse_terms():
    shape = (2, 4, 2, 5, 6, 7, 8)
    arrays = [torch.from_numpy(a) for a in make_inputs(shape, seed=4)]
    ll, num, den = k4.decoder_ll_dense_plain(*arrays, (7, 8))
    assert num.shape == (2, 2, 56) and den.shape == (2, 1, 56)
    torch.testing.assert_close(ll.reshape(2, 2, 56), num - den, rtol=0,
                               atol=0)
    assert not ll.requires_grad


def test_function_plumbing_on_cpu():
    """Through DecoderLLDense on CPU tensors: the gradients of the plain
    backward, each in its input's shape (alpha's own batch, the scalars'
    own shapes), None where none is asked for, and no launch counted."""
    shape = (3, 4, 2, 5, 5, 9, 10)
    arrays = make_inputs(shape, seed=5)
    mask = [1, 1, 1, 1, 1, 1, 1, 0]
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(bool(m))
              for a, m in zip(arrays, mask)]
    k4.launches = k4.bwd_launches = 0
    ll, num, den = k4.decoder_ll_dense(*leaves, (9, 10))
    assert not num.requires_grad and not den.requires_grad
    g = torch.from_numpy(cotangent(shape))
    (ll * g).sum().backward()
    want = k4.decoder_ll_dense_bwd_plain(g, num, den, *arrays_t(arrays),
                                         (9, 10), target_grad=False)
    assert want[7] is None and leaves[7].grad is None
    for name, leaf, w in zip(GRAD_NAMES, leaves[:7], want):
        assert leaf.grad.shape == leaf.shape, name
        torch.testing.assert_close(leaf.grad, w.reshape(leaf.shape), rtol=0,
                                   atol=0)
    assert (k4.launches, k4.bwd_launches) == (0, 0)


def arrays_t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_shared_memory_does_not_grow_with_capsules():
    # K4f: a ring of 2 buffers of 32 capsules' tables (2 floats a texel
    # at C = 1), from a 16-byte boundary their 6 pose entries and presence,
    # the same bytes for every M; K4b: one capsule's table (2 floats a
    # texel at C = 1, 4 at C = 3), and for each of 4 warps a gradient table
    # of C + 1 planes and 32 pixels' 4 (C + 1) tap values and keys
    assert k4.shared_memory_bytes(1, 11, 11) == \
        4 * 2 * (32 * 2 * 121 + 32 * 7)
    assert {k4.forward_plan((128, M, 1, 11, 11, 40, 40))["smem"]
            for M in (1, 13, 40, 64, 1000)} == \
        {k4.shared_memory_bytes(1, 11, 11)}
    assert k4.bwd_shared_memory_bytes(1, 11, 11) == \
        4 * (2 * 121 + 4 * (2 * 121 + 9 * 32))
    assert k4.bwd_shared_memory_bytes(3, 17, 17) == \
        4 * (4 * 289 + 4 * (4 * 289 + 17 * 32))
    # a 17x17 colour template, which K1 refuses at M = 64, fits
    assert k4.bwd_shared_memory_bytes(3, 17, 17) <= SMEM_LIMIT


def test_model_level_impls_match_jax():
    """TemplateBasedImageDecoder with fused_impl="pallas" and "xla" (float32
    and bfloat16 taps), on weights carried from flax, against the JAX
    decoder (its "xla" path with float32 taps): the likelihood and the
    gradients of its sum with respect to the decoder's parameters and the
    poses."""
    from scae_tpu.models.part_decoder import TemplateBasedImageDecoder as JD
    from scae_tpu_torch.models.part_decoder import (
        TemplateBasedImageDecoder as TD,
    )
    from scae_tpu_torch.utils.from_flax import load_flax_params

    B, M, C, Ht, Wt, H, W = 2, 6, 1, 5, 5, 14, 14
    templates, _, pose, presence, *_, target = make_inputs(
        (B, M, C, Ht, Wt, H, W), seed=6)
    kw = dict(n_templates=M, template_size=(Ht, Wt), output_size=(H, W),
              use_alpha_channel=True, background_value=True,
              learn_output_scale=True, use_fused_ll=True)
    jd = JD(fused_impl="xla", **kw)
    jargs = [jnp.asarray(a) for a in (templates, pose, presence)]
    params = jd.init(jax.random.PRNGKey(3), *jargs,
                     target=jnp.asarray(target))["params"]
    rng = np.random.RandomState(7)     # away from the zero init
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.randn(*np.shape(p)).astype(
            np.float32), params)

    def j_loss(p, pose_):
        res = jd.apply({"params": p}, jargs[0], pose_, jargs[2],
                       target=jnp.asarray(target))
        return jnp.sum(res.target_ll * cotangent((B, M, C, Ht, Wt, H, W)))

    want_ll = np.asarray(jax.jit(lambda p: jd.apply(
        {"params": p}, *jargs, target=jnp.asarray(target)).target_ll)(params))
    j_grads, j_gpose = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(params,
                                                                 jargs[1])

    for impl, taps, tol in (("pallas", "float32", 1e-4),
                            ("xla", "float32", 1e-4),
                            ("xla", "bfloat16", 2e-2)):
        td = TD(fused_impl=impl, fused_tap_dtype=taps, **kw)
        load_flax_params(td, params)
        p = torch.from_numpy(pose.copy()).requires_grad_()
        res = td(*arrays_t([templates]), p, *arrays_t([presence]),
                 target=torch.from_numpy(target))
        ll = res.target_ll
        np.testing.assert_allclose(
            ll.detach().numpy(), want_ll, rtol=0,
            atol=2e-5 if taps == "float32" else 5e-2, err_msg=impl)
        (ll * torch.from_numpy(cotangent((B, M, C, Ht, Wt, H, W)))).sum() \
            .backward()
        for name, param in td.named_parameters():
            ref = np.asarray(j_grads[name])
            scale = max(float(np.abs(ref).max()), 1.0)
            assert float(np.abs(param.grad.numpy() - ref).max()) \
                <= tol * scale, (impl, taps, name)
        ref = np.asarray(j_gpose)
        assert float(np.abs(p.grad.numpy() - ref).max()) \
            <= tol * float(np.abs(ref).max()), (impl, taps, "pose")


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
