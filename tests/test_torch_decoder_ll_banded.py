"""The banded decoder likelihood (``kernels/decoder_ll_banded.py``, K5's
wrapper and plain version, which CPU tensors take) against scae_tpu:

  * ``band_rows`` and ``h_windows`` against the JAX package's
    ``_band_rows`` and ``_h_windows``, exactly (integers);
  * the plain banded version against the port's dense one: the windows
    drop no mass, which the JAX package checks only under ``-m slow``;
  * against ``fused_decoder_ll`` with float32 taps, op by op, at poses
    whose coordinates lie on texel centres and edges;
  * against the Pallas kernel ``pallas_decoder_ll_banded`` in interpret
    mode, at that kernel's own tolerance;
  * the decoder with ``fused_impl="pallas_banded"`` against the JAX decoder.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances:
  * banded against dense (the same f32 arithmetic, the capsules summed in
    another order): values 1e-6 absolute, every gradient within 1e-5 of
    its largest |entry| (the three scalar gradients of max(|value|, 1));
  * against ``fused_decoder_ll``: 2e-5 and 1e-4, as
    tests/test_torch_decoder_ll_dense.py;
  * against the Pallas kernel: values 1e-2 absolute, gradients 3e-2
    relative to their largest |entry|: tests/test_pallas_decoder_impls.py's
    bars, since that kernel warps in bfloat16 on the MXU.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu.ops.decoder_ll import fused_decoder_ll as j_fused
from scae_tpu_torch.kernels import decoder_ll_banded as k5
from scae_tpu_torch.kernels import decoder_ll_dense as k4
from scae_tpu_torch.kernels._common import SMEM_LIMIT

# the package scae_tpu.ops exports a function of the module's name
j_banded = importlib.import_module("scae_tpu.ops.pallas_decoder_ll_banded")

torch.set_num_threads(1)
GRAD_NAMES = ["templates", "alpha", "pose", "presence", "bg_value",
              "bg_mixing_logit", "scale", "target"]


def make_inputs(shape, seed=0, pose=None, batch_alpha=False):
    """Uniform templates and target, alpha N(0, 0.25), pose entries uniform
    in [-0.8, 1.2], one presence at exactly 0, scale 1.2 of shape (1,)."""
    B, M, C, Ht, Wt, H, W = shape
    rng = np.random.RandomState(seed)
    presence = rng.rand(B, M)
    presence[0, 0] = 0.0
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


def torch_value_and_grads(fn, arrays, out_size, g):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    ll = fn(*leaves, out_size)
    if isinstance(ll, tuple):
        ll = ll[0]
    (ll * torch.from_numpy(g)).sum().backward()
    return ll.detach().numpy(), [x.grad.numpy() for x in leaves]


def jax_value_and_grads(fn, arrays, out_size, g, jit=True):
    def loss(*a):
        ll = fn(*a, out_size)
        return jnp.sum(ll * g), ll

    grad_fn = jax.grad(loss, argnums=tuple(range(8)), has_aux=True)
    grads, ll = (jax.jit(grad_fn) if jit else grad_fn)(
        *[jnp.asarray(a) for a in arrays])
    return np.asarray(ll), [np.asarray(x) for x in grads]


def check(got, want, value_tol, grad_tol, show=None):
    """The value within ``value_tol`` absolute, each gradient within
    ``grad_tol`` of its largest |entry| (of max(|value|, 1) for a scalar);
    ``show``: print the errors under that label."""
    (ll, grads), (ll_ref, grads_ref) = got, want
    value_err = float(np.abs(ll - ll_ref).max())
    errs = {}
    for name, a, b in zip(GRAD_NAMES, grads, grads_ref):
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max())
        if b.size == 1:
            scale = max(scale, 1.0)
        errs[name] = (float(np.abs(a - b).max()), scale)
    if show:
        print(f"{show}: value err {value_err:.3e}, gradient errs "
              + ", ".join(f"{k} {e / s if s else e:.2e}"
                          for k, (e, s) in errs.items()))
    assert value_err <= value_tol
    for name, (err, scale) in errs.items():
        assert err <= grad_tol * scale, (name, err, scale)


def banded(*args):
    return k5.decoder_ll_banded(*args)[0]


def dense(*args):
    return k4.decoder_ll_dense(*args)[0]


# ------------------------------------------------------- bands and windows

def test_band_rows_match_jax():
    for H in range(8, 49):
        for W in range(8, 49):
            assert k5.band_rows(H, W) == j_banded._band_rows(H, W), (H, W)
    # the flagship: 5 bands of 320 pixels; cifar10: 4 bands of 256
    assert (k5.band_rows(40, 40), k5.band_rows(32, 32)) == (8, 8)


def padded_sorted_pose(pose):
    """The sorted, padded poses the windows are computed from, through the
    port's wrapper."""
    B, M, _ = pose.shape
    args = [torch.zeros(B, M, 1, 3, 3), torch.zeros(1, M, 1, 3, 3),
            torch.from_numpy(pose), torch.ones(B, M)]
    return k5.sort_and_pad(*args)[2]


@pytest.mark.parametrize("kind", ["random", "identity", "zero", "off canvas",
                                  "pad"])
@pytest.mark.parametrize("Ht,Wt,H,W", [(11, 11, 40, 40), (5, 5, 32, 32),
                                        (7, 9, 24, 20)])
def test_h_windows_match_jax(kind, Ht, Wt, H, W):
    rng = np.random.RandomState(4)
    M = 13 if kind == "pad" else 16
    pose = rng.uniform(-0.8, 1.2, (3, M, 6)).astype(np.float32)
    if kind == "identity":
        pose[:] = [1, 0, 0, 0, 1, 0]
    elif kind == "zero":
        pose[:] = 0.0
    elif kind == "off canvas":
        # below and above the canvas: every window of those groups empty
        pose[:, :8] = [1, 0, 0, 0, 1, 3.0]
        pose[:, 8:] = [1, 0, 0, 0, 0.5, -2.5]
    p = padded_sorted_pose(pose)
    assert p.shape[1] % 8 == 0
    rows = k5.band_rows(H, W)
    got = k5.h_windows(p, Ht, H, W, rows)
    want = np.asarray(j_banded._h_windows(jnp.asarray(p.numpy()), Ht, Wt,
                                          H, W, rows))
    assert got.dtype == torch.int32 and got.shape == (3, H // rows,
                                                      p.shape[1] // 8, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "off canvas":
        assert (got[..., 1] == 0).all()


def test_window_mask_marks_the_window_rows():
    win = torch.tensor([[[[2, 3]], [[0, 0]]]], dtype=torch.int32)  # B1 NB2 G1
    mask = k5.window_row_mask(win, 6, 4, 3, 2)        # Ht 6, H 4, W 3, R 2
    assert mask.shape == (1, 8, 6, 12)
    want = torch.zeros(6, 12)
    want[2:5, :6] = 1.0                               # band 0: rows 2..4
    for m in range(8):
        assert torch.equal(mask[0, m], want)


# ------------------------------------------------------------ the function

@pytest.mark.parametrize("shape,batch_alpha", [
    ((2, 13, 1, 5, 5, 32, 32), False),    # the pad path, 4 bands
    ((2, 16, 2, 7, 6, 24, 20), True),     # colour, per-example alpha
    ((1, 8, 1, 11, 11, 40, 40), False),   # flagship widths, 5 bands
])
def test_plain_banded_equals_dense(shape, batch_alpha):
    arrays = make_inputs(shape, seed=1, batch_alpha=batch_alpha)
    out_size, g = shape[-2:], cotangent(shape)
    check(torch_value_and_grads(banded, arrays, out_size, g),
          torch_value_and_grads(dense, arrays, out_size, g), 1e-6, 1e-5)


@pytest.mark.parametrize("kind,out_size", [("zero", (8, 8)),
                                           ("identity", (5, 5))])
def test_plain_banded_matches_jax_module_on_texel_centres(kind, out_size):
    one = [1, 0, 0, 0, 1, 0] if kind == "identity" else [0] * 6
    shape = (2, 3, 1, 5, 5, *out_size)
    arrays = make_inputs(shape, seed=2,
                         pose=np.tile(np.asarray(one, np.float32), (2, 3, 1)))
    g = cotangent(shape)

    def jax_f32(*a):
        *a, size = a
        return j_fused(*a, size, jnp.float32)

    # at the zero pose every coordinate is exact under any fusion, so JAX
    # may compile the whole program; at the identity it runs op by op, each
    # operation rounded on its own as in PyTorch (a fused multiply-add would
    # move a coordinate off its texel centre)
    want = jax_value_and_grads(jax_f32, arrays, out_size, g,
                               jit=kind == "zero")
    check(torch_value_and_grads(banded, arrays, out_size, g), want, 2e-5,
          1e-4)


@pytest.mark.parametrize("shape", [(1, 8, 1, 5, 5, 32, 32),
                                   (2, 13, 1, 5, 5, 24, 24)])
def test_plain_matches_interpret_mode_pallas_kernel(shape):
    arrays = make_inputs(shape, seed=3)
    out_size, g = shape[-2:], cotangent(shape)
    want = jax_value_and_grads(j_banded.pallas_decoder_ll_banded, arrays,
                               out_size, g)
    check(torch_value_and_grads(banded, arrays, out_size, g), want, 1e-2,
          3e-2, show=f"port against the interpret-mode kernel, {shape}")


def test_function_plumbing_on_cpu():
    """Through DecoderLLBanded on CPU tensors: no launch counted, (ll, num,
    den) with num and den outside the graph, a gradient for each input
    that asks, in its own shape, and none for the target."""
    shape = (3, 10, 2, 5, 5, 16, 16)
    arrays = make_inputs(shape, seed=5)
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(i != 7)
              for i, a in enumerate(arrays)]
    k5.launches = k5.bwd_launches = 0
    ll, num, den = k5.decoder_ll_banded(*leaves, (16, 16))
    assert ll.shape == (3, 2, 16, 16) and num.shape == (3, 2, 256)
    assert den.shape == (3, 1, 256)
    assert not num.requires_grad and not den.requires_grad
    torch.testing.assert_close(ll.reshape(3, 2, 256), num - den, rtol=0,
                               atol=0)
    (ll * torch.from_numpy(cotangent(shape))).sum().backward()
    for name, leaf in zip(GRAD_NAMES[:7], leaves):
        assert leaf.grad is not None and leaf.grad.shape == leaf.shape, name
    assert leaves[7].grad is None
    assert (k5.launches, k5.bwd_launches) == (0, 0)


def test_windows_computed_once_per_step(monkeypatch):
    """DecoderLLBanded computes the windows once, in its forward, and its
    backward takes those same windows; a caller's windows are used as
    given."""
    shape = (2, 8, 1, 5, 5, 24, 24)
    arrays = make_inputs(shape, seed=6)
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return h_windows(*args)

    h_windows = k5.h_windows
    monkeypatch.setattr(k5, "h_windows", counted)
    leaves = [torch.from_numpy(np.array(a)).requires_grad_()
              for a in arrays]
    ll = k5.decoder_ll_banded(*leaves, (24, 24))[0]
    (ll * torch.from_numpy(cotangent(shape))).sum().backward()
    assert len(calls) == 1

    sorted_args = [torch.from_numpy(np.array(a)) for a in arrays]
    sorted_args[:4] = k5.sort_and_pad(*sorted_args[:4])
    rows = k5.band_rows(24, 24)
    win = h_windows(sorted_args[2], 5, 24, 24, rows)
    calls.clear()
    want = k5.decoder_ll_banded_plain(*sorted_args, (24, 24))
    assert len(calls) == 1
    got = k5.decoder_ll_banded_plain(*sorted_args, (24, 24), win=win)
    assert len(calls) == 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # empty windows drop every template's mass: only the background stays
    empty = k5.decoder_ll_banded_plain(*sorted_args, (24, 24),
                                       win=torch.zeros_like(win))
    assert not torch.equal(empty[0], want[0])
    assert len(calls) == 1


def test_shared_memory_and_threads():
    # K5f: one pixel a thread (or two); a ring of two buffers of `chunk`
    # capsules (one buffer when a chunk holds every capsule), each the
    # capsules' texel-major tables, then their poses and presences, padded
    # to 16 bytes, then a texel of zeros; K5b: K4b's block, one capsule's
    # table and 4 warps' gradient tables and scratch, whatever the band
    assert k5.threads_per_block(40, 40) == 320
    assert k5.threads_per_block(32, 32) == 256
    assert k5.threads_per_block(40, 40, pixels=2) == 160
    assert k5.shared_memory_bytes(1, 11, 11, 14, 40) == \
        4 * (2 * (14 * 2 * 121 + 7 * 14 + 2) + 4)
    assert k5.shared_memory_bytes(1, 11, 11, 40, 40) == \
        4 * (40 * 2 * 121 + 7 * 40 + 4)
    assert k5.bwd_shared_memory_bytes(1, 11, 11) == \
        k4.bwd_shared_memory_bytes(1, 11, 11) == \
        4 * (2 * 121 + 4 * (2 * 121 + 9 * 32))
    # cifar10's backward fits the 48 KB default now; all fit a block
    assert k5.bwd_shared_memory_bytes(3, 11, 11) <= 48 * 1024
    assert k5.bwd_shared_memory_bytes(3, 17, 17) <= SMEM_LIMIT


def test_decoder_pallas_banded_matches_jax():
    """TemplateBasedImageDecoder with fused_impl="pallas_banded" on weights
    carried from flax against the JAX decoder's f32 likelihood: the
    likelihood and the gradients with respect to the decoder's parameters
    and the poses."""
    from scae_tpu.models.part_decoder import TemplateBasedImageDecoder as JD
    from scae_tpu_torch.models.part_decoder import (
        TemplateBasedImageDecoder as TD,
    )
    from scae_tpu_torch.utils.from_flax import load_flax_params

    B, M, C, Ht, Wt, H, W = 2, 6, 1, 5, 5, 24, 24
    templates, _, pose, presence, *_, target = make_inputs(
        (B, M, C, Ht, Wt, H, W), seed=6)
    kw = dict(n_templates=M, template_size=(Ht, Wt), output_size=(H, W),
              use_alpha_channel=True, background_value=True,
              learn_output_scale=True, use_fused_ll=True)
    jd = JD(fused_impl="xla", **kw)
    jargs = [jnp.asarray(a) for a in (templates, pose, presence)]
    params = jd.init(jax.random.PRNGKey(3), *jargs,
                     target=jnp.asarray(target))["params"]
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.randn(*np.shape(p)).astype(
            np.float32), params)
    cot = cotangent((B, M, C, Ht, Wt, H, W))

    def j_loss(p, pose_):
        ll = jd.apply({"params": p}, jargs[0], pose_, jargs[2],
                      target=jnp.asarray(target)).target_ll
        return jnp.sum(ll * cot), ll

    (j_grads, j_gpose), want = jax.jit(jax.grad(
        j_loss, argnums=(0, 1), has_aux=True))(params, jargs[1])

    td = TD(fused_impl="pallas_banded", **kw)
    load_flax_params(td, params)
    p = torch.from_numpy(pose.copy()).requires_grad_()
    ll = td(torch.from_numpy(templates), p, torch.from_numpy(presence),
            target=torch.from_numpy(target)).target_ll
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    (ll * torch.from_numpy(cot)).sum().backward()
    for name, param in td.named_parameters():
        ref = np.asarray(j_grads[name])
        scale = max(float(np.abs(ref).max()), 1.0)
        assert float(np.abs(param.grad.numpy() - ref).max()) <= 1e-4 * scale, \
            name
    ref = np.asarray(j_gpose)
    assert float(np.abs(p.grad.numpy() - ref).max()) \
        <= 1e-4 * float(np.abs(ref).max())


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
