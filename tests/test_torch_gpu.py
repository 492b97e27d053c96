"""K1 (the CUDA gather decoder-likelihood kernel) and K2+K3 (its backward),
K4f and K4b (the dense ones), K5f and K5b (the banded ones), K6 (the set
attention) and the toolchain probes P1 and P2, against their plain PyTorch
versions, on the card; the flagship eval and train steps through them, and
the training CLI.

Needs a CUDA device and nvcc; every test skips without a card. The
decision is taken inside the ``cuda`` fixture, so every pytest worker
collects the same tests. Imports no jax: run on the GPU machine with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: 1e-4 absolute on ll, num and den. Both sides compute the same
f32 formula; they differ only in the order of the log-sum-exp (streaming
in the kernel, whole-axis in the plain version) and in fused multiply-adds,
each worth a few f32 ulps of values of order 10. The backward's outputs:
1e-4 of each output's largest |entry| (of max(|value|, 1) for the three
0-d scalar gradients); they are f32 sums over pixels (and, for a shared
alpha, examples) taken in another order than autograd's. K2+K3's, K4b's
and K5b's repeats bit for bit: they add in a fixed order, without atomics
since the gather backward's redesign. K6: 1e-5 absolute on
outputs of order 1 (the same f32 scores, softmax and products, summed in
another order), and the same bits on repeat. P1: exact (one rounding
either way). P2: 1e-4 absolute, the JAX probe's tolerance, on f32 sums of
128 products of N(0, 1) entries taken in another order than cuBLAS's.
"""

import numpy as np
import pytest
import torch

from scae_tpu_torch.kernels import attention as k6
from scae_tpu_torch.kernels import decoder_ll_banded as k5
from scae_tpu_torch.kernels import decoder_ll_dense as k4
from scae_tpu_torch.kernels import decoder_ll_gather as k1
from scae_tpu_torch.kernels import probe as kp
from scae_tpu_torch.ops.geometry import geometric_transform

pytestmark = pytest.mark.gpu

TOL = 1e-4
BWD_TOL = 1e-4
GRAD_NAMES = ("templates", "alpha", "pose", "presence", "bg_value",
              "bg_mixing_logit", "scale", "target")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(shape, seed=0, pose_noise=0.6, alpha_batched=False):
    B, M, C, Ht, Wt, H, W = shape
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return dict(
        templates=t(rng.rand(B, M, C, Ht, Wt)),
        alpha=t(rng.randn(B if alpha_batched else 1, M, 1, Ht, Wt)),
        pose=geometric_transform(t(rng.randn(B, M, 6) * pose_noise)),
        presence=t(rng.rand(B, M)),
        bg_value=t(0.3), bg_mixing_logit=t(0.7), scale=t(1.0),
        target=t(rng.rand(B, C, H, W)),
    )


def call(fn, a, out_size):
    return fn(a["templates"], a["alpha"], a["pose"], a["presence"],
              a["bg_value"], a["bg_mixing_logit"], a["scale"], a["target"],
              out_size)


def run(fn, inputs, device, out_size):
    return call(fn, {k: v.to(device).contiguous() for k, v in inputs.items()},
                out_size)


def max_err(got, want):
    return max(float((g.cpu() - w.cpu()).abs().max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("shape,pose_noise,alpha_batched", [
    ((8, 40, 1, 11, 11, 40, 40), 0.6, False),    # flagship widths
    ((4, 13, 1, 5, 5, 24, 24), 4.0, False),      # extreme poses, M = 13
    ((2, 16, 3, 14, 14, 32, 32), 0.6, False),    # colour, > 48 KB shared
    ((3, 8, 2, 7, 9, 20, 28), 0.6, True),        # per-example alpha
])
def test_kernel_matches_plain(cuda, shape, pose_noise, alpha_batched):
    inputs = make_inputs(shape, pose_noise=pose_noise,
                         alpha_batched=alpha_batched)
    if pose_noise > 1.0:
        inputs["presence"][:, ::3] = 0.0       # presences exactly 0
    out_size = shape[-2:]
    got = run(k1.decoder_ll_gather, inputs, cuda, out_size)
    torch.cuda.synchronize()
    want = run(k1.decoder_ll_gather_plain, inputs, cuda, out_size)
    assert all(torch.isfinite(g).all() for g in got)
    assert max_err(got, want) < TOL


@pytest.mark.parametrize("bg_value,bg_mix,scale", [
    (0.0, -2.0, 0.25), (0.9, 3.0, 2.5)])
def test_kernel_matches_plain_other_scalars(cuda, bg_value, bg_mix, scale):
    inputs = make_inputs((4, 8, 2, 5, 5, 12, 12), seed=1)
    inputs.update(bg_value=torch.tensor(bg_value),
                  bg_mixing_logit=torch.tensor(bg_mix),
                  scale=torch.tensor(scale))
    got = run(k1.decoder_ll_gather, inputs, cuda, (12, 12))
    torch.cuda.synchronize()
    want = run(k1.decoder_ll_gather_plain, inputs, cuda, (12, 12))
    assert max_err(got, want) < TOL


def test_kernel_counts_launches(cuda):
    inputs = make_inputs((2, 8, 1, 5, 5, 16, 16))
    k1.launches = 0
    run(k1.decoder_ll_gather, inputs, cuda, (16, 16))
    run(k1.decoder_ll_gather, inputs, cuda, (16, 16))
    assert k1.launches == 2
    run(k1.decoder_ll_gather_plain, inputs, cuda, (16, 16))
    assert k1.launches == 2


def test_kernel_rejects_what_it_does_not_take(cuda):
    inputs = {k: v.to(cuda) for k, v in
              make_inputs((2, 8, 1, 5, 5, 16, 16)).items()}
    bad = dict(inputs, pose=inputs["pose"].transpose(0, 1).contiguous()
               .transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        call(k1.decoder_ll_gather, bad, (16, 16))
    bad = dict(inputs, target=inputs["target"].double())
    with pytest.raises(TypeError, match="float32"):
        call(k1.decoder_ll_gather, bad, (16, 16))
    bad = dict(inputs, presence=inputs["presence"].cpu())
    with pytest.raises(ValueError, match="presence is on cpu"):
        call(k1.decoder_ll_gather, bad, (16, 16))
    grad = dict(inputs, templates=inputs["templates"].requires_grad_())
    k1.bwd_launches = 0
    call(k1.decoder_ll_gather, grad, (16, 16))[0].sum().backward()
    assert k1.bwd_launches == 1
    assert bool(torch.isfinite(grad["templates"].grad).all())
    big = make_inputs((1, 64, 4, 16, 16, 16, 16))
    with pytest.raises(ValueError, match="shared memory"):
        run(k1.decoder_ll_gather, big, cuda, (16, 16))


@pytest.mark.parametrize("source", [k1.SOURCE, k1.BWD_SOURCE])
def test_kernel_build_reports_registers(cuda, source):
    info = k1.build_info(source)
    assert info.path.endswith(".so")
    assert "registers" in info.log or info.cached


def test_base_grid_is_the_same_on_the_card(cuda):
    """PyTorch's CUDA division by a scalar multiplies by the reciprocal;
    the grid must not, or the backward kernel and the plain version pick
    other taps at texel boundaries."""
    from scae_tpu_torch.ops.warp import _base_grid

    for size in ((40, 40), (24, 24), (28, 97)):
        for a, b in zip(_base_grid(size, device=cuda), _base_grid(size)):
            assert torch.equal(a.cpu(), b)


def bwd_args(inputs, device, seed=2):
    a = {k: v.to(device).contiguous() for k, v in inputs.items()}
    B, C, H, W = a["target"].shape
    g = torch.from_numpy(np.random.RandomState(seed).randn(
        B, C, H, W).astype(np.float32)).to(device)
    args = (a["templates"], a["alpha"], a["pose"], a["presence"],
            a["bg_value"], a["bg_mixing_logit"], a["scale"], a["target"],
            (H, W))
    return g, args


def check_bwd(got, want):
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        if b.dim() == 0:
            scale = max(scale, 1.0)
        err = float((a - b).abs().max())
        assert err <= BWD_TOL * scale, f"d{name}: {err} vs {scale}"


@pytest.mark.parametrize("shape,pose_noise,alpha_batched", [
    ((8, 40, 1, 11, 11, 40, 40), 0.6, False),    # flagship widths
    ((4, 13, 1, 5, 5, 24, 24), 4.0, False),      # extreme poses, M = 13
    ((2, 16, 3, 14, 14, 32, 32), 0.6, False),    # colour, > 48 KB shared
    ((3, 8, 2, 7, 9, 20, 28), 0.6, True),        # per-example alpha
    ((8, 40, 1, 11, 11, 40, 40), 0.6, True),     # flagship, per-example alpha
    ((4, 64, 3, 11, 11, 32, 32), 0.6, False),    # cifar10: two capsule groups
    ((2, 60, 3, 15, 15, 8, 8), 0.6, True),       # two groups, per-example alpha
])
def test_bwd_kernel_matches_plain(cuda, shape, pose_noise, alpha_batched):
    inputs = make_inputs(shape, pose_noise=pose_noise,
                         alpha_batched=alpha_batched)
    if pose_noise > 1.0:
        inputs["presence"][:, ::3] = 0.0       # presences exactly 0
    g, args = bwd_args(inputs, cuda)
    _, num, den = k1.decoder_ll_gather(*args)
    got = k1.decoder_ll_gather_bwd(g, num, den, *args)
    torch.cuda.synchronize()
    want = k1.decoder_ll_gather_bwd_plain(g, num, den, *args)
    check_bwd(got, want)
    part = k1.decoder_ll_gather_bwd(g, num, den, *args, target_grad=False)
    assert part[7] is None
    check_bwd(part[:7], want[:7])


@pytest.mark.parametrize("bg_value,bg_mix,scale", [
    (0.0, -2.0, 0.25), (0.9, 3.0, 2.5)])
def test_bwd_kernel_matches_plain_other_scalars(cuda, bg_value, bg_mix,
                                                scale):
    inputs = make_inputs((4, 8, 2, 5, 5, 12, 12), seed=1)
    inputs.update(bg_value=torch.tensor(bg_value),
                  bg_mixing_logit=torch.tensor(bg_mix),
                  scale=torch.tensor(scale))
    g, args = bwd_args(inputs, cuda)
    _, num, den = k1.decoder_ll_gather(*args)
    got = k1.decoder_ll_gather_bwd(g, num, den, *args)
    torch.cuda.synchronize()
    check_bwd(got, k1.decoder_ll_gather_bwd_plain(g, num, den, *args))


def test_function_matches_plain_autograd(cuda):
    """Through autograd: the Function on the card against autograd of the
    plain version, with the expanded upstream gradient of a mean and a
    (1,)-shaped scalar."""
    inputs = make_inputs((4, 10, 1, 7, 7, 20, 20), seed=3)
    inputs["bg_value"] = inputs["bg_value"].reshape(1)
    results = []
    for fn in (k1.decoder_ll_gather, k1.decoder_ll_gather_plain):
        leaves = {k: v.to(cuda).contiguous().requires_grad_(k != "target")
                  for k, v in inputs.items()}
        ll = call(fn, leaves, (20, 20))[0]
        ll.mean().backward()
        results.append([leaves[k].grad for k in
                        ("templates", "alpha", "pose", "presence",
                         "bg_value", "bg_mixing_logit", "scale")])
    for name, a, b in zip(GRAD_NAMES, *results):
        scale = max(float(b.abs().max()), 1.0 if b.numel() == 1 else 0.0)
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= BWD_TOL * scale, name


def test_bwd_kernel_counts_launches(cuda):
    g, args = bwd_args(make_inputs((2, 8, 1, 5, 5, 16, 16)), cuda)
    _, num, den = k1.decoder_ll_gather(*args)
    k1.bwd_launches = 0
    k1.decoder_ll_gather_bwd(g, num, den, *args)
    k1.decoder_ll_gather_bwd(g, num, den, *args, target_grad=False)
    assert k1.bwd_launches == 2
    k1.decoder_ll_gather_bwd_plain(g, num, den, *args)
    assert k1.bwd_launches == 2


def test_bwd_kernel_rejects_what_it_does_not_take(cuda):
    g, args = bwd_args(make_inputs((2, 8, 1, 5, 5, 16, 16)), cuda)
    _, num, den = k1.decoder_ll_gather(*args)
    with pytest.raises(ValueError, match="g must be contiguous"):
        k1.decoder_ll_gather_bwd(g.expand(2, 1, 16, 16).transpose(2, 3),
                                 num, den, *args)
    with pytest.raises(TypeError, match="num must be float32"):
        k1.decoder_ll_gather_bwd(g, num.double(), den, *args)
    with pytest.raises(ValueError, match="den is on cpu"):
        k1.decoder_ll_gather_bwd(g, num, den.cpu(), *args)
    # the forward fits in a block's shared memory, the backward's tables
    # do not, even for one capsule per block
    g, args = bwd_args(make_inputs((1, 1, 4, 77, 77, 8, 8)), cuda)
    _, num, den = k1.decoder_ll_gather(*args)
    with pytest.raises(ValueError, match="backward's capsule and gradient"):
        k1.decoder_ll_gather_bwd(g, num, den, *args)


def test_flagship_eval_step_runs_through_kernel(cuda):
    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS, make_scae
    from scae_tpu_torch.parallel.train_step import make_raw_eval_step

    model = make_scae(FLAGSHIP_MODEL_PARAMS, device=cuda, seed=0)
    step = make_raw_eval_step(model, canvas=40, device=cuda)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (16, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (16,))
    k1.launches = 0
    metrics = step(images, labels)
    assert k1.launches == 1
    for name, v in metrics.items():
        assert np.isfinite(float(v)), name


def test_flagship_train_step_runs_through_kernels(cuda):
    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS, make_scae
    from scae_tpu_torch.optim import make_optimizer
    from scae_tpu_torch.parallel.train_step import (
        TrainState,
        make_raw_train_step,
    )
    from scae_tpu_torch.train.loop import make_augment_fn

    model = make_scae(FLAGSHIP_MODEL_PARAMS, device=cuda, seed=0)
    before = [p.detach().clone() for p in model.parameters()]
    state = TrainState(model, make_optimizer(model.parameters(), "rmsprop",
                                             3e-5, batch_size=16))
    step = make_raw_train_step(state, make_augment_fn(40, 6), device=cuda)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (16, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (16,))
    k1.launches = k1.bwd_launches = 0
    metrics = step(images, labels)
    torch.cuda.synchronize()
    assert (k1.launches, k1.bwd_launches) == (1, 1)
    assert state.step == 1
    for name, v in metrics.items():
        assert np.isfinite(float(v)), name
    moved = [not torch.equal(a, b) for a, b in zip(before,
                                                   model.parameters())]
    assert sum(moved) > len(moved) // 2


# identity on a canvas of the template's size puts every pixel on a texel
# centre; the zero pose puts every pixel on the template's centre; twice
# the identity's scale, and a shift by half a texel, put pixels on texel
# edges (whole-number source coordinates) along one or both axes
EDGE_POSES = {
    "identity": ([1, 0, 0, 0, 1, 0], (11, 11)),
    "zero": ([0] * 6, (40, 40)),
    "twice the scale": ([2, 0, 0, 0, 2, 0], (22, 22)),
    "half-texel shift": ([1, 0, 1 / 11, 0, 1, 0], (11, 11)),
}


def edge_inputs(kind, M=40, seed=4):
    one, out_size = EDGE_POSES[kind]
    inputs = make_inputs((4, M, 1, 11, 11) + out_size, seed=seed)
    inputs["pose"] = torch.tensor(one, dtype=torch.float32).repeat(4, M, 1)
    # a checkerboard of 0 and 1 in every template, so that neighbouring
    # taps differ by a whole unit
    board = (torch.arange(11)[:, None] + torch.arange(11)) % 2
    inputs["templates"] = board.float().expand(4, M, 1, 11, 11).contiguous()
    return inputs, out_size


@pytest.mark.parametrize("kind", sorted(EDGE_POSES))
def test_kernel_matches_plain_on_texel_edges(cuda, kind):
    """K1 takes its coordinates from common.cuh::source_coord on the
    wrapper's grid, as the backward does, so at whole-number coordinates
    it picks the plain version's taps. A bilinear sample is continuous
    there, so a forward that picked the other taps would differ only by a
    coordinate's rounding: the check is the tolerance, and the backward's
    at the same poses (test_bwd_kernel_matches_plain_on_texel_centres)."""
    inputs, out_size = edge_inputs(kind)
    got = run(k1.decoder_ll_gather, inputs, cuda, out_size)
    torch.cuda.synchronize()
    want = run(k1.decoder_ll_gather_plain, inputs, cuda, out_size)
    assert all(torch.isfinite(g).all() for g in got)
    assert max_err(got, want) < TOL


@pytest.mark.parametrize("kind", sorted(EDGE_POSES))
def test_bwd_kernel_matches_plain_on_texel_centres(cuda, kind):
    """At whole-number source coordinates the bilinear derivative jumps:
    the backward's texel gather must take the taps phase 1 took."""
    inputs, out_size = edge_inputs(kind)
    g, args = bwd_args(inputs, cuda)
    _, num, den = k1.decoder_ll_gather(*args)
    got = k1.decoder_ll_gather_bwd(g, num, den, *args)
    torch.cuda.synchronize()
    check_bwd(got, k1.decoder_ll_gather_bwd_plain(g, num, den, *args))


# the run-scatter backwards: their forward, their backward, and whether they
# take the banded wrapper's sorted, padded layout
BWD_KERNELS = {
    "K2+K3": (k1.decoder_ll_gather, k1.decoder_ll_gather_bwd, False),
    "K4b": (k4.decoder_ll_dense_fwd, k4.decoder_ll_dense_bwd, False),
    "K5b": (k5.decoder_ll_banded_fwd, k5.decoder_ll_banded_bwd, True),
}


@pytest.mark.parametrize("kernel", sorted(BWD_KERNELS))
@pytest.mark.parametrize("shape,alpha_batched", [
    ((8, 40, 1, 11, 11, 40, 40), False),     # flagship widths
    ((4, 64, 3, 11, 11, 32, 32), True),      # cifar10, per-example alpha
])
def test_bwd_kernel_repeats_bit_for_bit(cuda, kernel, shape, alpha_batched):
    """No floating-point atomics: the same inputs give the same bits, with
    and without the target's gradient."""
    fwd, bwd, banded = BWD_KERNELS[kernel]
    g, args = bwd_args(make_inputs(shape, alpha_batched=alpha_batched), cuda)
    if banded:
        args = (*k5.sort_and_pad(*args[:4]), *args[4:])
    _, num, den = fwd(*args)
    first = bwd(g, num, den, *args)
    again = bwd(g, num, den, *args)
    part = bwd(g, num, den, *args, target_grad=False)
    for a, b, c in zip(first, again, part):
        assert torch.equal(a, b)
        assert c is None or torch.equal(a, c)
    _, num2, den2 = fwd(*args)
    assert torch.equal(num, num2) and torch.equal(den, den2)


@pytest.mark.parametrize("shape", [(128, 40, 1, 11, 11, 40, 40),
                                   (128, 64, 3, 11, 11, 32, 32)])
def test_gather_kernels_fit_on_an_sm(cuda, shape):
    B, M, C, Ht, Wt, H, W = shape
    fwd = k1.blocks_per_sm(k1.SOURCE, M, C, Ht, Wt, 0,
                           k1.forward_buffers(M, C, Ht, Wt))
    bwd = k1.blocks_per_sm(k1.BWD_SOURCE, C, Ht, Wt)
    assert fwd >= 1 and bwd >= 2


# ------------------------------------------------------------ K4f and K4b

DENSE_SHAPES = [
    ((8, 40, 1, 11, 11, 40, 40), 0.6, False),    # flagship widths
    ((4, 13, 1, 5, 5, 24, 24), 4.0, False),      # extreme poses, M = 13
    ((2, 16, 3, 14, 14, 32, 32), 0.6, False),    # colour
    ((3, 8, 2, 7, 9, 20, 28), 0.6, True),        # per-example alpha
    ((2, 6, 1, 17, 17, 24, 24), 0.6, False),     # 289 texels: gather refuses
    ((2, 5, 3, 9, 9, 3000, 1), 0.6, False),      # one output column
]


@pytest.mark.parametrize("shape,pose_noise,alpha_batched", DENSE_SHAPES)
def test_dense_kernels_match_plain(cuda, shape, pose_noise, alpha_batched):
    inputs = make_inputs(shape, pose_noise=pose_noise,
                         alpha_batched=alpha_batched)
    if pose_noise > 1.0:
        inputs["presence"][:, ::3] = 0.0
    g, args = bwd_args(inputs, cuda)
    got = k4.decoder_ll_dense_fwd(*args)
    torch.cuda.synchronize()
    want = k4.decoder_ll_dense_plain(*args)
    assert all(torch.isfinite(x).all() for x in got)
    assert max_err(got, want) < TOL
    _, num, den = got
    got = k4.decoder_ll_dense_bwd(g, num, den, *args)
    again = k4.decoder_ll_dense_bwd(g, num, den, *args)
    torch.cuda.synchronize()
    check_bwd(got, k4.decoder_ll_dense_bwd_plain(g, num, den, *args))
    for a, b in zip(got, again):
        assert torch.equal(a, b)        # no atomics: the same bits
    part = k4.decoder_ll_dense_bwd(g, num, den, *args, target_grad=False)
    assert part[7] is None
    for a, b in zip(part[:7], got[:7]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["identity", "zero"])
def test_dense_kernels_match_plain_on_texel_centres(cuda, kind):
    """Coordinates on texel centres and edges, where the tap derivative
    (-sign, 0 at a centre) has its kinks."""
    inputs = make_inputs((2, 5, 1, 5, 5, 5, 5), seed=4)
    one = [1, 0, 0, 0, 1, 0] if kind == "identity" else [0] * 6
    inputs["pose"] = torch.tensor(one, dtype=torch.float32).repeat(2, 5, 1)
    g, args = bwd_args(inputs, cuda)
    got = k4.decoder_ll_dense_fwd(*args)
    assert max_err(got, k4.decoder_ll_dense_plain(*args)) < TOL
    _, num, den = got
    check_bwd(k4.decoder_ll_dense_bwd(g, num, den, *args),
              k4.decoder_ll_dense_bwd_plain(g, num, den, *args))


def test_dense_function_matches_plain_autograd(cuda):
    inputs = make_inputs((4, 10, 1, 7, 7, 20, 20), seed=3)
    inputs["bg_value"] = inputs["bg_value"].reshape(1)
    results = []
    for device in (cuda, "cpu"):
        leaves = {k: v.to(device).contiguous().requires_grad_(k != "target")
                  for k, v in inputs.items()}
        call(k4.decoder_ll_dense, leaves, (20, 20))[0].mean().backward()
        results.append([leaves[k].grad for k in
                        ("templates", "alpha", "pose", "presence",
                         "bg_value", "bg_mixing_logit", "scale")])
    for name, a, b in zip(GRAD_NAMES, *results):
        scale = max(float(b.abs().max()), 1.0 if b.numel() == 1 else 0.0)
        assert a.shape == b.shape, name
        assert float((a.cpu() - b).abs().max()) <= BWD_TOL * scale, name


def test_dense_kernels_count_launches(cuda):
    g, args = bwd_args(make_inputs((2, 8, 1, 5, 5, 16, 16)), cuda)
    k4.launches = k4.bwd_launches = 0
    _, num, den = k4.decoder_ll_dense_fwd(*args)
    k4.decoder_ll_dense_bwd(g, num, den, *args)
    k4.decoder_ll_dense_bwd(g, num, den, *args, target_grad=False)
    assert (k4.launches, k4.bwd_launches) == (1, 2)
    k4.decoder_ll_dense_plain(*args)
    k4.decoder_ll_dense_bwd_plain(g, num, den, *args)
    assert (k4.launches, k4.bwd_launches) == (1, 2)


def test_dense_kernels_reject_what_they_do_not_take(cuda):
    g, args = bwd_args(make_inputs((2, 8, 1, 5, 5, 16, 16)), cuda)
    bad = list(args)
    bad[7] = args[7].double()
    with pytest.raises(TypeError, match="target must be float32"):
        k4.decoder_ll_dense_fwd(*bad)
    _, num, den = k4.decoder_ll_dense_fwd(*args)
    with pytest.raises(ValueError, match="den is on cpu"):
        k4.decoder_ll_dense_bwd(g, num, den.cpu(), *args)
    big = make_inputs((1, 2, 4, 120, 120, 8, 8))
    with pytest.raises(ValueError, match="shared memory"):
        run(k4.decoder_ll_dense_fwd, big, cuda, (8, 8))


@pytest.mark.parametrize("source", [k4.SOURCE, k4.BWD_SOURCE])
def test_dense_kernel_build_reports_registers(cuda, source):
    info = k4.build_info(source)
    assert info.path.endswith(".so")
    assert "registers" in info.log or info.cached


def test_flagship_pallas_train_step_runs_through_dense_kernels(cuda):
    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS, make_scae
    from scae_tpu_torch.optim import make_optimizer
    from scae_tpu_torch.parallel.train_step import (
        TrainState,
        make_raw_eval_step,
        make_raw_train_step,
    )
    from scae_tpu_torch.train.loop import make_augment_fn

    params = dict(FLAGSHIP_MODEL_PARAMS,
                  pcae_decoder_params=dict(fused_impl="pallas"))
    model = make_scae(params, device=cuda, seed=0)
    state = TrainState(model, make_optimizer(model.parameters(), "rmsprop",
                                             3e-5, batch_size=16))
    step = make_raw_train_step(state, make_augment_fn(40, 6), device=cuda)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (16, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (16,))
    k1.launches = k1.bwd_launches = k4.launches = k4.bwd_launches = 0
    metrics = step(images, labels)
    make_raw_eval_step(model, canvas=40, device=cuda)(images, labels)
    torch.cuda.synchronize()
    assert (k4.launches, k4.bwd_launches) == (2, 1)
    assert (k1.launches, k1.bwd_launches) == (0, 0)
    for name, v in metrics.items():
        assert np.isfinite(float(v)), name


# ------------------------------------------------------------ K5f and K5b

BANDED_SHAPES = [
    # (shape, pose noise, per-example alpha, fixed pose)
    ((8, 40, 1, 11, 11, 40, 40), 0.6, False, None),   # flagship widths
    ((4, 64, 3, 11, 11, 32, 32), 0.6, False, None),   # cifar10: 4 bands
    ((4, 13, 1, 5, 5, 24, 24), 4.0, False, None),     # extreme poses, M = 13
    ((3, 8, 2, 7, 9, 20, 28), 0.6, True, None),       # per-example alpha
    ((2, 6, 1, 17, 17, 24, 24), 0.6, False, None),    # 17x17 templates
    ((2, 8, 1, 11, 11, 40, 40), 0.6, False, ([1, 0, 0, 0, 1, 0], None)),
    ((2, 8, 1, 11, 11, 40, 40), 0.6, False, ([0] * 6, None)),
    # every capsule off the canvas but the first: empty windows (trips = 0)
    ((2, 16, 1, 11, 11, 40, 40), 0.6, False,
     ([1, 0, 3.0, 0, 1, 3.0], [1, 0, 0, 0, 1, 0])),
    # bands of 280 pixels, so warp passes straddle a band boundary, and
    # capsules rotated by 15 degrees spanning both bands, whose windows
    # differ on the two sides (rows 0-4 and 2-6)
    ((2, 8, 1, 7, 9, 20, 28), 0.6, False,
     ([0.9659258, -0.2588190, 0, 0.2588190, 0.9659258, 0], None)),
    ((2, 16, 4, 11, 11, 40, 40), 0.6, False, None),   # C = 4
]


def banded_args(shape, pose_noise, alpha_batched, fixed, device):
    inputs = make_inputs(shape, pose_noise=pose_noise,
                         alpha_batched=alpha_batched)
    if pose_noise > 1.0:
        inputs["presence"][:, ::3] = 0.0
    if fixed is not None:    # (every capsule's pose, the first's or None)
        inputs["pose"][:] = torch.tensor(fixed[0], dtype=torch.float32)
        if fixed[1] is not None:
            inputs["pose"][:, 0] = torch.tensor(fixed[1], dtype=torch.float32)
    g, args = bwd_args(inputs, device)
    # the kernels take the wrapper's layout: padded, sorted, alpha per example
    sorted_args = (*k5.sort_and_pad(*args[:4]), *args[4:])
    return g, sorted_args


@pytest.mark.parametrize("shape,pose_noise,alpha_batched,fixed",
                         BANDED_SHAPES)
def test_banded_kernels_match_plain(cuda, shape, pose_noise, alpha_batched,
                                    fixed):
    g, args = banded_args(shape, pose_noise, alpha_batched, fixed, cuda)
    got = k5.decoder_ll_banded_fwd(*args)
    torch.cuda.synchronize()
    want = k5.decoder_ll_banded_plain(*args)
    assert all(torch.isfinite(x).all() for x in got)
    assert max_err(got, want) < TOL
    _, num, den = got
    got = k5.decoder_ll_banded_bwd(g, num, den, *args)
    again = k5.decoder_ll_banded_bwd(g, num, den, *args)
    torch.cuda.synchronize()
    check_bwd(got, k5.decoder_ll_banded_bwd_plain(g, num, den, *args))
    for a, b in zip(got, again):
        assert torch.equal(a, b)        # no atomics: the same bits
    part = k5.decoder_ll_banded_bwd(g, num, den, *args, target_grad=False)
    assert part[7] is None
    for a, b in zip(part[:7], got[:7]):
        assert torch.equal(a, b)


def test_banded_function_matches_dense_autograd(cuda):
    """Through autograd on the card: the banded likelihood (sorted, padded,
    windowed) against the dense one, with unsorted inputs, M = 13 and a
    shared alpha: the windows drop no mass."""
    inputs = make_inputs((4, 13, 1, 7, 7, 24, 24), seed=3)
    results = []
    for fn in (k5.decoder_ll_banded, k4.decoder_ll_dense):
        leaves = {k: v.to(cuda).contiguous().requires_grad_(k != "target")
                  for k, v in inputs.items()}
        ll = call(fn, leaves, (24, 24))[0]
        ll.mean().backward()
        results.append([ll.detach()] + [leaves[k].grad for k in
                        ("templates", "alpha", "pose", "presence",
                         "bg_value", "bg_mixing_logit", "scale")])
    assert float((results[0][0] - results[1][0]).abs().max()) < TOL
    for name, a, b in zip(GRAD_NAMES, results[0][1:], results[1][1:]):
        scale = max(float(b.abs().max()), 1.0 if b.numel() == 1 else 0.0)
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= BWD_TOL * scale, name


def test_banded_kernels_count_launches(cuda):
    g, args = banded_args((2, 8, 1, 5, 5, 16, 16), 0.6, False, None, cuda)
    k5.launches = k5.bwd_launches = 0
    _, num, den = k5.decoder_ll_banded_fwd(*args)
    k5.decoder_ll_banded_bwd(g, num, den, *args)
    k5.decoder_ll_banded_bwd(g, num, den, *args, target_grad=False)
    assert (k5.launches, k5.bwd_launches) == (1, 2)
    k5.decoder_ll_banded_plain(*args)
    k5.decoder_ll_banded_bwd_plain(g, num, den, *args)
    assert (k5.launches, k5.bwd_launches) == (1, 2)


def test_banded_kernels_reject_what_they_do_not_take(cuda):
    g, args = banded_args((2, 8, 1, 5, 5, 16, 16), 0.6, False, None, cuda)
    bad = list(args)
    bad[1] = args[1][:1].contiguous()
    with pytest.raises(ValueError, match="alpha per example"):
        k5.decoder_ll_banded_fwd(*bad)
    bad = list(args)
    bad[:4] = [x[:, :5].contiguous() for x in args[:4]]
    with pytest.raises(ValueError, match="groups of 8"):
        k5.decoder_ll_banded_fwd(*bad)
    # a canvas two rows high: no divisor of 2 gives a band of 512 or fewer
    _, args = banded_args((1, 8, 1, 5, 5, 2, 600), 0.6, False, None, cuda)
    with pytest.raises(ValueError, match="band of 600 pixels"):
        k5.decoder_ll_banded_fwd(*args)


@pytest.mark.parametrize("source", [k5.SOURCE, k5.BWD_SOURCE])
def test_banded_kernel_build_reports_registers(cuda, source):
    info = k5.build_info(source)
    assert info.path.endswith(".so")
    assert "registers" in info.log or info.cached


# ------------------------------------------------------------------- K6

def attention_inputs(B, N, M, dk, dv, seed=0, presence="soft"):
    """Q, K, V from N(0, 1) and presences of one kind: "soft" in [0, 1)
    ("zero": one set all absent), where the 1e9 penalties make the softmax
    one-hot on the largest presence, whatever the scores; "ones" (what
    ``qkv_attention`` builds when given none) and "binary", where the
    weights follow the scores; "near one", 1 or the two f32 values just
    below it, where the order of mask and scale shows too."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    p = rng.rand(B, M)
    q, k, v = rng.randn(B, N, dk), rng.randn(B, M, dk), rng.randn(B, M, dv)
    if presence == "zero":
        p[0] = 0.0
    elif presence == "ones":
        p = np.ones((B, M))
    elif presence == "binary":
        p = (p < 0.5).astype(np.float64)
    elif presence == "near one":
        p = 1.0 - np.floor(p * 3) * 2.0 ** -24
    return t(q), t(k), t(v), t(p)


@pytest.mark.parametrize("B,N,M,dk,dv", [
    (128, 40, 40, 16, 16),     # the flagship's set-attention blocks
    (128, 32, 40, 256, 256),   # its final attention, > 48 KB shared memory
    (3, 5, 7, 10, 6),          # nothing a power of two
])
@pytest.mark.parametrize("presence",
                         ["soft", "zero", "ones", "binary", "near one"])
def test_attention_kernel_matches_plain(cuda, B, N, M, dk, dv, presence):
    args = [x.to(cuda) for x in
            attention_inputs(B, N, M, dk, dv, presence=presence)]
    got = k6.attention(*args)
    again = k6.attention(*args)
    torch.cuda.synchronize()
    want = k6.attention_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) < 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize("presence", ["soft", "binary"])
def test_attention_function_matches_plain_autograd(cuda, presence):
    """qkv_attention(use_pallas=True) on the card, K6 forward and the plain
    path's backward, against the plain path's autograd."""
    from scae_tpu_torch.ops.attention import qkv_attention

    inputs = attention_inputs(4, 6, 9, 16, 8, seed=1, presence=presence)
    results = []
    for use_pallas in (True, False):
        leaves = [x.to(cuda).requires_grad_() for x in inputs]
        out = qkv_attention(*leaves, use_pallas=use_pallas)
        (out ** 2).sum().backward()
        results.append([out.detach()] + [x.grad for x in leaves])
    for name, a, b in zip(("out", "q", "k", "v", "p"), *results):
        # under binary presences d/dp carries the mask's 1e9 at full
        # weight: held within 1e-5 of its largest entry
        tol = 1e-5 * (float(b.abs().max())
                      if name == "p" and presence == "binary" else 1.0)
        assert float((a - b).abs().max()) < tol, name


def test_attention_kernel_counts_launches_and_rejects(cuda):
    args = [x.to(cuda) for x in attention_inputs(2, 3, 4, 8, 8)]
    k6.launches = 0
    k6.attention(*args)
    k6.attention_plain(*args)
    assert k6.launches == 1
    with pytest.raises(ValueError, match="contiguous"):
        k6.attention(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                     *args[1:])
    with pytest.raises(TypeError, match="float32"):
        k6.attention(args[0].double(), *args[1:])
    big = [x.to(cuda) for x in attention_inputs(1, 64, 64, 512, 512)]
    with pytest.raises(ValueError, match="shared memory"):
        k6.attention(*big)


def test_attention_kernel_build_reports_registers(cuda):
    info = k6.build_info()
    assert info.path.endswith(".so")
    assert "registers" in info.log or info.cached


def test_flagship_banded_train_step_runs_through_k5_and_k6(cuda):
    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS, make_scae
    from scae_tpu_torch.optim import make_optimizer
    from scae_tpu_torch.parallel.train_step import (
        TrainState,
        make_raw_eval_step,
        make_raw_train_step,
    )
    from scae_tpu_torch.train.loop import make_augment_fn

    params = dict(FLAGSHIP_MODEL_PARAMS,
                  pcae_decoder_params=dict(fused_impl="pallas_banded"))
    model = make_scae(params, device=cuda, seed=0)
    model.obj_encoder.use_pallas_attention = True
    state = TrainState(model, make_optimizer(model.parameters(), "rmsprop",
                                             3e-5, batch_size=16))
    step = make_raw_train_step(state, make_augment_fn(40, 6), device=cuda)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (16, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (16,))
    k5.launches = k5.bwd_launches = k6.launches = 0
    k4.launches = k4.bwd_launches = k1.launches = k1.bwd_launches = 0
    metrics = step(images, labels)
    torch.cuda.synchronize()
    assert (k5.launches, k5.bwd_launches, k6.launches) == (1, 1, 4)
    make_raw_eval_step(model, canvas=40, device=cuda)(images, labels)
    torch.cuda.synchronize()
    assert (k5.launches, k5.bwd_launches, k6.launches) == (2, 1, 8)
    assert (k1.launches, k1.bwd_launches, k4.launches, k4.bwd_launches) \
        == (0, 0, 0, 0)
    for name, v in metrics.items():
        assert np.isfinite(float(v)), name


# ------------------------------------------------------------- P1, P2

@pytest.mark.parametrize("shape", [(8, 128), (1000, 777), (1, 1)])
def test_affine_probe_matches_plain(cuda, shape):
    x = torch.from_numpy((np.random.RandomState(0).randn(*shape) * 100)
                         .astype(np.float32)).to(cuda)
    assert torch.equal(kp.affine_probe(x), kp.affine_probe_plain(x))


@pytest.mark.parametrize("M,K,N", [(256, 128, 256), (100, 37, 53),
                                   (1, 1, 1), (17, 300, 5)])
def test_matmul_probe_matches_plain(cuda, M, K, N):
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(K, N).astype(np.float32)).to(cuda)
    got = kp.matmul_probe(a, b)
    assert got.shape == (M, N)
    assert float((got - kp.matmul_probe_plain(a, b)).abs().max()) < TOL


def test_probes_count_launches_and_reject(cuda):
    from scae_tpu_torch.kernels import _build
    from scae_tpu_torch.kernels._common import raise_on

    x = torch.ones(8, 128, device=cuda)
    kp.affine_launches = kp.matmul_launches = 0
    kp.affine_probe(x)
    kp.matmul_probe(x, x.t().contiguous())
    kp.affine_probe_plain(x)
    assert (kp.affine_launches, kp.matmul_launches) == (1, 1)
    with pytest.raises(TypeError, match="float32"):
        kp.affine_probe(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        kp.matmul_probe(x, x.t())
    with pytest.raises(ValueError, match="inner sizes"):
        kp.matmul_probe(x, x)
    with pytest.raises(ValueError, match="2-D"):
        kp.affine_probe(x[None])
    # a launch the C launcher refuses (no elements) comes back as an error
    # code, which the wrappers' raise_on turns into an exception
    fn, err, _ = _build.load(kp.SOURCE, *kp._AFFINE)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    rc = fn(x.data_ptr(), x.data_ptr(), 0, stream)
    assert rc != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        raise_on(rc, err, "P1 (affine probe)")
    assert (kp.affine_launches, kp.matmul_launches) == (1, 1)


def test_probe_entry_point_runs_the_probes(cuda, capsys):
    from scae_tpu_torch.tools import probe as probe_tool

    kp.affine_launches = kp.matmul_launches = 0
    assert probe_tool.main(device=cuda) == 0
    out = capsys.readouterr().out
    assert "probe ok: True" in out and "probe matmul ok: True" in out
    assert (kp.affine_launches, kp.matmul_launches) == (1, 1)


def test_probe_kernel_build_reports_registers(cuda):
    info = kp.build_info()
    assert info.path.endswith(".so")
    assert "registers" in info.log or info.cached


# ------------------------------------------------------------- trainer

def test_trainer_cli_runs_through_kernels(cuda, tmp_path, monkeypatch):
    """The training CLI at small widths on the card: K2+K3 once per train
    step, K1 once per train step and per eval batch, nothing else."""
    from scae_tpu_torch.train import cli

    monkeypatch.setenv("SCAE_TPU_NO_TENSORBOARD", "1")
    argv = ["data_loader.batch_size=16", "data_loader.source=synthetic",
            "data_loader.synthetic_train=96", "data_loader.val_size=32",
            "data_loader.synthetic_test=20", "trainer.max_epochs=1",
            "trainer.log_every_steps=2", "trainer.max_eval_batches=1",
            f"trainer.checkpoint_dir={tmp_path}/ckpt",
            f"trainer.log_dir={tmp_path}/logs",
            "model.n_part_caps=8", "model.n_obj_caps=4",
            "model.pcae_cnn_encoder_params.out_channels=[16,16,16,16]",
            "model.ocae_encoder_set_transformer_params.dim_out=16",
            "model.ocae_decoder_capsule_params.dim_caps=8",
            "model.ocae_decoder_capsule_params.hidden_sizes=[16]"]
    k1.launches = k1.bwd_launches = 0
    k4.launches = k4.bwd_launches = k5.launches = k5.bwd_launches = 0
    k6.launches = 0
    state = cli.main(argv)
    torch.cuda.synchronize()
    assert state.step == 4
    assert (k1.launches, k1.bwd_launches) == (4 + 1, 4)
    assert (k4.launches, k4.bwd_launches, k5.launches, k5.bwd_launches,
            k6.launches) == (0, 0, 0, 0, 0)
    metrics = cli.main(argv + ["mode=test"])
    assert np.isfinite(metrics["test_loss"])
    assert any(k.startswith("test_class") for k in metrics)
