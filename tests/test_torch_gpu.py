"""K1 (the CUDA gather decoder-likelihood kernel) and K2+K3 (its backward),
K4f and K4b (the dense ones), K5f and K5b (the banded ones), K6 (the set
attention) and the toolchain probes P1 and P2, against their plain PyTorch
versions, on the card; the flagship eval and train steps through them, the
training CLI, and the train and eval scans' CUDA graphs against the eager
steps (bit for bit, with cuDNN's deterministic algorithms).

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
    ((2, 6, 1, 17, 17, 24, 24), 0.6, False),     # 289 texels: auto takes xla
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


@pytest.mark.parametrize("shape,pose_noise,alpha_batched", DENSE_SHAPES)
def test_dense_forward_repeats_bit_for_bit(cuda, shape, pose_noise,
                                           alpha_batched):
    """K4f's ring and pixel tiles sum each pixel's capsules in one order:
    the same inputs give the same bits."""
    _, args = bwd_args(make_inputs(shape, pose_noise=pose_noise,
                                   alpha_batched=alpha_batched), cuda)
    first = k4.decoder_ll_dense_fwd(*args)
    again = k4.decoder_ll_dense_fwd(*args)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("plan", [(7, 9), (17, 17), (40, 40), (60, 75),
                                  (75, 75)])
def test_dense_forward_plans_match_plain(cuda, C, plan):
    """Every instantiation (C) and the rings the planner picks for these
    template sizes (``plan``: Ht x Wt; chunks of 32, 16, 8, 2 and 1
    capsules, rings of up to 225,088 B), M = 13 (a last chunk that is not
    full), per-example alpha, a canvas of 19 x 21 pixels that no tiling
    covers exactly."""
    shape = (3, 13, C) + plan + (19, 21)
    _, args = bwd_args(make_inputs(shape, alpha_batched=True), cuda)
    got = k4.decoder_ll_dense_fwd(*args)
    assert max_err(got, k4.decoder_ll_dense_plain(*args)) < TOL


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


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("pixels", [1, 2])
@pytest.mark.parametrize("chunk", [1, 3, 8, 13, 40])
def test_banded_forward_plans_match_plain(cuda, C, pixels, chunk):
    """K5f's instantiations with rings of ``chunk`` capsules: one (the
    floor), chunks that straddle groups and end in a partial one, whole
    groups, and all 40 in one buffer; one or two pixels a thread, and a
    band of 280 pixels with capsules whose windows differ by band."""
    g, args = banded_args((2, 40, C, 7, 9, 20, 28), 0.6, False, None, cuda)
    H, W = args[-1]
    plan = dict(threads=k5.threads_per_block(H, W, pixels), pixels=pixels,
                chunk=chunk)
    got = k5._launch(*args, plan=plan)
    again = k5._launch(*args, plan=plan)
    torch.cuda.synchronize()
    assert max_err(got, k5.decoder_ll_banded_plain(*args)) < TOL
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_banded_forward_plan_fits_on_an_sm(cuda):
    """The planner's plan at the flagship: blocks per SM on the card at
    least the registers' count that sized the ring, minus one for the
    runtime's share."""
    shape = (128, 40, 1, 11, 11, 40, 40)
    p = k5.forward_plan(shape, k5.fwd_registers(1))
    assert p["threads"] == 320 and p["blocks"] == 640
    per_sm = k5.blocks_per_sm(1, 40, 11, 11, p["threads"], p["pixels"],
                              p["chunk"])
    assert per_sm >= p["register_blocks"] - 1


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


@pytest.mark.parametrize("B,N,M,dk,dv", [
    (3, 17, 45, 68, 132),    # a last tile of one row, keys past 32, values past 128
    (2, 9, 33, 12, 12),      # value teams of 4 lanes, a V row padded to 16
    (2, 33, 70, 20, 260),    # keys past 64, a second pass of values
    (2, 7, 5, 4, 8),         # value teams of 1 and 2 lanes
])
@pytest.mark.parametrize("presence", ["binary", "near one", "zero"])
def test_attention_kernel_matches_plain_across_tiles(cuda, B, N, M, dk, dv,
                                                     presence):
    """Shapes whose N, M, d_k and d_v straddle K6's tiles: rows per block,
    keys per lane pass, value chunks per lane and lane teams."""
    args = [x.to(cuda) for x in
            attention_inputs(B, N, M, dk, dv, seed=2, presence=presence)]
    got = k6.attention(*args)
    again = k6.attention(*args)
    want = k6.attention_plain(*args)
    assert float((got - want).abs().max()) < 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize("tile_plan", [
    ((1, 40, 256, 256), dict(rows_per_warp=1, warps=1, vec=True)),
    ((32, 40, 256, 256), dict(rows_per_warp=2, warps=8, vec=True)),
    ((5, 40, 20, 20), dict(rows_per_warp=2, warps=3, vec=True)),
    ((32, 40, 255, 256), dict(rows_per_warp=2, warps=8, vec=False)),
    ((1, 40, 255, 257), dict(rows_per_warp=1, warps=1, vec=False)),
])
def test_attention_kernel_plans_match_plain(cuda, tile_plan):
    """Every instantiation (rows per warp, 16-byte or 4-byte), reached
    through shapes (N, M, d_k, d_v) whose plan the test names: one query
    row, the flagship's final attention, a tile of 3 warps whose last
    warp has one row, d_k not a multiple of 4."""
    shape, want = tile_plan
    assert {k: k6.plan(*shape)[k] for k in want} == want
    args = [x.to(cuda) for x in
            attention_inputs(4, *shape, seed=3, presence="binary")]
    got = k6.attention(*args)
    assert float((got - k6.attention_plain(*args)).abs().max()) < 1e-5


def test_attention_kernel_takes_unaligned_inputs(cuda):
    """Contiguous inputs at a storage offset of one float, off the 16-byte
    boundary: K6 takes its 4-byte path and agrees with the plain
    version."""
    args = attention_inputs(4, 40, 40, 16, 16, seed=4, presence="binary")

    def shifted(x):
        store = torch.empty(x.numel() + 1, device=cuda)
        view = store[1:].view(x.shape)
        view.copy_(x.to(cuda))
        return view

    q, k, v = (shifted(x) for x in args[:3])
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    p = args[3].to(cuda)
    assert not k6.plan(40, 40, 16, 16, False)["vec"]
    got = k6.attention(q, k, v, p)
    want = k6.attention_plain(q, k, v, p)
    assert float((got - want).abs().max()) < 1e-5
    assert torch.equal(got, k6.attention(q, k, v, p))


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


@pytest.mark.parametrize("tile", kp.MATMUL_TILES)
@pytest.mark.parametrize("kc", [4, 64, 128])
@pytest.mark.parametrize("M,K,N,offset", [(256, 128, 256, 0),
                                          (100, 37, 53, 0), (17, 300, 5, 0),
                                          (33, 132, 68, 1)])
def test_matmul_probe_tiles_match_plain(cuda, tile, kc, M, K, N, offset):
    """Every tile P2 is built for, K in one chunk, two or more, ragged
    edges, and inputs that start 4 bytes past a 16-byte boundary (the
    4-byte copies though K and N are multiples of 4)."""
    rng = np.random.RandomState(2)

    def card(shape):
        flat = torch.from_numpy(rng.randn(offset + shape[0] * shape[1])
                                .astype(np.float32)).to(cuda)
        return flat[offset:].view(shape)

    a, b = card((M, K)), card((K, N))
    got = kp._matmul_launch(a, b, kp.matmul_plan(M, K, N, tile, kc))
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
    step, K1 once per train step and per eval batch, nothing else, in the
    profiler's device records. The scans replay graphs, so the wrappers
    launch for the warm-up steps and the captures only: the train scan's
    warm-up step and its one capture, the eval scan's one batch (its
    warm-up step)."""
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
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS

    run = {}
    # one window: the CLI runs once
    ran = kernel_records(lambda: run.update(state=cli.main(argv)), None,
                         windows=1)
    assert run["state"].step == 4
    assert ran == dict(dict.fromkeys(KERNEL_NAMES, 0), K1=4 + 1,
                       **{"K2+K3": 4})
    assert (k1.launches, k1.bwd_launches) == (WARMUP_STEPS + 1 + 1,
                                              WARMUP_STEPS + 1)
    assert (k4.launches, k4.bwd_launches, k5.launches, k5.bwd_launches,
            k6.launches) == (0, 0, 0, 0, 0)
    metrics = cli.main(argv + ["mode=test"])
    assert np.isfinite(metrics["test_loss"])
    assert any(k.startswith("test_class") for k in metrics)


# ----------------------------------------------------- graph scans

GRAPH_MODEL = dict(
    image_shape=(1, 24, 24), n_classes=10, n_part_caps=8, n_obj_caps=4,
    pcae_cnn_encoder_params=dict(out_channels=[16] * 4),
    pcae_template_generator_params=dict(template_size=(5, 5)),
    ocae_encoder_set_transformer_params=dict(dim_hidden=16, dim_out=16),
    ocae_decoder_capsule_params=dict(dim_caps=8, hidden_sizes=(16,)))
# per path: fused_impl, the attention flag, launches per train step
GRAPH_PATHS = {
    "gather": ("auto", False, {"K1": 1, "K2+K3": 1}),
    "dense": ("pallas", False, {"K4f": 1, "K4b": 1}),
    "banded": ("pallas_banded", True, {"K5f": 1, "K5b": 1, "K6": 4}),
}
# graph against eager on the card, both with cuDNN's deterministic
# algorithms: the same kernels in the same order, so the same bits. The
# eval rows: 1e-4 relative (an eval step's metrics, the same kernels; held
# loosely, as chip_smoke.py holds a default-cuDNN graph step's losses)
GRAPH_LOSS_RTOL = 1e-4


@pytest.fixture
def deterministic(cuda):
    """cuDNN's deterministic algorithms for the test: its default ones may
    add in another order from run to run, and RMSprop's small eps turns
    that into visible parameter gaps between any two runs."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = before


def graph_counts():
    return {"K1": k1.launches, "K2+K3": k1.bwd_launches, "K4f": k4.launches,
            "K4b": k4.bwd_launches, "K5f": k5.launches,
            "K5b": k5.bwd_launches, "K6": k6.launches}


def zero_graph_counts():
    k1.launches = k1.bwd_launches = k4.launches = k4.bwd_launches = 0
    k5.launches = k5.bwd_launches = k6.launches = 0


# the kernels' names in the profiler's records
KERNEL_NAMES = {"K1": "decoder_ll_gather_fwd_kernel",
                "K2+K3": "decoder_ll_gather_bwd_kernel",
                "K4f": "decoder_ll_dense_fwd_kernel",
                "K4b": "decoder_ll_dense_bwd_kernel",
                "K5f": "decoder_ll_banded_fwd_kernel",
                "K5b": "decoder_ll_banded_bwd_kernel",
                "K6": "attention_fwd_kernel"}


def kernel_records(fn, want, windows=3):
    """How many times each kernel ran on the card in one call of ``fn``,
    from torch.profiler's device records, which also record the kernels
    of a replayed graph. Each window opens with spins of PyTorch's sleep
    kernel: the profiler may lose the records of a window's first
    launches. A window whose counts differ from ``want`` is taken again,
    up to ``windows`` windows; the last window's counts are returned."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(200_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        got = {k: sum(e.count for e in events if name in e.key)
               for k, name in KERNEL_NAMES.items()}
        if got == want:
            break
    return got


def graph_state(cuda, path, seed=0):
    from scae_tpu_torch.factory import make_scae
    from scae_tpu_torch.optim import make_optimizer
    from scae_tpu_torch.parallel.train_step import TrainState

    impl, attention, _ = GRAPH_PATHS[path]
    model = make_scae(dict(GRAPH_MODEL, pcae_decoder_params=dict(
        fused_impl=impl)), device=cuda, seed=seed)
    model.obj_encoder.use_pallas_attention = attention
    return TrainState(model, make_optimizer(model.parameters(), "rmsprop",
                                            1e-3, batch_size=8), seed=3)


def graph_data(cuda, n=64, seed=0):
    rng = np.random.RandomState(seed)
    data = {"image": torch.from_numpy(rng.randint(
                0, 256, (n, 20, 20)).astype(np.uint8)).to(cuda),
            "label": torch.from_numpy(rng.randint(0, 10, (n,))).to(cuda)}
    idxs = np.stack([rng.permutation(n)[:8] for _ in range(12)])
    return data, idxs


def eager_rows(state, data, idxs, augment, cuda):
    from scae_tpu_torch.parallel.train_step import make_fused_train_step

    step = make_fused_train_step(state, augment, cuda)
    rows = [step(data, idx) for idx in idxs]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def assert_same_runs(got, want, got_state, want_state):
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (name, a), b in zip(got_state.model.named_parameters(),
                            want_state.model.parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_graph_scan_equals_eager_steps(deterministic, path):
    """Noise and translation on: the scan's warm-up row runs eagerly, the
    next 4 replay the captured step; the same rows through the eager fused
    step from the same state. The wrappers launch once each, into the
    capture; the replays call none."""
    from scae_tpu_torch.parallel import train_step as ts
    from scae_tpu_torch.train.loop import make_augment_fn

    cuda = deterministic
    augment = make_augment_fn(canvas=24, max_shift=2)
    data, idxs = graph_data(cuda)
    graph, eager = graph_state(cuda, path), graph_state(cuda, path)
    scan = ts.make_train_scan(augment, cuda)
    w = ts.WARMUP_STEPS
    scan(graph, data, idxs[:w])
    eager_rows(eager, data, idxs[:w], augment, cuda)
    per_step = GRAPH_PATHS[path][2]
    zero_graph_counts()
    _, got = scan(graph, data, idxs[w:w + 4])
    torch.cuda.synchronize()
    assert graph_counts() == {k: per_step.get(k, 0)
                              for k in graph_counts()}
    want = eager_rows(eager, data, idxs[w:w + 4], augment, cuda)
    assert graph.step == eager.step == w + 4
    assert all(v.shape == (4,) for v in got.values())
    assert_same_runs(got, want, graph, eager)


def test_graph_survives_a_restore_in_place(deterministic):
    """A graph captured before ``load_state_dict`` replays the restored
    state: the same 2 steps again give the same bits, and no capture is
    made anew."""
    from scae_tpu_torch.parallel import train_step as ts
    from scae_tpu_torch.train.loop import make_augment_fn

    captures = []

    class Counting(ts.StepGraph):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            captures.append(self)

    cuda = deterministic
    augment = make_augment_fn(canvas=24, max_shift=2)
    data, idxs = graph_data(cuda)
    state = graph_state(cuda, "gather")
    scan = ts.make_train_scan(augment, cuda)
    orig = ts.StepGraph
    ts.StepGraph = Counting
    try:
        scan(state, data, idxs[:5])
        saved = ({k: v.clone() for k, v in state.model.state_dict().items()},
                 state.optimizer.state_dict(), state.step)
        _, first = scan(state, data, idxs[5:7])
        after = [p.detach().clone() for p in state.model.parameters()]
        # train on, then restore in place
        scan(state, data, idxs[7:9])
        state.model.load_state_dict(saved[0])
        state.optimizer.load_state_dict(saved[1])
        state.step = saved[2]
        _, again = scan(state, data, idxs[5:7])
    finally:
        ts.StepGraph = orig
    assert len(captures) == 1
    for k in first:
        assert torch.equal(first[k], again[k]), k
    for a, b in zip(state.model.parameters(), after):
        assert torch.equal(a, b)


def test_graph_scans_count_launches_per_replay(cuda):
    """The kernels that the train and eval scans' replays run, from the
    profiler's device records: K1 and K2+K3 once per train step, K1 once
    per eval step, with no wrapper called; eval rows equal the eager eval
    step's."""
    from scae_tpu_torch.parallel import train_step as ts
    from scae_tpu_torch.train.loop import make_augment_fn

    data, idxs = graph_data(cuda)
    state = graph_state(cuda, "gather")
    scan = ts.make_train_scan(make_augment_fn(canvas=24, max_shift=2), cuda)
    eval_scan = ts.make_eval_scan(state.model, canvas=24, device=cuda)
    eval_step = ts.make_fused_eval_step(state.model, canvas=24, device=cuda)
    # the warm-up rows and the captures
    scan(state, data, idxs[:2])
    eval_scan(data, idxs[:2])
    torch.cuda.synchronize()
    none = dict.fromkeys(KERNEL_NAMES, 0)
    for chunk in (idxs[2:6], idxs[6:11]):
        zero_graph_counts()
        ran = kernel_records(lambda: scan(state, data, chunk),
                             dict(none, K1=len(chunk), **{
                                 "K2+K3": len(chunk)}))
        assert ran == dict(none, K1=len(chunk), **{"K2+K3": len(chunk)})
        got = {}
        ran = kernel_records(lambda: got.update(eval_scan(data, chunk)),
                             dict(none, K1=len(chunk)))
        assert ran == dict(none, K1=len(chunk))
        assert graph_counts() == none
        for j, idx in enumerate(chunk):
            want = eval_step(data, idx)
            for k in want:
                assert torch.allclose(got[k][j], want[k],
                                      rtol=GRAPH_LOSS_RTOL,
                                      atol=GRAPH_LOSS_RTOL), k


def test_capture_survives_a_graph_freed_by_the_collector(deterministic):
    """A dropped scan whose graphs sit in a reference cycle becomes garbage
    while another scan's step is captured (its augmentation drops the last
    reference to the cycle under capture), with the collector set to run
    at nearly every allocation. The collector stays off during a capture,
    so the old graphs are freed after it and not during it, which CUDA
    refuses and which would invalidate the capture; the new scan gives the
    eager loop's bits."""
    import gc
    import weakref

    from scae_tpu_torch.parallel import train_step as ts
    from scae_tpu_torch.train.loop import make_augment_fn

    cuda = deterministic
    augment = make_augment_fn(canvas=24, max_shift=2)
    data, idxs = graph_data(cuda)
    old = graph_state(cuda, "gather")
    old_scan = ts.make_train_scan(augment, cuda)
    old_scan(old, data, idxs[:3])
    cycle = [old_scan, old]
    cycle.append(cycle)
    holder, gone = [cycle], weakref.ref(old_scan)
    del cycle, old_scan, old

    def dropping_augment(batch, generator):
        if torch.cuda.is_current_stream_capturing():
            holder.clear()
        return augment(batch, generator)

    graph, eager = graph_state(cuda, "gather"), graph_state(cuda, "gather")
    scan = ts.make_train_scan(dropping_augment, cuda)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        _, got = scan(graph, data, idxs[:5])
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    assert not holder and gone() is None
    want = eager_rows(eager, data, idxs[:5], augment, cuda)
    assert_same_runs(got, want, graph, eager)


# each replay's optimizer numbers differ from the last: the rate halves
# every 2 steps, Adam's bias corrections move every step, RAdam switches
# from its SGD branch to the rectified one at step 6 and LookAhead syncs
# every 3 steps
GRAPH_OPTIMIZERS = {
    "rmsprop decaying": dict(name="rmsprop", lr_decay_rate=0.5,
                             decay_steps=2),
    "adam decaying": dict(name="adam", lr_decay_rate=0.5, decay_steps=2),
    "radam lookahead": dict(name="radam", use_lookahead=True,
                            lookahead_k=3),
}


@pytest.mark.parametrize("optimizer", sorted(GRAPH_OPTIMIZERS))
def test_graph_scan_follows_the_optimizers_numbers(deterministic,
                                                   optimizer):
    """One warm-up row, then 8 replays in two chunks, against the eager
    fused step from the same state, bit for bit: each replay reads its
    own step's numbers and branch."""
    from scae_tpu_torch.factory import make_scae
    from scae_tpu_torch.optim import make_optimizer
    from scae_tpu_torch.parallel import train_step as ts
    from scae_tpu_torch.train.loop import make_augment_fn

    cuda = deterministic
    augment = make_augment_fn(canvas=24, max_shift=2)
    data, idxs = graph_data(cuda)
    states = []
    for _ in range(2):
        model = make_scae(GRAPH_MODEL, device=cuda, seed=0)
        states.append(ts.TrainState(model, make_optimizer(
            model.parameters(), learning_rate=1e-3, batch_size=8,
            **GRAPH_OPTIMIZERS[optimizer]), seed=3))
    graph, eager = states
    scan = ts.make_train_scan(augment, cuda)
    w = ts.WARMUP_STEPS
    got = [scan(graph, data, rows)[1]
           for rows in (idxs[:w], idxs[w:w + 3], idxs[w + 3:w + 8])]
    got = {k: torch.cat([g[k] for g in got]) for k in got[0]}
    want = eager_rows(eager, data, idxs[:w + 8], augment, cuda)
    assert graph.step == eager.step == w + 8
    assert_same_runs(got, want, graph, eager)


def test_trainer_graph_scan_equals_an_eager_trainer(deterministic, tmp_path,
                                                    monkeypatch):
    """The training CLI at small width over 2 epochs of 4 steps, the rate
    halved at the epoch boundary, an eval between: the JSONL losses of the
    graph scans equal, bit for bit, those of a run whose Trainer scans
    through the eager loop (``make_eager_train_scan``)."""
    from scae_tpu_torch.parallel.train_step import make_eager_train_scan
    from scae_tpu_torch.train import cli, loop

    monkeypatch.setenv("SCAE_TPU_NO_TENSORBOARD", "1")

    def argv(tag):
        return ["data_loader.batch_size=16", "data_loader.source=synthetic",
                "data_loader.synthetic_train=96", "data_loader.val_size=32",
                "data_loader.synthetic_test=20", "trainer.max_epochs=2",
                "trainer.log_every_steps=1", "trainer.max_eval_batches=1",
                "lr_scheduler.decay_rate=0.5",
                f"trainer.checkpoint_dir={tmp_path}/{tag}/ckpt",
                f"trainer.log_dir={tmp_path}/{tag}/logs",
                "model.n_part_caps=8", "model.n_obj_caps=4",
                "model.pcae_cnn_encoder_params.out_channels=[16,16,16,16]",
                "model.ocae_encoder_set_transformer_params.dim_out=16",
                "model.ocae_decoder_capsule_params.dim_caps=8",
                "model.ocae_decoder_capsule_params.hidden_sizes=[16]"]

    def records(tag):
        import json
        with open(tmp_path / tag / "logs" / "metrics.jsonl") as f:
            return [r for r in map(json.loads, f) if "images_per_sec" in r]

    cli.main(argv("graph"))
    monkeypatch.setattr(loop, "make_train_scan", make_eager_train_scan)
    cli.main(argv("eager"))
    got, want = records("graph"), records("eager")
    assert [r["step"] for r in got] == list(range(1, 9))
    assert [r["step"] for r in want] == list(range(1, 9))
    assert got[-1]["learning_rate"] < got[0]["learning_rate"]
    for g, w in zip(got, want):
        for k in w:
            if k not in ("time", "images_per_sec"):
                assert g[k] == w[k], (k, g["step"])


# ------------------------------------------------ serving's CUDA graphs

def serving_surfaces(cuda, tmp_path, flag):
    """The live infer function and a loaded polymorphic-batch artifact of
    one model at test width (the attention flag ``flag``)."""
    from scae_tpu_torch import serve
    from scae_tpu_torch.factory import make_scae

    model = make_scae(dict(GRAPH_MODEL, pcae_decoder_params=dict(
        fused_impl="xla")), device=cuda, seed=0)
    model.obj_encoder.use_pallas_attention = flag
    serve.export_serving(model, image_shape=GRAPH_MODEL["image_shape"],
                         batch_size=None, out_dir=str(tmp_path / "art"),
                         device=cuda, polymorphic_batch=True)
    return model, {"live": serve.make_infer_fn(model, device=cuda),
                   "artifact": serve.load_serving(str(tmp_path / "art"))}


def serving_input(cuda, b, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(
        b, *GRAPH_MODEL["image_shape"]).astype(np.float32)).to(cuda)


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("surface", ["live", "artifact"])
def test_serving_graph_equals_eager_call(deterministic, tmp_path, flag,
                                         surface):
    """At batch 8 and 5 the replay gives the eager call's bits; each batch
    size captures once, and K6 launches only in the warm-up call and the
    capture (4 each with the flag), never in a replay."""
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS

    _, surfaces = serving_surfaces(deterministic, tmp_path, flag)
    call = surfaces[surface]
    for b in (8, 5):
        x = serving_input(deterministic, b, seed=b)
        zero_graph_counts()
        got = call(x)
        assert k6.launches == (4 * (WARMUP_STEPS + 1) if flag else 0)
        zero_graph_counts()
        again = call(x)
        assert k6.launches == 0
        want = call.eager(x)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
            assert torch.equal(again[k], want[k]), k
    assert call.graphs.captures == 2
    ran = kernel_records(lambda: call(x), {"K6": 4 if flag else 0})
    assert ran["K6"] == (4 if flag else 0)


def test_serving_graph_captures_again_for_replaced_tensors(deterministic,
                                                           tmp_path):
    """A parameter written in place keeps the graph, which replays the new
    values; a parameter replaced by a new tensor captures anew."""
    model, surfaces = serving_surfaces(deterministic, tmp_path, False)
    infer = surfaces["live"]
    x = serving_input(deterministic, 8)
    before = infer(x)
    weight = model.prior_classifier.weight
    with torch.no_grad():
        weight.mul_(2.0)
    in_place = infer(x)
    assert infer.graphs.captures == 1
    assert not torch.equal(in_place["prior_cls_prob"],
                           before["prior_cls_prob"])
    assert torch.equal(in_place["prior_cls_prob"],
                       infer.eager(x)["prior_cls_prob"])
    model.prior_classifier.weight = torch.nn.Parameter(weight.detach() / 2)
    replaced = infer(x)
    assert infer.graphs.captures == 2
    for k in before:
        assert torch.equal(replaced[k], before[k]), k


@pytest.mark.parametrize("surface", ["live", "artifact"])
def test_serving_graph_outputs_are_not_overwritten(deterministic, tmp_path,
                                                   surface):
    """A call returns fresh tensors: the next calls, on other images, leave
    them as they were."""
    _, surfaces = serving_surfaces(deterministic, tmp_path, True)
    call = surfaces[surface]
    first = call(serving_input(deterministic, 8, seed=1))
    kept = {k: v.clone() for k, v in first.items()}
    second = call(serving_input(deterministic, 8, seed=2))
    call(serving_input(deterministic, 8, seed=3))
    for k in kept:
        assert torch.equal(first[k], kept[k]), k
    assert not torch.equal(second["caps_presence"], first["caps_presence"])
