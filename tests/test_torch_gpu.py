"""K1 (the CUDA gather decoder-likelihood kernel) and K2+K3 (its backward),
K4f and K4b (the dense ones), against their plain PyTorch versions, on the
card; the flagship eval and train steps through them.

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
alpha, examples), the kernel's taken through atomics in an order that
changes from run to run. K4b's the same, and its repeat bit for bit: it
adds in a fixed order, without atomics.
"""

import numpy as np
import pytest
import torch

from scae_tpu_torch.kernels import decoder_ll_dense as k4
from scae_tpu_torch.kernels import decoder_ll_gather as k1
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


# ------------------------------------------------------------ K4f and K4b

DENSE_SHAPES = [
    ((8, 40, 1, 11, 11, 40, 40), 0.6, False),    # flagship widths
    ((4, 13, 1, 5, 5, 24, 24), 4.0, False),      # extreme poses, M = 13
    ((2, 16, 3, 14, 14, 32, 32), 0.6, False),    # colour
    ((3, 8, 2, 7, 9, 20, 28), 0.6, True),        # per-example alpha
    ((2, 6, 1, 17, 17, 24, 24), 0.6, False),     # 289 texels: gather refuses
    ((2, 5, 3, 9, 9, 3000, 1), 0.6, False),      # two pixel chunks in K4b
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
