"""K1 (the CUDA gather decoder-likelihood kernel) against its plain PyTorch
version, on the card.

Needs a CUDA device and nvcc; every test skips without a card. The
decision is taken inside the ``cuda`` fixture, so every pytest worker
collects the same tests. Imports no jax: run on the GPU machine with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: 1e-4 absolute on ll, num and den. Both sides compute the same
f32 formula; they differ only in the order of the log-sum-exp (streaming
in the kernel, whole-axis in the plain version) and in fused multiply-adds,
each worth a few f32 ulps of values of order 10.
"""

import numpy as np
import pytest
import torch

from scae_tpu_torch.kernels import decoder_ll_gather as k1
from scae_tpu_torch.ops.geometry import geometric_transform

pytestmark = pytest.mark.gpu

TOL = 1e-4


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
    bad = dict(inputs, templates=inputs["templates"].requires_grad_())
    with pytest.raises(NotImplementedError, match="no backward"):
        call(k1.decoder_ll_gather, bad, (16, 16))
    with torch.no_grad():
        call(k1.decoder_ll_gather, bad, (16, 16))
    big = make_inputs((1, 64, 4, 16, 16, 16, 16))
    with pytest.raises(ValueError, match="shared memory"):
        run(k1.decoder_ll_gather, big, cuda, (16, 16))


def test_kernel_build_reports_registers(cuda):
    info = k1.build_info()
    assert info.path.endswith(".so")
    assert "registers" in info.log or info.cached


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
