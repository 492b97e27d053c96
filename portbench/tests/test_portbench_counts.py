"""The yardstick's arithmetic: the likelihood kernels' least times at the
shapes and inputs they were first fixed on, and the model FLOP counts."""

import numpy as np
import pytest
import torch

from portbench.counts import flops, roofline
from portbench.reference.model import geometric_transform

FLAGSHIP = (128, 40, 1, 11, 11, 40, 40)
CIFAR10 = (128, 64, 3, 11, 11, 32, 32)


def poses(shape, seed=2, noise=0.6):
    """The poses of the kernels' timing inputs: a RandomState(seed) draw
    of templates, alpha, then poses (randn x 0.6 through the geometric
    transform)."""
    B, M, C, Ht, Wt, H, W = shape
    rng = np.random.RandomState(seed)
    rng.rand(B, M, C, Ht, Wt)
    rng.randn(1, M, 1, Ht, Wt)
    raw = np.asarray(rng.randn(B, M, 6) * noise, np.float32)
    return geometric_transform(torch.from_numpy(raw))


def test_k1_bound():
    ms, by, _, _ = roofline.k1_bound_ms(FLAGSHIP)
    assert by == "operations"
    assert ms == pytest.approx(0.00758, abs=5e-6)


@pytest.mark.parametrize("shape, want", [(FLAGSHIP, 0.01402),
                                         (CIFAR10, 0.02451)])
def test_k23_bound(shape, want):
    n_hit = roofline.hits(poses(shape), shape[3:5], shape[5:])
    ms, by, _, _ = roofline.k23_bound_ms(shape, n_hit)
    assert by == "operations"
    assert ms == pytest.approx(want, abs=5e-6)


def test_hits_counts_pairs_on_the_template():
    identity = torch.tensor([[[1.0, 0, 0, 0, 1.0, 0]]])
    far = torch.tensor([[[0.01, 0, 5.0, 0, 0.01, 5.0]]])
    assert roofline.hits(identity, (11, 11), (11, 11)) == 121
    assert roofline.hits(far, (11, 11), (11, 11)) == 0


def test_flops_of_the_configurations():
    mnist = dict(image_shape=(1, 40, 40), n_classes=10, n_part_caps=40,
                 n_obj_caps=32)
    cifar = dict(image_shape=(3, 32, 32), n_classes=10, n_part_caps=64,
                 n_obj_caps=32)
    # the encoder's convolutions alone, multiply-adds by hand
    convs = (19 * 19 * 128 * 9 + 9 * 9 * 128 * 1152 + 7 * 7 * 128 * 1152
             + 5 * 5 * 128 * 1152)
    assert flops.forward_macs(mnist) > convs + 5 * 5 * 128 * 960
    assert flops.forward_flops(mnist) == 2 * flops.forward_macs(mnist)
    assert flops.train_flops(mnist) == 3 * flops.forward_flops(mnist)
    assert 60e6 < flops.forward_flops(cifar) < flops.forward_flops(mnist)
