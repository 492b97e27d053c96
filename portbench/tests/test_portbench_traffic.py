"""The inputs made from the seed: deterministic per seed, Poisson arrivals,
and the request mix at its stated shares."""

import numpy as np
import pytest
import torch

from portbench import data, weights
from portbench.traffic.serve_open_loop import schedule
from portbench.tests import tiny

SIZES, SHARES = [1, 8, 32, 128], [0.50, 0.25, 0.15, 0.10]


def test_schedule_is_deterministic_per_seed():
    a = schedule(2 ** 31 + 3, 440, SIZES, SHARES, 5.0)
    b = schedule(2 ** 31 + 3, 440, SIZES, SHARES, 5.0)
    c = schedule(2 ** 31 + 4, 440, SIZES, SHARES, 5.0)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1][:100], c[1][:100])


def test_arrivals_are_poisson_and_sizes_at_their_shares():
    arrivals, sizes = schedule(2 ** 31, 440, SIZES, SHARES, 100.0)
    assert arrivals.max() < 100.0 and np.all(np.diff(arrivals) > 0)
    assert len(arrivals) == pytest.approx(44_000, rel=0.02)
    gaps = np.diff(arrivals)
    # exponential gaps: the mean 1/rate, the deviation equal to the mean,
    # and no two successive gaps correlated
    assert gaps.mean() == pytest.approx(1 / 440, rel=0.02)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.03)
    assert abs(np.corrcoef(gaps[:-1], gaps[1:])[0, 1]) < 0.02
    # a second's count varies as a Poisson count does
    counts = np.bincount(arrivals.astype(np.int64), minlength=100)
    assert counts.var() / counts.mean() == pytest.approx(1.0, abs=0.35)
    shares = np.bincount(sizes, minlength=129)[SIZES] / len(sizes)
    assert shares == pytest.approx(SHARES, abs=0.01)
    assert sizes.mean() == pytest.approx(20.1, abs=0.5)


def test_epoch_rows_are_a_seeded_permutation():
    a = data.epoch_rows(2 ** 31 + 1, 3, 1000, 128)
    assert a.shape == (7, 128)
    assert len(set(a.ravel().tolist())) == 7 * 128
    assert np.array_equal(a, data.epoch_rows(2 ** 31 + 1, 3, 1000, 128))
    assert not np.array_equal(a, data.epoch_rows(2 ** 31 + 1, 4, 1000, 128))


def test_dataset_and_pool_are_deterministic():
    cfg = tiny.config()["data"]
    a = data.dataset(cfg, 5, "cpu")
    b = data.dataset(cfg, 5, "cpu")
    for split in ("train", "val"):
        for k in ("image", "label"):
            assert torch.equal(a[split][k], b[split][k])
    assert a["train"]["image"].dtype == torch.uint8
    assert tuple(a["train"]["image"].shape) == (128, 20, 20)
    pool = data.serving_pool(16, cfg, (1, 24, 24), 5)
    assert torch.equal(pool, data.serving_pool(16, cfg, (1, 24, 24), 5))
    assert pool.shape == (16, 1, 24, 24) and float(pool.max()) <= 1.0


def test_weights_are_drawn_in_their_ranges():
    from portbench.reference.model import Model

    shapes = weights.shapes_of(Model(tiny.MODEL))
    a = weights.draw(shapes, 9, "cpu")
    assert all(torch.equal(a[k], v) for k, v in
               weights.draw(shapes, 9, "cpu").items())
    for name, (lo, hi) in weights.ranges(shapes).items():
        assert float(a[name].min()) >= lo and float(a[name].max()) <= hi
    assert float(a["part_encoder.att_conv.bias"].abs().max()) > 0
    assert float(a["obj_decoder.dummy_vote"].abs().max()) == 0
    assert float(a["obj_encoder.sab_0.mab.ln0.weight"].min()) == 1.0
