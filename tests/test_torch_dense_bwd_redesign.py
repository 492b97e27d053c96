"""The scatter rule of the two-tap backwards K4b (dense) and K5b (banded),
which share one kernel (``csrc/decoder_ll_tap_bwd.cuh``), and their
shared-memory planners, on the CPU.

The kernel sums the template gradient without atomics by grouping the 32
pixels of a warp pass by a key, the output row and the cell of the
pixel's two taps on each axis: a run of equal keys is summed by one lane,
so equal keys must be neighbours. ``decoder_ll_dense.bwd_tap_keys`` and
``decoder_ll_banded.bwd_tap_keys`` compute the keys as the kernel does,
from the two-tap rule and, for K5b, the row windows. Over random,
identity, zero, rotated, off-canvas and degenerate poses, at the
flagship, cifar10 and 17x17 shapes and with the banded windows:

  * equal keys of a pass form one run, and a key's row is its pixel's;
  * the keys' taps, clipped to the template and the window as the kernel
    clips them, hold every (texel, pixel) pair to which the plain version
    (``ops/decoder_ll.py``: weights relu(1 - |d|), the y-taps masked by the
    windows for K5b) gives a nonzero weight;
  * a model of the kernel's scatter in float64 (runs summed in lane order,
    written tap by tap into a table) equals the plain version's dense sum
    over the pixels to 1e-12 relative: every nonzero term lands once.

The kernels themselves run only on the card (tests/test_torch_gpu.py).
"""

import math

import numpy as np
import pytest
import torch

from scae_tpu_torch.kernels import decoder_ll_banded as k5
from scae_tpu_torch.kernels import decoder_ll_dense as k4
from scae_tpu_torch.kernels._common import SMEM_LIMIT
from scae_tpu_torch.ops.geometry import geometric_transform
from scae_tpu_torch.ops.warp import source_coordinates

torch.set_num_threads(1)


def rotation(theta, scale, tx, ty):
    c, s = scale * math.cos(theta), scale * math.sin(theta)
    return [c, -s, tx, s, c, ty]


IDENTITY = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
FIXED_POSES = {
    "identity": IDENTITY,
    "zero": [0.0] * 6,
    "rotated 30 degrees": rotation(math.pi / 6, 0.8, 0.1, -0.2),
    "rotated 90 degrees": rotation(math.pi / 2, 1.3, 0.0, 0.0),
    "rotated 45 degrees, small": rotation(math.pi / 4, 0.35, 0.3, 0.3),
    "off-canvas": [1.0, 0.0, 3.0, 0.0, 1.0, -2.5],
    "near-zero scale at the corner": [0.01, 0.0, 1.0, 0.0, 0.01, 1.0],
    "past the edge": [1.01, 0.0, -1.0, 0.0, 1.01, 0.0],
    "sheared": [1.0, 0.7, 0.0, -0.4, 0.9, 0.1],
    "flat in x": [1e-25, 0.0, 0.2, 0.0, 1.0, 0.0],
    "x from y only": [0.0, 1.0, 0.0, 1.0, 0.0, 0.0],
    "large translation": [0.5, 0.0, 40.0, 0.0, 0.5, -40.0],
    "twice as large": [2.0, 0.0, 0.0, 0.0, 2.0, 0.0],
}

SHAPES = [
    ((11, 11), (40, 40)),      # the flagship: 5 bands of 320 pixels
    ((11, 11), (32, 32)),      # cifar10: 4 bands of 256
    ((17, 17), (40, 40)),      # 289 texels
    ((11, 11), (11, 11)),      # identity: every pixel on a texel centre
    ((7, 9), (20, 28)),        # bands of 280 pixels: a pass straddles a band
    ((5, 5), (30, 30)),        # bands of 300 pixels
    ((4, 6), (9, 1)),          # one output column: 32 rows in a pass
]


def dense_weights(pose, tex_size, out_size):
    """The plain version's tap weights relu(1 - |d|): wy (B, M, Ht, P) and
    wx (B, M, Wt, P), float64."""
    Ht, Wt = tex_size
    ix, iy = source_coordinates(pose, tex_size, out_size)      # (B, M, P)
    ix, iy = ix.double(), iy.double()
    hs = torch.arange(Ht, dtype=torch.float64)[:, None]
    ws = torch.arange(Wt, dtype=torch.float64)[:, None]
    wy = torch.clamp(1.0 - (iy[..., None, :] - hs).abs(), min=0.0)
    wx = torch.clamp(1.0 - (ix[..., None, :] - ws).abs(), min=0.0)
    return wy, wx


def row_limits(pose, tex_size, out_size, win):
    """(lo, hi) (B, M, P): the rows a tap of each pixel may land on, the
    template's where ``win`` is None, else the window's, clipped to it."""
    B, M = pose.shape[:2]
    H, W = out_size
    if win is None:
        return (torch.zeros(B, M, H * W, dtype=torch.long),
                torch.full((B, M, H * W), tex_size[0], dtype=torch.long))
    return k5.window_rows(win, tex_size[0], H, W)


def keys_of(pose, tex_size, out_size, win):
    if win is None:
        return k4.bwd_tap_keys(pose, tex_size, out_size)
    return k5.bwd_tap_keys(pose, tex_size, out_size, win)


def nonzero_pairs(pose, tex_size, out_size, win):
    """(B, M, Ht, Wt, P) bool: the plain version gives texel (h, w) of
    pixel p a nonzero weight (the y-taps masked by the windows)."""
    wy, wx = dense_weights(pose, tex_size, out_size)
    if win is not None:
        rows = k5.band_rows(*out_size)
        mask = k5.window_row_mask(win, tex_size[0], *out_size, rows)
        wy = wy * mask.double()
    return (wy[:, :, :, None, :] > 0) & (wx[:, :, None, :, :] > 0)


def key_pairs(pose, tex_size, out_size, win):
    """(B, M, Ht, Wt, P) bool: texel (h, w) is one of the 4 taps of pixel
    p's key that the kernel writes: inside the template, and in the rows
    [lo, hi) of the pixel's window."""
    Ht, Wt = tex_size
    keys = keys_of(pose, tex_size, out_size, win)                # (B, M, P)
    lo, hi = row_limits(pose, tex_size, out_size, win)
    B, M, P = keys.shape
    cell = keys % ((Ht + 1) * (Wt + 1))
    h0, w0 = cell // (Wt + 1) - 1, cell % (Wt + 1) - 1
    mask = torch.zeros(B, M, Ht, Wt, P, dtype=torch.bool)
    for dh in (0, 1):
        for dw in (0, 1):
            h, w = h0 + dh, w0 + dw
            ok = (keys >= 0) & (h >= lo) & (h < hi) & (w >= 0) & (w < Wt)
            b, m, p = torch.nonzero(ok, as_tuple=True)
            mask[b, m, h[b, m, p], w[b, m, p], p] = True
    return mask


def check_runs(pose, tex_size, out_size, win):
    """Within every pass of 32 pixels (the kernel's warp passes start at
    multiples of 32), each key at or above 0 forms one run; the keys' rows
    are their pixels' rows."""
    Ht, Wt = tex_size
    W = out_size[1]
    keys = keys_of(pose, tex_size, out_size, win).numpy()
    B, M, P = keys.shape
    rows = keys // ((Ht + 1) * (Wt + 1))
    hit = keys >= 0
    pix_rows = np.broadcast_to(np.arange(P) // W, keys.shape)
    assert (rows[hit] == pix_rows[hit]).all()
    for base in range(0, P, 32):
        seg = keys[:, :, base:base + 32].reshape(B * M, -1)
        for lanes in seg:
            starts = np.r_[True, lanes[1:] != lanes[:-1]] & (lanes >= 0)
            assert starts.sum() == len(np.unique(lanes[lanes >= 0])), lanes


def check_cover(pose, tex_size, out_size, win):
    need = nonzero_pairs(pose, tex_size, out_size, win)
    got = key_pairs(pose, tex_size, out_size, win)
    assert not bool((need & ~got).any())


def scatter_like_the_kernel(pose, tex_size, out_size, win, vals):
    """The template gradient of one plane as the kernel sums it, in
    float64: per warp pass, each run of equal keys summed in lane order by
    its last lane, its 4 tap sums added into the table one output row and
    one tap at a time, taps outside the template or the window skipped.
    ``vals`` (B, M, P): each pixel's upstream value. (B, M, Ht, Wt)."""
    Ht, Wt = tex_size
    W = out_size[1]
    keys = keys_of(pose, tex_size, out_size, win).numpy()
    lo, hi = (v.numpy() for v in row_limits(pose, tex_size, out_size, win))
    ix, iy = (v.double().numpy()
              for v in source_coordinates(pose, tex_size, out_size))
    vals = vals.numpy()
    B, M, P = keys.shape
    h0, w0 = np.floor(iy), np.floor(ix)

    def weight(x, k, n):    # two_taps: relu(1 - |x - k|), 0 off the axis
        return np.where((k >= 0) & (k <= n - 1),
                        np.maximum(0.0, 1.0 - np.abs(x - k)), 0.0)

    wy = [weight(iy, h0 + j, Ht) for j in (0, 1)]
    wy = [w * ((h0 + j >= lo) & (h0 + j < hi)) for j, w in enumerate(wy)]
    wx = [weight(ix, w0 + j, Wt) for j in (0, 1)]
    table = np.zeros((B, M, Ht, Wt))
    for b in range(B):
        for m in range(M):
            key = keys[b, m]
            for base in range(0, P, 32):
                last = min(base + 32, P) - 1
                for row in range(base // W, last // W + 1):
                    for t in range(4):
                        for lane in range(base, last + 1):
                            end = key[lane] >= 0 and (
                                lane == last or key[lane + 1] != key[lane])
                            if not end or lane // W != row:
                                continue
                            first = lane
                            while first > base and key[first - 1] == key[lane]:
                                first -= 1
                            run = sum(vals[b, m, q] * wy[t >> 1][b, m, q]
                                      * wx[t & 1][b, m, q]
                                      for q in range(first, lane + 1))
                            h = int(h0[b, m, lane]) + (t >> 1)
                            w = int(w0[b, m, lane]) + (t & 1)
                            if lo[b, m, lane] <= h < hi[b, m, lane] \
                                    and 0 <= w < Wt:
                                table[b, m, h, w] += run
    return table


def dense_sum(pose, tex_size, out_size, win, vals):
    """The plain version's template gradient of one plane, float64:
    sum_p vals wy[h] wx[w], the y-taps masked by the windows."""
    wy, wx = dense_weights(pose, tex_size, out_size)
    if win is not None:
        rows = k5.band_rows(*out_size)
        wy = wy * k5.window_row_mask(win, tex_size[0], *out_size,
                                     rows).double()
    return torch.einsum("bmp,bmhp,bmwp->bmhw", vals.double(), wy,
                        wx).numpy()


def sorted_poses(pose, tex_size):
    """The wrapper's sorted, padded poses, through ``sort_and_pad``."""
    B, M, _ = pose.shape
    Ht, Wt = tex_size
    return k5.sort_and_pad(torch.zeros(B, M, 1, Ht, Wt),
                           torch.zeros(1, M, 1, Ht, Wt), pose,
                           torch.ones(B, M))[2]


def windows(pose, tex_size, out_size):
    H, W = out_size
    return k5.h_windows(pose, tex_size[0], H, W, k5.band_rows(H, W))


def random_poses(seed, B, M, noise):
    rng = np.random.RandomState(seed)
    return geometric_transform(torch.from_numpy(
        (rng.randn(B, M, 6) * noise).astype(np.float32)))


# ------------------------------------------------------- K4b: no windows

@pytest.mark.parametrize("name", sorted(FIXED_POSES))
@pytest.mark.parametrize("tex_size,out_size", SHAPES)
def test_dense_equal_keys_form_one_run(name, tex_size, out_size):
    pose = torch.tensor([[FIXED_POSES[name]]], dtype=torch.float32)
    check_runs(pose, tex_size, out_size, None)


@pytest.mark.parametrize("name", sorted(FIXED_POSES))
@pytest.mark.parametrize("tex_size,out_size", SHAPES)
def test_dense_keys_hold_every_nonzero_tap(name, tex_size, out_size):
    pose = torch.tensor([[FIXED_POSES[name]]], dtype=torch.float32)
    check_cover(pose, tex_size, out_size, None)


@pytest.mark.parametrize("seed,noise", [(0, 0.6), (1, 2.0), (2, 4.0)])
@pytest.mark.parametrize("tex_size,out_size", SHAPES[:3])
def test_dense_keys_at_random_poses(seed, noise, tex_size, out_size):
    pose = random_poses(seed, 2, 8, noise)
    check_runs(pose, tex_size, out_size, None)
    check_cover(pose, tex_size, out_size, None)


def test_dense_keys_mark_pixels_without_a_tap():
    pose = torch.tensor([[[1.0, 0.0, 5.0, 0.0, 1.0, 0.0],      # off-canvas
                          IDENTITY]])
    keys = k4.bwd_tap_keys(pose, (5, 5), (6, 6))
    assert (keys[0, 0] == -1).all()
    assert (keys[0, 1] >= 0).all()


# ------------------------------------------------------- K5b: the windows

@pytest.mark.parametrize("name", sorted(FIXED_POSES))
@pytest.mark.parametrize("tex_size,out_size", SHAPES[:3] + SHAPES[4:6])
def test_banded_keys_with_fixed_poses(name, tex_size, out_size):
    """Every capsule at one pose but the first, at the identity: two groups
    with other windows."""
    pose = torch.tensor([FIXED_POSES[name]] * 15 + [IDENTITY],
                        dtype=torch.float32)[None]
    pose = sorted_poses(pose, tex_size)
    win = windows(pose, tex_size, out_size)
    check_runs(pose, tex_size, out_size, win)
    check_cover(pose, tex_size, out_size, win)


@pytest.mark.parametrize("seed,noise,M", [(0, 0.6, 16), (1, 2.0, 13),
                                          (2, 4.0, 8)])
@pytest.mark.parametrize("tex_size,out_size", SHAPES[:3] + SHAPES[4:6])
def test_banded_keys_at_random_poses(seed, noise, M, tex_size, out_size):
    pose = sorted_poses(random_poses(seed, 2, M, noise), tex_size)
    win = windows(pose, tex_size, out_size)
    check_runs(pose, tex_size, out_size, win)
    check_cover(pose, tex_size, out_size, win)


def test_banded_passes_straddle_band_boundaries():
    """On a 20 x 28 canvas a band is 280 pixels, so some warp passes hold
    the end of one band and the start of the next, and a rotated capsule
    spanning the bands has other windows on the two sides: the runs still
    hold, and no key of a pixel lands outside its own band's window."""
    tex_size, out_size = (7, 9), (20, 28)
    pose = torch.tensor([rotation(math.pi / 12, 1.0, 0.0, 0.0)] * 8,
                        dtype=torch.float32)[None]
    win = windows(pose, tex_size, out_size)
    assert k5.band_rows(*out_size) * out_size[1] % 32 != 0
    assert len({tuple(w) for w in win[0, :, 0].tolist()}) > 1
    check_runs(pose, tex_size, out_size, win)
    check_cover(pose, tex_size, out_size, win)
    keys = k5.bwd_tap_keys(pose, tex_size, out_size, win)
    dense = k4.bwd_tap_keys(pose, tex_size, out_size)
    assert bool(((keys == dense) | (keys == -1)).all())


def test_banded_keys_with_full_and_empty_windows():
    """A window of every row gives K4b's keys; an empty one none."""
    tex_size, out_size = (11, 11), (40, 40)
    pose = sorted_poses(random_poses(3, 2, 16, 0.6), tex_size)
    win = windows(pose, tex_size, out_size)
    full = torch.zeros_like(win)
    full[..., 1] = tex_size[0]
    assert torch.equal(k5.bwd_tap_keys(pose, tex_size, out_size, full),
                       k4.bwd_tap_keys(pose, tex_size, out_size))
    empty = k5.bwd_tap_keys(pose, tex_size, out_size, torch.zeros_like(win))
    assert (empty == -1).all()


# ----------------------------------------------- the scatter, modelled

@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("tex_size,out_size,noise", [
    ((11, 11), (40, 40), 0.6),     # the flagship's widths
    ((7, 9), (20, 28), 2.0),       # passes across band boundaries
    ((5, 5), (12, 3), 4.0),        # 3-pixel rows, extreme poses
])
def test_scatter_model_equals_dense_sum(windowed, tex_size, out_size, noise):
    pose = sorted_poses(random_poses(5, 1, 8, noise), tex_size)
    pose[0, 0] = torch.tensor(IDENTITY)          # taps on texel centres
    pose[0, 1] = torch.zeros(6)
    win = windows(pose, tex_size, out_size) if windowed else None
    vals = torch.from_numpy(np.random.RandomState(6).randn(
        *pose.shape[:2], out_size[0] * out_size[1]))
    got = scatter_like_the_kernel(pose, tex_size, out_size, win, vals)
    want = dense_sum(pose, tex_size, out_size, win, vals)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


# ------------------------------------------------------------ planners

@pytest.mark.parametrize("shape,smem", [
    # (C, Ht, Wt): bytes: the table (2 floats a texel for C = 1, 4 for
    # C = 2 or 3, 8 for C = 4), then per warp a gradient table of C + 1
    # planes and a scratch of 32 pixels' 4 (C + 1) values and keys
    ((1, 11, 11), 4 * (121 * 2 + 4 * (2 * 121 + 9 * 32))),        # flagship
    ((3, 11, 11), 4 * (121 * 4 + 4 * (4 * 121 + 17 * 32))),       # cifar10
    ((3, 14, 14), 4 * (196 * 4 + 4 * (4 * 196 + 17 * 32))),       # colour
    ((1, 17, 17), 4 * (289 * 2 + 4 * (2 * 289 + 9 * 32))),        # 289 texels
    ((3, 17, 17), 4 * (289 * 4 + 4 * (4 * 289 + 17 * 32))),
    ((4, 11, 11), 4 * (121 * 8 + 4 * (5 * 121 + 21 * 32))),       # C = 4
])
def test_dense_and_banded_planners(shape, smem):
    assert k4.bwd_shared_memory_bytes(*shape) == smem <= SMEM_LIMIT
    assert k5.bwd_shared_memory_bytes(*shape) == smem


def test_planners_refuse_the_largest_tables():
    assert k4.bwd_shared_memory_bytes(1, 75, 75) <= SMEM_LIMIT
    assert k4.bwd_shared_memory_bytes(1, 76, 76) > SMEM_LIMIT
    assert k4.bwd_shared_memory_bytes(4, 40, 40) <= SMEM_LIMIT
    assert k5.bwd_shared_memory_bytes(4, 77, 77) > SMEM_LIMIT
