"""The gather backward's (K2+K3's) scatter rule and the gather kernels'
planners, on the CPU. The backward sums the template gradient without
atomics by grouping the 32 pixels of a warp pass by a key, the output row
and the cell of the pixel's 4 taps: a run of equal keys is summed by one
lane, so equal keys must be neighbours. ``bwd_tap_keys`` computes the keys
as the .cu does; over random, identity, zero, rotated, off-canvas and
degenerate poses, equal keys of a pass must form one run, and the keys'
taps must hold every (texel, pixel) pair that the plain 4-tap form gives a
nonzero weight. Then the shared-memory and grid planners at the flagship,
cifar10 and colour shapes. The kernels themselves run only on the card
(tests/test_torch_gpu.py).
"""

import math

import numpy as np
import pytest
import torch

from scae_tpu_torch.kernels import decoder_ll_gather as k1
from scae_tpu_torch.kernels._common import SMEM_LIMIT
from scae_tpu_torch.ops.geometry import geometric_transform
from scae_tpu_torch.ops.warp import source_coordinates


def nonzero_pairs(pose, tex_size, out_size):
    """(B, M, T, P) bool: texel t is a tap of pixel p with a nonzero weight
    in the plain version's 4-tap form."""
    Ht, Wt = tex_size
    H, W = out_size
    B, M = pose.shape[:2]
    ix, iy = source_coordinates(pose, tex_size, out_size)      # (B, M, P)
    h0, w0 = torch.floor(iy), torch.floor(ix)
    fy, fx = iy - h0, ix - w0
    mask = torch.zeros(B, M, Ht * Wt, H * W, dtype=torch.bool)
    for dh, wy in ((0, 1.0 - fy), (1, fy)):
        for dw, wx in ((0, 1.0 - fx), (1, fx)):
            h, w = h0 + dh, w0 + dw
            hit = ((h >= 0) & (h <= Ht - 1) & (w >= 0) & (w <= Wt - 1)
                   & (wy * wx != 0))
            texel = (h.clamp(0, Ht - 1) * Wt + w.clamp(0, Wt - 1)).long()
            b, m, p = torch.nonzero(hit, as_tuple=True)
            mask[b, m, texel[b, m, p], p] = True
    return mask


def key_pairs(pose, tex_size, out_size):
    """(B, M, T, P) bool: texel t is one of the 4 taps of pixel p's key
    (the taps the kernel adds p's run into), inside the template."""
    Ht, Wt = tex_size
    H, W = out_size
    keys = k1.bwd_tap_keys(pose, tex_size, out_size)             # (B, M, P)
    B, M, P = keys.shape
    cell = keys % ((Ht + 1) * (Wt + 1))
    h0, w0 = cell // (Wt + 1) - 1, cell % (Wt + 1) - 1
    mask = torch.zeros(B, M, Ht * Wt, P, dtype=torch.bool)
    for dh in (0, 1):
        for dw in (0, 1):
            h, w = h0 + dh, w0 + dw
            ok = (keys >= 0) & (h >= 0) & (h < Ht) & (w >= 0) & (w < Wt)
            b, m, p = torch.nonzero(ok, as_tuple=True)
            mask[b, m, (h * Wt + w)[b, m, p], p] = True
    return mask


def check_runs(pose, tex_size, out_size):
    """Within every pass of 32 pixels (the kernel's warp passes start at
    multiples of 32), each key at or above 0 forms one run; the keys' rows
    are their pixels' rows."""
    Ht, Wt = tex_size
    H, W = out_size
    keys = k1.bwd_tap_keys(pose, tex_size, out_size).numpy()
    B, M, P = keys.shape
    rows = keys // ((Ht + 1) * (Wt + 1))
    pix_rows = np.arange(P) // W
    hit = keys >= 0
    assert (rows[hit] == np.broadcast_to(pix_rows, keys.shape)[hit]).all()
    for base in range(0, P, 32):
        seg = keys[:, :, base:base + 32].reshape(B * M, -1)
        for lanes in seg:
            pos = lanes[lanes >= 0]
            starts = np.r_[True, lanes[1:] != lanes[:-1]] & (lanes >= 0)
            assert starts.sum() == len(np.unique(pos)), lanes


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
    "tiny slope": [3e-7, 0.0, 0.05, 0.0, 3e-7, -0.05],
    "large translation": [0.5, 0.0, 40.0, 0.0, 0.5, -40.0],
    "twice as large": [2.0, 0.0, 0.0, 0.0, 2.0, 0.0],
}


SHAPES = [
    ((11, 11), (40, 40)),      # the flagship
    ((11, 11), (11, 11)),      # identity: every pixel on a texel centre
    ((7, 5), (12, 20)),
    ((5, 5), (1, 9)),          # one output row
    ((4, 6), (9, 1)),          # one output column: 32 rows in a pass
    ((3, 3), (7, 45)),         # rows longer than a pass
]


@pytest.mark.parametrize("name", sorted(FIXED_POSES))
@pytest.mark.parametrize("tex_size,out_size", SHAPES)
def test_equal_keys_form_one_run(name, tex_size, out_size):
    pose = torch.tensor([[FIXED_POSES[name]]], dtype=torch.float32)
    check_runs(pose, tex_size, out_size)


@pytest.mark.parametrize("name", sorted(FIXED_POSES))
@pytest.mark.parametrize("tex_size,out_size", SHAPES)
def test_keys_hold_every_nonzero_tap(name, tex_size, out_size):
    pose = torch.tensor([[FIXED_POSES[name]]], dtype=torch.float32)
    need = nonzero_pairs(pose, tex_size, out_size)
    got = key_pairs(pose, tex_size, out_size)
    assert not bool((need & ~got).any()), name


@pytest.mark.parametrize("seed,noise", [(0, 0.6), (1, 0.6), (2, 2.0),
                                        (3, 4.0)])
def test_keys_at_random_poses(seed, noise):
    rng = np.random.RandomState(seed)
    pose = geometric_transform(torch.from_numpy(
        (rng.randn(3, 16, 6) * noise).astype(np.float32)))
    for tex_size, out_size in (((11, 11), (40, 40)), ((6, 9), (17, 13))):
        check_runs(pose, tex_size, out_size)
        need = nonzero_pairs(pose, tex_size, out_size)
        got = key_pairs(pose, tex_size, out_size)
        assert not bool((need & ~got).any())


def test_runs_are_long_at_the_flagship():
    """At the flagship's random poses a pass of 32 pixels holds about 10
    runs, so a run end sums about 3 lanes: the scatter does a third of the
    writes a lane-by-lane scatter would."""
    rng = np.random.RandomState(0)
    pose = geometric_transform(torch.from_numpy(
        (rng.randn(4, 40, 6) * 0.6).astype(np.float32)))
    keys = k1.bwd_tap_keys(pose, (11, 11), (40, 40)).reshape(4, 40, 50, 32)
    hit = keys >= 0
    starts = torch.cat([hit[..., :1], (keys[..., 1:] != keys[..., :-1])
                        & hit[..., 1:]], dim=-1)
    lanes_per_run = float(hit.sum()) / float(starts.sum())
    assert 2.0 < lanes_per_run < 8.0


def test_keys_mark_pixels_without_a_tap():
    pose = torch.tensor([[[1.0, 0.0, 5.0, 0.0, 1.0, 0.0],      # off-canvas
                          IDENTITY]])
    keys = k1.bwd_tap_keys(pose, (5, 5), (6, 6))
    assert (keys[0, 0] == -1).all()
    assert (keys[0, 1] >= 0).all()


@pytest.mark.parametrize("shape,buffers,smem", [
    # (M, C, Ht, Wt, per-example alpha), K1's buffers and bytes
    ((40, 1, 11, 11, False), 2, 60640),     # the flagship
    ((40, 1, 11, 11, True), 2, 4 * 2 * (4840 + 4840 + 240 + 80)),
    ((64, 3, 11, 11, False), 2, 220928),    # cifar10: two buffers just fit
    ((16, 3, 14, 14, False), 2, 4 * (3136 + 2 * (9408 + 96 + 32))),  # colour
    ((64, 3, 14, 14, False), 1, None),      # one buffer only
    ((64, 4, 16, 16, False), 0, None),      # not even one
])
def test_forward_planner(shape, buffers, smem):
    M, C, Ht, Wt, batched = shape
    assert k1.forward_buffers(M, C, Ht, Wt, batched) == buffers
    if smem is not None:
        assert k1.shared_memory_bytes(M, C, Ht, Wt, batched) == smem
    if buffers:
        assert k1.shared_memory_bytes(M, C, Ht, Wt, batched,
                                      buffers) <= SMEM_LIMIT
    if buffers < 2:
        assert k1.shared_memory_bytes(M, C, Ht, Wt, batched,
                                      buffers + 1) > SMEM_LIMIT


@pytest.mark.parametrize("P,tiles", [(1600, 7), (1024, 4), (256, 1),
                                     (257, 2), (1, 1)])
def test_forward_tiles(P, tiles):
    assert k1.forward_tiles(P) == tiles
    assert -(-P // tiles) <= k1.FWD_THREADS


@pytest.mark.parametrize("shape,smem", [
    # (C, Ht, Wt): bytes: the table (2 floats a texel for C = 1, 4 for
    # C = 2 or 3, 8 for C = 4), then per warp a gradient table of C + 1
    # planes and a scratch of 32 pixels' 4 (C + 1) values and keys
    ((1, 11, 11), 4 * (121 * 2 + 4 * (2 * 121 + 9 * 32))),        # flagship
    ((3, 11, 11), 4 * (121 * 4 + 4 * (4 * 121 + 17 * 32))),       # cifar10
    ((3, 14, 14), 4 * (196 * 4 + 4 * (4 * 196 + 17 * 32))),       # colour
    ((2, 17, 17), 4 * (289 * 4 + 4 * (3 * 289 + 13 * 32))),
    ((4, 7, 9), 4 * (63 * 8 + 4 * (5 * 63 + 21 * 32))),
])
def test_backward_planner(shape, smem):
    assert k1.bwd_shared_memory_bytes(*shape) == smem <= SMEM_LIMIT
    assert k1.BWD_WARPS == 4


def test_backward_planner_refuses_the_largest_tables():
    assert k1.bwd_shared_memory_bytes(4, 77, 77) > SMEM_LIMIT
    assert k1.bwd_shared_memory_bytes(4, 40, 40) <= SMEM_LIMIT
