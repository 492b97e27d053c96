"""The planners of the redesigned set attention (K6) and dense likelihood
forward (K4f), on the CPU: their plans at the flagship's shapes, that
every shape the earlier designs took is still planned and every shape they
refused is still refused by name, the bank rules of K6's shared-memory
strides, a model of K6's value pass (lanes in teams that split the keys
and add their sums by shuffles) against the plain weighted sum, and a
model of K4f's ring of capsule chunks (cp.async groups, one barrier per
chunk). The kernels themselves run only on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from scae_tpu_torch.kernels import attention as k6
from scae_tpu_torch.kernels import decoder_ll_dense as k4
from scae_tpu_torch.kernels._common import SMEM_LIMIT

# ------------------------------------------------------------------- K6


def old_k6_smem(N, M, d_k, d_v):
    """Shared memory of the earlier K6 (one block per batch row)."""
    return 4 * ((N + M) * (d_k + 1) + M * d_v + M + N * M)


@pytest.mark.parametrize("shape,want", [
    ((40, 40, 16, 16), dict(rows_per_warp=2, warps=4, vec=True, tile=8,
                            tiles=5, smem=7712)),
    ((32, 40, 256, 256), dict(rows_per_warp=2, warps=8, vec=True, tile=16,
                              tiles=2, smem=101664)),
    ((5, 7, 10, 6), dict(rows_per_warp=2, warps=3, vec=False, tile=6,
                         tiles=1, smem=912)),
    ((1, 7, 8, 8), dict(rows_per_warp=1, warps=1, vec=True, tile=1,
                        tiles=1, smem=652)),
])
def test_attention_plan_at_the_flagship_and_odd_shapes(shape, want):
    assert k6.plan(*shape) == want
    assert k6.shared_memory_bytes(*shape) == want["smem"]


def test_attention_plan_takes_every_shape_the_earlier_design_took():
    rng = np.random.RandomState(0)
    shapes = [tuple(int(x) for x in rng.randint(1, hi, 4))
              for hi in (9, 70, 300, 700) for _ in range(300)]
    # near the earlier design's limit: one query, many keys, odd widths
    shapes += [(1, M, d, d) for d in (1, 2, 3, 5, 6, 7, 9) for M in
               range(SMEM_LIMIT // (4 * (2 * d + 3)) - 40,
                     SMEM_LIMIT // (4 * (2 * d + 3)) + 40)]
    taken = 0
    for shape in shapes:
        for aligned in (True, False):
            p = k6.plan(*shape, aligned)
            if old_k6_smem(*shape) <= SMEM_LIMIT:
                assert p is not None, shape
                taken += 1
            if p is not None:
                assert p["smem"] <= SMEM_LIMIT
                assert p["tile"] * p["tiles"] >= shape[0]
                assert p["vec"] <= (aligned and shape[2] % 4 == 0
                                    and shape[3] % 4 == 0)
    assert taken > 1000


def test_attention_refusals_name_shared_memory():
    """What the earlier design refused for shared memory (K and V of 64
    keys of 512 floats) is still refused, by name, before any build."""
    assert old_k6_smem(64, 64, 512, 512) > SMEM_LIMIT
    assert k6.plan(64, 64, 512, 512) is None
    args = [torch.zeros(s) for s in
            ((1, 64, 512), (1, 64, 512), (1, 64, 512), (1, 64))]
    with pytest.raises(ValueError, match="shared memory"):
        k6._launch(*args)


@pytest.mark.parametrize("d_k", [4, 8, 16, 20, 64, 68, 256, 260, 512])
def test_key_rows_meet_distinct_banks(d_k):
    """A warp's 16-byte loads of 32 keys go in quarter warps of 8 lanes:
    the 8 rows' chunks fall on 8 distinct groups of 4 banks. Its 4-byte
    loads (the scalar path) of 32 keys fall on 32 distinct banks."""
    ld = k6.ld_k(d_k, True)
    assert ld % 4 == 0 and ld >= d_k
    for c in range(0, d_k // 4, 5):
        for base in range(0, 32, 8):
            groups = {((base + i) * ld // 4 + c) % 8 for i in range(8)}
            assert len(groups) == 8
    for d in (d_k - 1, d_k, d_k + 1):
        ld = k6.ld_k(d, False)
        assert d <= ld <= d + 1
        assert len({(i * ld) % 32 for i in range(32)}) == 32


@pytest.mark.parametrize("d_v", [4, 8, 12, 16, 20, 32, 36, 64, 132, 256])
def test_value_rows_meet_distinct_banks(d_v):
    """The value pass's 16-byte loads: lane (team t, chunk g) reads row
    m + t, chunk min(g, chunks - 1); within a quarter warp, distinct
    addresses fall on distinct groups of 4 banks."""
    ld = k6.ld_v(d_v, True)
    chunks = d_v // 4
    g2 = k6.team_width(chunks)
    assert ld % 4 == 0 and d_v <= ld <= d_v + 4
    for quarter in range(4):
        addrs = set()
        for lane in range(8 * quarter, 8 * quarter + 8):
            t, g = divmod(lane, g2)
            addrs.add((t * ld) // 4 + min(g, chunks - 1))
        assert len({a % 8 for a in addrs}) == len(addrs)


def value_pass_model(w, v, L):
    """K6's value pass for one query row, lane by lane, in float64: lanes
    in teams of G2 (chunk g = lane % G2) sum the keys team, team + T, ...,
    then add across teams by xor shuffles; team 0's lanes hold the
    output. Returns the (d_v,) row."""
    M, d_v = v.shape
    chunks = d_v // L
    g2 = k6.team_width(chunks)
    T = 32 // g2
    out = np.full(d_v, np.nan)
    for base in range(0, chunks, 64):
        slots = 2 if chunks - base > 32 else 1
        acc = np.zeros((32, slots, L))
        for lane in range(32):
            team, g = divmod(lane, g2)
            for s in range(slots):
                col = min(base + g + 32 * s, chunks - 1) * L
                for m in range(team, M, T):
                    acc[lane, s] += w[m] * v[m, col:col + L]
        o = g2
        while o < 32:
            acc = acc + acc[np.arange(32) ^ o]
            o *= 2
        for lane in range(g2):
            for s in range(slots):
                g = base + lane + 32 * s
                if g < chunks:
                    out[g * L:(g + 1) * L] = acc[lane, s]
    return out


@pytest.mark.parametrize("M,d_v,vec", [(40, 16, True), (40, 256, True),
                                       (7, 6, False), (45, 132, True),
                                       (70, 260, True), (33, 12, True),
                                       (5, 8, True), (9, 33, False)])
def test_value_pass_model_sums_every_key_once(M, d_v, vec):
    rng = np.random.RandomState(M + d_v)
    w, v = rng.rand(M), rng.randn(M, d_v)
    got = value_pass_model(w, v, 4 if vec else 1)
    np.testing.assert_allclose(got, w @ v, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ K4f


def old_k4f_smem(C, Ht, Wt):
    """Shared memory of the earlier K4f (two one-capsule buffers)."""
    return 4 * 2 * ((C + 1) * Ht * Wt + 8)


@pytest.mark.parametrize("shape,want", [
    ((128, 40, 1, 11, 11, 40, 40),          # the flagship
     dict(tiles=2, threads=416, chunk=32, blocks=256, smem=63744)),
    ((128, 64, 3, 11, 11, 32, 32),          # cifar10
     dict(tiles=1, threads=512, chunk=16, blocks=128, smem=62848)),
    ((32, 40, 1, 17, 17, 40, 40),           # 17x17 templates
     dict(tiles=2, threads=416, chunk=16, blocks=64, smem=74880)),
    ((2, 5, 3, 9, 9, 3000, 1),              # one output column
     dict(tiles=3, threads=512, chunk=32, blocks=6, smem=84736)),
])
def test_dense_forward_plan(shape, want):
    assert k4.forward_plan(shape) == want


def test_dense_forward_plans_every_size_the_earlier_design_took():
    """Two one-capsule buffers at the least: every template the earlier
    double-buffered design staged still fits, and every one it refused is
    still refused (the wrapper raises on "shared memory")."""
    sizes = [(C, h, w) for C in (1, 2, 3, 4) for h in (1, 5, 11, 17, 40, 75)
             for w in (1, 7, 11, 17, 40, 75)]
    # the earlier limit: (C + 1) Ht Wt <= 29048 floats
    sizes += [(1, 1, n) for n in range(14520, 14530)]
    sizes += [(3, 1, n) for n in range(7258, 7266)]
    for C, Ht, Wt in sizes:
        chunk = k4.forward_ring(C, Ht, Wt)
        smem = k4.shared_memory_bytes(C, Ht, Wt, chunk)
        assert (smem <= SMEM_LIMIT) == (old_k4f_smem(C, Ht, Wt)
                                        <= SMEM_LIMIT), (C, Ht, Wt)
        assert 1 <= chunk <= 32
        if smem > k4.FWD_SMEM_BUDGET:
            assert chunk == 1


@pytest.mark.parametrize("pixels", [range(1, 1100), range(1100, 40000, 37)])
def test_dense_pixel_tiling_covers_every_pixel(pixels):
    ppt = k4.FWD_PIXELS
    for P in pixels:
        tiles, threads = k4.pixel_tiling(P)
        tile_px = -(-P // tiles)
        assert threads % 32 == 0 and 32 <= threads <= k4.FWD_MAX_THREADS
        assert tile_px <= threads * ppt          # the C launcher's check
        assert (tiles - 1) * tile_px < P         # no empty tile
        # above 256 threads' worth, at most an eighth of the slots idle
        idle = tiles * threads * ppt - P
        assert 8 * idle <= P or P < 256 * ppt


def test_dense_ring_schedule_model():
    """K4f's loop, as the kernel orders it: load chunk 0; then per chunk
    wait until none of the thread's committed groups is in flight, meet at
    the barrier, load the next chunk into the buffer the previous chunk
    used, read the chunk. Every chunk is read after its copies landed, and
    no buffer is refilled before every thread has read it."""
    stages = k4.FWD_STAGES
    for M in (1, 7, 8, 9, 40, 64, 65):
        for chunk in (1, 3, 8, 32):
            n = -(-M // chunk)
            committed, landed = [], set()
            in_buffer = {}                  # buffer -> chunk it holds
            read_done = set()               # chunks every thread read

            def load(ch):
                if ch >= n:
                    return
                buf = ch % stages
                prev = in_buffer.get(buf)
                assert prev is None or prev in read_done
                in_buffer[buf] = ch
                committed.append(ch)

            load(0)
            for ch in range(n):
                # cp.async.wait_group(0): every committed group has landed
                landed.update(committed)
                # the barrier: every thread read chunk ch - 1
                if ch:
                    read_done.add(ch - 1)
                load(ch + 1)
                assert ch in landed and in_buffer[ch % stages] == ch
