"""The planners of the redesigned banded likelihood forward (K5f) and matmul
probe (P2), on the CPU: K5f's plans at the flagship's and other shapes,
that every size the earlier one-group-a-block design took is still
planned and the rest refused by name, that a band's pixels fall to its
threads once each, and a model of K5f's ring of capsule chunks with the row
windows (every tap the kernel reads was staged for that capsule, no buffer
is refilled before every thread has read it); P2's plans and refusals, and
a model of its tiles, chunks and ring (every output of a ragged product
written once, the sum of each of its K products once). The kernels
themselves run only on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from scae_tpu_torch.kernels import decoder_ll_banded as k5
from scae_tpu_torch.kernels import probe as kp
from scae_tpu_torch.kernels._common import SMEM_LIMIT
from scae_tpu_torch.ops.geometry import geometric_transform
from scae_tpu_torch.ops.warp import source_coordinates

torch.set_num_threads(1)

# ------------------------------------------------------------------ K5f


def old_k5f_smem(C, Ht, Wt):
    """Shared memory of the earlier K5f (one group of 8 capsule tables)."""
    return 4 * 8 * ((C + 1) * Ht * Wt + 8)


# registers: what ptxas gave K5f on the card (64 at C = 1..4)
@pytest.mark.parametrize("shape,registers,pixels,want", [
    ((128, 40, 1, 11, 11, 40, 40), 64, 1,   # the flagship: one chunk
     dict(rows=8, bands=5, threads=320, pixels=1, register_blocks=3,
          chunk=40, chunks=1, blocks=640, smem=39856)),
    ((128, 40, 1, 11, 11, 40, 40), 64, 2,   # two pixels a thread
     dict(rows=8, bands=5, threads=160, pixels=2, register_blocks=6,
          chunk=14, chunks=3, blocks=640, smem=27920)),
    ((128, 64, 3, 11, 11, 32, 32), 64, 1,   # cifar10
     dict(rows=8, bands=4, threads=256, pixels=1, register_blocks=4,
          chunk=13, chunks=5, blocks=512, smem=51088)),
    ((32, 40, 1, 17, 17, 40, 40), 64, 1,    # 17x17 templates
     dict(rows=8, bands=5, threads=320, pixels=1, register_blocks=3,
          chunk=14, chunks=3, blocks=160, smem=65552)),
    ((2, 16, 4, 11, 11, 40, 40), 64, 1,     # C = 4
     dict(rows=8, bands=5, threads=320, pixels=1, register_blocks=3,
          chunk=16, chunks=1, blocks=10, smem=39200)),
])
def test_banded_forward_plan(shape, registers, pixels, want):
    assert k5.forward_plan(shape, registers, pixels) == want
    B, M, C, Ht, Wt = shape[:5]
    assert want["smem"] == k5.shared_memory_bytes(C, Ht, Wt, want["chunk"], M)
    # the ring fits an SM beside the blocks the registers allow
    assert want["register_blocks"] * (want["smem"] + k5.BLOCK_RESERVED) \
        <= k5.SM_SHARED


def test_banded_forward_plans_every_size_the_earlier_design_took():
    """A one-capsule ring takes less than the earlier design's group of 8
    tables, so every template it staged is still planned within a block's
    shared memory, whatever the registers and M; every one it refused
    whose one-capsule ring does not fit is refused, by name, before any
    build (the CPU has no compiler)."""
    sizes = [(C, h, w) for C in (1, 2, 3, 4) for h in (1, 5, 11, 17, 40, 75)
             for w in (1, 7, 11, 17, 40)]
    # the earlier limit: (C + 1) Ht Wt <= 7256 floats
    sizes += [(1, 1, n) for n in range(3620, 3636)]
    sizes += [(3, 1, n) for n in range(1806, 1818)]
    planned = 0
    for C, Ht, Wt in sizes:
        for M in (8, 40, 64, 1000):
            for registers in (32, 64, 128, 255):
                p = k5.forward_plan((2, M, C, Ht, Wt, 40, 40), registers)
                assert 1 <= p["chunk"] <= min(M, k5.FWD_CHUNK)
                assert p["chunks"] == -(-M // p["chunk"])
                if old_k5f_smem(C, Ht, Wt) <= SMEM_LIMIT:
                    assert p["smem"] <= SMEM_LIMIT, (C, Ht, Wt, M, registers)
                    planned += 1
                if p["chunk"] > 1:
                    budget = k5.SM_SHARED // p["register_blocks"] \
                        - k5.BLOCK_RESERVED
                    assert p["smem"] <= budget
    assert planned > 2000
    # 171 x 171 at C = 1: two one-capsule buffers are 233,936 bytes
    big = [torch.zeros(s) for s in ((1, 8, 1, 171, 171), (1, 8, 1, 171, 171),
                                    (1, 8, 6), (1, 8), (1, 1, 16, 16))]
    assert k5.shared_memory_bytes(1, 171, 171, 1, 8) > SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        k5._launch(*big[:4], 0.3, 0.7, 1.0, big[4], (16, 16))


@pytest.mark.parametrize("pixels", [1, 2])
def test_banded_threads_cover_each_band_pixel_once(pixels):
    """Thread i takes pixels i, i + threads, ... of its band: each of the
    band's pixels once, within the C launcher's limits."""
    seen_bands = set()
    for H in range(1, 70):
        for W in range(1, 520, 7):
            band = k5.band_rows(H, W) * W
            if band > k5.MAX_BAND_PIXELS or band in seen_bands:
                continue
            seen_bands.add(band)
            threads = k5.threads_per_block(H, W, pixels)
            assert threads % 32 == 0 and 32 <= threads
            assert threads <= k5.MAX_BAND_PIXELS // pixels
            assert threads * pixels >= band > threads * pixels - 32 * pixels
            taken = np.concatenate([np.arange(threads) + k * threads
                                    for k in range(pixels)])
            taken = taken[taken < band]
            np.testing.assert_array_equal(np.sort(taken), np.arange(band))
    assert len(seen_bands) > 50


def taps_model(x, n):
    """common.cuh::two_taps' texel indices (clamped floors) of float32
    coordinates x on an axis of n texels: (k0, k1)."""
    f0 = np.floor(x)
    return [np.clip(f0 + j, 0, n - 1).astype(np.int64) for j in (0, 1)]


def ring_model(pose, Ht, Wt, H, W, chunk):
    """K5f's ring at one plan, for the sorted, padded poses (B, M, 6): per
    (example, band) block, chunk 0 is loaded, then for every chunk each
    thread waits for its copies, the block meets at the barrier, the next
    chunk is loaded into the other buffer and the chunk that landed is
    read. Loading a chunk stages, for each of its capsules, the rows of its
    group's window clipped to the template; reading it takes every band
    pixel's two row taps under each capsule and reads the rows whose tap
    is inside the window. Asserts that each read row was staged for that
    capsule in the buffer it is read from, and that no buffer is refilled
    before the chunk it holds was read; returns the rows read."""
    B, M, _ = pose.shape
    rows = k5.band_rows(H, W)
    win = k5.h_windows(pose, Ht, H, W, rows).numpy()
    _, iy = source_coordinates(pose, (Ht, Wt), (H, W))
    ky = taps_model(iy.numpy(), Ht)              # each (B, M, P)
    n_chunks = -(-M // chunk)
    reads = 0
    for b in range(B):
        for band in range(H // rows):
            px = slice(band * rows * W, (band + 1) * rows * W)
            staged = {}                    # (buffer, slot) -> (m, rows)
            held, read_done = {}, set()    # buffer -> chunk; chunks read

            def load(ch):
                if ch >= n_chunks:
                    return
                buf = ch % 2
                assert held.get(buf) is None or held[buf] in read_done
                held[buf] = ch
                for j in range(min(chunk, M - ch * chunk)):
                    m = ch * chunk + j
                    lo, trips = (int(v) for v in win[b, band, m // k5.GROUP])
                    lo_c = min(max(lo, 0), Ht)
                    hi_c = min(max(lo + trips, lo_c), Ht)
                    staged[(buf, j)] = (m, set(range(lo_c, hi_c)))

            load(0)
            for ch in range(n_chunks):
                if ch:
                    read_done.add(ch - 1)   # the barrier
                load(ch + 1)
                buf = ch % 2
                assert held[buf] == ch
                for j in range(min(chunk, M - ch * chunk)):
                    m = ch * chunk + j
                    lo, trips = (int(v) for v in win[b, band, m // k5.GROUP])
                    got_m, got_rows = staged[(buf, j)]
                    assert got_m == m
                    for k in ky:
                        r = k[b, m, px]
                        inside = (r >= lo) & (r < lo + trips)
                        assert set(r[inside].tolist()) <= got_rows
                        reads += int(inside.sum())
    return reads


def edge_poses(B, M, kind, rng):
    """chip_smoke.py's K5f poses: random (noise 0.6), "edge" (noise 4.0 and
    two degenerate capsules), "off canvas", "identity", "zero"."""
    noise = 4.0 if kind == "edge" else 0.6
    pose = geometric_transform(torch.from_numpy(
        (rng.randn(B, M, 6) * noise).astype(np.float32)))
    fixed = {"edge": None, "random": None,
             "off canvas": [1.0, 0.0, 3.0, 0.0, 1.0, 3.0],
             "identity": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
             "zero": [0.0] * 6}[kind]
    if kind == "edge":
        pose[:, 0] = torch.tensor([0.01, 0.0, 1.0, 0.0, 0.01, 1.0])
        pose[:, 1] = torch.tensor([1.01, 0.0, -1.0, 0.0, 1.01, 0.0])
    if fixed is not None:
        pose[:] = torch.tensor(fixed)
    return pose


@pytest.mark.parametrize("kind,shape", [
    ("random", (3, 40, 1, 11, 11, 40, 40)),
    ("random", (2, 64, 3, 11, 11, 32, 32)),
    ("random", (2, 40, 1, 7, 9, 20, 28)),
    ("random", (2, 40, 1, 17, 17, 40, 40)),
    ("edge", (3, 13, 1, 11, 11, 40, 40)),
    ("off canvas", (2, 40, 1, 11, 11, 40, 40)),
    ("identity", (2, 40, 1, 11, 11, 11, 11)),
    ("zero", (2, 40, 1, 11, 11, 40, 40)),
])
@pytest.mark.parametrize("chunk", [1, 3, 8, 14, 40, 64])
def test_banded_ring_model_reads_only_staged_rows(kind, shape, chunk):
    B, M, C, Ht, Wt, H, W = shape
    rng = np.random.RandomState(M + Ht + len(kind))
    pose = edge_poses(B, M, kind, rng)
    zeros = torch.zeros(B, M, C, Ht, Wt)
    _, _, pose, _ = k5.sort_and_pad(zeros, zeros[:, :, :1], pose,
                                    torch.ones(B, M))
    reads = ring_model(pose, Ht, Wt, H, W, min(chunk, pose.shape[1]))
    # every tap lies off the template under the off-canvas pose
    assert (reads == 0) == (kind == "off canvas")


# ------------------------------------------------------------------- P2


@pytest.mark.parametrize("MKN,tile,kc,want", [
    ((256, 128, 256), kp.MATMUL_TILE, kp.MATMUL_KC,   # the probe
     dict(bm=16, bn=32, tm=2, tn=2, ks=4, threads=512, kc=128, chunks=1,
          grid=(8, 16), blocks=128, smem=24576)),
    ((256, 128, 256), (32, 32, 2, 4, 4), 64,
     dict(bm=32, bn=32, tm=2, tn=4, ks=4, threads=512, kc=64, chunks=2,
          grid=(8, 8), blocks=64, smem=32768)),
    ((17, 300, 5), kp.MATMUL_TILE, kp.MATMUL_KC,
     dict(bm=16, bn=32, tm=2, tn=2, ks=4, threads=512, kc=128, chunks=3,
          grid=(1, 2), blocks=2, smem=49152)),
    ((1, 1, 1), kp.MATMUL_TILE, kp.MATMUL_KC,         # the partial sums
     dict(bm=16, bn=32, tm=2, tn=2, ks=4, threads=512, kc=4, chunks=1,
          grid=(1, 1), blocks=1, smem=6144)),
])
def test_matmul_plan(MKN, tile, kc, want):
    assert kp.matmul_plan(*MKN, tile, kc) == want


def test_matmul_plans_every_tile_within_a_block():
    for tile in kp.MATMUL_TILES:
        bm, bn, tm, tn, ks = tile
        assert bm % tm == 0 and bn % tn == 0 and tn in (2, 4)
        # a depth slice is whole warps, 1024 threads at most
        assert bn % 4 == 0 and ((bm // tm) * (bn // tn)) % 32 == 0
        assert (bm // tm) * (bn // tn) * ks <= 1024
        for K in (1, 4, 37, 128, 129, 300, 4096):
            for kc in (4, 64, 128):
                p = kp.matmul_plan(7, K, 9, tile, kc)
                assert p["kc"] % 4 == 0 and 4 <= p["kc"] <= kc
                assert (p["chunks"] - 1) * p["kc"] < K <= p["chunks"] * p["kc"]
                assert p["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("shape_a,shape_b,match", [
    ((16 * 65535 + 1, 1), (1, 1), "too large for P2's grid"),
    ((46341, 1), (1, 46341), "too large for P2's grid"),
])
def test_matmul_probe_refuses_what_its_grid_cannot_take(shape_a, shape_b,
                                                        match):
    """Refused on every device, before the plain version or a build: at
    most 65,535 rows of tiles, at most 2^31 - 1 outputs."""
    with pytest.raises(ValueError, match=match):
        kp.matmul_probe(torch.zeros(shape_a), torch.zeros(shape_b))
    kp.matmul_probe(torch.zeros(16 * 65535, 1), torch.zeros(1, 1))


def matmul_model(a, b, plan):
    """P2 as the kernel indexes it, in float64, block by block: each chunk
    of kc depths staged as A's (bm, kc) and B's (kc, bn) tiles (depth,
    row and column indices, -1 where the kernel stages a zero) in buffer
    chunk % 2, filled after the barrier that follows the read of the chunk
    it held; thread (ty, tx) of depth slice s reads tm rows of A and tn
    columns of B at the chunk's depths 4 s .. 4 s + 3, 4 (s + ks) ..., up
    to the chunk's K rounded up to 4; the first slice adds the others'
    partial sums and writes the outputs inside (M, N). Returns (out,
    writes, count): count[m, n, k] the products a[m, k] b[k, n] summed
    into out[m, n]."""
    M, K = a.shape
    N = b.shape[1]
    bm, bn, tm, tn, ks, kc = (plan[k] for k in ("bm", "bn", "tm", "tn", "ks",
                                                "kc"))
    tx_n = bn // tn
    tile = plan["threads"] // ks
    out = np.full((M, N), np.nan)
    writes = np.zeros((M, N), np.int64)
    count = np.zeros((M, N, K), np.int64)
    ty, tx = np.divmod(np.arange(tile), tx_n)
    for by in range(plan["grid"][1]):
        for bx in range(plan["grid"][0]):
            m0, n0 = by * bm, bx * bn
            acc = np.zeros((ks, tile, tm, tn))    # (slice, thread, ...)
            held, read_done, tiles = {}, set(), {}

            def load(ch):
                if ch >= plan["chunks"]:
                    return
                buf = ch % 2
                assert held.get(buf) is None or held[buf] in read_done
                held[buf] = ch
                k = ch * kc + np.arange(kc)
                r = m0 + np.arange(bm)
                c = n0 + np.arange(bn)
                ka = np.where((r[:, None] < M) & (k[None, :] < K), k, -1)
                kb = np.where((k[:, None] < K) & (c[None, :] < N),
                              k[:, None], -1)
                tiles[buf] = (ka, kb)

            load(0)
            for ch in range(plan["chunks"]):
                if ch:
                    read_done.add(ch - 1)
                load(ch + 1)
                ka, kb = tiles[ch % 2]
                depth = min(kc, -(-(K - ch * kc) // 4) * 4)
                # slice s reads the depths 4 s .. 4 s + 3, 4 (s + ks) ...
                for kk in range(depth):
                    sl = (kk // 4) % ks
                    for i in range(tm):
                        row = ty * tm + i                    # tile row
                        ki = ka[row, kk]
                        for j in range(tn):
                            col = tx * tn + j
                            kj = kb[kk, col]
                            both = (ki >= 0) & (kj >= 0)
                            # a staged product pairs a[m, k] with b[k, n]
                            assert np.all(ki[both] == kj[both])
                            gm, gn = m0 + row, n0 + col
                            av = np.where(ki >= 0, a[np.minimum(gm, M - 1),
                                                     np.maximum(ki, 0)], 0)
                            bv = np.where(kj >= 0, b[np.maximum(kj, 0),
                                                     np.minimum(gn, N - 1)], 0)
                            acc[sl, :, i, j] += av * bv
                            hit = both & (gm < M) & (gn < N)
                            np.add.at(count, (gm[hit], gn[hit], ki[hit]), 1)
            total = acc[0]
            for sl in range(1, ks):     # the first slice adds the others
                total = total + acc[sl]
            for i in range(tm):
                for j in range(tn):
                    gm, gn = m0 + ty * tm + i, n0 + tx * tn + j
                    inside = (gm < M) & (gn < N)
                    out[gm[inside], gn[inside]] = total[inside, i, j]
                    np.add.at(writes, (gm[inside], gn[inside]), 1)
    return out, writes, count


@pytest.mark.parametrize("M,K,N", [(100, 37, 53), (17, 300, 5), (1, 1, 1),
                                   (33, 130, 65)])
@pytest.mark.parametrize("tile,kc", [(kp.MATMUL_TILE, kp.MATMUL_KC),
                                     ((16, 32, 2, 2, 1), 128),
                                     ((32, 32, 2, 4, 4), 64),
                                     ((16, 64, 2, 4, 4), 4)])
def test_matmul_tile_model_writes_each_output_once(M, K, N, tile, kc):
    rng = np.random.RandomState(M + K + N)
    a, b = rng.randn(M, K), rng.randn(K, N)
    out, writes, count = matmul_model(a, b, kp.matmul_plan(M, K, N, tile,
                                                           kc))
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(count, 1)
    np.testing.assert_allclose(out, a @ b, rtol=1e-12, atol=1e-12)
