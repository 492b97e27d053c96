// The two toolchain probes, P1 and P2, for Hopper.
//
// P1 replaces the Pallas kernel tools/pallas_probe.py::kernel (its
// pallas_call at line 17): out = x * 2 + 1, elementwise, on one (8, 128)
// float32 block. Bound on the H100 SXM: bytes, 8,192 of them (4,096 read,
// 4,096 written), about 2.4 ns at 3.35 TB/s: the launch alone takes a
// thousand times longer, so the probe is launch-bound whatever its design.
// One thread per element. x * 2 is exact, so the sum is rounded once, as
// the plain version (x * 2 + 1 in PyTorch) rounds it.
//
// P2 replaces tools/pallas_probe.py::mm_kernel (its pallas_call at line 39):
// out = a @ b for a (256, 128) and b (128, 256) in float32, summed in
// float32, in the kernel's own body (no cuBLAS). Bound: 16.8 MFLOP, about
// 0.25 us at the H100's 67 TFLOP/s float32 rate outside the tensor cores,
// against 512 KB moved (0.16 us at 3.35 TB/s): operations. At this size
// the product is a few microseconds of latency, not of arithmetic: the
// earlier design (one output a thread, K walked in 16-wide tiles, 16
// barriers a block) made 8 round trips to memory one after another.
//
// Design. A block computes a BM x BN tile of the output, each thread TM x
// TN outputs kept in registers (the wrapper's planner picks the tile from
// the instantiations below: 16 x 32, 2 x 2 a thread, at the probe's size).
// The K axis is staged in chunks of kc (the whole of K = 128 at the probe's
// size, one chunk) through a ring of two shared-memory buffers: every
// thread issues the cp.async copies of the next chunk (16 bytes where a
// row is 16-byte aligned, 4 otherwise, chosen in the kernel) and goes on to
// the chunk that has landed, so the block pays one memory round trip and
// meets at one barrier per chunk. The depths of a chunk are split over KS
// slices of threads (4 at the probe's size, 512 threads), depth groups of
// 4 dealt in turn, so that each output's chain of fused multiply-adds is
// K / KS long instead of K; at the end the other slices hand their partial
// sums to the first through shared memory and it adds them in slice order.
// A's tile is stored row by row and read as float4 along K (a warp's lanes
// read one or two rows: broadcasts); B's row by row and read as float2 or
// float4 along N (consecutive lanes, consecutive addresses): 6 shared
// loads per 16 FMAs at 2 x 2 outputs a thread, where the earlier design
// took 2 per FMA. Rows, columns and depths past M, N and K are staged as
// zeros, and only outputs inside (M, N) are written. The TPU kernel's
// product ran on the matrix unit; TF32 tensor cores would round the inputs
// to 10 mantissa bits and miss the probe's 1e-4 tolerance at depth 128, so
// this one stays in float32 FMAs on the CUDA cores.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/probe.py binds it with ctypes.

#include "common.cuh"

namespace {

constexpr int kAffineThreads = 256;

__global__ void __launch_bounds__(kAffineThreads)
probe_affine_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(__fmul_rn(x[i], 2.0f), 1.0f);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void zero4(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Start copying rows [m0, m0 + BM) x depths [k0, k0 + kc) of a (M, K) into
// sa (BM, kc), zeros outside a. wide: K % 4 == 0 and a 16-byte aligned.
template <int BM>
__device__ __forceinline__ void stage_a(float* sa, const float* __restrict__ a, int M, int K,
                                        int m0, int k0, int kc, bool wide) {
  if (wide) {
    const int q = kc / 4;
    for (int i = threadIdx.x; i < BM * q; i += blockDim.x) {
      const int r = i / q;
      const int k = 4 * (i - r * q);
      float* dst = sa + r * kc + k;
      if (m0 + r < M && k0 + k < K) {
        cp_async16(dst, a + static_cast<size_t>(m0 + r) * K + k0 + k);
      } else {
        zero4(dst);
      }
    }
  } else {
    for (int i = threadIdx.x; i < BM * kc; i += blockDim.x) {
      const int r = i / kc;
      const int k = i - r * kc;
      if (m0 + r < M && k0 + k < K) {
        cp_async4(sa + i, a + static_cast<size_t>(m0 + r) * K + k0 + k);
      } else {
        sa[i] = 0.0f;
      }
    }
  }
}

// Start copying depths [k0, k0 + kc) x columns [n0, n0 + BN) of b (K, N)
// into sb (kc, BN), zeros outside b. wide: N % 4 == 0 and b 16-byte
// aligned.
template <int BN>
__device__ __forceinline__ void stage_b(float* sb, const float* __restrict__ b, int K, int N,
                                        int n0, int k0, int kc, bool wide) {
  if (wide) {
    constexpr int q = BN / 4;
    for (int i = threadIdx.x; i < kc * q; i += blockDim.x) {
      const int k = i / q;
      const int c = 4 * (i - k * q);
      float* dst = sb + k * BN + c;
      if (k0 + k < K && n0 + c < N) {
        cp_async16(dst, b + static_cast<size_t>(k0 + k) * N + n0 + c);
      } else {
        zero4(dst);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kc * BN; i += blockDim.x) {
      const int k = i / BN;
      const int c = i - k * BN;
      if (k0 + k < K && n0 + c < N) {
        cp_async4(sb + i, b + static_cast<size_t>(k0 + k) * N + n0 + c);
      } else {
        sb[i] = 0.0f;
      }
    }
  }
}

template <int TN>
__device__ __forceinline__ void load_row(const float* p, float (&v)[TN]) {
  if constexpr (TN == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    static_assert(TN == 2, "TN is 2 or 4");
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// Floats of one ring buffer: A's (BM, kc) tile, then B's (kc, BN).
__host__ __device__ inline int stage_floats(int bm, int bn, int kc) { return (bm + bn) * kc; }

// Buffers of the ring: two when K takes more than one chunk.
__host__ __device__ inline int ring_buffers(int K, int kc) { return K > kc ? 2 : 1; }

// Shared floats of a block: the ring, or the KS - 1 partial tiles that the
// depth slices other than the first hand over at the end, whichever is
// larger (the partials reuse the ring).
__host__ __device__ inline int block_floats(int bm, int bn, int ks, int K, int kc) {
  const int ring = ring_buffers(K, kc) * stage_floats(bm, bn, kc);
  const int parts = (ks - 1) * bm * bn;
  return ring > parts ? ring : parts;
}

template <int BM, int BN, int TM, int TN, int KS>
__global__ void __launch_bounds__((BM / TM) * (BN / TN) * KS)
probe_matmul_kernel(const float* __restrict__ a,  // (M, K)
                    const float* __restrict__ b,  // (K, N)
                    float* __restrict__ out,      // (M, N)
                    int M, int K, int N, int kc) {
  constexpr int TX = BN / TN;             // threads along a row of the tile
  constexpr int TILE = (BM / TM) * TX;    // threads of one depth slice
  extern __shared__ __align__(16) float smem[];
  const int stage = stage_floats(BM, BN, kc);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int slice = threadIdx.x / TILE;   // its depths: 4 slice, 4 (slice + KS), ...
  const int tid = threadIdx.x - slice * TILE;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int nchunks = (K + kc - 1) / kc;
  const bool wide_a = K % 4 == 0 && aligned16(a);
  const bool wide_b = N % 4 == 0 && aligned16(b);

  auto load = [&](int ch) {
    if (ch >= nchunks) return;
    float* buf = smem + (ch & 1) * stage;
    stage_a<BM>(buf, a, M, K, m0, ch * kc, kc, wide_a);
    stage_b<BN>(buf + BM * kc, b, K, N, n0, ch * kc, kc, wide_b);
    cp_async_commit();
  };
  load(0);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<0>();
    // chunk ch has landed for every thread, and every thread is done with
    // chunk ch - 1, whose buffer the next load refills
    __syncthreads();
    load(ch + 1);

    const float* buf = smem + (ch & 1) * stage;
    const float* sa = buf + ty * TM * kc;
    const float* sb = buf + BM * kc + tx * TN;
    const int depth = min(kc, pad4(K - ch * kc));  // past K the tiles hold zeros
#pragma unroll 4
    for (int kk = 4 * slice; kk < depth; kk += 4 * KS) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = *reinterpret_cast<const float4*>(sa + i * kc + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
        load_row<TN>(sb + (kk + q) * BN, bv);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = lane_of(av[i], q);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
        }
      }
    }
  }

  if constexpr (KS > 1) {
    // the other slices hand their partial sums to the first, which adds
    // them in slice order
    float* part = smem;  // (KS - 1, BM, BN), over the ring once all have read it
    __syncthreads();
    if (slice > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          part[((slice - 1) * BM + ty * TM + i) * BN + tx * TN + j] = acc[i][j];
        }
      }
    }
    __syncthreads();
    if (slice > 0) return;
#pragma unroll
    for (int s = 0; s < KS - 1; ++s) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += part[(s * BM + ty * TM + i) * BN + tx * TN + j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col < N) out[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN, int KS>
size_t matmul_smem(int K, int kc) {
  return static_cast<size_t>(block_floats(BM, BN, KS, K, kc)) * sizeof(float);
}

template <int BM, int BN, int TM, int TN, int KS>
cudaError_t matmul_set_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(probe_matmul_kernel<BM, BN, TM, TN, KS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int BM, int BN, int TM, int TN, int KS>
int matmul_launch(const float* a, const float* b, float* out, int M, int K, int N, int kc,
                  cudaStream_t stream) {
  const size_t smem = matmul_smem<BM, BN, TM, TN, KS>(K, kc);
  const cudaError_t e = matmul_set_smem<BM, BN, TM, TN, KS>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  probe_matmul_kernel<BM, BN, TM, TN, KS>
      <<<grid, (BM / TM) * (BN / TN) * KS, smem, stream>>>(a, b, out, M, K, N, kc);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int TM, int TN, int KS>
int matmul_occupancy(int K, int kc) {
  const size_t smem = matmul_smem<BM, BN, TM, TN, KS>(K, kc);
  cudaError_t e = matmul_set_smem<BM, BN, TM, TN, KS>(smem);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, probe_matmul_kernel<BM, BN, TM, TN, KS>, (BM / TM) * (BN / TN) * KS, smem);
  }
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

template <int BM, int BN, int TM, int TN, int KS>
int matmul_registers() {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, probe_matmul_kernel<BM, BN, TM, TN, KS>);
  return e == cudaSuccess ? attr.numRegs : -static_cast<int>(e);
}

}  // namespace

// The tiles P2 is built for, (BM, BN, TM, TN, KS): a block's BM x BN
// outputs, TM x TN a thread, each chunk's depths split over KS slices of
// threads; kernels/probe.py's MATMUL_TILES, in the same order.
#define SCAE_MATMUL_TILES(X) \
  X(16, 32, 2, 2, 1)         \
  X(16, 32, 2, 2, 2)         \
  X(16, 32, 2, 2, 4)         \
  X(32, 32, 2, 2, 2)         \
  X(32, 32, 2, 4, 4)         \
  X(16, 16, 2, 2, 4)         \
  X(16, 64, 2, 4, 4)

extern "C" {

// Launches P1 on `stream` and returns cudaGetLastError() (0 on success).
// x and out are contiguous float32 device arrays of n elements.
int scae_probe_affine(const void* x, void* out, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kAffineThreads - 1) / kAffineThreads;
  probe_affine_kernel<<<blocks, kAffineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Launches P2 on `stream` and returns cudaGetLastError() (0 on success).
// a (M, K), b (K, N) and out (M, N) are contiguous float32 device arrays.
// The plan comes from the wrapper's planner: a tile (bm, bn, tm, tn, ks)
// of SCAE_MATMUL_TILES and a chunk of kc depths, a multiple of 4 from 4 to
// 256; at most 65,535 rows of tiles.
int scae_probe_matmul(const void* a, const void* b, void* out, int M, int K, int N, int bm,
                      int bn, int tm, int tn, int ks, int kc, void* stream) {
  if (M < 1 || K < 1 || N < 1 || kc < 4 || kc > 256 || kc % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  auto* po = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define SCAE_MATMUL_CASE(BM, BN, TM, TN, KS)                                        \
  if (bm == BM && bn == BN && tm == TM && tn == TN && ks == KS) {                   \
    if ((M + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue); \
    return matmul_launch<BM, BN, TM, TN, KS>(pa, pb, po, M, K, N, kc, s);          \
  }
  SCAE_MATMUL_TILES(SCAE_MATMUL_CASE)
#undef SCAE_MATMUL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of P2 that fit on one SM for this plan at depth K
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a cudaError_t.
int scae_probe_matmul_occupancy(int bm, int bn, int tm, int tn, int ks, int K, int kc) {
#define SCAE_MATMUL_OCC(BM, BN, TM, TN, KS)                        \
  if (bm == BM && bn == BN && tm == TM && tn == TN && ks == KS) \
    return matmul_occupancy<BM, BN, TM, TN, KS>(K, kc);
  SCAE_MATMUL_TILES(SCAE_MATMUL_OCC)
#undef SCAE_MATMUL_OCC
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread of P2 takes for this tile, or minus a cudaError_t.
int scae_probe_matmul_registers(int bm, int bn, int tm, int tn, int ks) {
#define SCAE_MATMUL_REGS(BM, BN, TM, TN, KS)                       \
  if (bm == BM && bn == BN && tm == TM && tn == TN && ks == KS) \
    return matmul_registers<BM, BN, TM, TN, KS>();
  SCAE_MATMUL_TILES(SCAE_MATMUL_REGS)
#undef SCAE_MATMUL_REGS
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
