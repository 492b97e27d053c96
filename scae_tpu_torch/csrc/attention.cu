// Presence-masked set attention, forward, for Hopper (K6).
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_attention.py::_attention_kernel
// (its pallas_call at line 99, grid (B,)). Per batch row b (the set
// transformer folds its heads into b):
//   s[n, m] = sum_d q[n, d] k[m, d]
//   a[n, :] = softmax((s[n, :] - (1 - presence[m]) * 1e9) / sqrt(d_k))
//   o[n, j] = sum_m a[n, m] v[m, j]
// with the mask subtracted before the scaling, as the JAX package and its
// reference do. Its plain version is scae_tpu_torch/ops/attention.py's plain
// path. The penalty is rounded on its own before it is subtracted (no fused
// multiply-add): (1 - p) * 1e9 carries an error of up to 32 in f32, and a
// contracted s - (1 - p) * 1e9 would round elsewhere than the plain version
// and move a logit by that much. A set whose presence is all 0 gives every
// logit the same -1e9 offset (exactly -1e9 where |s| < 32), so the max
// subtraction of the softmax keeps it finite and, there, uniform.
//
// Bound on the H100 SXM: bytes. At the flagship's final attention (b = 128,
// N = 32, M = 40, d_k = d_v = 256) it moves 18.9 MB (5.6 us at 3.35 TB/s)
// for 0.17 GFLOP (2.5 us at 67 TFLOP/s); the three set-attention blocks
// (128, 40, 40, 16) move 1.3 MB (0.4 us), where a launch costs more.
//
// Design. A block takes one tile of query rows of one batch row: `warps`
// warps of R rows each (the wrapper's planner picks R and the warps; the
// grid is B x ceil(N / (warps R)) blocks, so a batch row's keys and values
// are read by each of its tiles, the repeats from L2). Every thread issues
// cp.async copies of the tile's Q and of K as one group and of V as a
// second, and goes on: V lands while the scores are computed, and the block
// meets at a barrier only where the copies it waits for land, twice. A warp
// owns its R query rows from then on: each lane computes the scores of keys
// lane and lane + 32 for all R rows at once (one shared-memory load of a
// key chunk feeds R fused multiply-adds per element, a query chunk is one
// broadcast load), writes the logits to the warp's own rows, takes the
// softmax with shuffles and no block barrier, and sums the values for the
// columns it holds: 4 a lane at a time over every key where a value row has
// more than 16 such chunks (d_v above 64), else in teams of lanes that
// split the keys and add their sums with shuffles. Where d_k and d_v are multiples of 4 and the
// inputs 16-byte aligned (the wrapper checks), copies, shared-memory loads
// and stores move 16 bytes; elsewhere 4, with a key row stride that is
// odd so that the lanes' scalar loads meet no bank conflict. Products and
// sums are f32 on the CUDA cores. Each dot product runs over d in order.
// Where one lane takes every key of its value columns (more than 16 chunks
// a row), each weighted sum runs over m in order, as in the earlier
// one-block-per-row design; where teams of lanes split the keys (d_v of 64
// or less with 16-byte rows, 16 or less with 4-byte rows, as in the
// set-attention blocks at d_v = 16), team t of T sums m = t, t + T, ... in
// order and the teams' sums are added by an xor butterfly, another order
// than the plain version's but the same one on every run. No atomics: the
// results repeat bit for bit.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/attention.py binds it with ctypes.

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;

__device__ __forceinline__ float warp_max_all(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum_all(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// L consecutive floats of shared memory: one 16-byte load where L is 4.
template <int L>
struct Chunk {
  float x[L];
};

template <int L>
__device__ __forceinline__ Chunk<L> load_chunk(const float* p) {
  Chunk<L> c;
  if constexpr (L == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    c.x[0] = v.x;
    c.x[1] = v.y;
    c.x[2] = v.z;
    c.x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < L; ++e) c.x[e] = p[e];
  }
  return c;
}

// Start copying `rows` rows of `width` floats (global row stride `width`)
// into shared rows of stride `ld`: 16 bytes a copy where Vec, else 4.
template <bool Vec>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* __restrict__ src,
                                           int width, int rows) {
  constexpr int L = Vec ? 4 : 1;
  const int per_row = width / L;
  const int n = rows * per_row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * L;
    if constexpr (Vec) {
      cp_async16(dst + r * ld + c, src + static_cast<size_t>(r) * width + c);
    } else {
      cp_async4(dst + r * ld + c, src + static_cast<size_t>(r) * width + c);
    }
  }
}

// Scores of keys mc + lane (and mc + 32 + lane where S is 2) against the
// warp's R query rows, written as logits to the warp's rows of `sw`.
template <int R, int S, int L>
__device__ __forceinline__ void score_pass(const float* sq, int ldq, const float* sk, int ldk,
                                           const float* spen, float* wrow, int M, int chunks,
                                           int mc, int lane, float root) {
  const float* krow[S];
#pragma unroll
  for (int s = 0; s < S; ++s) krow[s] = sk + min(mc + 32 * s + lane, M - 1) * ldk;
  float acc[R][S];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < S; ++s) acc[r][s] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    Chunk<L> kc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) kc[s] = load_chunk<L>(krow[s] + c * L);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const Chunk<L> qc = load_chunk<L>(sq + r * ldq + c * L);
#pragma unroll
      for (int e = 0; e < L; ++e)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[r][s] = fmaf(qc.x[e], kc[s].x[e], acc[r][s]);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int m = mc + 32 * s + lane;
    if (m < M) {
      const float pen = spen[m];
#pragma unroll
      for (int r = 0; r < R; ++r) wrow[r * M + m] = __fdiv_rn(__fsub_rn(acc[r][s], pen), root);
    }
  }
}

// The weighted sums of value chunks g0 (and g0 + 32 where CG is 2) over the
// keys m = team, team + T, ... for the warp's R rows; with T > 1 the teams'
// sums are added with shuffles (lanes g, g + G2, ... hold one chunk). Team 0
// writes the rows that exist.
template <int R, int CG, int L>
__device__ __forceinline__ void value_pass(const float* sv, int ldv, const float* wrow,
                                           float* __restrict__ ob, int M, int dv, int chunks,
                                           int g0, int team, int T, int G2, int rows_here) {
  const float* vcol[CG];
#pragma unroll
  for (int s = 0; s < CG; ++s) vcol[s] = sv + min(g0 + 32 * s, chunks - 1) * L;
  float acc[R][CG][L];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < CG; ++s)
#pragma unroll
      for (int e = 0; e < L; ++e) acc[r][s][e] = 0.0f;
  for (int m = team; m < M; m += T) {
    Chunk<L> vc[CG];
#pragma unroll
    for (int s = 0; s < CG; ++s) vc[s] = load_chunk<L>(vcol[s] + m * ldv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float w = wrow[r * M + m];
#pragma unroll
      for (int s = 0; s < CG; ++s)
#pragma unroll
        for (int e = 0; e < L; ++e) acc[r][s][e] = fmaf(w, vc[s].x[e], acc[r][s][e]);
    }
  }
  for (int o = G2; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < CG; ++s)
#pragma unroll
        for (int e = 0; e < L; ++e) acc[r][s][e] += __shfl_xor_sync(kFull, acc[r][s][e], o);
  }
  if (team != 0) return;
#pragma unroll
  for (int s = 0; s < CG; ++s) {
    const int g = g0 + 32 * s;
    if (g >= chunks) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows_here) continue;
      float* o = ob + static_cast<size_t>(r) * dv + g * L;
      if constexpr (L == 4) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[r][s][0], acc[r][s][1], acc[r][s][2], acc[r][s][3]);
      } else {
#pragma unroll
        for (int e = 0; e < L; ++e) o[e] = acc[r][s][e];
      }
    }
  }
}

// Shared-memory row strides: Q rows dense; K rows of an odd number of
// chunks (distinct banks for the 32 lanes' loads of 32 keys); V rows of a
// number of chunks that puts the keys of neighbouring lane teams on other
// banks (where a team is narrower than 8 lanes).
__host__ __device__ inline int ld_k(int dk, bool vec) {
  if (!vec) return dk | 1;
  return ((dk / 4) & 1) ? dk : dk + 4;
}

__host__ __device__ inline int team_width(int chunks) {  // G2: lanes per team
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  return g;
}

__host__ __device__ inline int ld_v(int dv, bool vec) {
  if (!vec) return dv;
  const int chunks = dv / 4;
  const int g2 = team_width(chunks);
  if (g2 >= 8) return dv;
  int x = chunks;
  while ((x & 7) != g2) ++x;
  return 4 * x;
}

__host__ __device__ inline size_t shared_floats(int tile, int M, int dk, int dv, bool vec) {
  return static_cast<size_t>(tile) * dk + static_cast<size_t>(M) * ld_k(dk, vec) +
         static_cast<size_t>(M) * ld_v(dv, vec) + (vec ? pad4(M) : M) +
         static_cast<size_t>(tile) * M;
}

template <int R, bool Vec>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
attention_fwd_kernel(const float* __restrict__ q,         // (B, N, dk)
                     const float* __restrict__ k,         // (B, M, dk)
                     const float* __restrict__ v,         // (B, M, dv)
                     const float* __restrict__ presence,  // (B, M)
                     float* __restrict__ out,             // (B, N, dv)
                     int N, int M, int dk, int dv, int tiles) {
  constexpr int L = Vec ? 4 : 1;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int tile = warps * R;
  const int b = blockIdx.x / tiles;
  const int n0 = (blockIdx.x - b * tiles) * tile;
  const int rows = min(tile, N - n0);
  const int ldq = dk;
  const int ldk = ld_k(dk, Vec);
  const int ldv = ld_v(dv, Vec);
  float* sq = smem;                       // (tile, ldq)
  float* sk = sq + tile * ldq;            // (M, ldk)
  float* sv = sk + M * ldk;               // (M, ldv)
  float* spen = sv + M * ldv;             // (M,) penalties (1 - p) * 1e9
  float* sw = spen + (Vec ? pad4(M) : M); // (tile, M) logits, then weights

  stage_rows<Vec>(sq, ldq, q + (static_cast<size_t>(b) * N + n0) * dk, dk, rows);
  stage_rows<Vec>(sk, ldk, k + static_cast<size_t>(b) * M * dk, dk, M);
  cp_async_commit();
  stage_rows<Vec>(sv, ldv, v + static_cast<size_t>(b) * M * dv, dv, M);
  cp_async_commit();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    spen[m] = __fmul_rn(1.0f - presence[static_cast<size_t>(b) * M + m], 1e9f);
  }
  // a last tile of an odd number of rows leaves its last warp's second row
  // unstaged: zeros, so that its (discarded) scores read no stale memory
  for (int i = rows * ldq + threadIdx.x; i < tile * ldq; i += blockDim.x) sq[i] = 0.0f;
  cp_async_wait<1>();
  __syncthreads();  // Q, K and the penalties are in

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * R;  // the warp's first row in the tile
  const bool busy = r0 < rows;
  float* wrow = sw + r0 * M;
  if (busy) {
    const float root = sqrtf(static_cast<float>(dk));
    const float* wq = sq + r0 * ldq;
    const int kchunks = dk / L;
    for (int mc = 0; mc < M; mc += 64) {
      if (M - mc > 32) {
        score_pass<R, 2, L>(wq, ldq, sk, ldk, spen, wrow, M, kchunks, mc, lane, root);
      } else {
        score_pass<R, 1, L>(wq, ldq, sk, ldk, spen, wrow, M, kchunks, mc, lane, root);
      }
    }
    // each lane reads back only the logits it wrote
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* row = wrow + r * M;
      float mx = -__int_as_float(0x7f800000);  // -inf
      for (int m = lane; m < M; m += 32) mx = fmaxf(mx, row[m]);
      mx = warp_max_all(mx);
      float sum = 0.0f;
      for (int m = lane; m < M; m += 32) {
        const float e = expf(row[m] - mx);
        row[m] = e;
        sum += e;
      }
      sum = warp_sum_all(sum);
      for (int m = lane; m < M; m += 32) row[m] = __fdiv_rn(row[m], sum);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // V is in
  if (!busy) return;

  const int vchunks = dv / L;
  const int g2 = team_width(vchunks);
  const int T = 32 / g2;
  const int team = lane / g2;
  const int g = lane - team * g2;
  float* ob = out + (static_cast<size_t>(b) * N + n0 + r0) * dv;
  const int rows_here = rows - r0;
  for (int base = 0; base < vchunks; base += 64) {
    if (vchunks - base > 32) {
      value_pass<R, 2, L>(sv, ldv, wrow, ob, M, dv, vchunks, base + g, team, T, g2, rows_here);
    } else {
      value_pass<R, 1, L>(sv, ldv, wrow, ob, M, dv, vchunks, base + g, team, T, g2, rows_here);
    }
  }
}

template <int R, bool Vec>
cudaError_t set_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(attention_fwd_kernel<R, Vec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int R, bool Vec>
int launch(const float* q, const float* k, const float* v, const float* p, float* o, int B, int N,
           int M, int dk, int dv, int warps, cudaStream_t stream) {
  const int tile = warps * R;
  const size_t smem = shared_floats(tile, M, dk, dv, Vec) * sizeof(float);
  const cudaError_t e = set_smem<R, Vec>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (N + tile - 1) / tile;
  attention_fwd_kernel<R, Vec><<<B * tiles, warps * 32, smem, stream>>>(q, k, v, p, o, N, M, dk,
                                                                        dv, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int R, bool Vec>
int occupancy(int M, int dk, int dv, int warps) {
  const size_t smem = shared_floats(warps * R, M, dk, dv, Vec) * sizeof(float);
  cudaError_t e = set_smem<R, Vec>(smem);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attention_fwd_kernel<R, Vec>,
                                                      warps * 32, smem);
  }
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

bool valid_plan(int N, int M, int dk, int dv, int rows_per_warp, int warps, int vec) {
  if (N < 1 || M < 1 || dk < 1 || dv < 1 || warps < 1 || warps > kMaxWarps) return false;
  if (rows_per_warp != 1 && rows_per_warp != 2) return false;
  return !vec || (dk % 4 == 0 && dv % 4 == 0);
}

}  // namespace

extern "C" {

// Launches K6 on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is a contiguous float32 device array of the shape in the
// kernel's parameter comments. The tile plan comes from the wrapper's
// planner: rows_per_warp 1 or 2, warps 1..8, vec 1 where d_k and d_v
// are multiples of 4 and q, k, v and out 16-byte aligned.
int scae_attention_fwd(const void* q, const void* k, const void* v, const void* presence,
                       void* out, int B, int N, int M, int dk, int dv, int rows_per_warp,
                       int warps, int vec, void* stream) {
  if (B < 1 || !valid_plan(N, M, dk, dv, rows_per_warp, warps, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fp = static_cast<const float*>(presence);
  auto* fo = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define SCAE_ATT_CASE(R, V) \
  if (rows_per_warp == R && (vec != 0) == V) return launch<R, V>(fq, fk, fv, fp, fo, B, N, M, dk, dv, warps, s);
  SCAE_ATT_CASE(1, true)
  SCAE_ATT_CASE(2, true)
  SCAE_ATT_CASE(1, false)
  SCAE_ATT_CASE(2, false)
#undef SCAE_ATT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of K6 that fit on one SM for this plan
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a cudaError_t.
int scae_attention_fwd_occupancy(int N, int M, int dk, int dv, int rows_per_warp, int warps,
                                 int vec) {
  if (!valid_plan(N, M, dk, dv, rows_per_warp, warps, vec)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
#define SCAE_ATT_CASE(R, V) \
  if (rows_per_warp == R && (vec != 0) == V) return occupancy<R, V>(M, dk, dv, warps);
  SCAE_ATT_CASE(1, true)
  SCAE_ATT_CASE(2, true)
  SCAE_ATT_CASE(1, false)
  SCAE_ATT_CASE(2, false)
#undef SCAE_ATT_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
