// Dense fused template-decoder reconstruction log-likelihood, forward, for
// Hopper (K4f).
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_decoder_ll.py::_fwd_kernel
// (its pallas_call at line 390, grid (B,)). Its function, written out in
// jnp, is scae_tpu/ops/decoder_ll.py::_forward with float32 taps, ported as
// scae_tpu_torch/ops/decoder_ll.py (this kernel's plain version):
//   (ix, iy)   = source coordinates of pixel p under capsule m's pose
//   wx[w]      = relu(1 - |ix - w|) for every template column w (wy likewise)
//   V[m, cc]   = sum_h wy[h] * sum_w wx[w] * table[m, cc, h, w]
//                (cc < C: template channels, cc = C: alpha logit)
//   mix[m]     = V[m, C] + log_safe(presence[m])
//   den        = LSE over {mix[m]} + {bg_mix}
//   num[c]     = LSE over {mix[m] + lp(t[c] | V[m, c])} + {bg_mix + lp(t[c] | bg_value)}
//   ll[c]      = num[c] - den,   lp(t | v) = -(t - v)^2 / (2 s^2) - log s - log sqrt(2 pi)
//
// The TPU kernel evaluates every template row and column for every pixel
// (2 Ht Wt (C+1) operations per capsule-pixel pair: 484 at the flagship).
// relu(1 - |ix - w|) is nonzero only for w = floor(ix) and floor(ix) + 1, so
// this kernel evaluates those two columns and two rows, each weight by the
// same formula as the plain version (common.cuh::two_taps); the other taps
// have weight exactly 0 and add nothing. What differs from the gather
// kernel (K1) is the memory plan: shared memory holds a ring of a few
// chunks of capsules, never all M of them, so its size does not depend on
// M, and every template size whose two one-capsule chunks fit in a block's
// 227 KB runs, for any M.
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40): the
// same function as K1's, ~5.9 MB of inputs and outputs (1.8 us at 3.35
// TB/s) against 8.19 M capsule-pixel pairs of about 62 f32 operations (7.58
// us at 67 TFLOP/s; chip_smoke.py's k1_bound_ms counts them), so the kernel
// is bound by f32 operations. The dense count of the TPU's formulation
// would be ~4 GFLOP, 60 us.
//
// Design. A block takes one tile of an example's pixels, kPixels = 2 a
// thread (the wrapper's planner picks the tiles and the threads so that few
// lanes idle: at the flagship 2 tiles of 800 pixels, 416 threads of 2
// pixels each). It streams the example's capsules through a ring of two
// shared-memory buffers of `chunk` capsules each (tables, poses,
// presences; the tables texel-major, all planes of a texel side by side,
// so that a tap is one 8-byte load at C = 1, where the earlier plane-major
// layout took two loads and two addresses): every thread issues cp.async
// copies (4 bytes each, scattered into that layout) of the next chunk and
// goes on to the chunk that has landed, so no thread waits on its own
// copies before its pixels' work, and the block meets at one barrier per
// chunk, where the chunk it reads has landed and the buffer it refills has
// been read. (Three buffers, which put two chunks' copies in flight before
// the first is read, were 3% slower at the flagship and no faster at the
// cifar10 shape: PERF.md, section 6.) A lane of each warp takes one
// capsule's log-presence (a logf) and the warp shares them by shuffles.
// The per-pixel log-sum-exps are streamed over the capsules without a
// branch (common.cuh::lse_push), as in K1; each thread's pixels are
// independent chains that overlap their latencies.
//
// The output grid comes from the wrapper (scae_tpu_torch/ops/warp.py's
// float64-rounded _base_grid) and the coordinates are evaluated with
// PyTorch's rounding (no fused multiply-adds), so the taps are the plain
// version's.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_dense.py binds it with ctypes.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kPixels = 2;  // pixels a thread, independent chains
constexpr int kStages = 2;  // buffers of the ring

// Start copying `n` floats that lie (planes, T) in global memory, Per
// planes a capsule (plane k = j Per + c of capsule j), into the texel-major
// table of CC floats a texel: float c of texel t of capsule j to
// (j T + t) CC + c0 + c.
template <int CC, int Per>
__device__ __forceinline__ void stage_planes(float* tab, const float* __restrict__ src, int n,
                                             int c0, int T, float inv_t) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int t;
    const int k = div_t(i, T, inv_t, t);
    const int j = k / Per;
    cp_async4(tab + (j * T + t) * CC + c0 + (k - j * Per), src + i);
  }
}

__host__ __device__ inline size_t shared_bytes(int C, int T, int chunk) {
  return static_cast<size_t>(kStages) * Stage(chunk, C, T).size * sizeof(float);
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
decoder_ll_dense_fwd_kernel(const float* __restrict__ templates,  // (B, M, C, Ht*Wt)
                            const float* __restrict__ alpha,      // (1 or B, M, Ht*Wt)
                            const float* __restrict__ pose,       // (B, M, 6)
                            const float* __restrict__ presence,   // (B, M)
                            const float* __restrict__ target,     // (B, C, P)
                            const float* __restrict__ scal,       // bg_value, bg_mix, scale
                            const float* __restrict__ grid_x,     // (P,) output x in [-1, 1]
                            const float* __restrict__ grid_y,     // (P,) output y in [-1, 1]
                            float* __restrict__ ll,               // (B, C, P)
                            float* __restrict__ num,              // (B, C, P)
                            float* __restrict__ den,              // (B, 1, P)
                            int M, int Ht, int Wt, int H, int W, int alpha_batched, int tiles,
                            int chunk) {
  constexpr int CC = C + 1;
  extern __shared__ __align__(16) float smem[];
  const int T = Ht * Wt;
  const int P = H * W;
  const Stage L(chunk, C, T);
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int tile_px = (P + tiles - 1) / tiles;
  const int p_end = min(P, (tile + 1) * tile_px);
  const int p0 = tile * tile_px + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int nchunks = (M + chunk - 1) / chunk;
  const float inv_t = 1.0f / static_cast<float>(T);

  auto load = [&](int ch) {
    if (ch >= nchunks) return;
    float* buf = smem + (ch % kStages) * L.size;
    const int m0 = ch * chunk;
    const int n = min(chunk, M - m0);
    const size_t bm = static_cast<size_t>(b) * M + m0;
    stage_planes<CC, C>(buf, templates + bm * C * T, n * C * T, 0, T, inv_t);
    stage_planes<CC, 1>(buf, alpha + (alpha_batched ? bm : static_cast<size_t>(m0)) * T,
                        n * T, C, T, inv_t);
    copy_async(buf + L.pose, pose + bm * 6, n * 6);
    copy_async(buf + L.pres, presence + bm, n);
    cp_async_commit();
  };
  load(0);

  const float bg_value = scal[0];
  const float bg_mix = scal[1];
  const float scale = scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float neg_const = -logf(scale) - kLogSqrt2Pi;
  const float fHt = static_cast<float>(Ht);
  const float fWt = static_cast<float>(Wt);

  // the background component enters every LSE once, as its first term
  float gx[kPixels], gy[kPixels], t[kPixels][C], nm[kPixels][C], ns[kPixels][C], dm[kPixels],
      ds[kPixels];
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int p = p0 + k * blockDim.x;
    const bool active = p < p_end;
    gx[k] = active ? grid_x[p] : 0.0f;
    gy[k] = active ? grid_y[p] : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      t[k][c] = active ? target[(static_cast<size_t>(b) * C + c) * P + p] : 0.0f;
      const float d = t[k][c] - bg_value;
      nm[k][c] = bg_mix + (-(d * d) * inv_2var + neg_const);
      ns[k][c] = 1.0f;
    }
    dm[k] = bg_mix;
    ds[k] = 1.0f;
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<0>();
    // chunk ch has landed for every thread, and every thread is done with
    // chunk ch - 1, whose buffer the next load refills
    __syncthreads();
    load(ch + 1);

    const float* buf = smem + (ch % kStages) * L.size;
    const int n = min(chunk, M - ch * chunk);
    const float lp_lane = lane < n ? log_safe(buf[L.pres + lane]) : 0.0f;
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float lp = __shfl_sync(kFull, lp_lane, j);
      const float2* pj = reinterpret_cast<const float2*>(buf + L.pose + 6 * j);
      const float2 p01 = pj[0], p23 = pj[1], p45 = pj[2];
      const float* tab = buf + j * T * CC;
#pragma unroll
      for (int k = 0; k < kPixels; ++k) {
        const float ix = source_coord(p01.x, p01.y, p23.x, gx[k], gy[k], fWt);
        const float iy = source_coord(p23.y, p45.x, p45.y, gx[k], gy[k], fHt);
        float wx[2], wy[2];
        int kx[2], ky[2];
        two_taps(ix, Wt, wx, kx);
        two_taps(iy, Ht, wy, ky);
        const int r0 = ky[0] * Wt;
        const int r1 = ky[1] * Wt;
        float t00[CC], t01[CC], t10[CC], t11[CC], v[CC];
        load_texel<CC>(tab + (r0 + kx[0]) * CC, t00);
        load_texel<CC>(tab + (r0 + kx[1]) * CC, t01);
        load_texel<CC>(tab + (r1 + kx[0]) * CC, t10);
        load_texel<CC>(tab + (r1 + kx[1]) * CC, t11);
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          // S[h] = sum_w T[h, w] wx[w], then V = sum_h S[h] wy[h]
          const float s0 = t00[cc] * wx[0] + t01[cc] * wx[1];
          const float s1 = t10[cc] * wx[0] + t11[cc] * wx[1];
          v[cc] = s0 * wy[0] + s1 * wy[1];
        }
        const float mix = v[C] + lp;
        lse_push(mix, dm[k], ds[k]);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float d = t[k][c] - v[c];
          lse_push(mix + (-(d * d) * inv_2var + neg_const), nm[k][c], ns[k][c]);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int p = p0 + k * blockDim.x;
    if (p >= p_end) continue;
    const float den_lse = logf(ds[k]) + dm[k];
    den[static_cast<size_t>(b) * P + p] = den_lse;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t o = (static_cast<size_t>(b) * C + c) * P + p;
      const float num_lse = logf(ns[k][c]) + nm[k][c];
      num[o] = num_lse;
      ll[o] = num_lse - den_lse;
    }
  }
}

template <int C>
cudaError_t set_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(decoder_ll_dense_fwd_kernel<C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int C>
int launch(const float* templates, const float* alpha, const float* pose,
           const float* presence, const float* target, const float* scal,
           const float* grid_x, const float* grid_y, float* ll, float* num, float* den, int B,
           int M, int Ht, int Wt, int H, int W, int alpha_batched, int tiles, int threads,
           int chunk, cudaStream_t stream) {
  const size_t smem = shared_bytes(C, Ht * Wt, chunk);
  const cudaError_t e = set_smem<C>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  decoder_ll_dense_fwd_kernel<C><<<B * tiles, threads, smem, stream>>>(
      templates, alpha, pose, presence, target, scal, grid_x, grid_y, ll, num, den, M, Ht, Wt,
      H, W, alpha_batched, tiles, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int occupancy(int Ht, int Wt, int threads, int chunk) {
  const size_t smem = shared_bytes(C, Ht * Wt, chunk);
  cudaError_t e = set_smem<C>(smem);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, decoder_ll_dense_fwd_kernel<C>, threads, smem);
  }
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

bool valid_plan(int C, int H, int W, int tiles, int threads, int chunk) {
  if (C < 1 || C > 4 || tiles < 1 || chunk < 1 || chunk > 32) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return false;
  // the tiles' pixels fit the threads
  const int tile_px = (H * W + tiles - 1) / tiles;
  return tile_px <= threads * kPixels;
}

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 device array (see the
// kernel's parameter comments for the shapes); grid_x and grid_y are the
// output grid as scae_tpu_torch/ops/warp.py::_base_grid gives it,
// flattened. The plan comes from the wrapper's planner: `tiles` pixel tiles
// per example of at most 2 x threads pixels, threads a multiple of 32 up
// to 512, chunks of 1..32 capsules in a ring of two buffers. C must be
// 1..4.
int scae_decoder_ll_dense_fwd(const void* templates, const void* alpha, const void* pose,
                              const void* presence, const void* target, const void* scal,
                              const void* grid_x, const void* grid_y, void* ll, void* num,
                              void* den, int B, int M, int C, int Ht, int Wt, int H, int W,
                              int alpha_batched, int tiles, int threads, int chunk,
                              void* stream) {
  if (B < 1 || M < 1 || !valid_plan(C, H, W, tiles, threads, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const float*>(templates);
  const auto* a = static_cast<const float*>(alpha);
  const auto* po = static_cast<const float*>(pose);
  const auto* pr = static_cast<const float*>(presence);
  const auto* tg = static_cast<const float*>(target);
  const auto* sc = static_cast<const float*>(scal);
  const auto* gxs = static_cast<const float*>(grid_x);
  const auto* gys = static_cast<const float*>(grid_y);
  auto* o_ll = static_cast<float*>(ll);
  auto* o_num = static_cast<float*>(num);
  auto* o_den = static_cast<float*>(den);
  auto s = static_cast<cudaStream_t>(stream);
#define SCAE_FWD_CASE(N)                                                                      \
  if (C == N)                                                                                 \
    return launch<N>(t, a, po, pr, tg, sc, gxs, gys, o_ll, o_num, o_den, B, M, Ht, Wt, H, W, \
                     alpha_batched, tiles, threads, chunk, s);
  SCAE_FWD_CASE(1) SCAE_FWD_CASE(2) SCAE_FWD_CASE(3) SCAE_FWD_CASE(4)
#undef SCAE_FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the forward kernel that fit on one SM for this plan
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a cudaError_t.
int scae_decoder_ll_dense_fwd_occupancy(int C, int Ht, int Wt, int threads, int chunk) {
#define SCAE_OCC_CASE(N) \
  if (C == N) return occupancy<N>(Ht, Wt, threads, chunk);
  SCAE_OCC_CASE(1) SCAE_OCC_CASE(2) SCAE_OCC_CASE(3) SCAE_OCC_CASE(4)
#undef SCAE_OCC_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
