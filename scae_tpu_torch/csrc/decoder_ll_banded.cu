// Banded, row-windowed fused template-decoder reconstruction
// log-likelihood, forward, for Hopper (K5f).
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_decoder_ll_banded.py::_fwd_kernel
// (its pallas_call at line 523, grid (B,)). It computes the function of the
// dense kernel K4f (decoder_ll_dense.cu; see there for the formulas) on the
// capsules that scae_tpu_torch/kernels/decoder_ll_banded.py has padded to
// whole groups of 8 and sorted by their vertical translation, with the
// TPU kernel's row windows: the canvas is cut into bands of R rows (R W
// pixels, 320 at the flagship), and for every (example, band, group of 8
// capsules) the wrapper passes the template rows [lo, lo + trips) that any
// of the group's capsules can touch from any pixel of the band
// (h_windows). A row tap outside its capsule's window has weight 0, which
// is what the plain version (ops/decoder_ll.py with the y-taps masked by
// the windows) computes; with windows that hold every touched row, as
// h_windows' bounds make them, that is the unwindowed function. The TPU
// kernel's pre-expanded template layout and its block-diagonal bfloat16
// warp on the MXU are not carried over: f32 throughout, two taps per axis.
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40): the
// function of K1 and K4f on the same inputs, so K1's count: 7.58 us by f32
// operations (chip_smoke.py's k1_bound_ms). The windows cut the template
// rows staged (about half of 11 at the flagship), not the operations per
// capsule-pixel pair, which the two-tap form already holds to the taps of
// nonzero weight.
//
// Design, K4f's (decoder_ll_dense.cu) with the windows kept. The earlier
// design staged one group of 8 capsules at a time with plain loads, plane
// by plane, and met at two barriers a group, one pixel a thread: every
// load's latency was exposed, a tap took one 4-byte shared load per plane,
// and each thread had one dependent log-sum-exp chain. Now:
//   - a block is one band of one example, so all its pixels share one
//     window per group; a thread takes Pix pixels of the band, 1 or 2
//     independent chains (the planner takes 1: with 2, a band's block has
//     half the threads for the same staged tables, and at the cifar10
//     shape, where the tables bound the blocks per SM, it ran 5% slower,
//     against 2% faster at the flagship; PERF.md section 6);
//   - the example's capsules stream through a ring of two shared-memory
//     buffers of `chunk` capsules (one buffer when a chunk holds them all;
//     the wrapper's planner sizes the chunk by the blocks per SM that the
//     registers allow): every thread issues the cp.async copies of the
//     next chunk and goes on to the chunk that has landed, and the block
//     meets at one barrier per chunk. A chunk counts capsules, not groups:
//     one capsule a buffer is the floor, so every size the earlier design
//     took (one group's 8 tables) still fits;
//   - only each capsule's window rows are copied, into texel-major tables
//     (the C template channels and the alpha logit of a texel side by side,
//     common.cuh::Stage), so a tap is one 8-byte load at C = 1; a tap whose
//     row lies outside the window (in[j] false) never reads its row, which
//     was not staged, but a texel of zeros after the ring, so it counts as
//     0, as before, without a branch;
//   - a lane of each warp takes one capsule's log-presence (a logf) and its
//     group's window, and the warp shares them by shuffles.
// Per pixel, the coordinates (common.cuh::source_coord), the taps
// (two_taps, window_taps) and the order of the log-sum-exps (the
// background first, then the capsules in sorted order) are the earlier
// design's, so the results are the plain version's to rounding.
// Grid: (H / R bands, B); threads: the band's pixels over Pix, in whole
// warps. PERF.md section 6 has its times beside the earlier design's.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_banded.py binds it with ctypes.

#include "decoder_ll_banded.cuh"

namespace {

constexpr int kMaxBandPixels = 512;  // pixels of a band, at most
constexpr int kMaxChunk = 64;        // capsules of a ring buffer: two lanes' log-presences

// Buffers of the ring: two when the capsules take more than one chunk.
__host__ __device__ inline int ring_buffers(int M, int chunk) { return M > chunk ? 2 : 1; }

// The ring, then one texel of C + 1 zeros: what a tap outside its
// capsule's window reads in place of the row that was not staged.
__host__ __device__ inline size_t shared_bytes(int C, int T, int M, int chunk) {
  return (static_cast<size_t>(ring_buffers(M, chunk)) * Stage(chunk, C, T).size + pad4(C + 1)) *
         sizeof(float);
}

// A group's window [lo, lo + trips) clipped to the template's Ht rows, as
// lo | hi << 16 (Ht is at most 2^15 wherever a one-capsule ring fits).
__device__ __forceinline__ int clipped_window(const int* w, int Ht) {
  const int lo = min(max(w[0], 0), Ht);
  const int hi = min(max(w[0] + w[1], lo), Ht);
  return lo | (hi << 16);
}

// Start copying the window rows of capsules [j1, j2) of a chunk, one group's,
// into the chunk's texel-major table of CC floats a texel. src: their
// planes (T floats each) in global memory, Per a capsule, from the chunk's
// first capsule on; float c of texel t of capsule j goes to
// (j T + t) CC + c0 + c, for the texels [first, first + span) of each plane.
template <int CC, int Per>
__device__ __forceinline__ void stage_window(float* tab, const float* __restrict__ src, int c0,
                                             int T, int first, int span, int j1, int j2) {
  if (span <= 0) return;
  const int n = (j2 - j1) * Per * span;
  const float inv_span = 1.0f / static_cast<float>(span);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r;
    const int k = div_t(i, span, inv_span, r);  // plane of the group's capsules in the chunk
    const int jj = k / Per;
    const int j = j1 + jj;
    const int c = k - jj * Per;
    const int t = first + r;
    cp_async4(tab + (j * T + t) * CC + c0 + c, src + (static_cast<size_t>(j) * Per + c) * T + t);
  }
}

template <int C, int Pix>
__global__ void __launch_bounds__(kMaxBandPixels / Pix)
decoder_ll_banded_fwd_kernel(const float* __restrict__ templates,  // (B, M, C, Ht*Wt) sorted
                             const float* __restrict__ alpha,      // (B, M, Ht*Wt) sorted
                             const float* __restrict__ pose,       // (B, M, 6) sorted
                             const float* __restrict__ presence,   // (B, M) sorted
                             const float* __restrict__ target,     // (B, C, P)
                             const float* __restrict__ scal,       // bg_value, bg_mix, scale
                             const float* __restrict__ grid_x,     // (P,) output x in [-1, 1]
                             const float* __restrict__ grid_y,     // (P,) output y in [-1, 1]
                             const int* __restrict__ win,          // (B, NB, G, 2) [lo, trips]
                             float* __restrict__ ll,               // (B, C, P)
                             float* __restrict__ num,              // (B, C, P)
                             float* __restrict__ den,              // (B, 1, P)
                             int M, int Ht, int Wt, int H, int W, int R, int chunk) {
  constexpr int CC = C + 1;
  extern __shared__ __align__(16) float smem[];
  const int T = Ht * Wt;
  const int P = H * W;
  const int PB = R * W;
  const int NB = H / R;
  const int G = M / kGroup;
  const Stage L(chunk, C, T);
  const int band = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int nchunks = (M + chunk - 1) / chunk;
  const int* wb = win + (static_cast<size_t>(b) * NB + band) * G * 2;  // this band's windows
  float* zero = smem + ring_buffers(M, chunk) * L.size;
  if (threadIdx.x < CC) zero[threadIdx.x] = 0.0f;  // seen by all after the first barrier

  auto load = [&](int ch) {
    if (ch >= nchunks) return;
    float* buf = smem + (ch & 1) * L.size;
    const int m0 = ch * chunk;
    const int n = min(chunk, M - m0);
    const size_t bm = static_cast<size_t>(b) * M + m0;
    for (int g = m0 / kGroup; g * kGroup < m0 + n; ++g) {
      // the window's rows clipped to the template: those a tap may read
      const int w = clipped_window(wb + 2 * g, Ht);
      const int lo = w & 0xffff;
      const int hi = w >> 16;
      const int j1 = max(g * kGroup, m0) - m0;
      const int j2 = min(g * kGroup + kGroup, m0 + n) - m0;
      stage_window<CC, C>(buf, templates + bm * C * T, 0, T, lo * Wt, (hi - lo) * Wt, j1, j2);
      stage_window<CC, 1>(buf, alpha + bm * T, C, T, lo * Wt, (hi - lo) * Wt, j1, j2);
    }
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
  float gx[Pix], gy[Pix], t[Pix][C], nm[Pix][C], ns[Pix][C], dm[Pix], ds[Pix];
#pragma unroll
  for (int k = 0; k < Pix; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    const int p = band * PB + i;
    const bool active = i < PB;
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

    const float* buf = smem + (ch & 1) * L.size;
    const int m0 = ch * chunk;
    const int n = min(chunk, M - m0);
    // lane l holds capsules l and 32 + l's log-presences and clipped windows
    float lp_lane[2];
    int win_lane[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      lp_lane[h] = j < n ? log_safe(buf[L.pres + j]) : 0.0f;
      win_lane[h] = j < n ? clipped_window(wb + 2 * ((m0 + j) / kGroup), Ht) : 0;
    }
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float lp = __shfl_sync(kFull, j < 32 ? lp_lane[0] : lp_lane[1], j & 31);
      const int w = __shfl_sync(kFull, j < 32 ? win_lane[0] : win_lane[1], j & 31);
      const int lo = w & 0xffff;
      const int trips = (w >> 16) - lo;
      const float2* pj = reinterpret_cast<const float2*>(buf + L.pose + 6 * j);
      const float2 p01 = pj[0], p23 = pj[1], p45 = pj[2];
      const float* tab = buf + j * T * CC;
#pragma unroll
      for (int k = 0; k < Pix; ++k) {
        const float ix = source_coord(p01.x, p01.y, p23.x, gx[k], gy[k], fWt);
        const float iy = source_coord(p23.y, p45.x, p45.y, gx[k], gy[k], fHt);
        float wx[2], wy[2], dwy[2];
        int kx[2], ky[2];
        bool in[2];
        two_taps(ix, Wt, wx, kx);
        window_taps(iy, Ht, lo, trips, wy, dwy, ky, in);
        // [row tap][column tap][plane]; a tap outside the window reads the
        // zero texel, never its row, which was not staged
        float tr[2][2][CC];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            load_texel<CC>(in[a] ? tab + (ky[a] * Wt + kx[e]) * CC : zero, tr[a][e]);
          }
        }
        float v[CC];
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          // S[h] = sum_w T[h, w] wx[w], then V = sum_h S[h] wy[h]
          const float s0 = tr[0][0][cc] * wx[0] + tr[0][1][cc] * wx[1];
          const float s1 = tr[1][0][cc] * wx[0] + tr[1][1][cc] * wx[1];
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
  for (int k = 0; k < Pix; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i >= PB) continue;
    const int p = band * PB + i;
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

template <int C, int Pix>
cudaError_t set_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(decoder_ll_banded_fwd_kernel<C, Pix>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int C, int Pix>
int launch(const float* templates, const float* alpha, const float* pose,
           const float* presence, const float* target, const float* scal,
           const float* grid_x, const float* grid_y, const int* win, float* ll, float* num,
           float* den, int B, int M, int Ht, int Wt, int H, int W, int R, int threads,
           int chunk, cudaStream_t stream) {
  const size_t smem = shared_bytes(C, Ht * Wt, M, chunk);
  const cudaError_t e = set_smem<C, Pix>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  decoder_ll_banded_fwd_kernel<C, Pix><<<dim3(H / R, B), threads, smem, stream>>>(
      templates, alpha, pose, presence, target, scal, grid_x, grid_y, win, ll, num, den, M, Ht,
      Wt, H, W, R, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int Pix>
int occupancy(int M, int Ht, int Wt, int threads, int chunk) {
  const size_t smem = shared_bytes(C, Ht * Wt, M, chunk);
  cudaError_t e = set_smem<C, Pix>(smem);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, decoder_ll_banded_fwd_kernel<C, Pix>, threads, smem);
  }
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

template <int C, int Pix>
int registers() {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, decoder_ll_banded_fwd_kernel<C, Pix>);
  return e == cudaSuccess ? attr.numRegs : -static_cast<int>(e);
}

// The sizes and plans K5f takes: whole groups, bands that tile the canvas,
// a band of at most kMaxBandPixels pixels covered by threads x pixels,
// threads in whole warps, chunks of 1..kMaxChunk capsules.
bool valid_plan(int B, int M, int C, int Ht, int Wt, int H, int W, int R, int threads,
                int pixels, int chunk) {
  if (B < 1 || B > 65535 || M < kGroup || M % kGroup != 0 || Ht < 1 || Wt < 1) return false;
  if (C < 1 || C > 4 || W < 1 || R < 1 || H % R != 0 || R * W > kMaxBandPixels) return false;
  if (pixels < 1 || pixels > 2 || chunk < 1 || chunk > kMaxChunk) return false;
  if (threads < 32 || threads > kMaxBandPixels / pixels || threads % 32) return false;
  return threads * pixels >= R * W;
}

}  // namespace

#define SCAE_BANDED_PLANS(X) X(1, 1) X(1, 2) X(2, 1) X(2, 2) X(3, 1) X(3, 2) X(4, 1) X(4, 2)

extern "C" {

// Launches the forward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 (win: int32) device
// array (see the kernel's parameter comments for the shapes); grid_x and
// grid_y are the output grid as scae_tpu_torch/ops/warp.py::_base_grid gives
// it, flattened. C must be 1..4, M a multiple of 8, R a divisor of H with
// R W at most 512. The plan comes from the wrapper's planner: `threads` a
// multiple of 32 of `pixels` (1 or 2) pixels each that cover the band,
// chunks of 1..64 capsules in a ring of two buffers (one when a chunk holds
// every capsule).
int scae_decoder_ll_banded_fwd(const void* templates, const void* alpha, const void* pose,
                               const void* presence, const void* target, const void* scal,
                               const void* grid_x, const void* grid_y, const void* win, void* ll,
                               void* num, void* den, int B, int M, int C, int Ht, int Wt, int H,
                               int W, int R, int threads, int pixels, int chunk, void* stream) {
  if (!valid_plan(B, M, C, Ht, Wt, H, W, R, threads, pixels, chunk)) {
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
  const auto* wn = static_cast<const int*>(win);
  auto* o_ll = static_cast<float*>(ll);
  auto* o_num = static_cast<float*>(num);
  auto* o_den = static_cast<float*>(den);
  auto s = static_cast<cudaStream_t>(stream);
#define SCAE_FWD_CASE(N, X)                                                                   \
  if (C == N && pixels == X)                                                                  \
    return launch<N, X>(t, a, po, pr, tg, sc, gxs, gys, wn, o_ll, o_num, o_den, B, M, Ht, Wt, \
                        H, W, R, threads, chunk, s);
  SCAE_BANDED_PLANS(SCAE_FWD_CASE)
#undef SCAE_FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the forward kernel that fit on one SM for this plan
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a cudaError_t.
int scae_decoder_ll_banded_fwd_occupancy(int C, int M, int Ht, int Wt, int threads, int pixels,
                                         int chunk) {
#define SCAE_OCC_CASE(N, X) \
  if (C == N && pixels == X) return occupancy<N, X>(M, Ht, Wt, threads, chunk);
  SCAE_BANDED_PLANS(SCAE_OCC_CASE)
#undef SCAE_OCC_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread of the forward kernel takes, or minus a cudaError_t.
int scae_decoder_ll_banded_fwd_registers(int C, int pixels) {
#define SCAE_REG_CASE(N, X) \
  if (C == N && pixels == X) return registers<N, X>();
  SCAE_BANDED_PLANS(SCAE_REG_CASE)
#undef SCAE_REG_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
