// Banded, row-windowed fused template-decoder reconstruction
// log-likelihood, forward, for Hopper (K5f).
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_decoder_ll_banded.py::_fwd_kernel
// (its pallas_call at line 523, grid (B,)). It computes the function of the
// dense kernel K4f (decoder_ll_dense.cu; see there for the formulas) on the
// capsules that scae_tpu_torch/kernels/decoder_ll_banded.py has padded to
// whole groups of 8 and sorted by their vertical translation, with the work
// plan of the TPU kernel:
//   - the canvas is cut into bands of R rows (R W pixels, 320 at the
//     flagship), one block per (band, example), one thread per band pixel;
//   - for each group of 8 capsules the wrapper passes the template rows
//     [lo, lo + trips) that any of them can touch from any pixel of the band
//     (h_windows), and the block stages only those rows of the group's 8
//     tables (C template planes and the alpha plane) in shared memory;
//   - a row tap outside the window has weight 0, which is what the plain
//     version (ops/decoder_ll.py with the y-taps masked by the windows)
//     computes. With windows that hold every touched row, as h_windows'
//     bounds make them, that is the unwindowed function.
// The log-sum-exps stream over the groups in order, the background first,
// as in K4f. The TPU kernel's pre-expanded template layout and its
// block-diagonal bfloat16 warp on the MXU are not carried over: f32
// throughout, two taps per axis.
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40): the
// function of K1 and K4f on the same inputs, so K1's count: 7.58 us by f32
// operations (chip_smoke.py's k1_bound_ms). The windows cut the template
// rows staged per group (about half of 11 at the flagship), not the
// operations per capsule-pixel pair, which the two-tap form already holds
// to the taps of nonzero weight.
// Grid: (NB bands, B); one thread per band pixel, rounded up to whole warps.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_banded.py binds it with ctypes.

#include "decoder_ll_banded.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
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
                             int M, int Ht, int Wt, int H, int W, int R) {
  constexpr int CC = C + 1;
  extern __shared__ float smem[];
  float* tab = smem;                          // (8, CC, Ht*Wt), window rows only
  float* extra = tab + kGroup * CC * Ht * Wt;  // (8, kExtra)
  const int P = H * W;
  const int PB = R * W;
  const int NB = H / R;
  const int G = M / kGroup;
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int i = threadIdx.x;
  const int p = k * PB + i;
  const bool active = i < PB;  // every thread stages and syncs; only active ones compute

  const float bg_value = scal[0];
  const float bg_mix = scal[1];
  const float scale = scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float neg_const = -logf(scale) - kLogSqrt2Pi;
  const float fHt = static_cast<float>(Ht);
  const float fWt = static_cast<float>(Wt);
  const float gx = active ? grid_x[p] : 0.0f;
  const float gy = active ? grid_y[p] : 0.0f;

  float t[C], nm[C], ns[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    t[c] = active ? target[(static_cast<size_t>(b) * C + c) * P + p] : 0.0f;
    const float d = t[c] - bg_value;
    nm[c] = bg_mix + (-(d * d) * inv_2var + neg_const);
    ns[c] = 1.0f;
  }
  float dm = bg_mix;
  float ds = 1.0f;

  for (int g = 0; g < G; ++g) {
    const int* wg = win + ((static_cast<size_t>(b) * NB + k) * G + g) * 2;
    const int lo = wg[0];
    const int trips = wg[1];
    stage_group<C>(tab, extra, templates, alpha, pose, presence, b, g, M, Ht, Wt, lo, trips);
    __syncthreads();
    if (active) {
      for (int m8 = 0; m8 < kGroup; ++m8) {
        const float* pm = extra + m8 * kExtra;
        const float ix = source_coord(pm[0], pm[1], pm[2], gx, gy, fWt);
        const float iy = source_coord(pm[3], pm[4], pm[5], gx, gy, fHt);
        float wx[2], wy[2], dwy[2];
        int kx[2], ky[2];
        bool in[2];
        two_taps(ix, Wt, wx, kx);
        window_taps(iy, Ht, lo, trips, wy, dwy, ky, in);
        float v[CC];
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const float* tc = tab + (m8 * CC + cc) * Ht * Wt;
          float s[2];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            s[a] = in[a] ? tc[ky[a] * Wt + kx[0]] * wx[0] + tc[ky[a] * Wt + kx[1]] * wx[1] : 0.0f;
          }
          v[cc] = s[0] * wy[0] + s[1] * wy[1];
        }
        const float mix = v[C] + pm[6];
        lse_push(mix, dm, ds);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float d = t[c] - v[c];
          lse_push(mix + (-(d * d) * inv_2var + neg_const), nm[c], ns[c]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;

  const float den_lse = logf(ds) + dm;
  den[static_cast<size_t>(b) * P + p] = den_lse;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const size_t o = (static_cast<size_t>(b) * C + c) * P + p;
    const float num_lse = logf(ns[c]) + nm[c];
    num[o] = num_lse;
    ll[o] = num_lse - den_lse;
  }
}

template <int C>
int launch(const float* templates, const float* alpha, const float* pose,
           const float* presence, const float* target, const float* scal,
           const float* grid_x, const float* grid_y, const int* win, float* ll, float* num,
           float* den, int B, int M, int Ht, int Wt, int H, int W, int R, cudaStream_t stream) {
  const size_t smem = group_smem_floats(C, Ht, Wt) * sizeof(float);
  auto kernel = decoder_ll_banded_fwd_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(H / R, B), band_threads(R * W), smem, stream>>>(
      templates, alpha, pose, presence, target, scal, grid_x, grid_y, win, ll, num, den, M, Ht,
      Wt, H, W, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 (win: int32) device
// array (see the kernel's parameter comments for the shapes); grid_x and
// grid_y are the output grid as scae_tpu_torch/ops/warp.py::_base_grid gives
// it, flattened. C must be 1..4, M a multiple of 8, R a divisor of H with R W
// at most kMaxThreads.
int scae_decoder_ll_banded_fwd(const void* templates, const void* alpha, const void* pose,
                               const void* presence, const void* target, const void* scal,
                               const void* grid_x, const void* grid_y, const void* win, void* ll,
                               void* num, void* den, int B, int M, int C, int Ht, int Wt, int H,
                               int W, int R, void* stream) {
  if (!valid_sizes(B, M, Ht, Wt, H, W, R)) return static_cast<int>(cudaErrorInvalidValue);
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
  switch (C) {
#define SCAE_FWD_CASE(N)                                                                   \
  case N:                                                                                  \
    return launch<N>(t, a, po, pr, tg, sc, gxs, gys, wn, o_ll, o_num, o_den, B, M, Ht, Wt, \
                     H, W, R, s);
    SCAE_FWD_CASE(1)
    SCAE_FWD_CASE(2)
    SCAE_FWD_CASE(3)
    SCAE_FWD_CASE(4)
#undef SCAE_FWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
