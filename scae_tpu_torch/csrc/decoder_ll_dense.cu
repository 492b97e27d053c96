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
// same formula as the plain version; the other taps have weight exactly 0
// and add nothing. What differs from the gather kernel (K1) is the memory
// plan: shared memory holds one capsule's table at a time (double
// buffered, 2 (C+1) Ht Wt floats), not all M of them, so any template size
// whose two tables fit in a block's 227 KB runs, for any M.
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40): the
// same function as K1's, ~5.9 MB of inputs and outputs (1.8 us at 3.35
// TB/s) against 8.19 M capsule-pixel pairs of about 62 f32 operations (7.58
// us at 67 TFLOP/s; chip_smoke.py's k1_bound_ms counts them), so the kernel
// is bound by f32 operations. The dense count of the TPU's formulation
// would be ~4 GFLOP, 60 us.
// Grid: (pixel tiles of 256, B); one thread per output pixel; the LSEs are
// streamed over the capsules, as in K1.
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

constexpr int kThreads = 256;
constexpr int kExtra = 8;  // per staged capsule: 6 pose entries, log-presence, pad

// Copy capsule m of example b into `buf`: C template planes, the alpha
// plane, the pose and the log-presence.
template <int C>
__device__ __forceinline__ void stage_capsule(float* buf, const float* __restrict__ templates,
                                              const float* __restrict__ alpha,
                                              const float* __restrict__ pose,
                                              const float* __restrict__ presence, int b, int m,
                                              int M, int T, int alpha_batched) {
  const size_t bm = static_cast<size_t>(b) * M + m;
  const float* tm = templates + bm * C * T;
  for (int i = threadIdx.x; i < C * T; i += blockDim.x) buf[i] = tm[i];
  const float* am = alpha + (alpha_batched ? bm : static_cast<size_t>(m)) * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) buf[C * T + i] = am[i];
  float* extra = buf + (C + 1) * T;
  if (threadIdx.x < 6) extra[threadIdx.x] = pose[bm * 6 + threadIdx.x];
  if (threadIdx.x == 6) extra[6] = log_safe(presence[bm]);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
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
                            int M, int Ht, int Wt, int H, int W, int alpha_batched) {
  constexpr int CC = C + 1;
  extern __shared__ float smem[];
  const int T = Ht * Wt;
  const int P = H * W;
  const int b = blockIdx.y;
  const int stride = CC * T + kExtra;  // one staged capsule
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = p < P;  // every thread stages and syncs; only active ones compute

  const float bg_value = scal[0];
  const float bg_mix = scal[1];
  const float scale = scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float neg_const = -logf(scale) - kLogSqrt2Pi;
  const float fHt = static_cast<float>(Ht);
  const float fWt = static_cast<float>(Wt);
  const float gx = active ? grid_x[p] : 0.0f;
  const float gy = active ? grid_y[p] : 0.0f;

  // the background component enters every LSE once, as its first term
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

  stage_capsule<C>(smem, templates, alpha, pose, presence, b, 0, M, T, alpha_batched);
  __syncthreads();
  for (int m = 0; m < M; ++m) {
    // stage the next capsule into the other buffer while this one is read;
    // the sync at the end of the last iteration freed that buffer
    if (m + 1 < M) {
      stage_capsule<C>(smem + ((m + 1) & 1) * stride, templates, alpha, pose, presence, b,
                       m + 1, M, T, alpha_batched);
    }
    const float* tab = smem + (m & 1) * stride;
    if (active) {
      const float* pm = tab + CC * T;
      const float ix = source_coord(pm[0], pm[1], pm[2], gx, gy, fWt);
      const float iy = source_coord(pm[3], pm[4], pm[5], gx, gy, fHt);
      float wx[2], wy[2];
      int kx[2], ky[2];
      two_taps(ix, Wt, wx, kx);
      two_taps(iy, Ht, wy, ky);
      float v[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float* tc = tab + cc * T;
        // S[h] = sum_w T[h, w] wx[w], then V = sum_h S[h] wy[h]
        const float s0 = tc[ky[0] * Wt + kx[0]] * wx[0] + tc[ky[0] * Wt + kx[1]] * wx[1];
        const float s1 = tc[ky[1] * Wt + kx[0]] * wx[0] + tc[ky[1] * Wt + kx[1]] * wx[1];
        v[cc] = s0 * wy[0] + s1 * wy[1];
      }
      const float mix = v[C] + pm[6];
      lse_push(mix, dm, ds);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float d = t[c] - v[c];
        lse_push(mix + (-(d * d) * inv_2var + neg_const), nm[c], ns[c]);
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
           const float* grid_x, const float* grid_y, float* ll, float* num, float* den, int B,
           int M, int Ht, int Wt, int H, int W, int alpha_batched, cudaStream_t stream) {
  const size_t smem =
      2 * (static_cast<size_t>(C + 1) * Ht * Wt + kExtra) * sizeof(float);
  auto kernel = decoder_ll_dense_fwd_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  kernel<<<grid, kThreads, smem, stream>>>(templates, alpha, pose, presence, target, scal,
                                           grid_x, grid_y, ll, num, den, M, Ht, Wt, H, W,
                                           alpha_batched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 device array (see the
// kernel's parameter comments for the shapes); grid_x and grid_y are the
// output grid as scae_tpu_torch/ops/warp.py::_base_grid gives it,
// flattened. C must be 1..4.
int scae_decoder_ll_dense_fwd(const void* templates, const void* alpha, const void* pose,
                              const void* presence, const void* target, const void* scal,
                              const void* grid_x, const void* grid_y, void* ll, void* num,
                              void* den, int B, int M, int C, int Ht, int Wt, int H, int W,
                              int alpha_batched, void* stream) {
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
  switch (C) {
#define SCAE_FWD_CASE(N)                                                                  \
  case N:                                                                                 \
    return launch<N>(t, a, po, pr, tg, sc, gxs, gys, o_ll, o_num, o_den, B, M, Ht, Wt, H, \
                     W, alpha_batched, s);
    SCAE_FWD_CASE(1)
    SCAE_FWD_CASE(2)
    SCAE_FWD_CASE(3)
    SCAE_FWD_CASE(4)
#undef SCAE_FWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
