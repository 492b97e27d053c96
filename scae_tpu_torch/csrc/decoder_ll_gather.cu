// Fused template-decoder reconstruction log-likelihood, forward, for Hopper.
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_decoder_ll_gather.py
// (_fwd_kernel, launched by _fwd_call's pallas_call, grid (B,)).
//
// Per example b and output pixel p, with M warped template capsules and
// one background component:
//   (ix, iy)  = source coordinates of p under capsule m's affine pose
//               (F.affine_grid / grid_sample convention, align_corners=False)
//   V[m, cc]  = exact bilinear sample of plane cc of capsule m's table
//               (cc < C: template channels, cc = C: alpha logit), the four
//               taps weighted 0 outside the template (zero padding)
//   mix[m]    = V[m, C] + log_safe(presence[m])
//   den       = LSE over {mix[m]} + {bg_mix}
//   num[c]    = LSE over {mix[m] + lp(t[c] | V[m, c])} + {bg_mix + lp(t[c] | bg_value)}
//   ll[c]     = num[c] - den,   lp(t | v) = -(t - v)^2 / (2 s^2) - log s - log sqrt(2 pi)
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40): the
// inputs and outputs are ~5.9 MB (about 1.8 us at 3.35 TB/s), while the per
// (capsule, pixel) arithmetic is 8.19 M pairs x 62 f32 operations (7.58 us
// at 67 TFLOP/s; chip_smoke.py's k1_bound_ms counts them), so the kernel
// is bound by f32 operations, not bytes.
// The design answers that bound by doing only the work the function needs:
// each block copies its example's capsule tables (M x (C+1) x Ht*Wt floats,
// 39 KB at the flagship size) into shared memory once, and each thread then
// reads just the 4 texels a bilinear tap touches per plane, instead of the
// dense Ht + Wt tap-weight rows the TPU's matrix-form warp evaluates. The
// LSEs are taken online in one pass over the capsules (running max and
// rescaled sum), so no (M, P) intermediate exists anywhere, not even in
// registers. Grid: (pixel tiles of 256, B); one thread per output pixel.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_gather.py binds it with ctypes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int C>
__global__ void __launch_bounds__(kThreads)
decoder_ll_gather_fwd_kernel(const float* __restrict__ templates,  // (B, M, C, Ht*Wt)
                             const float* __restrict__ alpha,      // (1 or B, M, Ht*Wt)
                             const float* __restrict__ pose,       // (B, M, 6)
                             const float* __restrict__ presence,   // (B, M)
                             const float* __restrict__ target,     // (B, C, P)
                             const float* __restrict__ scal,       // bg_value, bg_mix, scale
                             float* __restrict__ ll,               // (B, C, P)
                             float* __restrict__ num,              // (B, C, P)
                             float* __restrict__ den,              // (B, 1, P)
                             int M, int Ht, int Wt, int H, int W, int alpha_batched) {
  constexpr int CC = C + 1;
  extern __shared__ float smem[];
  const int T = Ht * Wt;
  const int P = H * W;
  const int b = blockIdx.y;
  float* tab = smem;                // (M, CC, T): C template planes, then alpha
  float* spose = tab + M * CC * T;  // (M, 6)
  float* slp = spose + M * 6;       // (M,) log_safe(presence)

  const float* tb = templates + static_cast<size_t>(b) * M * C * T;
  for (int i = threadIdx.x; i < M * C * T; i += blockDim.x) {
    const int m = i / (C * T);
    tab[m * CC * T + (i - m * C * T)] = tb[i];
  }
  const float* ab = alpha + (alpha_batched ? static_cast<size_t>(b) * M * T : 0);
  for (int i = threadIdx.x; i < M * T; i += blockDim.x) {
    const int m = i / T;
    tab[m * CC * T + C * T + (i - m * T)] = ab[i];
  }
  for (int i = threadIdx.x; i < M * 6; i += blockDim.x) {
    spose[i] = pose[static_cast<size_t>(b) * M * 6 + i];
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    slp[i] = log_safe(presence[static_cast<size_t>(b) * M + i]);
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int row = p / W;
  const int col = p - row * W;
  const float gx = (2.0f * col + 1.0f) / W - 1.0f;
  const float gy = (2.0f * row + 1.0f) / H - 1.0f;

  const float bg_value = scal[0];
  const float bg_mix = scal[1];
  const float scale = scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float neg_const = -logf(scale) - kLogSqrt2Pi;
  const float fHt = static_cast<float>(Ht);
  const float fWt = static_cast<float>(Wt);

  // the background component enters every LSE once, as its first term
  float t[C], nm[C], ns[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    t[c] = target[(static_cast<size_t>(b) * C + c) * P + p];
    const float d = t[c] - bg_value;
    nm[c] = bg_mix + (-(d * d) * inv_2var + neg_const);
    ns[c] = 1.0f;
  }
  float dm = bg_mix;
  float ds = 1.0f;

  for (int m = 0; m < M; ++m) {
    const float* pm = spose + m * 6;
    const float sx = pm[0] * gx + pm[1] * gy + pm[2];
    const float sy = pm[3] * gx + pm[4] * gy + pm[5];
    const float ix = ((sx + 1.0f) * fWt - 1.0f) * 0.5f;
    const float iy = ((sy + 1.0f) * fHt - 1.0f) * 0.5f;
    const float h0 = floorf(iy);
    const float w0 = floorf(ix);
    const float fy = iy - h0;
    const float fx = ix - w0;
    // tap validity folded into the weights; indices clamped so that every
    // shared-memory read is in bounds (its weight is 0 when clamped)
    const float wy0 = (h0 >= 0.0f && h0 <= fHt - 1.0f) ? 1.0f - fy : 0.0f;
    const float wy1 = (h0 + 1.0f >= 0.0f && h0 + 1.0f <= fHt - 1.0f) ? fy : 0.0f;
    const float wx0 = (w0 >= 0.0f && w0 <= fWt - 1.0f) ? 1.0f - fx : 0.0f;
    const float wx1 = (w0 + 1.0f >= 0.0f && w0 + 1.0f <= fWt - 1.0f) ? fx : 0.0f;
    const int ih0 = static_cast<int>(fminf(fmaxf(h0, 0.0f), fHt - 1.0f));
    const int ih1 = static_cast<int>(fminf(fmaxf(h0 + 1.0f, 0.0f), fHt - 1.0f));
    const int iw0 = static_cast<int>(fminf(fmaxf(w0, 0.0f), fWt - 1.0f));
    const int iw1 = static_cast<int>(fminf(fmaxf(w0 + 1.0f, 0.0f), fWt - 1.0f));
    const int r0 = ih0 * Wt;
    const int r1 = ih1 * Wt;

    const float* tm = tab + m * CC * T;
    float v[CC];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const float* tc = tm + cc * T;
      v[cc] = wy0 * (wx0 * tc[r0 + iw0] + wx1 * tc[r0 + iw1]) +
              wy1 * (wx0 * tc[r1 + iw0] + wx1 * tc[r1 + iw1]);
    }
    const float mix = v[C] + slp[m];
    lse_push(mix, dm, ds);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = t[c] - v[c];
      lse_push(mix + (-(d * d) * inv_2var + neg_const), nm[c], ns[c]);
    }
  }

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
           float* ll, float* num, float* den, int B, int M, int Ht, int Wt,
           int H, int W, int alpha_batched, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(M) * (C + 1) * Ht * Wt + static_cast<size_t>(M) * 7) * sizeof(float);
  auto kernel = decoder_ll_gather_fwd_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  kernel<<<grid, kThreads, smem, stream>>>(templates, alpha, pose, presence, target, scal,
                                           ll, num, den, M, Ht, Wt, H, W, alpha_batched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 device array; see the
// kernel's parameter comments for the shapes. C must be 1..4.
int scae_decoder_ll_gather_fwd(const void* templates, const void* alpha, const void* pose,
                               const void* presence, const void* target, const void* scal,
                               void* ll, void* num, void* den, int B, int M, int C, int Ht,
                               int Wt, int H, int W, int alpha_batched, void* stream) {
  const auto* t = static_cast<const float*>(templates);
  const auto* a = static_cast<const float*>(alpha);
  const auto* po = static_cast<const float*>(pose);
  const auto* pr = static_cast<const float*>(presence);
  const auto* tg = static_cast<const float*>(target);
  const auto* sc = static_cast<const float*>(scal);
  auto* o_ll = static_cast<float*>(ll);
  auto* o_num = static_cast<float*>(num);
  auto* o_den = static_cast<float*>(den);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(t, a, po, pr, tg, sc, o_ll, o_num, o_den, B, M, Ht, Wt, H, W, alpha_batched, s);
    case 2: return launch<2>(t, a, po, pr, tg, sc, o_ll, o_num, o_den, B, M, Ht, Wt, H, W, alpha_batched, s);
    case 3: return launch<3>(t, a, po, pr, tg, sc, o_ll, o_num, o_den, B, M, Ht, Wt, H, W, alpha_batched, s);
    case 4: return launch<4>(t, a, po, pr, tg, sc, o_ll, o_num, o_den, B, M, Ht, Wt, H, W, alpha_batched, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
