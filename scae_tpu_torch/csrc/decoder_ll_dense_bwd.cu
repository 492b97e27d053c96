// Dense fused template-decoder reconstruction log-likelihood, backward, for
// Hopper (K4b).
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_decoder_ll.py::_bwd_kernel
// (its pallas_call at line 414, grid (B,)). Its function, written out in
// jnp, is scae_tpu/ops/decoder_ll.py::_bwd with float32 taps, ported as
// scae_tpu_torch/ops/decoder_ll.py (this kernel's plain version). Given the
// upstream gradient g = dL/dll (B, C, P) and the forward's log-sum-exps num
// (B, C, P) and den (B, 1, P), for capsule m at pixel p:
//   r       = exp(mix - den),   q[c] = exp(mix + lp[c] - num[c]),  gq = g q
//   gV[c]   = gq[c] (t[c] - V[c]) / s^2,   gmix = sum_c gq[c] - (sum_c g[c]) r
//   g_T[m, c, h, w] = sum_p gV[c] wy[h] wx[w]      (g_A likewise with gmix)
//   g_ix    = sum_w dtap(ix - w) sum_{c,h} gval[c] wy[h] table[c, h, w]
//   g_iy    = sum_h dtap(iy - h) sum_{c,w} gval[c] wx[w] table[c, h, w]
//   gpose   = Wt/2 (sum_p g_ix x, sum_p g_ix y, sum_p g_ix), Ht/2 (the same for g_iy)
//   gpres   = sum_p gmix / presence   (0 where presence < 1e-16, as log_safe)
// with dtap(d) = -sign(d) where |d| < 1, else 0: the JAX package's _dtap,
// which is 0 at a texel centre and at |d| = 1. The background component
// gives the three scalar gradients (bg_value, bg_mixing_logit, scale) and,
// with the capsules, the target gradient.
//
// Deterministic: no floating-point atomics. Given num and den, capsule m's
// gradient terms need only capsule m's own values, so each block owns one
// (capsule, example) pair and writes its own outputs. The block works
// through the pixels in chunks of kChunk: first one thread per pixel
// computes that pixel's upstream values (gV, gmix), its pose terms and its
// coordinates, and stages the last two in shared memory; then one thread
// per (texel, pixel slice) adds up its texel's gradient over its slice of
// the chunk, in pixel order, testing each pixel's two tap distances. The
// slices are added in order at the end, and the pixel sums (pose, presence,
// scale) are fixed-order block reductions. Sums over the capsules are left
// out of the kernel: it writes the scale gradient's and the background's
// terms per (example, capsule) into a (B, M+1, 3) buffer, one extra block per
// example doing the background, which the wrapper sums in a fixed order
// (the TPU wrapper sums its scalar rows outside its kernel too), and, where
// the target's gradient is asked for, each capsule's term per pixel into a
// (B, M, C, P) buffer that a second kernel sums over the capsules in order.
// So the results are bit-identical from run to run, as the TPU kernel's
// are.
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40, no
// target gradient): the same function on the same inputs as the gather
// backward's (decoder_ll_gather_bwd.cu), so the same bound: ~11 MB of
// inputs and outputs, 3.3 us at 3.35 TB/s, against ~0.94 GFLOP of f32
// operations, the tap-derivative and template-gradient terms counted only
// for the pairs whose taps touch the template (chip_smoke.py's
// bwd_bound_ms), 14 us at 67 TFLOP/s: bound by operations. The texel scan
// tests each (texel, pixel) pair of a capsule, T P = 193,600 per block at
// the flagship, most of which touch nothing: it is the dense formulation's
// cost (the TPU kernel multiplies full tap rows on its MXU), paid here in
// compares, and is not in the bound.
// Grid: (M + 1, B); 256 threads per block.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_dense.py binds it with ctypes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;  // pixels staged per pass
constexpr int kSums = 9;      // per block: 6 pose sums, gmix, sum gq d^2, sum gq

// Sums each of v[0..N) over the block in a fixed order (a warp tree, then
// the warps in order); thread 0 gets the results.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float (*red)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float s = warp_sum(v[k]);
    if (lane == 0) red[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += red[k][w];
      v[k] = s;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
decoder_ll_dense_bwd_kernel(const float* __restrict__ templates,  // (B, M, C, Ht*Wt)
                            const float* __restrict__ alpha,      // (1 or B, M, Ht*Wt)
                            const float* __restrict__ pose,       // (B, M, 6)
                            const float* __restrict__ presence,   // (B, M)
                            const float* __restrict__ target,     // (B, C, P)
                            const float* __restrict__ scal,       // bg_value, bg_mix, scale
                            const float* __restrict__ g,          // (B, C, P) dL/dll
                            const float* __restrict__ num,        // (B, C, P)
                            const float* __restrict__ den,        // (B, 1, P)
                            const float* __restrict__ grid_x,     // (P,) output x in [-1, 1]
                            const float* __restrict__ grid_y,     // (P,) output y in [-1, 1]
                            float* __restrict__ gtab,             // (B, M, C+1, Ht*Wt)
                            float* __restrict__ gpose,            // (B, M, 6)
                            float* __restrict__ gpres,            // (B, M)
                            float* __restrict__ cscal,            // (B, M+1, 3)
                            float* __restrict__ tpart,            // (B, M, C, P) or null
                            int M, int Ht, int Wt, int H, int W, int alpha_batched,
                            int nslice) {
  constexpr int CC = C + 1;
  extern __shared__ float smem[];
  __shared__ float red[kSums][kWarps];
  const int T = Ht * Wt;
  const int P = H * W;
  const int m = blockIdx.x;
  const int b = blockIdx.y;

  const float bg_value = scal[0];
  const float bg_mix = scal[1];
  const float scale = scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float two_inv_2var = 2.0f * inv_2var;
  const float neg_const = -logf(scale) - kLogSqrt2Pi;
  const float s3 = scale * scale * scale;

  if (m == M) {
    // the background block: the scalar gradients' background terms
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // sum gq d, sum gq, sum gsum r, sum gq d^2
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float r = expf(bg_mix - den[static_cast<size_t>(b) * P + p]);
      float gsum = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t o = (static_cast<size_t>(b) * C + c) * P + p;
        const float gc = g[o];
        const float d = target[o] - bg_value;
        const float dd = d * d;
        const float gq = gc * expf(bg_mix + (-dd * inv_2var + neg_const) - num[o]);
        gsum += gc;
        v[0] += gq * d;
        v[1] += gq;
        v[3] += gq * dd;
      }
      v[2] += gsum * r;
    }
    block_sums(v, red);
    if (threadIdx.x == 0) {
      float* out = cscal + (static_cast<size_t>(b) * (M + 1) + M) * 3;
      out[0] = v[0] * two_inv_2var;
      out[1] = v[1] - v[2];
      out[2] = v[3] / s3 - v[1] / scale;
    }
    return;
  }

  const size_t bm = static_cast<size_t>(b) * M + m;
  float* tab = smem;                       // (CC, T): C template planes, then alpha
  float* acc = tab + CC * T;               // (nslice, CC, T) texel-gradient sums
  float* px_ix = acc + nslice * CC * T;    // (kChunk,) staged pixels' coordinates
  float* px_iy = px_ix + kChunk;
  float* px_g = px_iy + kChunk;            // (CC, kChunk) gV per channel, then gmix

  const float* tm = templates + bm * C * T;
  for (int i = threadIdx.x; i < C * T; i += blockDim.x) tab[i] = tm[i];
  const float* am = alpha + (alpha_batched ? bm : static_cast<size_t>(m)) * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) tab[C * T + i] = am[i];
  for (int i = threadIdx.x; i < nslice * CC * T; i += blockDim.x) acc[i] = 0.0f;
  float pm[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) pm[k] = pose[bm * 6 + k];
  const float pres = presence[bm];
  const float lp_m = log_safe(pres);
  const float fHt = static_cast<float>(Ht);
  const float fWt = static_cast<float>(Wt);
  __syncthreads();

  // per-thread pixel sums: 6 pose partials, gmix, sum gq d^2, sum gq
  float sums[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) sums[k] = 0.0f;

  for (int p0 = 0; p0 < P; p0 += kChunk) {
    const int n = min(kChunk, P - p0);
    // phase 1: one thread per pixel
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = p0 + i;
      const float gx = grid_x[p];
      const float gy = grid_y[p];
      const float ix = source_coord(pm[0], pm[1], pm[2], gx, gy, fWt);
      const float iy = source_coord(pm[3], pm[4], pm[5], gx, gy, fHt);
      float wx[2], dwx[2], wy[2], dwy[2];
      int kx[2], ky[2];
      two_taps(ix, Wt, wx, dwx, kx);
      two_taps(iy, Ht, wy, dwy, ky);

      float tx[CC][2][2];  // texel (cc, row tap, column tap)
      float sr[CC][2];     // S[cc][row tap] = sum_w table[cc, h, w] wx[w]
      float v[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float* tc = tab + cc * T;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          tx[cc][a][0] = tc[ky[a] * Wt + kx[0]];
          tx[cc][a][1] = tc[ky[a] * Wt + kx[1]];
          sr[cc][a] = tx[cc][a][0] * wx[0] + tx[cc][a][1] * wx[1];
        }
        v[cc] = sr[cc][0] * wy[0] + sr[cc][1] * wy[1];
      }

      const float mix = v[C] + lp_m;
      const float dn = den[static_cast<size_t>(b) * P + p];
      float gval[CC];
      float gsum = 0.0f, gq_sum = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t o = (static_cast<size_t>(b) * C + c) * P + p;
        const float gc = g[o];
        const float d = target[o] - v[c];
        const float dd = d * d;
        const float gq = gc * expf(mix + (-dd * inv_2var + neg_const) - num[o]);
        gval[c] = gq * d * two_inv_2var;
        gsum += gc;
        gq_sum += gq;
        sums[7] += gq * dd;
        if (tpart != nullptr) tpart[(bm * C + c) * P + p] = gq * d;
      }
      const float gmix = gq_sum - gsum * expf(mix - dn);
      gval[C] = gmix;
      sums[6] += gmix;
      sums[8] += gq_sum;

      // g_ix = sum_w dtap_w sum_{cc,h} (gval wy[h]) table[cc, h, w];
      // g_iy = sum_h dtap_h sum_cc gval S[cc][h]
      float gix = 0.0f, giy = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float gw = 0.0f, gh = 0.0f;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          gw += gval[cc] * wy[0] * tx[cc][0][j] + gval[cc] * wy[1] * tx[cc][1][j];
          gh += gval[cc] * sr[cc][j];
        }
        gix += gw * dwx[j];
        giy += gh * dwy[j];
      }
      sums[0] += gix * gx;
      sums[1] += gix * gy;
      sums[2] += gix;
      sums[3] += giy * gx;
      sums[4] += giy * gy;
      sums[5] += giy;

      px_ix[i] = ix;
      px_iy[i] = iy;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) px_g[cc * kChunk + i] = gval[cc];
    }
    __syncthreads();

    // phase 2: one thread per (texel, pixel slice), the slice in pixel order
    const int span = (n + nslice - 1) / nslice;
    for (int job = threadIdx.x; job < T * nslice; job += blockDim.x) {
      const int texel = job % T;
      const int slice = job / T;
      const int h = texel / Wt;
      const float fh = static_cast<float>(h);
      const float fw = static_cast<float>(texel - h * Wt);
      float* a = acc + slice * CC * T + texel;
      float s[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) s[cc] = a[cc * T];
      const int i1 = min(n, (slice + 1) * span);
      for (int i = slice * span; i < i1; ++i) {
        const float ay = fabsf(px_iy[i] - fh);
        if (ay < 1.0f) {
          const float ax = fabsf(px_ix[i] - fw);
          if (ax < 1.0f) {
            const float wyh = 1.0f - ay;
            const float wxw = 1.0f - ax;
#pragma unroll
            for (int cc = 0; cc < CC; ++cc) s[cc] += (px_g[cc * kChunk + i] * wyh) * wxw;
          }
        }
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) a[cc * T] = s[cc];
    }
    __syncthreads();
  }

  float* gt = gtab + bm * CC * T;
  for (int i = threadIdx.x; i < CC * T; i += blockDim.x) {
    float s = 0.0f;
    for (int slice = 0; slice < nslice; ++slice) s += acc[slice * CC * T + i];
    gt[i] = s;
  }

  block_sums(sums, red);
  if (threadIdx.x == 0) {
    const float cx = 0.5f * fWt;
    const float cy = 0.5f * fHt;
#pragma unroll
    for (int k = 0; k < 6; ++k) gpose[bm * 6 + k] = sums[k] * (k < 3 ? cx : cy);
    gpres[bm] = pres < kPresEps ? 0.0f : sums[6] / pres;
    float* out = cscal + (static_cast<size_t>(b) * (M + 1) + m) * 3;
    out[0] = 0.0f;
    out[1] = 0.0f;
    out[2] = sums[7] / s3 - sums[8] / scale;
  }
}

// The target's gradient: each capsule's term summed over the capsules in
// order, plus the background's. Grid: (pixel tiles of 256, B).
template <int C>
__global__ void __launch_bounds__(kThreads)
decoder_ll_dense_target_kernel(const float* __restrict__ target,  // (B, C, P)
                               const float* __restrict__ scal,    // bg_value, bg_mix, scale
                               const float* __restrict__ g,       // (B, C, P)
                               const float* __restrict__ num,     // (B, C, P)
                               const float* __restrict__ tpart,   // (B, M, C, P)
                               float* __restrict__ gtarget,       // (B, C, P)
                               int M, int P) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float bg_value = scal[0];
  const float bg_mix = scal[1];
  const float scale = scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float neg_const = -logf(scale) - kLogSqrt2Pi;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const size_t o = (static_cast<size_t>(b) * C + c) * P + p;
    float s = 0.0f;
    for (int m = 0; m < M; ++m) s += tpart[((static_cast<size_t>(b) * M + m) * C + c) * P + p];
    const float d = target[o] - bg_value;
    const float gq = g[o] * expf(bg_mix + (-(d * d) * inv_2var + neg_const) - num[o]);
    gtarget[o] = (s + gq * d) * (-2.0f * inv_2var);
  }
}

template <int C>
int launch(const float* templates, const float* alpha, const float* pose,
           const float* presence, const float* target, const float* scal, const float* g,
           const float* num, const float* den, const float* grid_x, const float* grid_y,
           float* gtab, float* gpose, float* gpres, float* cscal, float* tpart, float* gtarget,
           int B, int M, int Ht, int Wt, int H, int W, int alpha_batched, int nslice,
           cudaStream_t stream) {
  const size_t T = static_cast<size_t>(Ht) * Wt;
  const size_t smem =
      ((1 + static_cast<size_t>(nslice)) * (C + 1) * T + static_cast<size_t>(kChunk) * (C + 3)) *
      sizeof(float);
  auto kernel = decoder_ll_dense_bwd_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(M + 1, B), kThreads, smem, stream>>>(
      templates, alpha, pose, presence, target, scal, g, num, den, grid_x, grid_y, gtab, gpose,
      gpres, cscal, tpart, M, Ht, Wt, H, W, alpha_batched, nslice);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || gtarget == nullptr) return static_cast<int>(e);
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  decoder_ll_dense_target_kernel<C><<<grid, kThreads, 0, stream>>>(target, scal, g, num, tpart,
                                                                   gtarget, M, H * W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the backward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 device array (see the
// kernels' parameter comments for the shapes); grid_x and grid_y are the
// output grid as scae_tpu_torch/ops/warp.py::_base_grid gives it, flattened.
// Every output is written in full, so none needs zeroing. tpart and
// gtarget are both null (no target gradient) or both given. nslice is the
// number of pixel slices of the texel scan, at least 1. C must be 1..4.
int scae_decoder_ll_dense_bwd(const void* templates, const void* alpha, const void* pose,
                              const void* presence, const void* target, const void* scal,
                              const void* g, const void* num, const void* den,
                              const void* grid_x, const void* grid_y, void* gtab, void* gpose,
                              void* gpres, void* cscal, void* tpart, void* gtarget, int B,
                              int M, int C, int Ht, int Wt, int H, int W, int alpha_batched,
                              int nslice, void* stream) {
  const auto* t = static_cast<const float*>(templates);
  const auto* a = static_cast<const float*>(alpha);
  const auto* po = static_cast<const float*>(pose);
  const auto* pr = static_cast<const float*>(presence);
  const auto* tg = static_cast<const float*>(target);
  const auto* sc = static_cast<const float*>(scal);
  const auto* gg = static_cast<const float*>(g);
  const auto* nm = static_cast<const float*>(num);
  const auto* dn = static_cast<const float*>(den);
  const auto* gxs = static_cast<const float*>(grid_x);
  const auto* gys = static_cast<const float*>(grid_y);
  auto* o_tab = static_cast<float*>(gtab);
  auto* o_pose = static_cast<float*>(gpose);
  auto* o_pres = static_cast<float*>(gpres);
  auto* o_scal = static_cast<float*>(cscal);
  auto* o_part = static_cast<float*>(tpart);
  auto* o_tgt = static_cast<float*>(gtarget);
  auto s = static_cast<cudaStream_t>(stream);
  if (nslice < 1 || (o_part == nullptr) != (o_tgt == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (C) {
#define SCAE_BWD_CASE(N)                                                                      \
  case N:                                                                                     \
    return launch<N>(t, a, po, pr, tg, sc, gg, nm, dn, gxs, gys, o_tab, o_pose, o_pres, o_scal, \
                     o_part, o_tgt, B, M, Ht, Wt, H, W, alpha_batched, nslice, s);
    SCAE_BWD_CASE(1)
    SCAE_BWD_CASE(2)
    SCAE_BWD_CASE(3)
    SCAE_BWD_CASE(4)
#undef SCAE_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
