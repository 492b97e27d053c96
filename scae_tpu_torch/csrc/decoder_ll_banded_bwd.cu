// Banded, row-windowed fused template-decoder reconstruction
// log-likelihood, backward, for Hopper (K5b).
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_decoder_ll_banded.py::_bwd_kernel
// (its pallas_call at line 549, grid (B,)). It computes the gradients of
// the dense backward K4b (decoder_ll_dense_bwd.cu; see there for the
// formulas, the tap slope being the JAX package's _dtap: 0 at a texel
// centre and at |d| >= 1), on the sorted capsules and with the row
// windows of K5f (decoder_ll_banded.cu): a row outside the window has
// weight and slope 0 in y, as in the plain version.
//
// Deterministic: no floating-point atomics. One block owns one (band,
// example) pair; for each group of 8 capsules it stages the group's window
// rows, then
//   1. one thread per band pixel computes, for each of the 8 capsules, the
//      warp, the upstream values (gV per channel, gmix), the tap
//      derivatives into g_ix and g_iy, and stages the coordinates and
//      upstream values; the pose and presence sums over the band's pixels
//      are fixed-order block reductions (a warp tree, then the warps in
//      order);
//   2. one thread per (capsule, texel) gathers that texel's template and
//      alpha gradient over the band's pixels, in pixel order (K4b's gather
//      form, over R W pixels and the window's rows instead of the whole
//      canvas), and writes 0 for the rows outside the window.
// It writes these per (example, band) to buffers that the wrapper sums over
// the bands in a fixed order (24.8 MB of template partials at the
// flagship). A pixel lies in one band, so the target's gradient and the
// per-pixel rows of the three scalar gradients (bg_value, bg_mix, scale)
// are written whole, and the wrapper sums the rows, as the TPU wrapper
// does. So the results repeat bit for bit, as the TPU kernel's do.
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40, no
// target gradient): the same function on the same inputs as K2+K3's and
// K4b's, so their count: 14.0 us by f32 operations (chip_smoke.py's
// bwd_bound_ms). The texel scan, this kernel's own cost beside the
// bound, tests 8 x trips x Wt texels against R W pixels per group: about
// a fifth of K4b's scan at the flagship, where a window holds about 6 of
// 11 rows and a band 320 of 1,600 pixels.
// Grid: (NB bands, B); one thread per band pixel, rounded up to whole warps.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_banded.py binds it with ctypes.

#include "decoder_ll_banded.cuh"

namespace {

constexpr int kSums = 7;  // per capsule and band: 6 pose sums, gmix

// Floats of K5b's dynamic shared memory: the staged group, each capsule's
// coordinates and upstream values at every band pixel, and the per-warp
// partial sums.
inline size_t bwd_smem_floats(int C, int Ht, int Wt, int PB) {
  return group_smem_floats(C, Ht, Wt) + static_cast<size_t>(kGroup) * PB * (C + 3) +
         static_cast<size_t>(kGroup) * kSums * (band_threads(PB) / 32);
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
decoder_ll_banded_bwd_kernel(const float* __restrict__ templates,  // (B, M, C, Ht*Wt) sorted
                             const float* __restrict__ alpha,      // (B, M, Ht*Wt) sorted
                             const float* __restrict__ pose,       // (B, M, 6) sorted
                             const float* __restrict__ presence,   // (B, M) sorted
                             const float* __restrict__ target,     // (B, C, P)
                             const float* __restrict__ scal,       // bg_value, bg_mix, scale
                             const float* __restrict__ g,          // (B, C, P) dL/dll
                             const float* __restrict__ num,        // (B, C, P)
                             const float* __restrict__ den,        // (B, 1, P)
                             const float* __restrict__ grid_x,     // (P,) output x in [-1, 1]
                             const float* __restrict__ grid_y,     // (P,) output y in [-1, 1]
                             const int* __restrict__ win,          // (B, NB, G, 2) [lo, trips]
                             float* __restrict__ gtab,             // (B, NB, M, C+1, Ht*Wt)
                             float* __restrict__ gpose,            // (B, NB, M, 6)
                             float* __restrict__ gmixs,            // (B, NB, M) sum of gmix
                             float* __restrict__ gtarget,          // (B, C, P) or null
                             float* __restrict__ grow,             // (B, 3, P) scalar rows
                             int M, int Ht, int Wt, int H, int W, int R) {
  constexpr int CC = C + 1;
  extern __shared__ float smem[];
  const int T = Ht * Wt;
  const int P = H * W;
  const int PB = R * W;
  const int NB = H / R;
  const int G = M / kGroup;
  const int nwarps = blockDim.x / 32;
  float* tab = smem;                        // (8, CC, T), window rows only
  float* extra = tab + kGroup * CC * T;     // (8, kExtra)
  float* px_ix = extra + kGroup * kExtra;   // (8, PB) coordinates
  float* px_iy = px_ix + kGroup * PB;
  float* px_g = px_iy + kGroup * PB;        // (8, CC, PB) gV per channel, then gmix
  float* red = px_g + kGroup * CC * PB;     // (8 * kSums, nwarps)
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int i = threadIdx.x;
  const int p = k * PB + i;
  const bool active = i < PB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float bg_value = scal[0];
  const float bg_mix = scal[1];
  const float scale = scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float two_inv_2var = 2.0f * inv_2var;
  const float neg_const = -logf(scale) - kLogSqrt2Pi;
  const float s3 = scale * scale * scale;
  const float fHt = static_cast<float>(Ht);
  const float fWt = static_cast<float>(Wt);
  const float cx = 0.5f * fWt;
  const float cy = 0.5f * fHt;

  // this pixel's inputs and its background terms; inactive threads hold 0
  float gx = 0.0f, gy = 0.0f, dn = 0.0f, gsum = 0.0f;
  float t[C], gc[C], nm[C], tsum[C];
  float gq_bg_sum = 0.0f, gbgv = 0.0f, sq_row = 0.0f, q_row = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) t[c] = gc[c] = nm[c] = tsum[c] = 0.0f;
  if (active) {
    gx = grid_x[p];
    gy = grid_y[p];
    dn = den[static_cast<size_t>(b) * P + p];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t o = (static_cast<size_t>(b) * C + c) * P + p;
      t[c] = target[o];
      gc[c] = g[o];
      nm[c] = num[o];
      gsum += gc[c];
      const float d = t[c] - bg_value;
      const float dd = d * d;
      const float gq = gc[c] * expf(bg_mix + (-dd * inv_2var + neg_const) - nm[c]);
      gq_bg_sum += gq;
      gbgv += gq * d;
      sq_row += gq * dd;
      q_row += gq;
      tsum[c] = gq * d;
    }
  }

  for (int grp = 0; grp < G; ++grp) {
    const int* wg = win + ((static_cast<size_t>(b) * NB + k) * G + grp) * 2;
    const int lo = wg[0];
    const int trips = wg[1];
    stage_group<C>(tab, extra, templates, alpha, pose, presence, b, grp, M, Ht, Wt, lo, trips);
    __syncthreads();

    // 1. one thread per pixel, each of the group's capsules in turn
    for (int m8 = 0; m8 < kGroup; ++m8) {
      float sums[kSums];
#pragma unroll
      for (int j = 0; j < kSums; ++j) sums[j] = 0.0f;
      if (active) {
        const float* pm = extra + m8 * kExtra;
        const float ix = source_coord(pm[0], pm[1], pm[2], gx, gy, fWt);
        const float iy = source_coord(pm[3], pm[4], pm[5], gx, gy, fHt);
        float wx[2], dwx[2], wy[2], dwy[2];
        int kx[2], ky[2];
        bool in[2];
        two_taps(ix, Wt, wx, dwx, kx);
        window_taps(iy, Ht, lo, trips, wy, dwy, ky, in);

        float tx[CC][2][2];  // texel (cc, row tap, column tap)
        float sr[CC][2];     // S[cc][row tap] = sum_w table[cc, h, w] wx[w]
        float v[CC];
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const float* tc = tab + (m8 * CC + cc) * T;
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            tx[cc][a][0] = in[a] ? tc[ky[a] * Wt + kx[0]] : 0.0f;
            tx[cc][a][1] = in[a] ? tc[ky[a] * Wt + kx[1]] : 0.0f;
            sr[cc][a] = tx[cc][a][0] * wx[0] + tx[cc][a][1] * wx[1];
          }
          v[cc] = sr[cc][0] * wy[0] + sr[cc][1] * wy[1];
        }

        const float mix = v[C] + pm[6];
        float gval[CC];
        float gq_sum = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float d = t[c] - v[c];
          const float dd = d * d;
          const float gq = gc[c] * expf(mix + (-dd * inv_2var + neg_const) - nm[c]);
          gval[c] = gq * d * two_inv_2var;
          gq_sum += gq;
          sq_row += gq * dd;
          q_row += gq;
          tsum[c] += gq * d;
        }
        const float gmix = gq_sum - gsum * expf(mix - dn);
        gval[C] = gmix;

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
        sums[0] = gix * gx;
        sums[1] = gix * gy;
        sums[2] = gix;
        sums[3] = giy * gx;
        sums[4] = giy * gy;
        sums[5] = giy;
        sums[6] = gmix;

        px_ix[m8 * PB + i] = ix;
        px_iy[m8 * PB + i] = iy;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) px_g[(m8 * CC + cc) * PB + i] = gval[cc];
      }
#pragma unroll
      for (int j = 0; j < kSums; ++j) {
        const float s = warp_sum(sums[j]);
        if (lane == 0) red[(m8 * kSums + j) * nwarps + warp] = s;
      }
    }
    __syncthreads();

    // 2. one thread per (capsule, texel): its gradient over the band's
    // pixels in pixel order, 0 outside the window
    const size_t part = (static_cast<size_t>(b) * NB + k) * M + static_cast<size_t>(grp) * kGroup;
    for (int job = threadIdx.x; job < kGroup * T; job += blockDim.x) {
      const int m8 = job / T;
      const int texel = job % T;
      const int h = texel / Wt;
      float s[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) s[cc] = 0.0f;
      if (h >= lo && h < lo + trips) {
        const float fh = static_cast<float>(h);
        const float fw = static_cast<float>(texel - h * Wt);
        const float* qy = px_iy + m8 * PB;
        const float* qx = px_ix + m8 * PB;
        const float* qg = px_g + m8 * CC * PB;
        for (int j = 0; j < PB; ++j) {
          const float ay = fabsf(qy[j] - fh);
          if (ay < 1.0f) {
            const float ax = fabsf(qx[j] - fw);
            if (ax < 1.0f) {
              const float wyh = 1.0f - ay;
              const float wxw = 1.0f - ax;
#pragma unroll
              for (int cc = 0; cc < CC; ++cc) s[cc] += (qg[cc * PB + j] * wyh) * wxw;
            }
          }
        }
      }
      float* out = gtab + (part + m8) * CC * T + texel;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) out[cc * T] = s[cc];
    }

    // the pose and gmix sums over the band's pixels, the warps in order
    if (threadIdx.x < kGroup * kSums) {
      const int m8 = threadIdx.x / kSums;
      const int j = threadIdx.x % kSums;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += red[threadIdx.x * nwarps + w];
      if (j < 6) {
        gpose[(part + m8) * 6 + j] = s * (j < 3 ? cx : cy);
      } else {
        gmixs[part + m8] = s;
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (gtarget != nullptr) {
      gtarget[(static_cast<size_t>(b) * C + c) * P + p] = tsum[c] * (-2.0f * inv_2var);
    }
  }
  float* row = grow + static_cast<size_t>(b) * 3 * P + p;
  row[0] = gbgv * two_inv_2var;
  row[P] = gq_bg_sum - gsum * expf(bg_mix - dn);
  row[2 * P] = sq_row / s3 - q_row / scale;
}

template <int C>
int launch(const float* templates, const float* alpha, const float* pose,
           const float* presence, const float* target, const float* scal, const float* g,
           const float* num, const float* den, const float* grid_x, const float* grid_y,
           const int* win, float* gtab, float* gpose, float* gmixs, float* gtarget, float* grow,
           int B, int M, int Ht, int Wt, int H, int W, int R, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(C, Ht, Wt, R * W) * sizeof(float);
  auto kernel = decoder_ll_banded_bwd_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(H / R, B), band_threads(R * W), smem, stream>>>(
      templates, alpha, pose, presence, target, scal, g, num, den, grid_x, grid_y, win, gtab,
      gpose, gmixs, gtarget, grow, M, Ht, Wt, H, W, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the backward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 (win: int32) device array
// (see the kernel's parameter comments for the shapes); grid_x and grid_y
// are the output grid as scae_tpu_torch/ops/warp.py::_base_grid gives it,
// flattened. Every output is written in full, so none needs zeroing;
// gtarget may be null (no target gradient). C must be 1..4, M a multiple
// of 8, R a divisor of H with R W at most kMaxThreads.
int scae_decoder_ll_banded_bwd(const void* templates, const void* alpha, const void* pose,
                               const void* presence, const void* target, const void* scal,
                               const void* g, const void* num, const void* den,
                               const void* grid_x, const void* grid_y, const void* win,
                               void* gtab, void* gpose, void* gmixs, void* gtarget, void* grow,
                               int B, int M, int C, int Ht, int Wt, int H, int W, int R,
                               void* stream) {
  if (!valid_sizes(B, M, Ht, Wt, H, W, R)) return static_cast<int>(cudaErrorInvalidValue);
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
  const auto* wn = static_cast<const int*>(win);
  auto* o_tab = static_cast<float*>(gtab);
  auto* o_pose = static_cast<float*>(gpose);
  auto* o_mix = static_cast<float*>(gmixs);
  auto* o_tgt = static_cast<float*>(gtarget);
  auto* o_row = static_cast<float*>(grow);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define SCAE_BWD_CASE(N)                                                                     \
  case N:                                                                                    \
    return launch<N>(t, a, po, pr, tg, sc, gg, nm, dn, gxs, gys, wn, o_tab, o_pose, o_mix,  \
                     o_tgt, o_row, B, M, Ht, Wt, H, W, R, s);
    SCAE_BWD_CASE(1)
    SCAE_BWD_CASE(2)
    SCAE_BWD_CASE(3)
    SCAE_BWD_CASE(4)
#undef SCAE_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
