// Fused template-decoder reconstruction log-likelihood, backward, for Hopper.
//
// Replaces the two Pallas kernels of the JAX package's gather backward,
// scae_tpu/ops/pallas_decoder_ll_gather.py: _bwd_kernel (split mode, its
// pallas_call at line 604) and _gt_kernel (pallas_call at line 634). Their
// function is _core_bwd; written out in jnp it is
// scae_tpu/ops/decoder_ll.py::_bwd.
//
// Given the upstream gradient g = dL/dll (B, C, P) and the forward's
// log-sum-exps num (B, C, P) and den (B, 1, P), each thread owns one output
// pixel p of one example b and loops over the M capsules, recomputing the
// forward's warp (coordinates, validity-folded taps, the 4 texels of each
// plane):
//   r       = exp(mix - den),   q[c] = exp(mix + lp[c] - num[c]),  gq = g q
//   gV[c]   = gq[c] (t[c] - V[c]) / s^2
//   gmix    = sum_c gq[c] - (sum_c g[c]) r
//   g_ix    = sum_cc gval[cc] * dV[cc]/dix   (masked texels; the same for iy)
//   gpose  += (g_ix x, g_ix y, g_ix) Wt/2, (g_iy x, g_iy y, g_iy) Ht/2
//   gpres  += gmix / presence   (0 where presence < 1e-16, as log_safe)
//   gtab[m, cc, tap] += gval[cc] * wy_a * wx_b   for the 4 taps
// plus, per pixel, the target gradient and the three scalar-gradient rows
// (bg_value, bg_mixing_logit, scale), which the TPU kernel returns as rows.
//
// The TPU needs two kernels because Mosaic has no scatter: its first kernel
// writes the (B, C+1, M, P) upstream planes to HBM in bf16 and the second
// contracts them on the MXU against dense tap rows. On Hopper the template
// gradient is a scatter-add: each (capsule, pixel) adds its 4 tap weights
// times the C+1 upstream values into a per-capsule gradient table in shared
// memory laid out like the forward's texel table (M x (C+1) x Ht*Wt), and
// the block adds the table to global memory once at its end. So the
// (B, C+1, M, P) planes never exist (65.5 MB each in f32 at the flagship),
// and one kernel does the work of both. Sums over pixels (pose, presence,
// scalar rows) are warp-shuffle reductions into shared memory, then one
// global atomicAdd per value per block; atomics make the summation order,
// and so the last bits, change from run to run.
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40): the
// bytes in and out are ~11 MB (about 3.3 us at 3.35 TB/s), while the
// arithmetic is 76 f32 operations for each of the 8.19 M (capsule, pixel)
// pairs plus 74 more for each pair whose taps touch the template (about
// half of them with random poses): ~0.94 GFLOP, 14 us at 67 TFLOP/s
// (chip_smoke.py's bwd_bound_ms counts them from this code and the run's
// data), so the kernel is bound by f32 operations.
// Grid: (pixel tiles of 256, B, capsule groups); one thread per output
// pixel. A block holds the tables of one group of Mb capsules, at most
// all M: the capsule and gradient tables of all 64 capsules of the cifar10
// shape (M=64, C=3, 11x11) need 251,392 bytes, more than a block's 232,448,
// so the wrapper splits them into as few groups as fit (one group, as
// before, at the flagship; two of 32 at the cifar10 shape). Given num and
// den, each capsule's gradient terms need only its own values; only the
// target gradient and the scalar rows sum over the capsules, and with more
// than one group each group adds its share into them through atomics
// (the target gradient then arrives zeroed), the first group adding the
// background's.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_gather.py binds it with ctypes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPart = 7;  // per capsule: 6 pose partials, then presence

template <int C>
__global__ void __launch_bounds__(kThreads)
decoder_ll_gather_bwd_kernel(const float* __restrict__ templates,  // (B, M, C, Ht*Wt)
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
                             float* __restrict__ gtab,             // (B, M, C+1, Ht*Wt), zeroed
                             float* __restrict__ gpose,            // (B, M, 6), zeroed
                             float* __restrict__ gpres,            // (B, M), zeroed
                             float* __restrict__ gtarget,          // (B, C, P) or null
                             float* __restrict__ gscal,            // (3,), zeroed
                             int M_total, int Mb, int Ht, int Wt, int H, int W,
                             int alpha_batched) {
  constexpr int CC = C + 1;
  extern __shared__ float smem[];
  __shared__ float red[3][kWarps];
  const int T = Ht * Wt;
  const int P = H * W;
  const int b = blockIdx.y;
  const int m0 = blockIdx.z * Mb;          // this block's capsule group
  const int M = min(Mb, M_total - m0);     // its capsules
  const bool first = blockIdx.z == 0;      // the group that adds the background's terms
  const bool split = gridDim.z > 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* tab = smem;                // (M, CC, T): C template planes, then alpha
  float* spose = tab + M * CC * T;  // (M, 6)
  float* slp = spose + M * 6;       // (M,) log_safe(presence)
  float* gt = slp + M;              // (M, CC, T) gradient table
  float* part = gt + M * CC * T;    // (M, kPart) pixel sums of this block
  const size_t bm0 = static_cast<size_t>(b) * M_total + m0;  // (b, m0) in (B, M_total)

  const float* tb = templates + bm0 * C * T;
  for (int i = threadIdx.x; i < M * C * T; i += blockDim.x) {
    const int m = i / (C * T);
    tab[m * CC * T + (i - m * C * T)] = tb[i];
  }
  const float* ab = alpha + (alpha_batched ? bm0 : static_cast<size_t>(m0)) * T;
  for (int i = threadIdx.x; i < M * T; i += blockDim.x) {
    const int m = i / T;
    tab[m * CC * T + C * T + (i - m * T)] = ab[i];
  }
  for (int i = threadIdx.x; i < M * 6; i += blockDim.x) {
    spose[i] = pose[bm0 * 6 + i];
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    slp[i] = log_safe(presence[bm0 + i]);
  }
  for (int i = threadIdx.x; i < M * CC * T + M * kPart; i += blockDim.x) {
    gt[i] = 0.0f;  // the gradient table and the partials are contiguous
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  // threads past the last pixel take part in the warp reductions with zeros
  const bool active = p < P;
  // the grid comes from the wrapper, as the plain version computes it
  const float gx = active ? grid_x[p] : 0.0f;
  const float gy = active ? grid_y[p] : 0.0f;

  const float bg_value = scal[0];
  const float bg_mix = scal[1];
  const float scale = scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float two_inv_2var = 2.0f * inv_2var;
  const float neg_const = -logf(scale) - kLogSqrt2Pi;
  const float fHt = static_cast<float>(Ht);
  const float fWt = static_cast<float>(Wt);

  float t[C], gc[C], nm[C], tg[C];
  float gsum = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const size_t o = (static_cast<size_t>(b) * C + c) * P + p;
    t[c] = active ? target[o] : 0.0f;
    gc[c] = active ? g[o] : 0.0f;
    nm[c] = active ? num[o] : 0.0f;
    tg[c] = 0.0f;
    gsum += gc[c];
  }
  const float dn = active ? den[static_cast<size_t>(b) * P + p] : 0.0f;
  float sq_acc = 0.0f;  // sum of gq (t - v)^2 over every component and channel
  float q_acc = 0.0f;   // sum of gq over every component and channel

  for (int m = 0; m < M; ++m) {
    float gmix = 0.0f, gix = 0.0f, giy = 0.0f;
    bool hit = false;  // some tap of this capsule lies inside the template
    if (active) {
      const float* pm = spose + m * 6;
      const float ix = source_coord(pm[0], pm[1], pm[2], gx, gy, fWt);
      const float iy = source_coord(pm[3], pm[4], pm[5], gx, gy, fHt);
      const float h0 = floorf(iy);
      const float w0 = floorf(ix);
      const float fy = iy - h0;
      const float fx = ix - w0;
      const float vy0 = (h0 >= 0.0f && h0 <= fHt - 1.0f) ? 1.0f : 0.0f;
      const float vy1 = (h0 + 1.0f >= 0.0f && h0 + 1.0f <= fHt - 1.0f) ? 1.0f : 0.0f;
      const float vx0 = (w0 >= 0.0f && w0 <= fWt - 1.0f) ? 1.0f : 0.0f;
      const float vx1 = (w0 + 1.0f >= 0.0f && w0 + 1.0f <= fWt - 1.0f) ? 1.0f : 0.0f;
      const float wy0 = (1.0f - fy) * vy0;
      const float wy1 = fy * vy1;
      const float wx0 = (1.0f - fx) * vx0;
      const float wx1 = fx * vx1;
      const int ih0 = static_cast<int>(fminf(fmaxf(h0, 0.0f), fHt - 1.0f));
      const int ih1 = static_cast<int>(fminf(fmaxf(h0 + 1.0f, 0.0f), fHt - 1.0f));
      const int iw0 = static_cast<int>(fminf(fmaxf(w0, 0.0f), fWt - 1.0f));
      const int iw1 = static_cast<int>(fminf(fmaxf(w0 + 1.0f, 0.0f), fWt - 1.0f));
      const int k00 = ih0 * Wt + iw0, k01 = ih0 * Wt + iw1;
      const int k10 = ih1 * Wt + iw0, k11 = ih1 * Wt + iw1;
      hit = (vy0 + vy1) * (vx0 + vx1) > 0.0f;

      const float* tm = tab + m * CC * T;
      float tx[CC][4], v[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float* tc = tm + cc * T;
        tx[cc][0] = tc[k00];
        tx[cc][1] = tc[k01];
        tx[cc][2] = tc[k10];
        tx[cc][3] = tc[k11];
        v[cc] = wy0 * (wx0 * tx[cc][0] + wx1 * tx[cc][1]) +
                wy1 * (wx0 * tx[cc][2] + wx1 * tx[cc][3]);
      }
      const float mix = v[C] + slp[m];
      float gval[CC];
      gmix = -gsum * expf(mix - dn);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float d = t[c] - v[c];
        const float dd = d * d;
        const float gq = gc[c] * expf(mix + (-dd * inv_2var + neg_const) - nm[c]);
        gval[c] = gq * d * two_inv_2var;
        gmix += gq;
        tg[c] += gq * d;
        sq_acc += gq * dd;
        q_acc += gq;
      }
      gval[C] = gmix;

      if (hit) {
        // dV/dix and dV/diy from the validity-masked texels
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const float dx = wy0 * (vx1 * tx[cc][1] - vx0 * tx[cc][0]) +
                           wy1 * (vx1 * tx[cc][3] - vx0 * tx[cc][2]);
          const float dy = wx0 * (vy1 * tx[cc][2] - vy0 * tx[cc][0]) +
                           wx1 * (vy1 * tx[cc][3] - vy0 * tx[cc][1]);
          gix += gval[cc] * dx;
          giy += gval[cc] * dy;
        }
        // scatter the tap weights into the gradient table; taps outside the
        // template have weight 0 and are skipped
        const float w00 = wy0 * wx0, w01 = wy0 * wx1, w10 = wy1 * wx0, w11 = wy1 * wx1;
        float* gm = gt + m * CC * T;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          float* gcp = gm + cc * T;
          if (w00 != 0.0f) atomicAdd(gcp + k00, gval[cc] * w00);
          if (w01 != 0.0f) atomicAdd(gcp + k01, gval[cc] * w01);
          if (w10 != 0.0f) atomicAdd(gcp + k10, gval[cc] * w10);
          if (w11 != 0.0f) atomicAdd(gcp + k11, gval[cc] * w11);
        }
      }
    }

    float* pp = part + m * kPart;
    const float gm_sum = warp_sum(gmix);
    if (lane == 0) atomicAdd(pp + 6, gm_sum);
    if (__any_sync(kFull, hit)) {
      const float s0 = warp_sum(gix * gx);
      const float s1 = warp_sum(gix * gy);
      const float s2 = warp_sum(gix);
      const float s3 = warp_sum(giy * gx);
      const float s4 = warp_sum(giy * gy);
      const float s5 = warp_sum(giy);
      if (lane == 0) {
        atomicAdd(pp + 0, s0);
        atomicAdd(pp + 1, s1);
        atomicAdd(pp + 2, s2);
        atomicAdd(pp + 3, s3);
        atomicAdd(pp + 4, s4);
        atomicAdd(pp + 5, s5);
      }
    }
  }

  // background component (first group only): target gradient and the
  // scalar-gradient rows
  float row0 = 0.0f, row1 = 0.0f, row2 = 0.0f;
  if (active) {
    float gq_bg_sum = 0.0f, gbv = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float bg_term = 0.0f;
      if (first) {
        const float d = t[c] - bg_value;
        const float dd = d * d;
        const float gq = gc[c] * expf(bg_mix + (-dd * inv_2var + neg_const) - nm[c]);
        gq_bg_sum += gq;
        gbv += gq * d;
        sq_acc += gq * dd;
        q_acc += gq;
        bg_term = gq * d;
      }
      if (gtarget != nullptr) {
        float* o = gtarget + (static_cast<size_t>(b) * C + c) * P + p;
        const float v = (tg[c] + bg_term) * -two_inv_2var;
        if (split) {
          atomicAdd(o, v);
        } else {
          *o = v;
        }
      }
    }
    if (first) {
      row0 = gbv * two_inv_2var;
      row1 = gq_bg_sum - gsum * expf(bg_mix - dn);
    }
    row2 = sq_acc / (scale * scale * scale) - q_acc / scale;
  }
  row0 = warp_sum(row0);
  row1 = warp_sum(row1);
  row2 = warp_sum(row2);
  if (lane == 0) {
    red[0][warp] = row0;
    red[1][warp] = row1;
    red[2][warp] = row2;
  }
  __syncthreads();  // also orders every shared atomic before the flush

  if (threadIdx.x < 3) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x][w];
    atomicAdd(gscal + threadIdx.x, s);
  }
  float* gtb = gtab + bm0 * CC * T;
  for (int i = threadIdx.x; i < M * CC * T; i += blockDim.x) {
    const float v = gt[i];
    if (v != 0.0f) atomicAdd(gtb + i, v);
  }
  const float cx = 0.5f * fWt;
  const float cy = 0.5f * fHt;
  for (int i = threadIdx.x; i < M * 6; i += blockDim.x) {
    const int m = i / 6;
    const int k = i - m * 6;
    atomicAdd(gpose + bm0 * 6 + i, part[m * kPart + k] * (k < 3 ? cx : cy));
  }
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float pr = presence[bm0 + m];
    if (pr >= kPresEps) atomicAdd(gpres + bm0 + m, part[m * kPart + 6] / pr);
  }
}

template <int C>
int launch(const float* templates, const float* alpha, const float* pose,
           const float* presence, const float* target, const float* scal, const float* g,
           const float* num, const float* den, const float* grid_x, const float* grid_y,
           float* gtab, float* gpose, float* gpres, float* gtarget, float* gscal, int B, int M,
           int Mb, int Ht, int Wt, int H, int W, int alpha_batched, cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(Mb) * (C + 1) * Ht * Wt + static_cast<size_t>(Mb) * (7 + kPart)) *
      sizeof(float);
  auto kernel = decoder_ll_gather_bwd_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((H * W + kThreads - 1) / kThreads, B, (M + Mb - 1) / Mb);
  kernel<<<grid, kThreads, smem, stream>>>(templates, alpha, pose, presence, target, scal, g,
                                           num, den, grid_x, grid_y, gtab, gpose, gpres,
                                           gtarget, gscal, M, Mb, Ht, Wt, H, W, alpha_batched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the backward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 device array (see the
// kernel's parameter comments for the shapes); grid_x and grid_y are the
// output grid as scae_tpu_torch/ops/warp.py::_base_grid gives it, flattened;
// gtab, gpose, gpres and gscal
// must be zeroed, and gtarget may be null where no target gradient is
// needed; it must be zeroed too where Mb < M. Mb is the number of capsules
// a block takes, 1..M. C must be 1..4.
int scae_decoder_ll_gather_bwd(const void* templates, const void* alpha, const void* pose,
                               const void* presence, const void* target, const void* scal,
                               const void* g, const void* num, const void* den,
                               const void* grid_x, const void* grid_y, void* gtab,
                               void* gpose, void* gpres, void* gtarget, void* gscal, int B,
                               int M, int Mb, int C, int Ht, int Wt, int H, int W,
                               int alpha_batched, void* stream) {
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
  auto* o_tgt = static_cast<float*>(gtarget);
  auto* o_scal = static_cast<float*>(gscal);
  auto s = static_cast<cudaStream_t>(stream);
  if (Mb < 1 || Mb > M) return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
#define SCAE_BWD_CASE(N)                                                                    \
  case N:                                                                                   \
    return launch<N>(t, a, po, pr, tg, sc, gg, nm, dn, gxs, gys, o_tab, o_pose, o_pres, o_tgt, \
                     o_scal, B, M, Mb, Ht, Wt, H, W, alpha_batched, s);
    SCAE_BWD_CASE(1)
    SCAE_BWD_CASE(2)
    SCAE_BWD_CASE(3)
    SCAE_BWD_CASE(4)
#undef SCAE_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
