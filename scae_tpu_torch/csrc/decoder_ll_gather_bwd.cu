// Fused template-decoder reconstruction log-likelihood, backward, for Hopper
// (K2+K3).
//
// Replaces the two Pallas kernels of the JAX package's gather backward,
// scae_tpu/ops/pallas_decoder_ll_gather.py: _bwd_kernel (split mode, its
// pallas_call at line 604) and _gt_kernel (pallas_call at line 634). Their
// function is _core_bwd; written out in jnp it is
// scae_tpu/ops/decoder_ll.py::_bwd.
//
// Given the upstream gradient g = dL/dll (B, C, P) and the forward's
// log-sum-exps num (B, C, P) and den (B, 1, P), for capsule m at output
// pixel p, recomputing the forward's warp (coordinates, validity-folded
// taps, the 4 texels of each plane):
//   r       = exp(mix - den),   q[c] = exp(mix + lp[c] - num[c]),  gq = g q
//   gV[c]   = gq[c] (t[c] - V[c]) / s^2
//   gmix    = sum_c gq[c] - (sum_c g[c]) r
//   g_ix    = sum_cc gval[cc] * dV[cc]/dix   (masked texels; the same for iy)
//   gpose   = sum_p (g_ix x, g_ix y, g_ix) Wt/2, (g_iy x, g_iy y, g_iy) Ht/2
//   gpres   = sum_p gmix / presence   (0 where presence < 1e-16, as log_safe)
//   gtab[m, cc, h, w] = sum_p gval[cc] wy[h] wx[w]   over p's 4 taps
// plus, per pixel, the target gradient and the three scalar gradients
// (bg_value, bg_mixing_logit, scale), which the TPU kernel returns as rows.
//
// The TPU needs two kernels because Mosaic has no scatter: its first kernel
// writes the (B, C+1, M, P) upstream planes to HBM in bf16 and the second
// contracts them on the MXU against dense tap rows. Here one kernel does
// both, and the planes never leave the block.
//
// Design. Given num and den, capsule m's gradient terms need only its own
// values, so a block owns one (capsule, example) pair, as K4b's
// (decoder_ll_dense_bwd.cu), and writes each of its outputs once with a
// plain store; one more block per example does the background's terms.
// Each warp walks the pixels 32 at a time, one per lane, and computes
// gval (C + 1 values), g_ix and g_iy; the pose, presence and scale
// partials stay in the lane's registers and are reduced once per block in
// a fixed order (common.cuh::block_sums). The template gradient is a
// scatter of each pixel's 4 tap weights times gval, made without atomics:
//   - the key of a pixel is its output row and the cell (floor(iy),
//     floor(ix)) of its taps. Along a row the source coordinates are
//     affine in the column, and their rounding (common.cuh::source_coord)
//     keeps them monotone, so the pixels of one row with equal keys are
//     neighbours: each run of equal keys among a warp's 32 pixels is
//     summed by its last lane, in lane order, from the lanes' values in
//     shared memory;
//   - the run ends then add their 4 sums into the warp's own gradient
//     table, one tap at a time and one output row at a time, so that no
//     two lanes ever write one address together (within a row and a tap,
//     distinct runs hit distinct texels);
//   - the block's warps' tables are added in order at the end.
// The taps are the value's own (the weights computed for V), so the
// scatter takes the same tap decisions as the value and its derivative,
// exact at texel centres and edges. Sums over the capsules are the
// wrapper's, as in K4b: the scale's and the background's scalar terms go
// to a (B, M+1, 3) buffer, and, where the target's gradient is asked for,
// each capsule's term per pixel to a (B, M, C, P) buffer that
// common.cuh::decoder_ll_target_kernel sums over the capsules in order. No
// floating-point atomics anywhere: the results are bit-identical from run
// to run, and no output needs zeroing.
//
// What this does about the earlier design's costs (one block per 256-pixel
// tile and example, all M capsules; every tap added to a per-block table
// with a float atomic add in shared memory, which sm_90a compiles to a
// compare-and-swap loop that conflicting lanes retry, 69% of its time):
// (1) no shared atomics: a run of pixels with one key is summed by one
// lane, and no two lanes write one address together; (2) one block
// reduction per capsule instead of 7 warp reductions and 7 shared atomics
// per capsule per warp; (3) 9.4 KB of shared memory at the flagship
// instead of 79.7 KB, and 5,248 small blocks in place of 896 large ones,
// so more blocks fit an SM and the last wave is a small share of the run;
// (4) no global atomics: every output entry is stored once by the block
// that owns it; (5) no zeroing launches before the kernel, and the same
// bits on every run.
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40): the
// bytes in and out are ~11 MB (about 3.3 us at 3.35 TB/s), while the
// function's arithmetic is 76 f32 operations for each of the 8.19 M
// (capsule, pixel) pairs plus 74 more for each pair whose taps touch the
// template (about half of them with random poses): ~0.94 GFLOP, 14 us at
// 67 TFLOP/s (chip_smoke.py's bwd_bound_ms, fixed with the first port as
// the function's work: the runs' bookkeeping here is this design's own
// cost, not counted), so the kernel is bound by f32 operations.
// Grid: (M + 1, B); kThreads threads per block.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_gather.py binds it with ctypes.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 9;  // per block: 6 pose sums, gmix, sum gq d^2, sum gq

// Floats a texel of the capsule table takes in shared memory: its C + 1
// planes, padded for one vector load.
__host__ __device__ constexpr int tex_stride(int C) {
  return C + 1 <= 2 ? 2 : (C + 1 <= 4 ? 4 : 8);
}

// Loads N floats (N = 2, 4 or 8) at an 8- or 16-byte aligned shared-memory
// address with vector instructions.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + q);
      v[q] = t.x;
      v[q + 1] = t.y;
      v[q + 2] = t.z;
      v[q + 3] = t.w;
    }
  }
}

// Floats of a block's dynamic shared memory: the capsule table (T, TS),
// each warp's gradient table (C + 1, T), and each warp's scratch: the
// 4 (C + 1) tap values of its 32 pixels and their keys.
size_t shared_floats(int C, int Ht, int Wt) {
  const size_t T = static_cast<size_t>(Ht) * Wt;
  return T * tex_stride(C) + kWarps * ((C + 1) * T + (4 * (C + 1) + 1) * 32);
}

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
                             float* __restrict__ gtab,             // (B, M, C+1, Ht*Wt)
                             float* __restrict__ gpose,            // (B, M, 6)
                             float* __restrict__ gpres,            // (B, M)
                             float* __restrict__ cscal,            // (B, M+1, 3)
                             float* __restrict__ tpart,            // (B, M, C, P) or null
                             int M, int Ht, int Wt, int H, int W, int alpha_batched) {
  constexpr int CC = C + 1;
  constexpr int TS = tex_stride(C);
  constexpr int NV = 4 * CC;  // tap values of a pixel: (tap, plane)
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kSums][kWarps];
  const int T = Ht * Wt;
  const int P = H * W;
  const int m = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float bg_value = scal[0];
  const float bg_mix = scal[1];
  const float scale = scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float two_inv_2var = 2.0f * inv_2var;
  const float neg_const = -logf(scale) - kLogSqrt2Pi;

  if (m == M) {  // the background block
    background_scalars<C>(target, g, num, den, bg_value, bg_mix, inv_2var, neg_const, scale, b,
                          P, red, cscal + (static_cast<size_t>(b) * (M + 1) + M) * 3);
    return;
  }

  const size_t bm = static_cast<size_t>(b) * M + m;
  float* tab = smem;                        // (T, TS): C template planes, then alpha
  float* wtab = tab + T * TS;               // (kWarps, CC, T) the warps' gradient tables
  float* scratch = wtab + kWarps * CC * T;  // (kWarps, NV + 1, 32)
  float* mytab = wtab + warp * CC * T;
  float* vals = scratch + warp * (NV + 1) * 32;        // (NV, 32) this warp's tap values
  int* keys = reinterpret_cast<int*>(vals + NV * 32);  // (32,) and their keys

  const float* tm = templates + bm * C * T;
  for (int i = threadIdx.x; i < C * T; i += blockDim.x) {
    const int c = i / T;
    tab[(i - c * T) * TS + c] = tm[i];
  }
  const float* am = alpha + (alpha_batched ? bm : static_cast<size_t>(m)) * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) tab[i * TS + C] = am[i];
  for (int i = threadIdx.x; i < kWarps * CC * T; i += blockDim.x) wtab[i] = 0.0f;
  float pm[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) pm[k] = pose[bm * 6 + k];
  const float pres = presence[bm];
  const float lp_m = log_safe(pres);
  const float fHt = static_cast<float>(Ht);
  const float fWt = static_cast<float>(Wt);
  __syncthreads();

  // per-lane pixel sums: 6 pose partials, gmix, sum gq d^2, sum gq
  float sums[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) sums[k] = 0.0f;

  // every lane of a warp takes part in each pass, with or without a pixel
  for (int base = warp * 32; base < P; base += kThreads) {
    const int p = base + lane;
    int key = -1 - lane;  // no pixel, or no tap in the template: a run of its own
    int h0i = 0, w0i = 0;
    if (p < P) {
      const float gx = grid_x[p];
      const float gy = grid_y[p];
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
      const bool hit = (vy0 + vy1) * (vx0 + vx1) > 0.0f;

      float tx[CC][4], v[CC];
      {
        const int k[4] = {ih0 * Wt + iw0, ih0 * Wt + iw1, ih1 * Wt + iw0, ih1 * Wt + iw1};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float planes[TS];
          load_vec<TS>(tab + k[t] * TS, planes);
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) tx[cc][t] = planes[cc];
        }
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        v[cc] = wy0 * (wx0 * tx[cc][0] + wx1 * tx[cc][1]) +
                wy1 * (wx0 * tx[cc][2] + wx1 * tx[cc][3]);
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

      if (hit) {
        // dV/dix and dV/diy from the validity-masked texels (one-sided at a
        // texel centre, as the 4-tap form's autograd)
        float gix = 0.0f, giy = 0.0f;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const float dx = wy0 * (vx1 * tx[cc][1] - vx0 * tx[cc][0]) +
                           wy1 * (vx1 * tx[cc][3] - vx0 * tx[cc][2]);
          const float dy = wx0 * (vy1 * tx[cc][2] - vy0 * tx[cc][0]) +
                           wx1 * (vy1 * tx[cc][3] - vy0 * tx[cc][1]);
          gix += gval[cc] * dx;
          giy += gval[cc] * dy;
        }
        sums[0] += gix * gx;
        sums[1] += gix * gy;
        sums[2] += gix;
        sums[3] += giy * gx;
        sums[4] += giy * gy;
        sums[5] += giy;

        // the tap values, and the key: the output row and the taps' cell
        const float wt[4] = {wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) vals[(t * CC + cc) * 32 + lane] = gval[cc] * wt[t];
        }
        h0i = static_cast<int>(h0);
        w0i = static_cast<int>(w0);
        key = ((p / W) * (Ht + 1) + h0i + 1) * (Wt + 1) + w0i + 1;
      }
    }
    keys[lane] = key;
    __syncwarp();

    // the last lane of each run of equal keys sums the run, in lane order
    const bool end = key >= 0 && (lane == 31 || keys[lane + 1] != key);
    float run[NV];
    if (end) {
      int first = lane;
      while (first > 0 && keys[first - 1] == key) --first;
#pragma unroll
      for (int e = 0; e < NV; ++e) run[e] = vals[e * 32 + first];
      for (int l = first + 1; l <= lane; ++l) {
#pragma unroll
        for (int e = 0; e < NV; ++e) run[e] += vals[e * 32 + l];
      }
    }
    // into the warp's table, one output row and one tap at a time: within
    // a row, distinct runs have distinct cells, so no two lanes write one
    // texel at once
    const int row = p / W;
    const int last_row = min(base + 31, P - 1) / W;
    for (int r = base / W; r <= last_row; ++r) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int h = h0i + (t >> 1);
        const int w = w0i + (t & 1);
        if (end && row == r && h >= 0 && h < Ht && w >= 0 && w < Wt) {
          float* dst = mytab + h * Wt + w;
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) dst[cc * T] += run[t * CC + cc];
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  float* gt = gtab + bm * CC * T;
  for (int i = threadIdx.x; i < CC * T; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += wtab[w * CC * T + i];
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
    out[2] = sums[7] / (scale * scale * scale) - sums[8] / scale;
  }
}

template <int C>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(decoder_ll_gather_bwd_kernel<C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int C>
int launch(const float* templates, const float* alpha, const float* pose,
           const float* presence, const float* target, const float* scal, const float* g,
           const float* num, const float* den, const float* grid_x, const float* grid_y,
           float* gtab, float* gpose, float* gpres, float* cscal, float* tpart, float* gtarget,
           int B, int M, int Ht, int Wt, int H, int W, int alpha_batched, cudaStream_t stream) {
  const size_t smem = shared_floats(C, Ht, Wt) * sizeof(float);
  cudaError_t e = prepare<C>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  decoder_ll_gather_bwd_kernel<C><<<dim3(M + 1, B), kThreads, smem, stream>>>(
      templates, alpha, pose, presence, target, scal, g, num, den, grid_x, grid_y, gtab, gpose,
      gpres, cscal, tpart, M, Ht, Wt, H, W, alpha_batched);
  e = cudaGetLastError();
  if (e != cudaSuccess || gtarget == nullptr) return static_cast<int>(e);
  const dim3 grid((H * W + 255) / 256, B);
  decoder_ll_target_kernel<C><<<grid, 256, 0, stream>>>(target, scal, g, num, tpart, gtarget, M,
                                                        H * W);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int occupancy(size_t smem) {
  cudaError_t e = prepare<C>(smem);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, decoder_ll_gather_bwd_kernel<C>,
                                                      kThreads, smem);
  }
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

}  // namespace

extern "C" {

// Launches the backward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 device array (see the
// kernel's parameter comments for the shapes); grid_x and grid_y are the
// output grid as scae_tpu_torch/ops/warp.py::_base_grid gives it, flattened.
// Every output is written in full, so none needs zeroing. tpart and
// gtarget are both null (no target gradient) or both given. C must be 1..4.
int scae_decoder_ll_gather_bwd(const void* templates, const void* alpha, const void* pose,
                               const void* presence, const void* target, const void* scal,
                               const void* g, const void* num, const void* den,
                               const void* grid_x, const void* grid_y, void* gtab,
                               void* gpose, void* gpres, void* cscal, void* tpart,
                               void* gtarget, int B, int M, int C, int Ht, int Wt, int H,
                               int W, int alpha_batched, void* stream) {
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
  if ((o_part == nullptr) != (o_tgt == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
#define SCAE_BWD_CASE(N)                                                                      \
  case N:                                                                                     \
    return launch<N>(t, a, po, pr, tg, sc, gg, nm, dn, gxs, gys, o_tab, o_pose, o_pres, o_scal, \
                     o_part, o_tgt, B, M, Ht, Wt, H, W, alpha_batched, s);
    SCAE_BWD_CASE(1)
    SCAE_BWD_CASE(2)
    SCAE_BWD_CASE(3)
    SCAE_BWD_CASE(4)
#undef SCAE_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the backward kernel that fit on one SM at these sizes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a cudaError_t.
int scae_decoder_ll_gather_bwd_occupancy(int C, int Ht, int Wt) {
  const size_t smem = shared_floats(C, Ht, Wt) * sizeof(float);
  switch (C) {
    case 1: return occupancy<1>(smem);
    case 2: return occupancy<2>(smem);
    case 3: return occupancy<3>(smem);
    case 4: return occupancy<4>(smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
