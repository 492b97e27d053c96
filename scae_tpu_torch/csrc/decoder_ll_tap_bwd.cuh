// The backward of the two-tap fused template-decoder likelihood, for
// Hopper: one kernel template for K4b (decoder_ll_dense_bwd.cu) and K5b
// (decoder_ll_banded_bwd.cu), which compute one function and differ only
// by K5b's row windows.
//
// Function (scae_tpu/ops/decoder_ll.py::_bwd with float32 taps, ported as
// scae_tpu_torch/ops/decoder_ll.py, the kernels' plain version). Given the
// upstream gradient g = dL/dll (B, C, P) and the forward's log-sum-exps
// num (B, C, P) and den (B, 1, P), for capsule m at output pixel p:
//   r       = exp(mix - den),   q[c] = exp(mix + lp[c] - num[c]),  gq = g q
//   gV[c]   = gq[c] (t[c] - V[c]) / s^2,   gmix = sum_c gq[c] - (sum_c g[c]) r
//   g_T[m, c, h, w] = sum_p gV[c] wy[h] wx[w]      (g_A likewise with gmix)
//   g_ix    = sum_w dtap(ix - w) sum_{c,h} gval[c] wy[h] table[c, h, w]
//   g_iy    = sum_h dtap(iy - h) sum_{c,w} gval[c] wx[w] table[c, h, w]
//   gpose   = Wt/2 (sum_p g_ix x, sum_p g_ix y, sum_p g_ix), Ht/2 (the same for g_iy)
//   gpres   = sum_p gmix / presence   (0 where presence < 1e-16, as log_safe)
// with the taps of common.cuh::two_taps: weights relu(1 - |d|) and slopes
// dtap(d) = -sign(d) where |d| < 1, else 0 (the JAX package's _dtap, 0 at
// a texel centre and at |d| = 1). Windowed (K5b): a template row outside
// the row window of the capsule's group for the pixel's band has weight
// and slope 0 in y (decoder_ll_banded.cuh::window_taps), as in the plain
// version's row mask. The background component gives the three scalar
// gradients (bg_value, bg_mixing_logit, scale) and, with the capsules, the
// target gradient.
//
// Design: the run scatter of the gather backward (decoder_ll_gather_bwd.cu,
// which keeps its own copy of it). Given num and den, capsule m's terms
// need only its own values, so a block owns one (capsule, example) pair
// and stores each of its outputs once; one more block per example does
// the background's terms (common.cuh::background_scalars). The block
// stages its capsule's C template planes and alpha plane, a texel's planes
// side by side for one vector load. Each warp walks the pixels 32 at a
// time, one per lane, and computes the taps, gval (C + 1 values), g_ix and
// g_iy; the pose, presence and scale partials stay in the lane's registers
// and are reduced once per block in a fixed order (common.cuh::block_sums).
// The template gradient is a scatter of each pixel's 4 tap weights times
// gval, made without atomics:
//   - the key of a pixel is its output row and the cell (floor(iy),
//     floor(ix)) of its two taps on each axis. Along a row the source
//     coordinates are affine in the column, and their rounding
//     (common.cuh::source_coord) keeps them monotone, so floor(iy) and
//     floor(ix) are monotone along the row and the pixels of one row with
//     equal keys are neighbours. A pixel has a key only where one of its
//     row taps lies in the template (and, windowed, in its window) and one
//     of its column taps lies in the template: a test of the floors and
//     the window alone, and the window is constant along an output row (a
//     row lies in one band, and the block's capsule in one group), so a
//     pixel between two with one key has that key too, and masking by the
//     window never splits a run. A window change inside a warp's 32 pixels
//     happens only at a band boundary, which is a row boundary, and the key
//     holds the row. So each run of equal keys among a warp's 32 pixels is
//     summed by its last lane, in lane order, from the lanes' values in
//     shared memory;
//   - the run ends then add their 4 tap sums into the warp's own gradient
//     table, one tap at a time and one output row at a time, so that no
//     two lanes ever write one address together (within a row and a tap,
//     distinct runs hit distinct texels); a tap outside the template or
//     the window, whose weight is 0, is skipped;
//   - the block's warps' tables are added in order at the end.
// The scatter takes the value's own taps and weights, so it is exact at
// texel centres and edges as the value is. Sums over the capsules are the
// wrapper's: the scale's and the background's scalar terms go to a
// (B, M+1, 3) buffer, and, where the target's gradient is asked for, each
// capsule's term per pixel to a (B, M, C, P) buffer that
// common.cuh::decoder_ll_target_kernel sums over the capsules in order. No
// floating-point atomics anywhere: the results are bit-identical from run
// to run, and no output needs zeroing.
//
// What this replaces: K4b's texel scan (one thread per (texel, pixel
// slice) testing every staged pixel's two tap distances, T P = 193,600
// tests per block at the flagship, almost all misses) and K5b's band grid
// ((bands, B) blocks walking the capsule groups in turn, each group a scan
// of its window's texels over the band's pixels, with per-band partial
// gradients, 24.8 MB at the flagship, that the wrapper summed).
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40, no
// target gradient): the same function on the same inputs as K2+K3's, so
// its count: ~11 MB in and out (3.3 us at 3.35 TB/s) against ~0.94 GFLOP
// of f32 operations (14 us at 67 TFLOP/s, chip_smoke.py's bwd_bound_ms):
// bound by operations. The runs' bookkeeping (keys, run sums, the writes
// tap by tap) is this design's own cost and is not counted.
// Grid: (M + 1, B); kTapThreads threads per block.

#pragma once

#include "decoder_ll_banded.cuh"

namespace {

constexpr int kTapThreads = 128;
constexpr int kTapWarps = kTapThreads / 32;
constexpr int kTapSums = 9;  // per block: 6 pose sums, gmix, sum gq d^2, sum gq

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
inline size_t tap_bwd_smem_floats(int C, int Ht, int Wt) {
  const size_t T = static_cast<size_t>(Ht) * Wt;
  return T * tex_stride(C) + kTapWarps * ((C + 1) * T + (4 * (C + 1) + 1) * 32);
}

// The kernel's arguments; every array is a contiguous device array.
struct TapBwdArgs {
  const float* templates;  // (B, M, C, Ht*Wt)
  const float* alpha;      // (1 or B, M, Ht*Wt)
  const float* pose;       // (B, M, 6)
  const float* presence;   // (B, M)
  const float* target;     // (B, C, P)
  const float* scal;       // bg_value, bg_mix, scale
  const float* g;          // (B, C, P) dL/dll
  const float* num;        // (B, C, P)
  const float* den;        // (B, 1, P)
  const float* grid_x;     // (P,) output x in [-1, 1]
  const float* grid_y;     // (P,) output y in [-1, 1]
  const int* win;          // (B, H / R, M / kGroup, 2) [lo, trips]; windowed only
  float* gtab;             // (B, M, C+1, Ht*Wt)
  float* gpose;            // (B, M, 6)
  float* gpres;            // (B, M)
  float* cscal;            // (B, M+1, 3)
  float* tpart;            // (B, M, C, P) or null
  int M, Ht, Wt, H, W;
  int R;                   // band rows (windowed only)
  int alpha_batched;
};

// TapBwdArgs from a launcher's untyped pointers (win null for K4b).
inline TapBwdArgs tap_bwd_args(const void* templates, const void* alpha, const void* pose,
                               const void* presence, const void* target, const void* scal,
                               const void* g, const void* num, const void* den,
                               const void* grid_x, const void* grid_y, const void* win,
                               void* gtab, void* gpose, void* gpres, void* cscal, void* tpart,
                               int M, int Ht, int Wt, int H, int W, int R, int alpha_batched) {
  TapBwdArgs a;
  a.templates = static_cast<const float*>(templates);
  a.alpha = static_cast<const float*>(alpha);
  a.pose = static_cast<const float*>(pose);
  a.presence = static_cast<const float*>(presence);
  a.target = static_cast<const float*>(target);
  a.scal = static_cast<const float*>(scal);
  a.g = static_cast<const float*>(g);
  a.num = static_cast<const float*>(num);
  a.den = static_cast<const float*>(den);
  a.grid_x = static_cast<const float*>(grid_x);
  a.grid_y = static_cast<const float*>(grid_y);
  a.win = static_cast<const int*>(win);
  a.gtab = static_cast<float*>(gtab);
  a.gpose = static_cast<float*>(gpose);
  a.gpres = static_cast<float*>(gpres);
  a.cscal = static_cast<float*>(cscal);
  a.tpart = static_cast<float*>(tpart);
  a.M = M;
  a.Ht = Ht;
  a.Wt = Wt;
  a.H = H;
  a.W = W;
  a.R = R;
  a.alpha_batched = alpha_batched;
  return a;
}

// The work of one block, (capsule blockIdx.x or the background, example
// blockIdx.y); see the header comment.
template <int C, bool Windowed>
__device__ __forceinline__ void tap_bwd_block(TapBwdArgs a) {
  constexpr int CC = C + 1;
  constexpr int TS = tex_stride(C);
  constexpr int NV = 4 * CC;  // tap values of a pixel: (tap, plane)
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kTapSums][kTapWarps];
  const float* __restrict__ g = a.g;
  const float* __restrict__ target = a.target;
  const float* __restrict__ num = a.num;
  const float* __restrict__ den = a.den;
  const float* __restrict__ grid_x = a.grid_x;
  const float* __restrict__ grid_y = a.grid_y;
  const int M = a.M;
  const int Ht = a.Ht;
  const int Wt = a.Wt;
  const int W = a.W;
  const int T = Ht * Wt;
  const int P = a.H * W;
  const int m = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float bg_value = a.scal[0];
  const float bg_mix = a.scal[1];
  const float scale = a.scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float two_inv_2var = 2.0f * inv_2var;
  const float neg_const = -logf(scale) - kLogSqrt2Pi;

  if (m == M) {  // the background block
    background_scalars<C>(target, g, num, den, bg_value, bg_mix, inv_2var, neg_const, scale, b,
                          P, red, a.cscal + (static_cast<size_t>(b) * (M + 1) + M) * 3);
    return;
  }

  const size_t bm = static_cast<size_t>(b) * M + m;
  float* tab = smem;                        // (T, TS): C template planes, then alpha
  float* wtab = tab + T * TS;                  // (kTapWarps, CC, T) the warps' tables
  float* scratch = wtab + kTapWarps * CC * T;  // (kTapWarps, NV + 1, 32)
  float* mytab = wtab + warp * CC * T;
  float* vals = scratch + warp * (NV + 1) * 32;        // (NV, 32) this warp's tap values
  int* keys = reinterpret_cast<int*>(vals + NV * 32);  // (32,) and their keys

  const float* tm = a.templates + bm * C * T;
  for (int i = threadIdx.x; i < C * T; i += blockDim.x) {
    const int c = i / T;
    tab[(i - c * T) * TS + c] = tm[i];
  }
  const float* am = a.alpha + (a.alpha_batched ? bm : static_cast<size_t>(m)) * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) tab[i * TS + C] = am[i];
  for (int i = threadIdx.x; i < kTapWarps * CC * T; i += blockDim.x) wtab[i] = 0.0f;
  float pm[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) pm[k] = a.pose[bm * 6 + k];
  const float pres = a.presence[bm];
  const float lp_m = log_safe(pres);
  const float fHt = static_cast<float>(Ht);
  const float fWt = static_cast<float>(Wt);
  // this capsule's windows, one per band: win[b, band, m / kGroup]
  const int* wins = nullptr;
  int win_stride = 0;
  if constexpr (Windowed) {
    const int G = M / kGroup;
    wins = a.win + (static_cast<size_t>(b) * (a.H / a.R) * G + m / kGroup) * 2;
    win_stride = G * 2;
  }
  __syncthreads();

  // per-lane pixel sums: 6 pose partials, gmix, sum gq d^2, sum gq
  float sums[kTapSums];
#pragma unroll
  for (int k = 0; k < kTapSums; ++k) sums[k] = 0.0f;

  // every lane of a warp takes part in each pass, with or without a pixel
  for (int base = warp * 32; base < P; base += kTapThreads) {
    const int p = base + lane;
    const int row = p / W;
    int key = -1 - lane;  // no pixel, or no tap in the template: a run of its own
    int h0i = 0, w0i = 0;
    int lo = 0, hi = Ht;  // the rows a tap may land on: the template's, or the window's
    if (p < P) {
      const float gx = grid_x[p];
      const float gy = grid_y[p];
      const float ix = source_coord(pm[0], pm[1], pm[2], gx, gy, fWt);
      const float iy = source_coord(pm[3], pm[4], pm[5], gx, gy, fHt);
      float wx[2], dwx[2], wy[2], dwy[2];
      int kx[2], ky[2];
      two_taps(ix, Wt, wx, dwx, kx);
      if constexpr (Windowed) {
        const int* wn = wins + (row / a.R) * win_stride;
        bool in[2];
        window_taps(iy, Ht, wn[0], wn[1], wy, dwy, ky, in);
        lo = max(wn[0], 0);
        hi = min(wn[0] + wn[1], Ht);
      } else {
        two_taps(iy, Ht, wy, dwy, ky);
      }

      float tx[CC][2][2];  // texel (cc, row tap, column tap)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float planes[TS];
          load_vec<TS>(tab + (ky[r] * Wt + kx[j]) * TS, planes);
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) tx[cc][r][j] = planes[cc];
        }
      }
      float sr[CC][2];  // S[cc][row tap] = sum_w table[cc, h, w] wx[w]
      float v[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
#pragma unroll
        for (int r = 0; r < 2; ++r) sr[cc][r] = tx[cc][r][0] * wx[0] + tx[cc][r][1] * wx[1];
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
        if (a.tpart != nullptr) a.tpart[(bm * C + c) * P + p] = gq * d;
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

      // the key: the output row and the taps' cell, where a row tap lies
      // in [lo, hi) and a column tap in the template
      const float h0 = floorf(iy);
      const float w0 = floorf(ix);
      if (lo < hi && h0 >= static_cast<float>(lo - 1) && h0 <= static_cast<float>(hi - 1) &&
          w0 >= -1.0f && w0 <= fWt - 1.0f) {
        const float wt[4] = {wy[0] * wx[0], wy[0] * wx[1], wy[1] * wx[0], wy[1] * wx[1]};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) vals[(t * CC + cc) * 32 + lane] = gval[cc] * wt[t];
        }
        h0i = static_cast<int>(h0);
        w0i = static_cast<int>(w0);
        key = (row * (Ht + 1) + h0i + 1) * (Wt + 1) + w0i + 1;
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
    const int last_row = min(base + 31, P - 1) / W;
    for (int r = base / W; r <= last_row; ++r) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int h = h0i + (t >> 1);
        const int w = w0i + (t & 1);
        if (end && row == r && h >= lo && h < hi && w >= 0 && w < Wt) {
          float* dst = mytab + h * Wt + w;
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) dst[cc * T] += run[t * CC + cc];
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  float* gt = a.gtab + bm * CC * T;
  for (int i = threadIdx.x; i < CC * T; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kTapWarps; ++w) s += wtab[w * CC * T + i];
    gt[i] = s;
  }

  block_sums(sums, red);
  if (threadIdx.x == 0) {
    const float cx = 0.5f * fWt;
    const float cy = 0.5f * fHt;
#pragma unroll
    for (int k = 0; k < 6; ++k) a.gpose[bm * 6 + k] = sums[k] * (k < 3 ? cx : cy);
    a.gpres[bm] = pres < kPresEps ? 0.0f : sums[6] / pres;
    float* out = a.cscal + (static_cast<size_t>(b) * (M + 1) + m) * 3;
    out[0] = 0.0f;
    out[1] = 0.0f;
    out[2] = sums[7] / (scale * scale * scale) - sums[8] / scale;
  }
}

// Launches `kernel` (a __global__ that runs tap_bwd_block<C, ...>) on a
// (M + 1, B) grid, and, where gtarget is given (a.tpart then too), the sum
// of the target's gradient over the capsules after it. Returns
// cudaGetLastError() (0 on success).
template <int C>
int launch_tap_bwd(void (*kernel)(TapBwdArgs), const TapBwdArgs& a, float* gtarget, int B,
                   cudaStream_t stream) {
  const size_t smem = tap_bwd_smem_floats(C, a.Ht, a.Wt) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.M + 1, B), kTapThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || gtarget == nullptr) return static_cast<int>(e);
  const int P = a.H * a.W;
  decoder_ll_target_kernel<C><<<dim3((P + 255) / 256, B), 256, 0, stream>>>(
      a.target, a.scal, a.g, a.num, a.tpart, gtarget, a.M, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
