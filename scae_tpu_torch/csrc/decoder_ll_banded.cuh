// What the banded kernels K5f (decoder_ll_banded.cu) and K5b
// (decoder_ll_banded_bwd.cu) share: the group size, the staging of one
// group's window rows, and the row taps masked by the window.
#pragma once

#include "common.cuh"

namespace {

constexpr int kGroup = 8;         // capsules per group, as on the TPU
constexpr int kExtra = 8;         // per staged capsule: 6 pose entries, log-presence, pad
constexpr int kMaxThreads = 512;  // one thread per band pixel, at most this many

// Threads of a block for a band of `pixels` pixels: whole warps.
inline int band_threads(int pixels) { return (pixels + 31) / 32 * 32; }

// Floats of shared memory that one staged group takes.
inline size_t group_smem_floats(int C, int Ht, int Wt) {
  return static_cast<size_t>(kGroup) * ((C + 1) * Ht * Wt + kExtra);
}

// The sizes both kernels take: whole groups, bands that tile the canvas,
// a band of at most kMaxThreads pixels.
inline bool valid_sizes(int B, int M, int Ht, int Wt, int H, int W, int R) {
  return B >= 1 && B <= 65535 && M >= kGroup && M % kGroup == 0 && Ht >= 1 && Wt >= 1 &&
         W >= 1 && R >= 1 && H % R == 0 && R * W <= kMaxThreads;
}

// Stage group g of example b: for each of its 8 capsules the rows
// [lo, lo + trips) of its C template planes and its alpha plane, at their
// own row offsets in an (8, C+1, Ht, Wt) table (the other rows are left
// as they were and never read), then its pose and log-presence in
// extra[8][kExtra].
template <int C>
__device__ __forceinline__ void stage_group(float* tab, float* extra,
                                            const float* __restrict__ templates,
                                            const float* __restrict__ alpha,
                                            const float* __restrict__ pose,
                                            const float* __restrict__ presence, int b, int g,
                                            int M, int Ht, int Wt, int lo, int trips) {
  constexpr int CC = C + 1;
  const int T = Ht * Wt;
  const int span = trips * Wt;  // the window's texels of one plane
  const size_t first = static_cast<size_t>(b) * M + static_cast<size_t>(g) * kGroup;
  for (int i = threadIdx.x; i < kGroup * CC * span; i += blockDim.x) {
    const int plane = i / span;  // m8 * CC + cc
    const int j = lo * Wt + i % span;
    const int cc = plane % CC;
    const size_t bm = first + plane / CC;
    tab[plane * T + j] = cc < C ? templates[(bm * C + cc) * T + j] : alpha[bm * T + j];
  }
  for (int i = threadIdx.x; i < kGroup * kExtra; i += blockDim.x) {
    const size_t bm = first + i / kExtra;
    const int e = i % kExtra;
    extra[i] = e < 6 ? pose[bm * 6 + e] : (e == 6 ? log_safe(presence[bm]) : 0.0f);
  }
}

// The two row taps of iy (two_taps), the weight and the slope of a row
// outside the window [lo, lo + trips) set to 0, and in[j] false for it: the
// plain version's window-masked y-taps. A tap with in[j] false must not
// read the staged table (its row was not staged).
__device__ __forceinline__ void window_taps(float iy, int Ht, int lo, int trips, float w[2],
                                            float dw[2], int k[2], bool in[2]) {
  two_taps(iy, Ht, w, dw, k);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    in[j] = k[j] >= lo && k[j] < lo + trips;
    if (!in[j]) {
      w[j] = 0.0f;
      dw[j] = 0.0f;
    }
  }
}

}  // namespace
