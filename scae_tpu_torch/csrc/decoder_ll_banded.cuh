// The banded kernels' group size and row taps masked by the window, which
// K5f (decoder_ll_banded.cu) and K5b (decoder_ll_banded_bwd.cu, through
// decoder_ll_tap_bwd.cuh) share.
#pragma once

#include "common.cuh"

namespace {

constexpr int kGroup = 8;  // capsules per group, as on the TPU

// The two row taps of iy (two_taps), the weight and the slope of a row
// outside the window [lo, lo + trips) set to 0, and in[j] false for it: the
// plain version's window-masked y-taps. In K5f a tap with in[j] false must
// not read the staged table (its row was not staged).
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
