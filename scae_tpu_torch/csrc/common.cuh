// Device helpers shared by the decoder-likelihood kernels of this directory.
//
// Each kernel source includes this header and is built on its own into its
// own shared library (scae_tpu_torch/kernels/_build.py hashes this header
// with the source, so a change here rebuilds every kernel).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLogSqrt2Pi = 0.91893853320467274178f;  // 0.5 * log(2 pi)
constexpr float kPresEps = 1e-16f;                      // log_safe floor

__device__ __forceinline__ float log_safe(float x) {
  return x < kPresEps ? -1e8f : logf(x);
}

// One step of a streaming log-sum-exp: (mx, s) represents mx + log(s).
__device__ __forceinline__ void lse_push(float x, float& mx, float& s) {
  if (x > mx) {
    s = s * expf(mx - x) + 1.0f;
    mx = x;
  } else {
    s += expf(x - mx);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// ((a x + b y + t + 1) n - 1) / 2 with every operation rounded on its own,
// as PyTorch evaluates it (no fused multiply-adds), from the plain version's
// grid x, y (scae_tpu_torch/ops/warp.py::_base_grid, passed in by the
// wrapper). The derivative of a bilinear sample jumps where the coordinate
// crosses a texel centre or edge, so a coordinate one ulp off picks other
// taps for a pixel that lies there and moves the pose gradient by a whole
// texel difference; computed this way, the kernels' taps are the plain
// version's. Every kernel that takes a grid computes its coordinates here.
__device__ __forceinline__ float source_coord(float a, float b, float t, float x, float y,
                                              float n) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), t);
  return __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(s, 1.0f), n), -1.0f), 0.5f);
}

// The two taps of coordinate x that can be nonzero, k0 = floor(x) and
// k0 + 1, on an axis of n texels: weights relu(1 - |x - k|) and slopes
// -sign(x - k) where |x - k| < 1 (the JAX package's _dtap, 0 at a texel
// centre), both 0 for a tap outside the axis, and the texel indices
// clamped into it (a clamped index has weight and slope 0).
__device__ __forceinline__ void two_taps(float x, int n, float w[2], float dw[2], int k[2]) {
  const float f0 = floorf(x);
  const float last = static_cast<float>(n - 1);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float kf = f0 + static_cast<float>(j);
    const bool inside = kf >= 0.0f && kf <= last;
    const float d = x - kf;
    const float a = fabsf(d);
    w[j] = inside ? fmaxf(0.0f, 1.0f - a) : 0.0f;
    dw[j] = (inside && a < 1.0f) ? (d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f)) : 0.0f;
    k[j] = static_cast<int>(fminf(fmaxf(kf, 0.0f), last));
  }
}

// The same taps' weights and indices alone, for a forward.
__device__ __forceinline__ void two_taps(float x, int n, float w[2], int k[2]) {
  float dw[2];
  two_taps(x, n, w, dw, k);
}

}  // namespace

// Every kernel library exports this beside its launcher: the text of a
// cudaError_t code that the launcher returned.
extern "C" const char* scae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
