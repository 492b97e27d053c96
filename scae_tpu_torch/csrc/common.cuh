// Device helpers shared by the decoder-likelihood kernels of this directory.
//
// Each kernel source includes this header and is built on its own into its
// own shared library (scae_tpu_torch/kernels/_build.py hashes this header
// with the source, so a change here rebuilds every kernel).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLogSqrt2Pi = 0.91893853320467274178f;  // 0.5 * log(2 pi)
constexpr float kPresEps = 1e-16f;                      // log_safe floor

__device__ __forceinline__ float log_safe(float x) {
  return x < kPresEps ? -1e8f : logf(x);
}

// One step of a streaming log-sum-exp: (mx, s) represents mx + log(s).
// Without a branch, so that the lanes of a warp never diverge on it: one
// exp of -|x - mx| serves both cases (x above the running max rescales the
// sum, else x's term is added).
__device__ __forceinline__ void lse_push(float x, float& mx, float& s) {
  const float d = x - mx;
  const float e = expf(-fabsf(d));
  s = d > 0.0f ? s * e + 1.0f : s + e;
  mx = fmaxf(mx, x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// up): a thread issues them and goes on; cp_async_wait<N> waits until at
// most N of its committed groups are still in flight, and a barrier then
// makes every thread's copies visible to the block.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts copying n floats from global src to shared dst, 16 bytes a thread
// where both are 16-byte aligned, else 4.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  const bool wide = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  int i = 0;
  if (wide) {
    for (int k = threadIdx.x; 4 * k + 3 < n; k += blockDim.x) cp_async16(dst + 4 * k, src + 4 * k);
    i = n & ~3;
  }
  for (int k = i + threadIdx.x; k < n; k += blockDim.x) cp_async4(dst + k, src + k);
}

// Floats of a region, rounded up to 4 so that every region starts 16-byte
// aligned.
__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// One ring buffer of `chunk` capsules of the likelihood forwards K4f and
// K5f: their tables texel by texel, the C template channels and the alpha
// logit of a texel side by side (chunk, T, C + 1), so that a tap is one
// 8-byte load at C = 1 and one 16-byte load at C = 3; then from a 16-byte
// boundary the poses (chunk, 6) and presences (chunk,).
struct Stage {
  int pose, pres, size;
  __host__ __device__ Stage(int chunk, int C, int T) {
    pose = pad4(chunk * (C + 1) * T);
    pres = pose + 6 * chunk;
    size = pad4(pres + chunk);
  }
};

// q = i / T and r = i % T for 0 <= i < 2^24, from a float reciprocal of T
// and one correction step.
__device__ __forceinline__ int div_t(int i, int T, float inv_t, int& r) {
  int q = __float2int_rz(__int2float_rn(i) * inv_t);
  r = i - q * T;
  if (r < 0) {
    --q;
    r += T;
  } else if (r >= T) {
    ++q;
    r -= T;
  }
  return q;
}

// The C + 1 floats of one texel of a texel-major table.
template <int CC>
__device__ __forceinline__ void load_texel(const float* p, float (&v)[CC]) {
  if constexpr (CC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else if constexpr (CC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int c = 0; c < CC; ++c) v[c] = p[c];
  }
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

// Sums each of v[0..N) over a block of Warps warps in a fixed order (a warp
// tree, then the warps in order); thread 0 gets the results.
template <int N, int Warps>
__device__ __forceinline__ void block_sums(float (&v)[N], float (*red)[Warps]) {
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
      for (int w = 0; w < Warps; ++w) s += red[k][w];
      v[k] = s;
    }
  }
}

// The background component's terms of the three scalar gradients
// (bg_value, bg_mixing_logit, scale) for example b, summed over its P
// pixels by one block in a fixed order and written by thread 0 to out[0..3).
// Used by the backward kernels that leave the sums over the capsules to
// their wrapper.
template <int C, int Warps>
__device__ __forceinline__ void background_scalars(
    const float* __restrict__ target, const float* __restrict__ g,
    const float* __restrict__ num, const float* __restrict__ den, float bg_value,
    float bg_mix, float inv_2var, float neg_const, float scale, int b, int P,
    float (*red)[Warps], float* __restrict__ out) {
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
    out[0] = v[0] * (2.0f * inv_2var);
    out[1] = v[1] - v[2];
    out[2] = v[3] / (scale * scale * scale) - v[1] / scale;
  }
}

// The target's gradient: each capsule's term (tpart, written by a backward
// kernel) summed over the capsules in order, plus the background's.
// Grid: (pixel tiles of blockDim.x, B).
template <int C>
__global__ void decoder_ll_target_kernel(const float* __restrict__ target,  // (B, C, P)
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

}  // namespace

// Every kernel library exports this beside its launcher: the text of a
// cudaError_t code that the launcher returned.
extern "C" const char* scae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
