// Presence-masked set attention, forward, for Hopper (K6).
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_attention.py::_attention_kernel
// (its pallas_call at line 99, grid (B,)). Per batch row b (the set
// transformer folds its heads into b):
//   s[n, m] = sum_d q[n, d] k[m, d]
//   a[n, :] = softmax((s[n, :] - (1 - presence[m]) * 1e9) / sqrt(d_k))
//   o[n, j] = sum_m a[n, m] v[m, j]
// with the mask subtracted before the scaling, as the JAX package and its
// reference do. Its plain version is scae_tpu_torch/ops/attention.py's plain
// path. The penalty is rounded on its own before it is subtracted (no fused
// multiply-add): (1 - p) * 1e9 carries an error of up to 32 in f32, and a
// contracted s - (1 - p) * 1e9 would round elsewhere than the plain version
// and move a logit by that much. A set whose presence is all 0 gives every
// logit the same -1e9 offset (exactly -1e9 where |s| < 32), so the max
// subtraction of the softmax keeps it finite and, there, uniform.
//
// Bound on the H100 SXM: bytes. At the flagship's final attention (b = 128,
// N = 32, M = 40, d_k = d_v = 256) it moves 18.9 MB (5.6 us at 3.35 TB/s)
// for 0.17 GFLOP (2.5 us at 67 TFLOP/s); the three set-attention blocks
// (128, 40, 40, 16) are smaller still. The TPU kernel pads N to 8 and M,
// d_k, d_v to 128 for its MXU; here nothing is padded and the products are
// f32 FMAs: one block per batch row stages Q, K and V in shared memory (rows
// of Q and K padded by one float, so that the threads of a warp, which
// take consecutive keys, read distinct banks), one thread per score, one
// warp per softmax row, one thread per output. No atomics: the results
// repeat bit for bit.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/attention.py binds it with ctypes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max_all(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum_all(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q,         // (B, N, dk)
                     const float* __restrict__ k,         // (B, M, dk)
                     const float* __restrict__ v,         // (B, M, dv)
                     const float* __restrict__ presence,  // (B, M)
                     float* __restrict__ out,             // (B, N, dv)
                     int N, int M, int dk, int dv) {
  extern __shared__ float smem[];
  const int ld = dk + 1;
  float* sq = smem;          // (N, dk + 1)
  float* sk = sq + N * ld;   // (M, dk + 1)
  float* sv = sk + M * ld;   // (M, dv)
  float* sp = sv + M * dv;   // (M,)
  float* sw = sp + M;        // (N, M) logits, then attention weights
  const size_t b = blockIdx.x;

  const float* qb = q + b * N * dk;
  const float* kb = k + b * M * dk;
  const float* vb = v + b * M * dv;
  for (int i = threadIdx.x; i < N * dk; i += blockDim.x) sq[(i / dk) * ld + i % dk] = qb[i];
  for (int i = threadIdx.x; i < M * dk; i += blockDim.x) sk[(i / dk) * ld + i % dk] = kb[i];
  for (int i = threadIdx.x; i < M * dv; i += blockDim.x) sv[i] = vb[i];
  for (int i = threadIdx.x; i < M; i += blockDim.x) sp[i] = presence[b * M + i];
  __syncthreads();

  const float root = sqrtf(static_cast<float>(dk));
  for (int i = threadIdx.x; i < N * M; i += blockDim.x) {
    const float* qn = sq + (i / M) * ld;
    const int m = i % M;
    const float* km = sk + m * ld;
    float s = 0.0f;
    for (int d = 0; d < dk; ++d) s = fmaf(qn[d], km[d], s);
    const float penalty = __fmul_rn(1.0f - sp[m], 1e9f);
    sw[i] = __fdiv_rn(__fsub_rn(s, penalty), root);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int n = threadIdx.x >> 5; n < N; n += kWarps) {
    float* row = sw + n * M;
    float mx = -__int_as_float(0x7f800000);  // -inf
    for (int m = lane; m < M; m += 32) mx = fmaxf(mx, row[m]);
    mx = warp_max_all(mx);
    float sum = 0.0f;
    for (int m = lane; m < M; m += 32) {
      const float e = expf(row[m] - mx);
      row[m] = e;
      sum += e;
    }
    sum = warp_sum_all(sum);
    for (int m = lane; m < M; m += 32) row[m] = row[m] / sum;
  }
  __syncthreads();

  float* ob = out + b * N * dv;
  for (int i = threadIdx.x; i < N * dv; i += blockDim.x) {
    const float* wn = sw + (i / dv) * M;
    const int j = i % dv;
    float o = 0.0f;
    for (int m = 0; m < M; ++m) o = fmaf(wn[m], sv[m * dv + j], o);
    ob[i] = o;
  }
}

}  // namespace

extern "C" {

// Launches K6 on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is a contiguous float32 device array of the shape in the
// kernel's parameter comments.
int scae_attention_fwd(const void* q, const void* k, const void* v, const void* presence,
                       void* out, int B, int N, int M, int dk, int dv, void* stream) {
  if (B < 1 || N < 1 || M < 1 || dk < 1 || dv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      (static_cast<size_t>(N + M) * (dk + 1) + static_cast<size_t>(M) * dv + M +
       static_cast<size_t>(N) * M) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attention_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(presence), static_cast<float*>(out), N, M, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
