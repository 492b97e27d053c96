// The two toolchain probes, P1 and P2, for Hopper.
//
// P1 replaces the Pallas kernel tools/pallas_probe.py::kernel (its
// pallas_call at line 17): out = x * 2 + 1, elementwise, on one (8, 128)
// float32 block. Bound on the H100 SXM: bytes, 8,192 of them (4,096 read,
// 4,096 written), about 2.4 ns at 3.35 TB/s: the launch alone takes a
// thousand times longer, so the probe is launch-bound whatever its design.
// One thread per element. x * 2 is exact, so the sum is rounded once, as
// the plain version (x * 2 + 1 in PyTorch) rounds it.
//
// P2 replaces tools/pallas_probe.py::mm_kernel (its pallas_call at line 39):
// out = a @ b for a (256, 128) and b (128, 256) in float32, summed in
// float32, in the kernel's own body (no cuBLAS). Bound: 16.8 MFLOP, about
// 0.25 us at the H100's 67 TFLOP/s float32 rate outside the tensor cores,
// against 512 KB moved (0.16 us at 3.35 TB/s): operations. A plain tiled
// product: one 16 x 16 block per 16 x 16 tile of the output, one thread per
// output element, the K axis walked in 16-wide tiles of a and b staged in
// shared memory, one fused multiply-add per product on the CUDA cores.
// Threads of a row of the block read consecutive columns of b's tile and
// one broadcast element of a's, so no two threads of a warp hit one bank at
// different addresses. The ragged edges of M, N and K are masked. The
// TPU kernel's product ran on the matrix unit; TF32 tensor cores would
// round the inputs to 10 mantissa bits and miss the probe's 1e-4 tolerance
// at depth 128, so this one stays in float32 FMAs.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/probe.py binds it with ctypes.

#include "common.cuh"

namespace {

constexpr int kAffineThreads = 256;
constexpr int kTile = 16;

__global__ void __launch_bounds__(kAffineThreads)
probe_affine_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(__fmul_rn(x[i], 2.0f), 1.0f);
}

__global__ void __launch_bounds__(kTile * kTile)
probe_matmul_kernel(const float* __restrict__ a,  // (M, K)
                    const float* __restrict__ b,  // (K, N)
                    float* __restrict__ out,      // (M, N)
                    int M, int K, int N) {
  __shared__ float sa[kTile][kTile];
  __shared__ float sb[kTile][kTile];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty;
  const int col = blockIdx.x * kTile + tx;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int ka = k0 + tx;
    const int kb = k0 + ty;
    sa[ty][tx] = (row < M && ka < K) ? a[static_cast<size_t>(row) * K + ka] : 0.0f;
    sb[ty][tx] = (kb < K && col < N) ? b[static_cast<size_t>(kb) * N + col] : 0.0f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTile; ++k) acc = fmaf(sa[ty][k], sb[k][tx], acc);
    __syncthreads();
  }
  if (row < M && col < N) out[static_cast<size_t>(row) * N + col] = acc;
}

}  // namespace

extern "C" {

// Launches P1 on `stream` and returns cudaGetLastError() (0 on success).
// x and out are contiguous float32 device arrays of n elements.
int scae_probe_affine(const void* x, void* out, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kAffineThreads - 1) / kAffineThreads;
  probe_affine_kernel<<<blocks, kAffineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Launches P2 on `stream` and returns cudaGetLastError() (0 on success).
// a (M, K), b (K, N) and out (M, N) are contiguous float32 device arrays.
int scae_probe_matmul(const void* a, const void* b, void* out, int M, int K, int N,
                      void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  const dim3 block(kTile, kTile);
  probe_matmul_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), M, K,
      N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
