// Dense fused template-decoder reconstruction log-likelihood, backward, for
// Hopper (K4b).
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_decoder_ll.py::_bwd_kernel
// (its pallas_call at line 414, grid (B,)). Its function, written out in
// jnp, is scae_tpu/ops/decoder_ll.py::_bwd with float32 taps, ported as
// scae_tpu_torch/ops/decoder_ll.py (this kernel's plain version). The TPU
// kernel multiplies full tap rows on its MXU; here the kernel is the run
// scatter of decoder_ll_tap_bwd.cuh (one block per (capsule, example), the
// template gradient scattered by runs of equal tap cells, no atomics),
// which K5b shares: see there for the function, the design and its bound
// on the H100 (0.94 GFLOP of f32 operations at the flagship, 14 us).
// Grid: (M + 1, B); kTapThreads threads per block.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_dense.py binds it with ctypes.

#include "decoder_ll_tap_bwd.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(kTapThreads) decoder_ll_dense_bwd_kernel(TapBwdArgs a) {
  tap_bwd_block<C, false>(a);
}

}  // namespace

extern "C" {

// Launches the backward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 device array (see
// TapBwdArgs for the shapes); grid_x and grid_y are the output grid as
// scae_tpu_torch/ops/warp.py::_base_grid gives it, flattened. Every output
// is written in full, so none needs zeroing. tpart and gtarget are both
// null (no target gradient) or both given. C must be 1..4.
int scae_decoder_ll_dense_bwd(const void* templates, const void* alpha, const void* pose,
                              const void* presence, const void* target, const void* scal,
                              const void* g, const void* num, const void* den,
                              const void* grid_x, const void* grid_y, void* gtab, void* gpose,
                              void* gpres, void* cscal, void* tpart, void* gtarget, int B,
                              int M, int C, int Ht, int Wt, int H, int W, int alpha_batched,
                              void* stream) {
  if ((tpart == nullptr) != (gtarget == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const TapBwdArgs a =
      tap_bwd_args(templates, alpha, pose, presence, target, scal, g, num, den, grid_x, grid_y,
                   nullptr, gtab, gpose, gpres, cscal, tpart, M, Ht, Wt, H, W, 1, alpha_batched);
  auto* o_tgt = static_cast<float*>(gtarget);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_tap_bwd<1>(decoder_ll_dense_bwd_kernel<1>, a, o_tgt, B, s);
    case 2: return launch_tap_bwd<2>(decoder_ll_dense_bwd_kernel<2>, a, o_tgt, B, s);
    case 3: return launch_tap_bwd<3>(decoder_ll_dense_bwd_kernel<3>, a, o_tgt, B, s);
    case 4: return launch_tap_bwd<4>(decoder_ll_dense_bwd_kernel<4>, a, o_tgt, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
