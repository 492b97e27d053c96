// Banded, row-windowed fused template-decoder reconstruction
// log-likelihood, backward, for Hopper (K5b).
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_decoder_ll_banded.py::_bwd_kernel
// (its pallas_call at line 549, grid (B,)). It computes the gradients of
// the dense backward K4b (decoder_ll_dense_bwd.cu), on the sorted, padded
// capsules and with the row windows of K5f (decoder_ll_banded.cu): a
// template row outside the window of the capsule's group for the pixel's
// band has weight and slope 0 in y, as in the plain version. The kernel is
// K4b's run scatter (decoder_ll_tap_bwd.cuh), windowed: one block per
// (capsule, example), the y-taps masked by the window of (example, pixel
// row / R, capsule / 8), and a tap outside the window skipped by the
// scatter. See there for the function, the design and the bound (the same
// as K4b's and K2+K3's: 14 us by f32 operations at the flagship). Its
// outputs are K4b's, so the wrapper sums nothing over bands.
// Grid: (M + 1, B); kTapThreads threads per block.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_banded.py binds it with ctypes.

#include "decoder_ll_tap_bwd.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(kTapThreads) decoder_ll_banded_bwd_kernel(TapBwdArgs a) {
  tap_bwd_block<C, true>(a);
}

}  // namespace

extern "C" {

// Launches the backward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 (win: int32) device array
// (see TapBwdArgs for the shapes), alpha per example; grid_x and grid_y
// are the output grid as scae_tpu_torch/ops/warp.py::_base_grid gives it,
// flattened. Every output is written in full, so none needs zeroing. tpart
// and gtarget are both null (no target gradient) or both given. C must be
// 1..4, M a multiple of 8, R a divisor of H.
int scae_decoder_ll_banded_bwd(const void* templates, const void* alpha, const void* pose,
                               const void* presence, const void* target, const void* scal,
                               const void* g, const void* num, const void* den,
                               const void* grid_x, const void* grid_y, const void* win,
                               void* gtab, void* gpose, void* gpres, void* cscal, void* tpart,
                               void* gtarget, int B, int M, int C, int Ht, int Wt, int H, int W,
                               int R, void* stream) {
  if (B < 1 || B > 65535 || M < kGroup || M % kGroup != 0 || R < 1 || H % R != 0 ||
      (tpart == nullptr) != (gtarget == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TapBwdArgs a =
      tap_bwd_args(templates, alpha, pose, presence, target, scal, g, num, den, grid_x, grid_y,
                   win, gtab, gpose, gpres, cscal, tpart, M, Ht, Wt, H, W, R, 1);
  auto* o_tgt = static_cast<float*>(gtarget);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_tap_bwd<1>(decoder_ll_banded_bwd_kernel<1>, a, o_tgt, B, s);
    case 2: return launch_tap_bwd<2>(decoder_ll_banded_bwd_kernel<2>, a, o_tgt, B, s);
    case 3: return launch_tap_bwd<3>(decoder_ll_banded_bwd_kernel<3>, a, o_tgt, B, s);
    case 4: return launch_tap_bwd<4>(decoder_ll_banded_bwd_kernel<4>, a, o_tgt, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
