// Fused template-decoder reconstruction log-likelihood, forward, for Hopper
// (K1).
//
// Replaces the Pallas kernel scae_tpu/ops/pallas_decoder_ll_gather.py
// (_fwd_kernel, launched by _fwd_call's pallas_call, grid (B,)).
//
// Per example b and output pixel p, with M warped template capsules and
// one background component:
//   (ix, iy)  = source coordinates of p under capsule m's affine pose
//               (F.affine_grid / grid_sample convention, align_corners=False)
//   V[m, cc]  = exact bilinear sample of plane cc of capsule m's table
//               (cc < C: template channels, cc = C: alpha logit), the four
//               taps weighted 0 outside the template (zero padding)
//   mix[m]    = V[m, C] + log_safe(presence[m])
//   den       = LSE over {mix[m]} + {bg_mix}
//   num[c]    = LSE over {mix[m] + lp(t[c] | V[m, c])} + {bg_mix + lp(t[c] | bg_value)}
//   ll[c]     = num[c] - den,   lp(t | v) = -(t - v)^2 / (2 s^2) - log s - log sqrt(2 pi)
//
// Bound on the H100 SXM (flagship: B=128, M=40, C=1, 11x11 -> 40x40): the
// inputs and outputs are ~5.9 MB (about 1.8 us at 3.35 TB/s), while the per
// (capsule, pixel) arithmetic is 8.19 M pairs x 62 f32 operations (7.58 us
// at 67 TFLOP/s; chip_smoke.py's k1_bound_ms counts them), so the kernel
// is bound by f32 operations, not bytes.
//
// Design. Each thread reads just the 4 texels a bilinear tap touches per
// plane from the capsule tables in shared memory, instead of the dense
// Ht + Wt tap-weight rows the TPU's matrix-form warp evaluates, and takes
// the LSEs online in one pass over the capsules (running max and rescaled
// sum), so no (M, P) intermediate exists anywhere. The coordinates come
// from common.cuh::source_coord on the wrapper's grid, as in the backward
// kernel, so the forward and the backward pick the same taps.
// The kernel is persistent: the work is B x tiles items (an example's
// pixels in `tiles` equal tiles of at most kThreads), and the grid is as
// many blocks as fit on the card at once, each taking one contiguous run
// of items, so that consecutive items mostly share an example. A block
// keeps a batch-shared alpha table (alpha of batch 1, the main path's)
// for its whole run, and loads each example's templates, poses and
// presences once per run of that example, into one of two shared-memory
// buffers with cp.async while it computes the previous example from the
// other: the earlier design (one block per 256-pixel tile, 896 blocks in 1.36
// waves at the flagship) copied the whole 39,840-byte table 7 times per
// example, alpha included, before any arithmetic of each block. Where two
// buffers do not fit in a block's shared memory, one is used and the load
// is not overlapped.
//
// Built by scae_tpu_torch/kernels/_build.py with plain nvcc into a shared
// library; scae_tpu_torch/kernels/decoder_ll_gather.py binds it with ctypes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Layout of one example's buffer: templates (M, C, T), alpha (M, T) where
// alpha is per example, poses (M, 6), presences (M,), log-presences (M,).
struct Layout {
  int tmpl, alpha, pose, pres, lp, size;
  __host__ __device__ Layout(int M, int C, int T, int alpha_batched) {
    tmpl = 0;
    alpha = pad4(M * C * T);
    pose = alpha + (alpha_batched ? pad4(M * T) : 0);
    pres = pose + pad4(M * 6);
    lp = pres + pad4(M);
    size = lp + pad4(M);
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads)
decoder_ll_gather_fwd_kernel(const float* __restrict__ templates,  // (B, M, C, Ht*Wt)
                             const float* __restrict__ alpha,      // (1 or B, M, Ht*Wt)
                             const float* __restrict__ pose,       // (B, M, 6)
                             const float* __restrict__ presence,   // (B, M)
                             const float* __restrict__ target,     // (B, C, P)
                             const float* __restrict__ scal,       // bg_value, bg_mix, scale
                             const float* __restrict__ grid_x,     // (P,) output x in [-1, 1]
                             const float* __restrict__ grid_y,     // (P,) output y in [-1, 1]
                             float* __restrict__ ll,               // (B, C, P)
                             float* __restrict__ num,              // (B, C, P)
                             float* __restrict__ den,              // (B, 1, P)
                             int B, int M, int Ht, int Wt, int H, int W, int alpha_batched,
                             int tiles, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  const int T = Ht * Wt;
  const int P = H * W;
  const Layout L(M, C, T, alpha_batched);
  float* shared_alpha = smem;  // (M, T) where alpha has batch 1
  float* bufs = smem + (alpha_batched ? 0 : pad4(M * T));

  // this block's run of items [i0, i1), item = b * tiles + tile
  const long long items = static_cast<long long>(B) * tiles;
  const int i0 = static_cast<int>(items * blockIdx.x / gridDim.x);
  const int i1 = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x);
  if (i0 >= i1) return;
  const int tile_px = (P + tiles - 1) / tiles;

  auto load = [&](float* buf, int b) {
    const size_t bm = static_cast<size_t>(b) * M;
    copy_async(buf + L.tmpl, templates + bm * C * T, M * C * T);
    if (alpha_batched) copy_async(buf + L.alpha, alpha + bm * T, M * T);
    copy_async(buf + L.pose, pose + bm * 6, M * 6);
    copy_async(buf + L.pres, presence + bm, M);
    cp_async_commit();
  };

  if (!alpha_batched) copy_async(shared_alpha, alpha, M * T);
  load(bufs, i0 / tiles);  // the shared alpha joins the first group

  const float bg_value = scal[0];
  const float bg_mix = scal[1];
  const float scale = scal[2];
  const float inv_2var = 1.0f / (2.0f * scale * scale);
  const float neg_const = -logf(scale) - kLogSqrt2Pi;
  const float fHt = static_cast<float>(Ht);
  const float fWt = static_cast<float>(Wt);

  int seg = 0;  // runs of one example; run s uses buffer s % nbuf
  for (int item = i0; item < i1; ++seg) {
    const int b = item / tiles;
    const int end = min(i1, (b + 1) * tiles);
    float* buf = bufs + (seg % nbuf) * L.size;
    const bool more = end < i1;
    if (nbuf == 2 && more) {
      load(bufs + ((seg + 1) % 2) * L.size, b + 1);  // the next example, meanwhile
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += blockDim.x) buf[L.lp + m] = log_safe(buf[L.pres + m]);
    __syncthreads();

    const float* tmpl = buf + L.tmpl;
    const float* alp = alpha_batched ? buf + L.alpha : shared_alpha;
    const float* spose = buf + L.pose;
    const float* slp = buf + L.lp;
    for (; item < end; ++item) {
      const int p = (item - b * tiles) * tile_px + threadIdx.x;
      if (threadIdx.x >= tile_px || p >= P) continue;
      const float gx = grid_x[p];
      const float gy = grid_y[p];

      // the background component enters every LSE once, as its first term
      float t[C], nm[C], ns[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        t[c] = target[(static_cast<size_t>(b) * C + c) * P + p];
        const float d = t[c] - bg_value;
        nm[c] = bg_mix + (-(d * d) * inv_2var + neg_const);
        ns[c] = 1.0f;
      }
      float dm = bg_mix;
      float ds = 1.0f;

      // two capsules at a time: their warps and texel reads are
      // independent, so their latencies overlap
#pragma unroll 2
      for (int m = 0; m < M; ++m) {
        const float* pm = spose + m * 6;
        const float ix = source_coord(pm[0], pm[1], pm[2], gx, gy, fWt);
        const float iy = source_coord(pm[3], pm[4], pm[5], gx, gy, fHt);
        const float h0 = floorf(iy);
        const float w0 = floorf(ix);
        const float fy = iy - h0;
        const float fx = ix - w0;
        // tap validity folded into the weights; indices clamped so that
        // every shared-memory read is in bounds (its weight is 0 when
        // clamped)
        const float wy0 = (h0 >= 0.0f && h0 <= fHt - 1.0f) ? 1.0f - fy : 0.0f;
        const float wy1 = (h0 + 1.0f >= 0.0f && h0 + 1.0f <= fHt - 1.0f) ? fy : 0.0f;
        const float wx0 = (w0 >= 0.0f && w0 <= fWt - 1.0f) ? 1.0f - fx : 0.0f;
        const float wx1 = (w0 + 1.0f >= 0.0f && w0 + 1.0f <= fWt - 1.0f) ? fx : 0.0f;
        const int ih0 = static_cast<int>(fminf(fmaxf(h0, 0.0f), fHt - 1.0f));
        const int ih1 = static_cast<int>(fminf(fmaxf(h0 + 1.0f, 0.0f), fHt - 1.0f));
        const int iw0 = static_cast<int>(fminf(fmaxf(w0, 0.0f), fWt - 1.0f));
        const int iw1 = static_cast<int>(fminf(fmaxf(w0 + 1.0f, 0.0f), fWt - 1.0f));
        const int r0 = ih0 * Wt;
        const int r1 = ih1 * Wt;

        float v[C + 1];
#pragma unroll
        for (int cc = 0; cc <= C; ++cc) {
          const float* tc = cc < C ? tmpl + (m * C + cc) * T : alp + m * T;
          v[cc] = wy0 * (wx0 * tc[r0 + iw0] + wx1 * tc[r0 + iw1]) +
                  wy1 * (wx0 * tc[r1 + iw0] + wx1 * tc[r1 + iw1]);
        }
        const float mix = v[C] + slp[m];
        lse_push(mix, dm, ds);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float d = t[c] - v[c];
          lse_push(mix + (-(d * d) * inv_2var + neg_const), nm[c], ns[c]);
        }
      }

      const float den_lse = logf(ds) + dm;
      den[static_cast<size_t>(b) * P + p] = den_lse;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t o = (static_cast<size_t>(b) * C + c) * P + p;
        const float num_lse = logf(ns[c]) + nm[c];
        num[o] = num_lse;
        ll[o] = num_lse - den_lse;
      }
    }
    __syncthreads();  // every read of this buffer is done before it is refilled
    if (nbuf == 1 && more) load(bufs, b + 1);
  }
}

size_t shared_bytes(int M, int C, int Ht, int Wt, int alpha_batched, int nbuf) {
  const int T = Ht * Wt;
  const Layout L(M, C, T, alpha_batched);
  return (static_cast<size_t>(alpha_batched ? 0 : pad4(M * T)) +
          static_cast<size_t>(nbuf) * L.size) *
         sizeof(float);
}

// Blocks of the kernel that fit on one SM with smem bytes, or minus a
// cudaError_t.
template <int C>
int occupancy(size_t smem) {
  auto kernel = decoder_ll_gather_fwd_kernel<C>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  }
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// Blocks of the persistent grid: as many as fit on the card at once, at
// most one per item.
template <int C>
int grid_blocks(size_t smem, int items, cudaError_t& e) {
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return 0;
  const int per_sm = occupancy<C>(smem);
  if (per_sm <= 0) {
    e = per_sm < 0 ? static_cast<cudaError_t>(-per_sm) : cudaErrorInvalidConfiguration;
    return 0;
  }
  return min(items, per_sm * sms);
}

template <int C>
int launch(const float* templates, const float* alpha, const float* pose,
           const float* presence, const float* target, const float* scal,
           const float* grid_x, const float* grid_y, float* ll, float* num, float* den, int B,
           int M, int Ht, int Wt, int H, int W, int alpha_batched, int tiles, int nbuf,
           cudaStream_t stream) {
  const size_t smem = shared_bytes(M, C, Ht, Wt, alpha_batched, nbuf);
  cudaError_t e;
  const int blocks = grid_blocks<C>(smem, B * tiles, e);
  if (e != cudaSuccess) return static_cast<int>(e);
  decoder_ll_gather_fwd_kernel<C><<<blocks, kThreads, smem, stream>>>(
      templates, alpha, pose, presence, target, scal, grid_x, grid_y, ll, num, den, B, M, Ht, Wt,
      H, W, alpha_batched, tiles, nbuf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a contiguous float32 device array; see the
// kernel's parameter comments for the shapes; grid_x and grid_y are the
// output grid as scae_tpu_torch/ops/warp.py::_base_grid gives it,
// flattened. tiles: the pixel tiles of an example, at least
// ceil(H W / 256); nbuf: 1 or 2 example buffers. C must be 1..4.
int scae_decoder_ll_gather_fwd(const void* templates, const void* alpha, const void* pose,
                               const void* presence, const void* target, const void* scal,
                               const void* grid_x, const void* grid_y, void* ll, void* num,
                               void* den, int B, int M, int C, int Ht, int Wt, int H, int W,
                               int alpha_batched, int tiles, int nbuf, void* stream) {
  const auto* t = static_cast<const float*>(templates);
  const auto* a = static_cast<const float*>(alpha);
  const auto* po = static_cast<const float*>(pose);
  const auto* pr = static_cast<const float*>(presence);
  const auto* tg = static_cast<const float*>(target);
  const auto* sc = static_cast<const float*>(scal);
  const auto* gx = static_cast<const float*>(grid_x);
  const auto* gy = static_cast<const float*>(grid_y);
  auto* o_ll = static_cast<float*>(ll);
  auto* o_num = static_cast<float*>(num);
  auto* o_den = static_cast<float*>(den);
  auto s = static_cast<cudaStream_t>(stream);
  if ((nbuf != 1 && nbuf != 2) || tiles < 1 || (H * W + tiles - 1) / tiles > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (C) {
#define SCAE_FWD_CASE(N)                                                                    \
  case N:                                                                                   \
    return launch<N>(t, a, po, pr, tg, sc, gx, gy, o_ll, o_num, o_den, B, M, Ht, Wt, H, W, \
                     alpha_batched, tiles, nbuf, s);
    SCAE_FWD_CASE(1)
    SCAE_FWD_CASE(2)
    SCAE_FWD_CASE(3)
    SCAE_FWD_CASE(4)
#undef SCAE_FWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the forward kernel that fit on one SM at these sizes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a cudaError_t.
int scae_decoder_ll_gather_fwd_occupancy(int M, int C, int Ht, int Wt, int alpha_batched,
                                         int nbuf) {
  const size_t smem = shared_bytes(M, C, Ht, Wt, alpha_batched, nbuf);
  switch (C) {
    case 1: return occupancy<1>(smem);
    case 2: return occupancy<2>(smem);
    case 3: return occupancy<3>(smem);
    case 4: return occupancy<4>(smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
