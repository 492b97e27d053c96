// V1f and V1b: the object capsules' vote head (models/object_decoder.py,
// CapsuleLayer) forward and backward, each one kernel plus a small
// deterministic reduction, in place of about 96 PyTorch operations forward
// and 150 backward in every train step.
//
// They replace no TPU kernel: on the TPU, XLA fused the head into a kernel
// or two. Eager PyTorch runs it op by op, most ops on (B, O, V, 1) slices
// cut from the last axis with a stride of 6 (PyTorch's non-vectorised
// elementwise kernel), each moving well under a megabyte, so the head cost
// the step its launches and the gaps between them.
//
// What it computes, per example b and capsule o, from the row all_param[b,
// o] of A = 8V + 7 floats (the chunks OPR-dynamic (V, 6), OVR (6), capsule
// presence logit (1), vote presence logits (V), vote scales (V)):
//   cpr[v]  = T(dynamic[v] + cpr_static[o, v])   (dynamic 0 without
//             deformations)
//   cvr     = T(ovr + caps_bias_0[o])
//   vote[v] = cvr o cpr[v], as a 3x3 matrix with the row [0 0 1]
//   logit_caps = lc + caps_bias_1[o] (+ log_safe(caps_exist)) (+ noise)
//   logit_vote[v] = lv[v] + caps_bias_2[o, v] (+ noise)
//   vote_presence[v] = sigmoid(logit_caps) sigmoid(logit_vote[v])
//   scale[v] = softplus(sc[v] + caps_bias_3[o, v] + 0.5) + 0.01, or 1
//   reg = sum(dynamic^2) / 2 / B
// with T ops/geometry.py::geometric_transform (nonlinear, similarity or
// not) and the noise (u - 0.5) s or log(u / (1 - u)) s from the caller's
// uniform draws u. Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn: no fused multiply-adds), in PyTorch's order, and
// the transcendentals are the ones PyTorch's CUDA kernels call (expf,
// tanhf, cosf, sinf, logf, log1pf), so V1f gives the plain version's values
// to a few ulps.
//
// Bound on the H100: bytes. At the mnist40 shape (B 128, O 32, V 40) V1f
// reads all_param (5.4 MB) and writes the votes (5.9 MB) and four (B, O, V)
// outputs, about 14 MB, 4 us at 3.35 TB/s; V1b reads all_param and the
// output gradients and writes all_param's, about 20 MB. The arithmetic
// (about ten transcendentals a vote, 164 K votes) is a few microseconds of
// the card's lanes. So the design is about loads and stores:
//   * a block owns R consecutive rows of all_param in memory (R V votes,
//     one a thread), and copies their R A floats as one span with
//     coalesced loads into shared memory: a row is 1,308 or 2,076 bytes,
//     not 16-byte aligned, so the loads cover the span, not each row;
//   * all_param may be contiguous (B, O, A) or in the capsule banks' (O, B)
//     row order (StackedMLP's output, a transposed view): either way a
//     block's rows are one span. V1b writes all_param's gradient contiguous
//     (B, O, A), row by row, as autograd of the plain version gave it, so
//     that the banks' backward gets the same layout whether all_param came
//     from the banks or from the mesh's gather of them, and computes the
//     same bits;
//   * the capsule's OVR transform and presence are computed once a row,
//     then each thread takes one vote;
//   * the votes (V, 3, 3) of a row are staged in shared memory and stored
//     as one coalesced span; the (B, O, V) outputs are stored by
//     consecutive threads at consecutive addresses;
//   * V1b recomputes the forward from all_param rather than saving
//     intermediates, stages the output gradient of the votes like V1f's
//     votes, writes each row's gradient into the row's own shared span
//     (each thread overwrites only the entries it read) and stores each
//     row's span with coalesced stores;
//   * no atomics: the sums over a row's votes (the OVR's gradient and the
//     capsule presence's) and the regulariser's partial sums run in a fixed
//     order, and the gradients of cpr_static and caps_bias_* (sums over B)
//     come from a second pass, a block per 32 columns of all_param's
//     gradient walking B in 8 fixed slices. Results repeat bit for bit.

#include <cstring>

#include "common.cuh"

namespace {

constexpr float kTwoPi = 6.283185307179586f;      // 2 * math.pi in float32
constexpr float kClampLo = 1e-7f;                 // the logistic noise's clamp
constexpr float kClampHi = 0.99999988f;           // float32(1 - 1e-7)
constexpr int kColumnSlices = 8;                  // B slices of the column pass

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// PyTorch's CUDA sigmoid for float: 1 / (1 + exp(-x)).
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, add(1.0f, expf(-x)));
}

// PyTorch's sigmoid_backward: g (1 - y) y.
__device__ __forceinline__ float sigmoid_grad(float g, float y) {
  return mul(mul(g, sub(1.0f, y)), y);
}

// PyTorch's tanh_backward: g (1 - y^2).
__device__ __forceinline__ float tanh_grad(float g, float y) {
  return mul(g, sub(1.0f, mul(y, y)));
}

// The layer's settings, packed by the wrapper into one int.
struct Flags {
  bool similarity, deform, learn_scale, exist, o_major;
  int noise;  // 0 none, 1 uniform, 2 logistic
  __device__ Flags(int f)
      : similarity(f & 1), deform(f & 2), learn_scale(f & 4), exist(f & 8),
        o_major(f & 16), noise((f >> 5) & 3) {}
};

// t + the noise of draw u (scale s), as the layer's add_noise computes it.
__device__ __forceinline__ float add_noise(float t, const float* u, size_t i, int kind,
                                           float s) {
  if (kind == 0) return t;
  const float x = u[i];
  if (kind == 1) return add(t, mul(sub(x, 0.5f), s));
  const float c = fminf(fmaxf(x, kClampLo), kClampHi);
  return add(t, mul(logf(__fdiv_rn(c, sub(1.0f, c))), s));
}

// geometric_transform(p, similarity, nonlinear=True) on one pose, with the
// intermediates its backward needs.
struct Transform {
  float sx, sy, sig_x, sig_y, sh, tx, ty, c, s;
  float f[6];  // a b tx c d ty
  __device__ Transform(const float (&p)[6], bool similarity) {
    sig_x = sigmoid(p[0]);
    sig_y = sigmoid(p[1]);
    sx = add(sig_x, 0.01f);
    sy = add(sig_y, 0.01f);
    tx = tanhf(mul(p[4], 5.0f));
    ty = tanhf(mul(p[5], 5.0f));
    sh = tanhf(mul(p[3], 5.0f));
    const float theta = mul(p[2], kTwoPi);
    c = cosf(theta);
    s = sinf(theta);
    if (similarity) {
      f[0] = mul(sx, c);
      f[1] = mul(-sx, s);
      f[3] = mul(sx, s);
      f[4] = mul(sx, c);
    } else {
      const float shy = mul(sh, sy);
      f[0] = add(mul(sx, c), mul(shy, s));
      f[1] = add(mul(-sx, s), mul(shy, c));
      f[3] = mul(sy, s);
      f[4] = mul(sy, c);
    }
    f[2] = tx;
    f[5] = ty;
  }

  // The gradient of the pose p from the gradient g of f.
  __device__ void backward(const float (&g)[6], bool similarity, float (&gp)[6]) const {
    float g_sx, g_c, g_s;
    if (similarity) {
      g_sx = add(add(add(mul(g[0], c), mul(g[1], -s)), mul(g[3], s)), mul(g[4], c));
      g_c = add(mul(g[0], sx), mul(g[4], sx));
      g_s = add(mul(g[1], -sx), mul(g[3], sx));
      gp[1] = 0.0f;
      gp[3] = 0.0f;
    } else {
      const float shy = mul(sh, sy);
      g_sx = add(mul(g[0], c), mul(g[1], -s));
      const float g_shy = add(mul(g[0], s), mul(g[1], c));
      g_c = add(add(mul(g[0], sx), mul(g[1], shy)), mul(g[4], sy));
      g_s = add(add(mul(g[0], shy), mul(g[1], -sx)), mul(g[3], sy));
      const float g_sy = add(add(mul(g_shy, sh), mul(g[3], s)), mul(g[4], c));
      gp[1] = sigmoid_grad(g_sy, sig_y);
      gp[3] = mul(tanh_grad(mul(g_shy, sy), sh), 5.0f);
    }
    gp[0] = sigmoid_grad(g_sx, sig_x);
    gp[2] = mul(add(mul(g_c, -s), mul(g_s, c)), kTwoPi);
    gp[4] = mul(tanh_grad(g[2], tx), 5.0f);
    gp[5] = mul(tanh_grad(g[5], ty), 5.0f);
  }
};

// outer o inner on flat affines (ops/geometry.py::compose_affines).
__device__ __forceinline__ void compose(const float* o, const float (&i)[6], float (&v)[6]) {
  v[0] = add(mul(o[0], i[0]), mul(o[1], i[3]));
  v[1] = add(mul(o[0], i[1]), mul(o[1], i[4]));
  v[2] = add(add(mul(o[0], i[2]), mul(o[1], i[5])), o[2]);
  v[3] = add(mul(o[3], i[0]), mul(o[4], i[3]));
  v[4] = add(mul(o[3], i[1]), mul(o[4], i[4]));
  v[5] = add(add(mul(o[3], i[2]), mul(o[4], i[5])), o[5]);
}

// The (b, o) of memory row n: all_param's rows in (B, O) or (O, B) order.
__device__ __forceinline__ int out_row(int n, int B, int O, bool o_major) {
  return o_major ? (n % B) * O + n / B : n;
}

__device__ __forceinline__ int capsule_of(int n, int B, int O, bool o_major) {
  return o_major ? n / B : n % O;
}

// Shared memory of a V1f / V1b block of R rows, in floats.
struct Smem {
  int row, votes, part, red, cvr, pres, size;
  __host__ __device__ Smem(int R, int V, int A) {
    row = 0;                       // R A: the rows, then (V1b) their gradients
    votes = pad4(R * A);           // R V 9: the votes (V1f), their gradient (V1b)
    part = votes + pad4(R * V * 9);  // R 7 V: V1b's per-vote terms of the row sums
    red = part + pad4(R * 7 * V);  // R 7: V1b's row sums; V1f's warp partials
    cvr = red + pad4(R * 7 + 32);  // R 6: each row's OVR
    pres = cvr + pad4(R * 6);      // R: each row's capsule presence
    size = pres + pad4(R);
  }
};

// Copies rows [n0, n0 + rows) of x (rows of `width` floats, memory order)
// into shared memory.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ x, int n0,
                                          int rows, int width) {
  const float* src = x + static_cast<size_t>(n0) * width;
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) dst[i] = __ldg(src + i);
}

// The per-row part of the forward: the capsule's OVR transform and its
// presence logit; writes logit_caps when `out` is given.
__device__ __forceinline__ void row_forward(const float* row, int V, const float* b0, float b1,
                                            const float* exist, const float* u_caps, int bo,
                                            const Flags& fl, float noise_scale, float (&p)[6],
                                            float& logit) {
#pragma unroll
  for (int k = 0; k < 6; ++k) p[k] = add(row[6 * V + k], b0[k]);
  logit = add(row[6 * V + 6], b1);
  if (fl.exist) logit = add(logit, log_safe(exist[bo]));
  logit = add_noise(logit, u_caps, bo, fl.noise, noise_scale);
}

// V1f. Grid: ceil(N / R) blocks of R rows.
__global__ void capsule_votes_fwd_kernel(
    const float* __restrict__ all_param, const float* __restrict__ cpr_static,
    const float* __restrict__ bias0, const float* __restrict__ bias1,
    const float* __restrict__ bias2, const float* __restrict__ bias3,
    const float* __restrict__ exist, const float* __restrict__ u_caps,
    const float* __restrict__ u_vote, float* __restrict__ vote, float* __restrict__ scale,
    float* __restrict__ vote_presence, float* __restrict__ logit_caps,
    float* __restrict__ logit_vote, float* __restrict__ reg_partial, int B, int O, int V, int R,
    int flags, float noise_scale) {
  extern __shared__ float smem[];
  const Flags fl(flags);
  const int A = 8 * V + 7;
  const int N = B * O;
  const Smem L(R, V, A);
  const int n0 = blockIdx.x * R;
  const int rows = min(R, N - n0);
  float* rowbuf = smem + L.row;
  float* votes = smem + L.votes;
  load_rows(rowbuf, all_param, n0, rows, A);
  __syncthreads();

  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    const int n = n0 + r;
    const int o = capsule_of(n, B, O, fl.o_major);
    const int bo = out_row(n, B, O, fl.o_major);
    float p[6], logit;
    row_forward(rowbuf + r * A, V, bias0 + 6 * o, bias1[o], exist, u_caps, bo, fl, noise_scale, p,
                logit);
    const Transform t(p, fl.similarity);
#pragma unroll
    for (int k = 0; k < 6; ++k) smem[L.cvr + 6 * r + k] = t.f[k];
    smem[L.pres + r] = sigmoid(logit);
    logit_caps[bo] = logit;
  }
  __syncthreads();

  float reg = 0.0f;
  for (int i = threadIdx.x; i < rows * V; i += blockDim.x) {
    const int r = i / V;
    const int v = i - r * V;
    const int n = n0 + r;
    const int o = capsule_of(n, B, O, fl.o_major);
    const int bo = out_row(n, B, O, fl.o_major);
    const float* row = rowbuf + r * A;
    const float* st = cpr_static + (static_cast<size_t>(o) * V + v) * 6;
    float p[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float d = fl.deform ? row[6 * v + k] : 0.0f;
      reg = add(reg, mul(d, d));
      p[k] = add(d, __ldg(st + k));
    }
    const Transform t(p, fl.similarity);
    float w[6];
    compose(smem + L.cvr + 6 * r, t.f, w);
    float* dst = votes + (r * V + v) * 9;
#pragma unroll
    for (int k = 0; k < 6; ++k) dst[k] = w[k];
    dst[6] = 0.0f;
    dst[7] = 0.0f;
    dst[8] = 1.0f;

    const size_t ov = static_cast<size_t>(o) * V + v;
    const size_t j = static_cast<size_t>(bo) * V + v;
    const float lv = add_noise(add(row[6 * V + 7 + v], __ldg(bias2 + ov)), u_vote, j, fl.noise,
                               noise_scale);
    logit_vote[j] = lv;
    vote_presence[j] = mul(smem[L.pres + r], sigmoid(lv));
    float sc = 1.0f;
    if (fl.learn_scale) {
      const float x = add(add(row[7 * V + 7 + v], __ldg(bias3 + ov)), 0.5f);
      sc = add(x > 20.0f ? x : log1pf(expf(x)), 0.01f);
    }
    scale[j] = sc;
  }

  // the block's part of sum(dynamic^2): warps in order, then their sums
  reg = warp_sum(reg);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[L.red + warp] = reg;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < (blockDim.x + 31) / 32; ++w) s = add(s, smem[L.red + w]);
    reg_partial[blockIdx.x] = s;
  }

  // the votes, a row's (V, 3, 3) block as one span
  const int span = 9 * V;
  for (int i = threadIdx.x; i < rows * span; i += blockDim.x) {
    const int r = i / span;
    const int k = i - r * span;
    vote[static_cast<size_t>(out_row(n0 + r, B, O, fl.o_major)) * span + k] = votes[i];
  }
}

// sum(dynamic^2) / 2 / B from V1f's per-block partial sums, in a fixed
// order. One block of 256 threads.
__global__ void capsule_votes_reg_kernel(const float* __restrict__ partial, int n, int B,
                                         float* __restrict__ reg) {
  __shared__ float red[1][8];
  float v[1] = {0.0f};
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[0] = add(v[0], partial[i]);
  block_sums<1, 8>(v, red);
  if (threadIdx.x == 0) *reg = __fdiv_rn(__fdiv_rn(v[0], 2.0f), static_cast<float>(B));
}

// V1b, the rows' pass. Writes into grad ((B, O, A), contiguous) each row's
// gradient of the head before the regulariser's term: for the dynamic
// chunk the gradient of dynamic + cpr_static, which is cpr_static's
// example term too. Grid: ceil(N / R) blocks of R rows.
__global__ void capsule_votes_bwd_kernel(
    const float* __restrict__ all_param, const float* __restrict__ cpr_static,
    const float* __restrict__ bias0, const float* __restrict__ bias1,
    const float* __restrict__ bias2, const float* __restrict__ bias3,
    const float* __restrict__ exist, const float* __restrict__ u_caps,
    const float* __restrict__ u_vote, const float* __restrict__ g_vote,
    const float* __restrict__ g_scale, const float* __restrict__ g_pres,
    const float* __restrict__ g_logit_caps, const float* __restrict__ g_logit_vote,
    float* __restrict__ grad, int B, int O, int V, int R, int flags, float noise_scale) {
  extern __shared__ float smem[];
  const Flags fl(flags);
  const int A = 8 * V + 7;
  const int N = B * O;
  const Smem L(R, V, A);
  const int n0 = blockIdx.x * R;
  const int rows = min(R, N - n0);
  const int span = 9 * V;
  float* rowbuf = smem + L.row;
  float* gv = smem + L.votes;
  load_rows(rowbuf, all_param, n0, rows, A);
  if (g_vote != nullptr) {
    for (int i = threadIdx.x; i < rows * span; i += blockDim.x) {
      const int r = i / span;
      const int k = i - r * span;
      gv[i] = __ldg(g_vote + static_cast<size_t>(out_row(n0 + r, B, O, fl.o_major)) * span + k);
    }
  }
  __syncthreads();

  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    const int n = n0 + r;
    const int o = capsule_of(n, B, O, fl.o_major);
    const int bo = out_row(n, B, O, fl.o_major);
    float p[6], logit;
    row_forward(rowbuf + r * A, V, bias0 + 6 * o, bias1[o], exist, u_caps, bo, fl, noise_scale, p,
                logit);
    const Transform t(p, fl.similarity);
#pragma unroll
    for (int k = 0; k < 6; ++k) smem[L.cvr + 6 * r + k] = t.f[k];
    smem[L.pres + r] = sigmoid(logit);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * V; i += blockDim.x) {
    const int r = i / V;
    const int v = i - r * V;
    const int n = n0 + r;
    const int o = capsule_of(n, B, O, fl.o_major);
    const int bo = out_row(n, B, O, fl.o_major);
    float* row = rowbuf + r * A;
    const float* cvr = smem + L.cvr + 6 * r;
    const float pc = smem[L.pres + r];
    const float* st = cpr_static + (static_cast<size_t>(o) * V + v) * 6;
    float p[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) p[k] = add(fl.deform ? row[6 * v + k] : 0.0f, __ldg(st + k));
    const Transform t(p, fl.similarity);

    // the vote's gradient: outer (the row's OVR) and inner (this vote's)
    float g[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) g[k] = g_vote != nullptr ? gv[(r * V + v) * 9 + k] : 0.0f;
    float* part = smem + L.part + r * 7 * V + v;
    part[0 * V] = add(add(mul(g[0], t.f[0]), mul(g[1], t.f[1])), mul(g[2], t.f[2]));
    part[1 * V] = add(add(mul(g[0], t.f[3]), mul(g[1], t.f[4])), mul(g[2], t.f[5]));
    part[2 * V] = g[2];
    part[3 * V] = add(add(mul(g[3], t.f[0]), mul(g[4], t.f[1])), mul(g[5], t.f[2]));
    part[4 * V] = add(add(mul(g[3], t.f[3]), mul(g[4], t.f[4])), mul(g[5], t.f[5]));
    part[5 * V] = g[5];
    float gi[6];
    gi[0] = add(mul(g[0], cvr[0]), mul(g[3], cvr[3]));
    gi[1] = add(mul(g[1], cvr[0]), mul(g[4], cvr[3]));
    gi[2] = add(mul(g[2], cvr[0]), mul(g[5], cvr[3]));
    gi[3] = add(mul(g[0], cvr[1]), mul(g[3], cvr[4]));
    gi[4] = add(mul(g[1], cvr[1]), mul(g[4], cvr[4]));
    gi[5] = add(mul(g[2], cvr[1]), mul(g[5], cvr[4]));
    float gp[6];
    t.backward(gi, fl.similarity, gp);

    // presences: vote_presence = pc sigmoid(logit_vote)
    const size_t ov = static_cast<size_t>(o) * V + v;
    const size_t j = static_cast<size_t>(bo) * V + v;
    const float lv = add_noise(add(row[6 * V + 7 + v], __ldg(bias2 + ov)), u_vote, j, fl.noise,
                               noise_scale);
    const float sv = sigmoid(lv);
    const float gvp = g_pres != nullptr ? g_pres[j] : 0.0f;
    part[6 * V] = mul(gvp, sv);
    float glv = sigmoid_grad(mul(gvp, pc), sv);
    if (g_logit_vote != nullptr) glv = add(g_logit_vote[j], glv);

    float gsc = 0.0f;
    if (fl.learn_scale && g_scale != nullptr) {
      const float x = add(add(row[7 * V + 7 + v], __ldg(bias3 + ov)), 0.5f);
      const float gs = g_scale[j];
      if (x > 20.0f) {
        gsc = gs;
      } else {
        const float z = expf(x);
        gsc = __fdiv_rn(mul(gs, z), add(z, 1.0f));
      }
    }

    // this thread read only these entries of the row: overwrite them
#pragma unroll
    for (int k = 0; k < 6; ++k) row[6 * v + k] = gp[k];
    row[6 * V + 7 + v] = glv;
    row[7 * V + 7 + v] = gsc;
  }
  __syncthreads();

  // the row sums over the votes, each in vote order
  for (int i = threadIdx.x; i < rows * 7; i += blockDim.x) {
    const float* part = smem + L.part + i * V;
    float s = 0.0f;
    for (int v = 0; v < V; ++v) s = add(s, part[v]);
    smem[L.red + i] = s;
  }
  __syncthreads();

  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    const int n = n0 + r;
    const int o = capsule_of(n, B, O, fl.o_major);
    const int bo = out_row(n, B, O, fl.o_major);
    float* row = rowbuf + r * A;
    const float* red = smem + L.red + 7 * r;
    float p[6], logit;
    // the row's OVR and logit entries, which no vote thread wrote
    row_forward(row, V, bias0 + 6 * o, bias1[o], exist, u_caps, bo, fl, noise_scale, p, logit);
    const Transform t(p, fl.similarity);
    const float g[6] = {red[0], red[1], red[2], red[3], red[4], red[5]};
    float gp[6];
    t.backward(g, fl.similarity, gp);
#pragma unroll
    for (int k = 0; k < 6; ++k) row[6 * V + k] = gp[k];
    float glc = sigmoid_grad(red[6], smem[L.pres + r]);
    if (g_logit_caps != nullptr) glc = add(g_logit_caps[bo], glc);
    row[6 * V + 6] = glc;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * A; i += blockDim.x) {
    const int r = i / A;
    const int k = i - r * A;
    grad[static_cast<size_t>(out_row(n0 + r, B, O, fl.o_major)) * A + k] = rowbuf[i];
  }
}

// V1b, the columns' pass: for each column (o, j) of the gradient, its sum
// over B (the gradient of cpr_static or caps_bias_*, written to their own
// tensors), and in the dynamic chunk the regulariser's term g_reg / B x
// (or 0 without deformations) added in place. A block takes 32 columns;
// its 8 warps walk B in slices b = s, s + 8, ..., then warp 0 adds the
// slices in order. Grid: ceil(O A / 32) blocks of 256 threads.
__global__ void capsule_votes_columns_kernel(
    const float* __restrict__ all_param, const float* __restrict__ g_reg,
    float* __restrict__ grad, float* __restrict__ g_static, float* __restrict__ g_bias0,
    float* __restrict__ g_bias1, float* __restrict__ g_bias2, float* __restrict__ g_bias3, int B,
    int O, int V, int flags) {
  __shared__ float red[kColumnSlices][32];
  const Flags fl(flags);
  const int A = 8 * V + 7;
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const bool live = c < O * A;
  const int o = live ? c / A : 0;
  const int j = c - o * A;
  const bool dynamic = live && j < 6 * V;
  // the regulariser sum(x^2) / 2 / B: gradient (g / B / 2) x, twice
  const float h = g_reg != nullptr ? __fdiv_rn(__fdiv_rn(*g_reg, static_cast<float>(B)), 2.0f)
                                   : 0.0f;
  float s = 0.0f;
  if (live) {
    for (int b = slice; b < B; b += kColumnSlices) {
      const size_t at = (static_cast<size_t>(b) * O + o) * A + j;
      const float g = grad[at];
      s = add(s, g);
      if (dynamic) {
        if (!fl.deform) {
          grad[at] = 0.0f;
        } else if (g_reg != nullptr) {
          const int n = fl.o_major ? o * B + b : b * O + o;
          const float hx = mul(h, all_param[static_cast<size_t>(n) * A + j]);
          grad[at] = add(g, add(hx, hx));
        }
      }
    }
  }
  red[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && live) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < kColumnSlices; ++k) t = add(t, red[k][lane]);
    if (j < 6 * V) {
      g_static[static_cast<size_t>(o) * 6 * V + j] = t;
    } else if (j < 6 * V + 6) {
      g_bias0[6 * o + j - 6 * V] = t;
    } else if (j == 6 * V + 6) {
      g_bias1[o] = t;
    } else if (j < 7 * V + 7) {
      g_bias2[static_cast<size_t>(o) * V + j - 6 * V - 7] = t;
    } else {
      g_bias3[static_cast<size_t>(o) * V + j - 7 * V - 7] = t;
    }
  }
}

// Threads of a V1f / V1b block: one a vote of its R rows, in whole warps,
// at most 256 (then a thread takes several votes).
int threads_for(int R, int V) {
  const int t = ((R * V + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

}  // namespace

// Pointers: all_param, cpr_static, caps_bias_0..3, caps_exist, u_caps,
// u_vote (the last three may be null), vote, scale, vote_presence,
// logit_caps, logit_vote, reg (0-d), reg_partial (ceil(N / R) floats).
extern "C" int scae_capsule_votes_fwd(const float* all_param, const float* cpr_static,
                                      const float* bias0, const float* bias1, const float* bias2,
                                      const float* bias3, const float* exist, const float* u_caps,
                                      const float* u_vote, float* vote, float* scale,
                                      float* vote_presence, float* logit_caps, float* logit_vote,
                                      float* reg, float* reg_partial, int B, int O, int V, int R,
                                      int flags, int noise_scale_bits, cudaStream_t stream) {
  float noise_scale;
  std::memcpy(&noise_scale, &noise_scale_bits, sizeof(float));
  const int blocks = (B * O + R - 1) / R;
  const size_t smem = sizeof(float) * Smem(R, V, 8 * V + 7).size;
  capsule_votes_fwd_kernel<<<blocks, threads_for(R, V), smem, stream>>>(
      all_param, cpr_static, bias0, bias1, bias2, bias3, exist, u_caps, u_vote, vote, scale,
      vote_presence, logit_caps, logit_vote, reg_partial, B, O, V, R, flags, noise_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  capsule_votes_reg_kernel<<<1, 256, 0, stream>>>(reg_partial, blocks, B, reg);
  return cudaGetLastError();
}

// Pointers: all_param, cpr_static, caps_bias_0..3, caps_exist, u_caps,
// u_vote, then the output gradients g_vote, g_scale, g_vote_presence,
// g_logit_caps, g_logit_vote, g_reg (each may be null: no gradient), then
// the results: all_param's gradient ((B, O, A), contiguous) and
// cpr_static's and caps_bias_0..3's.
extern "C" int scae_capsule_votes_bwd(
    const float* all_param, const float* cpr_static, const float* bias0, const float* bias1,
    const float* bias2, const float* bias3, const float* exist, const float* u_caps,
    const float* u_vote, const float* g_vote, const float* g_scale, const float* g_pres,
    const float* g_logit_caps, const float* g_logit_vote, const float* g_reg, float* grad,
    float* g_static, float* g_bias0, float* g_bias1, float* g_bias2, float* g_bias3, int B, int O,
    int V, int R, int flags, int noise_scale_bits, cudaStream_t stream) {
  float noise_scale;
  std::memcpy(&noise_scale, &noise_scale_bits, sizeof(float));
  const int blocks = (B * O + R - 1) / R;
  const size_t smem = sizeof(float) * Smem(R, V, 8 * V + 7).size;
  capsule_votes_bwd_kernel<<<blocks, threads_for(R, V), smem, stream>>>(
      all_param, cpr_static, bias0, bias1, bias2, bias3, exist, u_caps, u_vote, g_vote, g_scale,
      g_pres, g_logit_caps, g_logit_vote, grad, B, O, V, R, flags, noise_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int columns = O * (8 * V + 7);
  capsule_votes_columns_kernel<<<(columns + 31) / 32, 32 * kColumnSlices, 0, stream>>>(
      all_param, g_reg, grad, g_static, g_bias0, g_bias1, g_bias2, g_bias3, B, O, V, flags);
  return cudaGetLastError();
}
