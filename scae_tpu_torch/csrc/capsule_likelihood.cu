// L1f and L1b: the capsule mixture likelihood of the object decoder
// (models/object_decoder.py::capsule_likelihood) forward and backward, each
// one kernel (plus a small deterministic reduction), in place of about 40
// PyTorch operations forward and 32 backward in every train step.
//
// They replace no TPU kernel: XLA fused the likelihood on the TPU. Eager
// PyTorch runs it op by op (the Gaussian's six elementwise passes and its
// sum, two concatenations, two logsumexps of several kernels each, the
// softmax, the argmax and its gathers, the soft winner's products and sums),
// each moving a megabyte or less, so the likelihood cost the step its
// launches and the gaps between them.
//
// What it computes, for each example b and part m (a point), from the votes
// v[o] (B, O, M, 6), their scales s[o] and presences p[o] (B, O, M), the
// dummy vote (M, 6), the part pose x (B, M, 6) and its presence (B, M):
//   vlp[o] = sum_k (-(x_k - v[o]_k)^2 / (2 s s) - log s - log sqrt(2 pi)),
//            vlp[O] = log 0.01 (the dummy component)
//   ml[o]  = log_safe(p[o]), ml[O] = log 0.01     (mixing_logit)
//   mixing_log_prob = ml - logsumexp(ml)
//   vote_presence_binary[o] = ml[o] > ml[O]
//   pl = ml + vlp                                  (the posterior logits)
//   log_prob = mean_b sum_m logsumexp(pl) presence
//   posterior = softmax(pl); soft_winner = sum_o posterior[o] v[o] (the
//   dummy vote for o = O); soft_winner_presence = sum_{o < O} posterior[o] p[o]
//   w = argmax_{o < O} pl[o] (the first maximum); winner = v[w], its
//   presence p[w]; is_from_capsule = w / M.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn: no fused
// multiply-adds but where PyTorch's kernel has one), in PyTorch's order,
// and every sum over the six pose parameters or the O + 1 components is
// taken in the order PyTorch's CUDA reductions take it at these shapes
// (found on the H100 with torch 2.11: the six as ((0+4)+2)+((1+5)+3),
// torch.logsumexp's in four accumulators, torch.softmax's in order). So
// L1f gives the plain version's posterior and mixing terms to the bit, and
// L1b, for the gradients a training step's loss sends (log_prob's and the
// posterior's), autograd's gradients of the votes, scales and presences to
// the bit: a difference at rounding level there moved RMSprop's first
// steps apart (its eps is 1e-2 / B^2, so an element's step has the size of
// lr whatever the size of its gradient), and the benchmark's reference
// comparison with them.
//
// Bound on the H100: latency, not bytes. At the cifar10 shape (B 128, O 32,
// M 64) L1f reads the votes, scales and presences (8.4 MB) and writes about
// 5 MB, 4 us at 3.35 TB/s; the arithmetic is ~30 operations a component and
// point. So the design is about few launches, no round trips through device
// memory, and enough loads in flight:
//   * a group of 8 lanes of a warp owns a point (b, m) and walks its O + 1
//     components, 4 or 5 a lane, so that the card holds ~10 warps an SM at
//     these shapes (one thread a point, the first design, held 2 and waited
//     on each load in turn: 0.049 ms for L1f, 0.078 ms for L1b at mnist40);
//     the lanes that read one component read neighbouring points' votes;
//   * each lane keeps its components' logits and their exponentials in its
//     columns of shared memory; the maxima and the argmax are butterflies
//     of warp shuffles, and each lane of the group then takes the ordered
//     sums over the group's columns itself (33 adds at these shapes);
//   * log_prob's sum comes from per-block partial sums in a fixed order and
//     a second one-block pass: no atomics, results repeat bit for bit;
//   * the votes may be the (B, O, M, 6) view of the vote head's (B, O, M,
//     3, 3) matrices (a pose stride of 9 floats), read where they lie.
// L1b recomputes the forward per point, as V1b does, takes the upstream
// gradient of every float output (a missing one counts as zero), and writes
// the gradients of the votes, scales, presences, the part pose and its
// presence, each where needed; the dummy vote's gradient, a sum over B,
// comes from a second pass, a thread a column walking B in order.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kLog001 = -4.60517018598809136804f;  // float32(log(0.01))

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// Which gradients L1b writes (the wrapper's `needs`).
constexpr int kNeedVote = 1, kNeedScale = 2, kNeedPresence = 4, kNeedX = 8, kNeedPointPresence = 16;

// The inputs of both kernels.
struct In {
  const float* vote;      // (B, O, M, 6), pose stride S
  const float* scale;     // (B, O, M)
  const float* vp;        // (B, O, M)
  const float* dummy;     // (M, 6)
  const float* x;         // (B, M, 6)
  const float* presence;  // (B, M) or null
  int B, O, M, S;
};

// A sum of six in the order in which PyTorch's CUDA reduction over a
// contiguous last axis of six adds them.
__device__ __forceinline__ float sum6(const float (&e)[6]) {
  return add(add(add(e[0], e[4]), e[2]), add(add(e[1], e[5]), e[3]));
}

// The Gaussian's log-density of the pose x under vote v, scale s, summed over
// the six parameters, as ops/gmm.py::normal_log_prob and torch.sum take it.
// d[k] = x_k - v_k on return.
__device__ __forceinline__ float vote_log_prob(const float* v, const float (&x)[6], float s,
                                               float (&d)[6]) {
  const float q = mul(mul(2.0f, s), s);
  const float log_s = logf(s);
  float e[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    d[k] = sub(x[k], __ldg(v + k));
    e[k] = sub(sub(fdiv(-mul(d[k], d[k]), q), log_s), kLogSqrt2Pi);
  }
  return sum6(e);
}

// A point's components are walked by a group of kGroup lanes of one warp:
// lane g of the group takes the components o = g, g + kGroup, ..., and keeps
// what it computes for them in its columns of shared memory (the c-th of its
// components at column[c T]). Lane l of a warp is lane l / kPoints of the
// group of point l % kPoints, so that the lanes that read one component read
// neighbouring points' votes. A sum over the components is taken by every
// lane of the group alone, reading the group's columns in PyTorch's order,
// so that the likelihood's logsumexps and softmax, forward and backward,
// give PyTorch's bits; maxima are butterflies over the group's lanes.
constexpr int kGroup = 8;
constexpr int kPoints = 32 / kGroup;  // points a warp

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = kPoints; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kPoints; o < 32; o <<= 1) v = add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The group's largest v and its index i, the smallest index among equals (as
// torch.argmax takes the first maximum).
__device__ __forceinline__ void group_argmax(float& v, int& i) {
#pragma unroll
  for (int o = kPoints; o < 32; o <<= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// Component k of the point, from the column `col` of lane g (this lane).
__device__ __forceinline__ float component(const float* col, int k, int g, int T) {
  return col[(k / kGroup) * T + (k % kGroup - g) * kPoints];
}

// The sum over the K components of a column, as torch.sum and
// torch.logsumexp add them over the component axis: four accumulators,
// component k in the (k mod 4)-th, then added in turn.
__device__ __forceinline__ float sum_in_fours(const float* col, int K, int g, int T) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < K; ++k) a[k & 3] = add(a[k & 3], component(col, k, g, T));
  return add(add(add(a[0], a[1]), a[2]), a[3]);
}

// The sum over the K components of a column in order, as torch.softmax and
// its backward add them.
__device__ __forceinline__ float sum_in_order(const float* col, int K, int g, int T) {
  float a = 0.0f;
  for (int k = 0; k < K; ++k) a = add(a, component(col, k, g, T));
  return a;
}

// The shared memory columns of a lane: the posterior logits, the mixing
// logits, their exponentials less their maxima, and a scratch column.
struct Columns {
  float *pl, *ml, *ex, *ex_mix, *scratch;
  static constexpr int kCount = 5;
  __device__ Columns(float* smem, int C, int T) {
    float* base = smem + threadIdx.x;
    pl = base;
    ml = base + C * T;
    ex = base + 2 * C * T;
    ex_mix = base + 3 * C * T;
    scratch = base + 4 * C * T;
  }
};

// The forward passes of one point that both kernels run, on one lane of its
// group: the posterior and mixing logits of the lane's components, their
// maxima, the argmax over the real capsules, the exponentials less the
// maxima, and the sums of those. L1f also writes mixing_logit and
// vote_presence_binary (the pointers non-null). A lane of a point past the
// last (valid false) takes part in the group's butterflies only.
struct Point {
  int b, m, g, K, T;
  bool valid;
  float x[6];
  float mx, mx_mix;           // pl's and ml's maxima
  float sum, sum4, sum4_mix;  // the softmax's sum of exp(pl - mx); the logsumexps'
  int win;

  __device__ Point(const In& in, const Columns& col, int T_, float* mixing_logit,
                   float* binary) {
    T = T_;
    const int lane = threadIdx.x & 31;
    const int p = (blockIdx.x * (T / 32) + (threadIdx.x >> 5)) * kPoints + lane % kPoints;
    g = lane / kPoints;
    K = in.O + 1;
    valid = p < in.B * in.M;
    b = valid ? p / in.M : 0;
    m = valid ? p - b * in.M : 0;
    mx = -INFINITY;
    mx_mix = -INFINITY;
    float best = -INFINITY;
    win = g < in.O ? g : INT_MAX;
    if (valid) {
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = __ldg(in.x + static_cast<size_t>(p) * 6 + k);
      for (int o = g, c = 0; o < K; o += kGroup, ++c) {
        float lp, lm;
        if (o < in.O) {
          const size_t j = (static_cast<size_t>(b) * in.O + o) * in.M + m;
          float d[6];
          const float vlp = vote_log_prob(in.vote + j * in.S, x, __ldg(in.scale + j), d);
          lm = log_safe(__ldg(in.vp + j));
          lp = add(lm, vlp);
          if (lp > best) {  // the lane's first maximum
            best = lp;
            win = o;
          }
          if (binary != nullptr) binary[j] = lm > kLog001 ? 1.0f : 0.0f;
        } else {  // the dummy component
          lm = kLog001;
          lp = add(kLog001, kLog001);
        }
        col.pl[c * T] = lp;
        col.ml[c * T] = lm;
        mx = fmaxf(mx, lp);
        mx_mix = fmaxf(mx_mix, lm);
        if (mixing_logit != nullptr) {
          mixing_logit[(static_cast<size_t>(b) * K + o) * in.M + m] = lm;
        }
      }
    }
    mx = group_max(mx);
    mx_mix = group_max(mx_mix);
    group_argmax(best, win);
    if (valid) {
      for (int c = 0; g + c * kGroup < K; ++c) {
        col.ex[c * T] = expf(sub(col.pl[c * T], mx));
        col.ex_mix[c * T] = expf(sub(col.ml[c * T], mx_mix));
      }
    }
    __syncwarp();
    if (valid) {
      sum = sum_in_order(col.ex, K, g, T);
      sum4 = sum_in_fours(col.ex, K, g, T);
      sum4_mix = sum_in_fours(col.ex_mix, K, g, T);
    }
  }

  __device__ int point(const In& in) const { return b * in.M + m; }
  __device__ float lse() const { return add(logf(sum4), mx); }
  __device__ float lse_mix() const { return add(logf(sum4_mix), mx_mix); }
  // softmax(pl) of the lane's c-th component, as torch.softmax takes it
  __device__ float posterior(const Columns& col, int c) const {
    return fdiv(col.ex[c * T], sum);
  }
};

// The most components a lane takes, ceil((O + 1) / kGroup): its floats in
// each column of shared memory.
__host__ __device__ __forceinline__ int slots(int O) { return (O + kGroup) / kGroup; }

// L1f. Grid: ceil(B M / (T / kGroup)) blocks of T threads, a group of
// kGroup lanes a point; dynamic shared memory Columns::kCount columns and a
// float a warp.
__global__ void capsule_likelihood_fwd_kernel(In in, float* __restrict__ binary,
                                              float* __restrict__ winner,
                                              float* __restrict__ winner_presence,
                                              float* __restrict__ soft_winner,
                                              float* __restrict__ soft_winner_presence,
                                              float* __restrict__ posterior,
                                              float* __restrict__ mixing_log_prob,
                                              float* __restrict__ mixing_logit,
                                              int64_t* __restrict__ is_from_capsule,
                                              float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int C = slots(in.O);
  const Columns col(smem, C, T);
  const Point pt(in, col, T, mixing_logit, binary);
  const int K = pt.K;
  float sw[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // soft winner, its presence
  if (pt.valid) {
    const float lse_mix = pt.lse_mix();
    for (int o = pt.g, c = 0; o < K; o += kGroup, ++c) {
      const float post = pt.posterior(col, c);
      mixing_log_prob[(static_cast<size_t>(pt.b) * K + o) * in.M + pt.m] =
          sub(col.ml[c * T], lse_mix);
      const float* v;
      if (o < in.O) {
        const size_t j = (static_cast<size_t>(pt.b) * in.O + o) * in.M + pt.m;
        posterior[j] = post;
        sw[6] = add(sw[6], mul(post, __ldg(in.vp + j)));
        v = in.vote + j * in.S;
      } else {
        v = in.dummy + static_cast<size_t>(pt.m) * 6;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) sw[k] = add(sw[k], mul(post, __ldg(v + k)));
    }
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) sw[k] = group_sum(sw[k]);
  float point_lp = 0.0f;
  if (pt.valid && pt.g == 0) {
    const int p = pt.point(in);
    const size_t jw = (static_cast<size_t>(pt.b) * in.O + pt.win) * in.M + pt.m;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      soft_winner[static_cast<size_t>(p) * 6 + k] = sw[k];
      winner[static_cast<size_t>(p) * 6 + k] = __ldg(in.vote + jw * in.S + k);
    }
    soft_winner_presence[p] = sw[6];
    winner_presence[p] = __ldg(in.vp + jw);
    is_from_capsule[p] = pt.win / in.M;
    point_lp = pt.lse();
    if (in.presence != nullptr) point_lp = mul(point_lp, __ldg(in.presence + p));
  }
  // the block's part of log_prob's sum: warps in order
  float* red = smem + Columns::kCount * C * T;
  point_lp = warp_sum(point_lp);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = point_lp;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < T / 32; ++w) s = add(s, red[w]);
    partial[blockIdx.x] = s;
  }
}

// log_prob = (the sum of L1f's partial sums, in a fixed order) / B. One block
// of 256 threads.
__global__ void capsule_likelihood_sum_kernel(const float* __restrict__ partial, int n, int B,
                                              float* __restrict__ log_prob) {
  __shared__ float red[1][8];
  float v[1] = {0.0f};
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[0] = add(v[0], partial[i]);
  block_sums<1, 8>(v, red);
  if (threadIdx.x == 0) *log_prob = fdiv(v[0], static_cast<float>(B));
}

// The upstream gradients of L1f's float outputs, each null where none.
struct Grads {
  const float* log_prob;              // ()
  const float* winner;                // (B, M, 6)
  const float* winner_presence;       // (B, M)
  const float* soft_winner;           // (B, M, 6)
  const float* soft_winner_presence;  // (B, M)
  const float* posterior;             // (B, O, M)
  const float* mixing_log_prob;       // (B, O + 1, M)
  const float* mixing_logit;          // (B, O + 1, M)
};

// L1b. Grid and shared memory as L1f's. Writes the gradients of vote
// (contiguous (B, O, M, 6)), scale, vote_presence, x and presence that
// `needs` names, and each point's term of the dummy vote's (post[O]
// g_soft_winner) into dummy_part (B, M, 6) when the soft winner has a
// gradient. Where only log_prob and the posterior have gradients (a
// training step's loss), the vote's, the scale's and the vote presence's
// are PyTorch's autograd of the plain version to the bit: each step follows
// the backward formula autograd runs, rounded where it rounds.
__global__ void capsule_likelihood_bwd_kernel(In in, Grads g, int needs, float* __restrict__ g_vote,
                                              float* __restrict__ g_scale,
                                              float* __restrict__ g_vp, float* __restrict__ g_x,
                                              float* __restrict__ g_presence,
                                              float* __restrict__ dummy_part) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int C = slots(in.O);
  const Columns col(smem, C, T);
  const Point pt(in, col, T, nullptr, nullptr);
  const int K = pt.K;
  const int p = pt.point(in);
  const size_t pK = static_cast<size_t>(pt.b) * K;

  // log_prob = mean_b sum_m lse presence: its gradient at this point's lse
  const float g_point = g.log_prob != nullptr ? fdiv(__ldg(g.log_prob), static_cast<float>(in.B))
                                              : 0.0f;
  float g_lse = g_point;
  float g_sw[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float g_swp = 0.0f;
  float sum_g_mix = 0.0f;
  if (pt.valid) {
    if (in.presence != nullptr) {
      g_lse = mul(g_point, __ldg(in.presence + p));
      if ((needs & kNeedPointPresence) && pt.g == 0) g_presence[p] = mul(g_point, pt.lse());
    }
    if (g.soft_winner != nullptr) {
#pragma unroll
      for (int k = 0; k < 6; ++k) g_sw[k] = __ldg(g.soft_winner + static_cast<size_t>(p) * 6 + k);
    }
    if (g.soft_winner_presence != nullptr) g_swp = __ldg(g.soft_winner_presence + p);
    // the softmax output's upstream gradient gp times the output, per
    // component, into the scratch column
    for (int o = pt.g, c = 0; o < K; o += kGroup, ++c) {
      const float* v;
      float gp = 0.0f;
      if (o < in.O) {
        const size_t j = (static_cast<size_t>(pt.b) * in.O + o) * in.M + pt.m;
        if (g.posterior != nullptr) gp = __ldg(g.posterior + j);
        if (g.soft_winner_presence != nullptr) gp = add(gp, mul(g_swp, __ldg(in.vp + j)));
        v = in.vote + j * in.S;
      } else {
        v = in.dummy + static_cast<size_t>(pt.m) * 6;
      }
      if (g.soft_winner != nullptr) {
#pragma unroll
        for (int k = 0; k < 6; ++k) gp = add(gp, mul(g_sw[k], __ldg(v + k)));
      }
      col.scratch[c * T] = mul(gp, pt.posterior(col, c));
      if (g.mixing_log_prob != nullptr) {
        sum_g_mix = add(sum_g_mix, __ldg(g.mixing_log_prob + (pK + o) * in.M + pt.m));
      }
    }
  }
  sum_g_mix = group_sum(sum_g_mix);
  __syncwarp();
  float gx[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (pt.valid) {
    // torch.softmax's backward: its sum of gp y in order, then gp y - y sum
    const float dot_post = sum_in_order(col.scratch, K, pt.g, T);
    const float lse = pt.lse();
    const float lse_mix = pt.lse_mix();
    for (int o = pt.g, c = 0; o < K; o += kGroup, ++c) {
      const float post = pt.posterior(col, c);
      if (o == in.O) {  // the dummy component: its vote's term
        if (dummy_part != nullptr) {
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            dummy_part[static_cast<size_t>(p) * 6 + k] = mul(post, g_sw[k]);
          }
        }
        continue;
      }
      const size_t j = (static_cast<size_t>(pt.b) * in.O + o) * in.M + pt.m;
      const size_t jk = (pK + o) * in.M + pt.m;
      // the posterior logit's: logsumexp's backward, g exp(pl - lse), and the
      // softmax's, fma(-y, sum, gp y)
      const float g_pl = add(mul(g_lse, expf(sub(col.pl[c * T], lse))),
                             __fmaf_rn(-post, dot_post, col.scratch[c * T]));
      // the mixing logit's: the posterior logit's, mixing_log_prob's, its own
      float g_ml = g_pl;
      if (g.mixing_log_prob != nullptr) {
        g_ml = add(g_ml, sub(__ldg(g.mixing_log_prob + jk),
                             mul(expf(sub(col.ml[c * T], lse_mix)), sum_g_mix)));
      }
      if (g.mixing_logit != nullptr) g_ml = add(g_ml, __ldg(g.mixing_logit + jk));
      const bool won = o == pt.win;
      if (needs & kNeedPresence) {
        const float pres = __ldg(in.vp + j);
        float gv = pres < kPresEps ? 0.0f : fdiv(g_ml, pres);  // log_safe's
        if (g.soft_winner_presence != nullptr) gv = add(gv, mul(post, g_swp));
        if (won && g.winner_presence != nullptr) gv = add(gv, __ldg(g.winner_presence + p));
        g_vp[j] = gv;
      }
      if (needs & (kNeedVote | kNeedScale | kNeedX)) {
        // the Gaussian's, as autograd runs normal_log_prob's backward: with
        // t = x - v, q = (2 s) s and u = -t^2 / q, the vote's (g / q)(2 t);
        // the scale's through q, (sum6(-g (u / q)) (2 s)) + ..., and through
        // log s, sum6(-g) / s
        const float s = __ldg(in.scale + j);
        const float* v = in.vote + j * in.S;
        const float s2 = mul(2.0f, s);
        const float q = mul(s2, s);
        const float g_over_q = fdiv(g_pl, q);
        float u[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float t = sub(pt.x[k], __ldg(v + k));
          const float gt = mul(g_over_q, mul(2.0f, t));
          gx[k] = sub(gx[k], gt);
          u[k] = mul(-g_pl, fdiv(fdiv(-mul(t, t), q), q));
          if (needs & kNeedVote) {
            float gv = gt;
            if (g.soft_winner != nullptr) gv = add(gv, mul(post, g_sw[k]));
            if (won && g.winner != nullptr) {
              gv = add(gv, __ldg(g.winner + static_cast<size_t>(p) * 6 + k));
            }
            g_vote[j * 6 + k] = gv;
          }
        }
        if (needs & kNeedScale) {
          const float g_q = sum6(u);
          const float neg[6] = {-g_pl, -g_pl, -g_pl, -g_pl, -g_pl, -g_pl};
          g_scale[j] = add(add(mul(g_q, s2), fdiv(sum6(neg), s)), mul(mul(g_q, s), 2.0f));
        }
      }
    }
  }
  if (needs & kNeedX) {
#pragma unroll
    for (int k = 0; k < 6; ++k) gx[k] = group_sum(gx[k]);
    if (pt.valid && pt.g == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) g_x[static_cast<size_t>(p) * 6 + k] = gx[k];
    }
  }
}

// The dummy vote's gradient: each of its M 6 entries summed over B in order.
// Grid: ceil(M 6 / 128) blocks of 128 threads, a thread a column.
__global__ void capsule_likelihood_dummy_kernel(const float* __restrict__ dummy_part, int B, int M,
                                                float* __restrict__ g_dummy) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= M * 6) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s = add(s, dummy_part[static_cast<size_t>(b) * M * 6 + c]);
  g_dummy[c] = s;
}

size_t shared_bytes(int O, int T) {
  return sizeof(float) * (static_cast<size_t>(Columns::kCount) * slots(O) * T + T / 32);
}

int blocks_for(int B, int M, int T) {
  const int points = T / 32 * kPoints;
  return (B * M + points - 1) / points;
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Pointers: vote, scale, vote_presence, dummy_vote, x, presence (may be
// null), then the outputs log_prob (0-d), vote_presence_binary, winner,
// winner_presence, soft_winner, soft_winner_presence, posterior_mixing_prob,
// mixing_log_prob, mixing_logit, is_from_capsule (int64) and the scratch of
// partial sums (ceil(B M / T) floats). Ints: B, O, M, the votes' pose
// stride S (6, or 9 for the view of 3 x 3 matrices) and T, the threads of a
// block.
extern "C" int scae_capsule_likelihood_fwd(const float* vote, const float* scale,
                                           const float* vote_presence, const float* dummy,
                                           const float* x, const float* presence, float* log_prob,
                                           float* binary, float* winner, float* winner_presence,
                                           float* soft_winner, float* soft_winner_presence,
                                           float* posterior, float* mixing_log_prob,
                                           float* mixing_logit, int64_t* is_from_capsule,
                                           float* partial, int B, int O, int M, int S, int T,
                                           cudaStream_t stream) {
  const In in{vote, scale, vote_presence, dummy, x, presence, B, O, M, S};
  const int blocks = blocks_for(B, M, T);
  const size_t smem = shared_bytes(O, T);
  cudaError_t err = allow_shared(capsule_likelihood_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  capsule_likelihood_fwd_kernel<<<blocks, T, smem, stream>>>(
      in, binary, winner, winner_presence, soft_winner, soft_winner_presence, posterior,
      mixing_log_prob, mixing_logit, is_from_capsule, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  capsule_likelihood_sum_kernel<<<1, 256, 0, stream>>>(partial, blocks, B, log_prob);
  return cudaGetLastError();
}

// Pointers: the six inputs as L1f's, then the upstream gradients of
// log_prob, winner, winner_presence, soft_winner, soft_winner_presence,
// posterior_mixing_prob, mixing_log_prob and mixing_logit (each may be null:
// no gradient), then the results: the gradients of vote ((B, O, M, 6),
// contiguous), scale, vote_presence, x, presence and dummy_vote (each null
// where not wanted; dummy_vote's needs the soft winner's), and the scratch
// dummy_part (B, M, 6) beside dummy_vote's. Ints: B, O, M, S, T as L1f's,
// and `needs` (kNeed*: which of vote, scale, vote_presence, x, presence).
extern "C" int scae_capsule_likelihood_bwd(
    const float* vote, const float* scale, const float* vote_presence, const float* dummy,
    const float* x, const float* presence, const float* g_log_prob, const float* g_winner,
    const float* g_winner_presence, const float* g_soft_winner,
    const float* g_soft_winner_presence, const float* g_posterior, const float* g_mixing_log_prob,
    const float* g_mixing_logit, float* g_vote, float* g_scale, float* g_vp, float* g_x,
    float* g_presence, float* g_dummy, float* dummy_part, int B, int O, int M, int S, int T,
    int needs, cudaStream_t stream) {
  const In in{vote, scale, vote_presence, dummy, x, presence, B, O, M, S};
  const Grads g{g_log_prob,    g_winner,    g_winner_presence, g_soft_winner,
                g_soft_winner_presence, g_posterior, g_mixing_log_prob, g_mixing_logit};
  const int blocks = blocks_for(B, M, T);
  const size_t smem = shared_bytes(O, T);
  cudaError_t err = allow_shared(capsule_likelihood_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  capsule_likelihood_bwd_kernel<<<blocks, T, smem, stream>>>(
      in, g, needs, g_vote, g_scale, g_vp, g_x, g_presence,
      g_dummy != nullptr ? dummy_part : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || g_dummy == nullptr) return err;
  capsule_likelihood_dummy_kernel<<<(M * 6 + 127) / 128, 128, 0, stream>>>(dummy_part, B, M,
                                                                          g_dummy);
  return cudaGetLastError();
}
