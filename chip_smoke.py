#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``scae_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # the run that proves the port
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown

Phases, each announced when it starts and when it ends, with its seconds:

  env     torch / CUDA versions, the card's name and power limit, nvcc
  build   the CUDA kernels, built from csrc/ with nvcc (one nvcc per
          source, all started together), and ptxas's report
  kernel  each kernel against its plain PyTorch version at the main path's
          shapes and at edge shapes; the kernel's time, the plain
          version's, and the least time the card could take (the bound).
          K1 is the gather forward (decoder likelihood), K2+K3 its
          backward (also at the cifar10 shape, M=64, C=3, whose capsules
          it splits over two blocks); K4f and K4b the dense forward and
          backward (fused_impl="pallas"), also at the identity and zero
          poses and at a 17x17 template, K4b run twice for the same bits
  slice   the flagship SCAE (1x40x40, M=40, O=32, 11x11 templates), built
          on the card from a seeded generator, through the eval step and
          the infer function at batch 128; the kernels' launch counts over
          that run; the same weights and input through the port on the CPU,
          term by term; the eval step's time, images per second and peak
          device memory
  train   the flagship train step (uint8 decode, pad to 40x40, translate by
          up to 6, forward with noise, 8-term loss, backward through K1 and
          K2+K3, RMSprop): one step with noise and translation off on the
          card and on the CPU, every loss term and every gradient compared;
          the launch counts of one real step at batch 128; then 5 warm-up
          and 20 timed real steps: ms per step, images per second, peak
          device memory
  pallas  the same train phase with fused_impl="pallas" (K4f and K4b in
          place of K1 and K2+K3), and its eval step at batch 128
  cifar10 one train step of the shipped cifar10 model (3x32x32, M=64) with
          noise off at batch 32 on the card and on the CPU, through K1 and
          K2+K3

Every number is printed beside the card's name and power limit. Imports
torch, numpy, the standard library and scae_tpu_torch only. Exits
non-zero, with no result line, when CUDA is absent or any check fails. The
line before the last is the card's name and power limit; before it, a JSON
line of per-kernel numbers; the last line is the JSON result.
"""

import argparse
import concurrent.futures
import contextlib
import json
import math
import subprocess
import sys
import time

BATCH = 128            # eval and train batch of the flagship
CPU_BATCH = 32         # batch of the card-vs-CPU train-step comparison
KERNEL_TOL = 1e-4      # abs, kernel vs its plain version (f32 ulps of O(10))
# backward kernel vs its plain version, relative to each output's largest
# |entry| (for the three 0-d scalar gradients, to max(|value|, 1)): both are
# f32 sums over pixels (and, for alpha, examples) taken in other orders, the
# kernel's through atomics whose order changes from run to run
BWD_TOL = 1e-4
TERM_RTOL = 1e-4       # card vs CPU, per loss term, relative to max(1, |cpu|)
PROB_TOL = 1e-4        # card vs CPU, abs, on presences and probabilities
# card vs CPU train step, per parameter, relative to its largest |gradient|:
# the card's cuDNN may convolve by Winograd or FFT where the CPU convolves
# directly (f32 either way, TF32 off), and every sum runs in another order
GRAD_RTOL = 1e-3
GRAD_NAMES = ("templates", "alpha", "pose", "presence", "bg_value",
              "bg_mixing_logit", "scale", "target")
FLAGSHIP_SHAPE = (BATCH, 40, 1, 11, 11, 40, 40)  # (B, M, C, Ht, Wt, H, W)
CIFAR10_SHAPE = (CPU_BATCH, 64, 3, 11, 11, 32, 32)
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM f32, outside the tensor cores


def say(*parts):
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(name):
    say(f"[phase] {name}: start")
    t0 = time.perf_counter()
    yield
    say(f"[phase] {name}: done in {time.perf_counter() - t0:.2f} s")


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ K1

def k1_inputs(torch, shape, seed, pose_noise=0.6, edge=False,
              alpha_batched=False, fixed_pose=None):
    """Random decoder-likelihood inputs, made with numpy from a seed.
    ``edge``: every third presence exactly 0, and two hand-built degenerate
    poses (a near-zero scale at the canvas corner, a translation off it).
    ``alpha_batched``: alpha per example (B, ...) instead of (1, ...).
    ``fixed_pose``: one flat affine for every capsule."""
    import numpy as np

    from scae_tpu_torch.ops.geometry import geometric_transform

    B, M, C, Ht, Wt, H, W = shape
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    templates = t(rng.rand(B, M, C, Ht, Wt))
    alpha = t(rng.randn(B if alpha_batched else 1, M, 1, Ht, Wt))
    pose = geometric_transform(t(rng.randn(B, M, 6) * pose_noise))
    presence = rng.rand(B, M)
    if edge:
        presence[:, ::3] = 0.0
        pose[:, 0] = t([0.01, 0.0, 1.0, 0.0, 0.01, 1.0])
        pose[:, 1] = t([1.01, 0.0, -1.0, 0.0, 1.01, 0.0])
    if fixed_pose is not None:
        pose[:] = t(fixed_pose)
    return (templates, alpha, pose.contiguous(), t(presence), t(0.3),
            t(0.7), t(1.0), t(rng.rand(B, C, H, W)), (H, W))


def k1_bound_ms(shape, alpha_batch=1):
    """Least time of K1 on the card: the larger of bytes moved over the
    memory rate and f32 operations over the f32 rate.

    Bytes: each input read once (templates, alpha, pose, presence, target,
    3 scalars) and each output written once (ll, num, den).
    Operations per (capsule, pixel) pair, as the kernel does them:
      16  source coordinates (two 2-FMA affine maps, two 4-op rescales)
      14  taps (2 floors, 2 fractions, 2 complements, 8 bound tests)
       9  4-tap blend, per plane (C template planes + alpha)
       5  mixing logit (1) and the streaming LSE step of den (4)
       9  per channel: residual, square, scale, offset, add mix (5) and
          its streaming LSE step (4)
    Integer index and address arithmetic is not counted.
    """
    B, M, C, Ht, Wt, H, W = shape
    P, T = H * W, Ht * Wt
    n_bytes = 4 * (B * M * C * T + alpha_batch * M * T + B * M * 6 + B * M
                   + B * C * P + 3 + 2 * B * C * P + B * P)
    ops = B * M * P * (16 + 14 + 9 * (C + 1) + 5 + 9 * C)
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, ops


def time_cuda(torch, fn, iters, warmup):
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(torch, fn, kernel, iters=200, warmup=20):
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel``, over ``iters`` calls of ``fn``, from torch.profiler: the
    kernel alone, without the wrapper's checks and allocations on the host
    or its small PyTorch kernels (zeroing, the alpha sum) on the card."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in events)
    if count != iters:
        raise RuntimeError(f"the profiler saw {count} launches of {kernel}, "
                           f"expected {iters}")
    total_us = sum(getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0.0) for e in events)
    return total_us / count / 1e3


def kernel_phase(torch, card):
    from scae_tpu_torch.kernels import decoder_ll_gather as k1

    cases = [
        ("flagship", (BATCH, 40, 1, 11, 11, 40, 40), 0.6, False),
        ("edge: raw pose noise 4.0, zero presences, degenerate poses, M=13",
         (BATCH, 13, 1, 11, 11, 40, 40), 4.0, True),
        ("colour: C=3, 14x14 templates, >48 KB shared memory",
         (16, 16, 3, 14, 14, 32, 32), 0.6, False),
    ]
    flagship_err = None
    for name, shape, noise, edge in cases:
        args = k1_inputs(torch, shape, seed=1, pose_noise=noise, edge=edge)
        smem = k1.shared_memory_bytes(*shape[1:5])
        got = k1.decoder_ll_gather(*args)
        torch.cuda.synchronize()
        want = k1.decoder_ll_gather_plain(*args)
        for g in got:
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"K1 {name}: non-finite output")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        say(f"K1 {name} {shape}: shared memory {smem} B, max abs err "
            f"{err:.3e} (tolerance {KERNEL_TOL:.0e}) [{card}]")
        if not err < KERNEL_TOL:
            raise RuntimeError(f"K1 {name}: max abs err {err} exceeds "
                               f"{KERNEL_TOL}")
        if flagship_err is None:
            flagship_err = err

    args = k1_inputs(torch, cases[0][1], seed=2)
    ms = kernel_device_ms(torch, lambda: k1.decoder_ll_gather(*args),
                          "decoder_ll_gather_fwd_kernel")
    call_ms = time_cuda(torch, lambda: k1.decoder_ll_gather(*args),
                        iters=200, warmup=20)
    plain_ms = time_cuda(torch, lambda: k1.decoder_ll_gather_plain(*args),
                         iters=20, warmup=3)
    bound_ms, bound_by, n_bytes, ops = k1_bound_ms(cases[0][1])
    say(f"K1 flagship time: kernel {ms:.4f} ms (device time per launch over "
        f"200 launches, torch.profiler), wrapper call {call_ms:.4f} ms (200 "
        f"back-to-back calls, CUDA events), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us by "
        f"{bound_by} ({n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP), "
        f"library_ms: none (no single PyTorch call computes this), "
        f"roofline share {bound_ms / ms:.1%} [{card}]")
    return dict(name="decoder_ll_gather_fwd", route="cuda",
                source="scae_tpu_torch/csrc/decoder_ll_gather.cu",
                replaces="scae_tpu/ops/pallas_decoder_ll_gather.py:565",
                launches=None, max_abs_err=flagship_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# ------------------------------------------------------------- K2 + K3

def bwd_bound_ms(torch, args, target_grad):
    """Least time of the backward kernel on these inputs: the larger of
    bytes moved over the memory rate and f32 operations over the f32 rate.

    Bytes: each input read once (templates, alpha, pose, presence, target,
    3 scalars, g, num, den) and each output written once (the gradient
    table, alpha's gradient, pose, presence, 3 scalars, and the target's
    where asked for).
    Operations per (capsule, pixel) pair, as the kernel does them:
      16  source coordinates, as K1
      18  taps (2 floors, 2 fractions, 8 bound tests, 6 for the four
          validity-folded weights)
       3  the test that some tap lies in the template
       9  4-tap blend, per plane (C template planes + alpha)
       4  mixing logit (1) and r = exp(mix - den) into gmix (3)
      16  per channel: residual, square, log-density (2), +mix, -num, exp,
          times g, the value gradient (2), gmix, target sum (2), squared
          sum (2), q sum
       1  the pixel sum of gmix
    and, for a pair whose taps touch the template (counted from this data):
      22  per plane: dV/dix and dV/diy from the masked texels (9 each) and
          their products into g_ix and g_iy (4)
       4  the four tap weights
       8  per plane: the four scatter products and adds
      10  pose partials (4 products, 6 pixel sums)
    per pixel: 18 per channel (gsum, background term, target gradient) and
    13 for the scalar rows; and B*M*Ht*Wt adds of the alpha sum over the
    batch. Integer index and address arithmetic is not counted.
    """
    from scae_tpu_torch.ops.warp import source_coordinates

    templates, alpha, pose = args[0], args[1], args[2]
    B, M, C, Ht, Wt = templates.shape
    H, W = args[-1]
    P, T, CC = H * W, Ht * Wt, C + 1
    A = alpha.shape[0]
    ix, iy = source_coordinates(pose, (Ht, Wt), (H, W))
    h0, w0 = torch.floor(iy), torch.floor(ix)
    hit = ((h0 >= -1) & (h0 <= Ht - 1) & (w0 >= -1) & (w0 <= Wt - 1))
    n_hit = int(hit.sum())
    n_pairs = B * M * P
    ops = (n_pairs * (42 + 9 * CC + 16 * C) + n_hit * (30 * CC + 14)
           + B * P * (18 * C + 13) + (B * M * T if A == 1 else 0))
    n_bytes = 4 * (B * M * C * T + A * M * T + B * M * 6 + B * M
                   + B * C * P + 3 + 2 * B * C * P + B * P
                   + B * M * CC * T + A * M * T + B * M * 6 + B * M + 3
                   + (B * C * P if target_grad else 0))
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, ops, n_hit


def bwd_kernel_phase(torch, card):
    """The backward kernel against the plain backward (autograd of K1's
    plain version) at K1's shapes and with per-example alpha; its time."""
    import numpy as np

    from scae_tpu_torch.kernels import decoder_ll_gather as k1

    cases = [
        ("flagship", (BATCH, 40, 1, 11, 11, 40, 40), 0.6, False, False),
        ("edge: raw pose noise 4.0, zero presences, degenerate poses, M=13",
         (BATCH, 13, 1, 11, 11, 40, 40), 4.0, True, False),
        ("colour: C=3, 14x14 templates, >48 KB shared memory",
         (16, 16, 3, 14, 14, 32, 32), 0.6, False, False),
        ("per-example alpha", (BATCH, 40, 1, 11, 11, 40, 40), 0.6, False,
         True),
        ("cifar10: M=64, C=3, 11x11", CIFAR10_SHAPE, 0.6, False, False),
    ]
    flagship_err = None
    for name, shape, noise, edge, alpha_batched in cases:
        args = k1_inputs(torch, shape, seed=1, pose_noise=noise, edge=edge,
                         alpha_batched=alpha_batched)
        B, C, H, W = shape[0], shape[2], shape[5], shape[6]
        g = torch.from_numpy(np.random.RandomState(3).randn(
            B, C, H, W).astype(np.float32) / B).cuda()
        _, num, den = k1.decoder_ll_gather(*args)
        got = k1.decoder_ll_gather_bwd(g, num, den, *args)
        torch.cuda.synchronize()
        want = k1.decoder_ll_gather_bwd_plain(g, num, den, *args)
        per_block = k1.bwd_capsules_per_block(*shape[1:5])
        smem = k1.bwd_shared_memory_bytes(per_block, *shape[2:5])
        worst = 0.0
        for out, a, b in zip(GRAD_NAMES, got, want):
            if not bool(torch.isfinite(a).all()):
                raise RuntimeError(f"K2+K3 {name}: non-finite {out}")
            scale = float(b.abs().max())
            if b.dim() == 0:
                scale = max(scale, 1.0)
            err = float((a - b).abs().max())
            tol = BWD_TOL * scale
            say(f"K2+K3 {name} {shape}: d{out} max abs err {err:.3e} "
                f"(tolerance {tol:.3e} = {BWD_TOL:.0e} x {scale:.3e}) "
                f"[{card}]")
            if not err <= tol:
                raise RuntimeError(f"K2+K3 {name}: d{out} max abs err {err}"
                                   f" exceeds {tol}")
            worst = max(worst, err / scale)
        say(f"K2+K3 {name}: {per_block} of {shape[1]} capsules per block, "
            f"shared memory {smem} B, worst relative err {worst:.3e} "
            f"[{card}]")
        if flagship_err is None:
            flagship_err = max(float((a - b).abs().max())
                               for a, b in zip(got, want))

    # the main path's call: the loss's constant upstream gradient -1/B,
    # no target gradient; and the same call at the cifar10 shape, batch 128
    cifar = (BATCH,) + CIFAR10_SHAPE[1:]
    args = k1_inputs(torch, cifar, seed=2)
    _, num, den = k1.decoder_ll_gather(*args)
    g = torch.full((BATCH, 3, 32, 32), -1.0 / BATCH, device="cuda")
    cifar_ms = kernel_device_ms(
        torch, lambda: k1.decoder_ll_gather_bwd(g, num, den, *args,
                                                target_grad=False),
        "decoder_ll_gather_bwd_kernel")
    cifar_bound = bwd_bound_ms(torch, args, target_grad=False)
    say(f"K2+K3 cifar10 time {cifar}: kernel {cifar_ms:.4f} ms (device time "
        f"per launch over 200 launches, torch.profiler; "
        f"{k1.bwd_capsules_per_block(*cifar[1:5])} capsules per block), "
        f"bound {cifar_bound[0] * 1e3:.2f} us by {cifar_bound[1]} "
        f"({cifar_bound[3] / 1e9:.3f} GFLOP) [{card}]")

    args = k1_inputs(torch, cases[0][1], seed=2)
    _, num, den = k1.decoder_ll_gather(*args)
    g = torch.full((BATCH, 1, 40, 40), -1.0 / BATCH, device="cuda")

    def main_path_call():
        return k1.decoder_ll_gather_bwd(g, num, den, *args,
                                        target_grad=False)

    ms = kernel_device_ms(torch, main_path_call,
                          "decoder_ll_gather_bwd_kernel")
    call_ms = time_cuda(torch, main_path_call, iters=200, warmup=20)
    plain_ms = time_cuda(torch, lambda: k1.decoder_ll_gather_bwd_plain(
        g, num, den, *args, target_grad=False), iters=10, warmup=2)
    bound_ms, bound_by, n_bytes, ops, n_hit = bwd_bound_ms(
        torch, args, target_grad=False)
    say(f"K2+K3 flagship time: kernel {ms:.4f} ms (device time per launch "
        f"over 200 launches, torch.profiler), wrapper call {call_ms:.4f} ms "
        f"(200 back-to-back calls, CUDA events, with the zeroing of its "
        f"outputs and the alpha sum), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us by "
        f"{bound_by} ({n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP, "
        f"{n_hit} of {BATCH * 40 * 1600} capsule-pixel pairs touch their "
        f"template), library_ms: none (no single PyTorch call computes "
        f"this), roofline share {bound_ms / ms:.1%} [{card}]")
    return dict(name="decoder_ll_gather_bwd", route="cuda",
                source="scae_tpu_torch/csrc/decoder_ll_gather_bwd.cu",
                replaces="scae_tpu/ops/pallas_decoder_ll_gather.py:604",
                launches=None, max_abs_err=flagship_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# ------------------------------------------------------------ K4f, K4b

def dense_kernel_phase(torch, card):
    """K4f and K4b against their plain version (ops/decoder_ll.py with f32
    taps and its hand-derived backward) at the main path's shape and at
    edge shapes, K4b twice for the same bits; their times."""
    import numpy as np

    from scae_tpu_torch.kernels import decoder_ll_dense as k4

    identity, zero = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0], [0.0] * 6
    cases = [
        # (name, shape, pose noise, edge, per-example alpha, fixed pose)
        ("flagship", FLAGSHIP_SHAPE, 0.6, False, False, None),
        ("edge: raw pose noise 4.0, zero presences, degenerate poses, M=13",
         (BATCH, 13, 1, 11, 11, 40, 40), 4.0, True, False, None),
        ("colour: C=3, 14x14 templates", (16, 16, 3, 14, 14, 32, 32), 0.6,
         False, False, None),
        ("per-example alpha", FLAGSHIP_SHAPE, 0.6, False, True, None),
        ("identity pose, 11x11 canvas: coordinates at texel centres",
         (BATCH, 40, 1, 11, 11, 11, 11), 0.6, False, False, identity),
        ("zero pose: every coordinate the template's centre",
         FLAGSHIP_SHAPE, 0.6, False, False, zero),
        ("17x17 templates (289 texels, more than gather takes)",
         (32, 40, 1, 17, 17, 40, 40), 0.6, False, False, None),
    ]
    errs = {}
    for name, shape, noise, edge, alpha_batched, fixed in cases:
        args = k1_inputs(torch, shape, seed=1, pose_noise=noise, edge=edge,
                         alpha_batched=alpha_batched, fixed_pose=fixed)
        B, C, H, W = shape[0], shape[2], shape[5], shape[6]
        got = k4.decoder_ll_dense_fwd(*args)
        torch.cuda.synchronize()
        want = k4.decoder_ll_dense_plain(*args)
        for x in got:
            if not bool(torch.isfinite(x).all()):
                raise RuntimeError(f"K4f {name}: non-finite output")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        say(f"K4f {name} {shape}: shared memory "
            f"{k4.shared_memory_bytes(*shape[2:5])} B, max abs err "
            f"{err:.3e} (tolerance {KERNEL_TOL:.0e}) [{card}]")
        if not err < KERNEL_TOL:
            raise RuntimeError(f"K4f {name}: max abs err {err} exceeds "
                               f"{KERNEL_TOL}")
        errs.setdefault("fwd", err)

        g = torch.from_numpy(np.random.RandomState(3).randn(
            B, C, H, W).astype(np.float32) / B).cuda()
        _, num, den = got
        out = k4.decoder_ll_dense_bwd(g, num, den, *args)
        again = k4.decoder_ll_dense_bwd(g, num, den, *args)
        torch.cuda.synchronize()
        ref = k4.decoder_ll_dense_bwd_plain(g, num, den, *args)
        worst = 0.0
        for grad_name, a, b, c in zip(GRAD_NAMES, out, ref, again):
            if not bool(torch.isfinite(a).all()):
                raise RuntimeError(f"K4b {name}: non-finite {grad_name}")
            if not torch.equal(a, c):
                raise RuntimeError(f"K4b {name}: d{grad_name} differs "
                                   "between two runs on the same inputs")
            scale = float(b.abs().max())
            if b.dim() == 0:
                scale = max(scale, 1.0)
            gerr = float((a - b).abs().max())
            tol = BWD_TOL * scale
            if not gerr <= tol:
                raise RuntimeError(f"K4b {name}: d{grad_name} max abs err "
                                   f"{gerr} exceeds {tol}")
            # (the zero pose's pose gradient is 0 everywhere, on both sides)
            worst = max(worst, gerr / scale if scale else gerr)
        say(f"K4b {name} {shape}: shared memory "
            f"{k4.bwd_shared_memory_bytes(*shape[2:5])} B, worst err "
            f"{worst:.3e} of each gradient's largest |entry| (tolerance "
            f"{BWD_TOL:.0e}), a second run bit-identical [{card}]")
        errs.setdefault("bwd", max(float((a - b).abs().max())
                                   for a, b in zip(out, ref)))

    args = k1_inputs(torch, FLAGSHIP_SHAPE, seed=2)
    ms = kernel_device_ms(torch, lambda: k4.decoder_ll_dense_fwd(*args),
                          "decoder_ll_dense_fwd_kernel")
    plain_ms = time_cuda(torch, lambda: k4.decoder_ll_dense_plain(*args),
                         iters=10, warmup=2)
    bound_ms, bound_by, n_bytes, ops = k1_bound_ms(FLAGSHIP_SHAPE)
    dense_ops = 2 * BATCH * 40 * 1600 * 121 * 2
    say(f"K4f flagship time: kernel {ms:.4f} ms (device time per launch over "
        f"200 launches, torch.profiler), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us by {bound_by} ({n_bytes / 1e6:.2f} MB, "
        f"{ops / 1e9:.3f} GFLOP: K1's count, the taps of nonzero weight; the "
        f"TPU's dense count {dense_ops / 1e9:.3f} GFLOP would give "
        f"{dense_ops / PEAK_F32_FLOPS * 1e6:.2f} us), library_ms: none, "
        f"roofline share {bound_ms / ms:.1%} [{card}]")
    rows = [dict(name="decoder_ll_dense_fwd", route="cuda",
                 source="scae_tpu_torch/csrc/decoder_ll_dense.cu",
                 replaces="scae_tpu/ops/pallas_decoder_ll.py:390",
                 launches=None, max_abs_err=errs["fwd"], ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None)]

    # the main path's call: upstream gradient -1/B, no target gradient
    _, num, den = k4.decoder_ll_dense_fwd(*args)
    g = torch.full((BATCH, 1, 40, 40), -1.0 / BATCH, device="cuda")

    def main_path_call():
        return k4.decoder_ll_dense_bwd(g, num, den, *args, target_grad=False)

    ms = kernel_device_ms(torch, main_path_call,
                          "decoder_ll_dense_bwd_kernel")
    plain_ms = time_cuda(torch, lambda: k4.decoder_ll_dense_bwd_plain(
        g, num, den, *args, target_grad=False), iters=10, warmup=2)
    # the same function on the same inputs as the gather backward's, so the
    # same count of what these inputs need: the dense formulation's texel
    # scan (3 operations for each (texel, pixel) pair of every capsule) is
    # this kernel's own cost, not the function's, and is reported apart
    bound_ms, bound_by, n_bytes, ops, n_hit = bwd_bound_ms(
        torch, args, target_grad=False)
    scan = 3 * BATCH * 40 * 121 * 1600
    say(f"K4b flagship time: kernel {ms:.4f} ms (device time per launch "
        f"over 200 launches, torch.profiler), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us by {bound_by} ({n_bytes / 1e6:.2f} MB, "
        f"{ops / 1e9:.3f} GFLOP: bwd_bound_ms's count, {n_hit} of "
        f"{BATCH * 40 * 1600} capsule-pixel pairs touch their template; the "
        f"texel scan's {scan / 1e9:.3f} G tests not counted), library_ms: "
        f"none, roofline share {bound_ms / ms:.1%} [{card}]")
    rows.append(dict(name="decoder_ll_dense_bwd", route="cuda",
                     source="scae_tpu_torch/csrc/decoder_ll_dense_bwd.cu",
                     replaces="scae_tpu/ops/pallas_decoder_ll.py:414",
                     launches=None, max_abs_err=errs["bwd"], ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None))
    return rows


# --------------------------------------------------------------- slice

def slice_phase(torch, card, rows):
    import numpy as np

    from scae_tpu_torch import serve
    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS, make_scae
    from scae_tpu_torch.kernels import decoder_ll_gather as k1
    from scae_tpu_torch.parallel.train_step import (
        decode_images,
        make_raw_eval_step,
    )
    from scae_tpu_torch.train.data import pad_to_canvas

    cuda = torch.device("cuda")
    model = make_scae(FLAGSHIP_MODEL_PARAMS, device=cuda, seed=0)
    eval_step = make_raw_eval_step(model, canvas=40, device=cuda)
    infer = serve.make_infer_fn(model, device=cuda)

    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (BATCH, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (BATCH,)).astype(np.int64)
    canvas_images = pad_to_canvas(
        decode_images(torch.from_numpy(images).to(cuda)), 40)

    # the main path: every launch count at 0 just before, read just after.
    # The eval step reads the likelihood (one launch); the infer call
    # returns none of it, and the decoder computes it only when read.
    zero_kernel_counts()
    metrics = eval_step(images, labels)
    served = infer(canvas_images)
    torch.cuda.synchronize()
    check_kernel_counts(card, rows, "the eval path (1 eval step, 1 infer "
                        "call)", {"K1": 1})

    terms = {k: float(v) for k, v in metrics.items()}
    for k, v in terms.items():
        say(f"  eval {k} = {v!r} [{card}]")
        if not math.isfinite(v):
            raise RuntimeError(f"eval term {k} is not finite: {v}")
    for k, v in served.items():
        if not bool(torch.isfinite(v.float()).all()):
            raise RuntimeError(f"infer output {k} is not finite")
    expect = {"part_presence": (BATCH, 40), "part_pose": (BATCH, 40, 6),
              "caps_presence": (BATCH, 32), "prior_cls_prob": (BATCH, 10),
              "posterior_cls_prob": (BATCH, 10), "prediction": (BATCH,),
              "prior_prediction": (BATCH,)}
    for k, shape in expect.items():
        if tuple(served[k].shape) != shape:
            raise RuntimeError(f"infer {k}: shape {tuple(served[k].shape)}"
                               f" != {shape}")

    # the same weights and input through the port on the CPU, where the
    # decoder likelihood takes K1's plain version
    cpu_model = make_scae(FLAGSHIP_MODEL_PARAMS, device="cpu", seed=0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    cpu_terms = make_raw_eval_step(cpu_model, canvas=40, device="cpu")(
        images, labels)
    cpu_served = serve.make_infer_fn(cpu_model, device="cpu")(
        canvas_images.cpu())
    for k, v in terms.items():
        ref = float(cpu_terms[k])
        if k == "accuracy":
            # one borderline example may flip its argmax between devices
            tol, diff = 1.0 / BATCH, abs(v - ref)
        else:
            tol, diff = TERM_RTOL, abs(v - ref) / max(1.0, abs(ref))
        say(f"  card vs CPU {k}: card {v!r} cpu {ref!r} diff {diff:.3e} "
            f"(tolerance {tol:.1e}) [{card}]")
        if not diff <= tol:
            raise RuntimeError(f"{k}: card and CPU differ by {diff}")
    for k in ("part_presence", "part_pose", "caps_presence",
              "prior_cls_prob", "posterior_cls_prob"):
        diff = float((served[k].cpu() - cpu_served[k]).abs().max())
        say(f"  card vs CPU infer {k}: max abs diff {diff:.3e} "
            f"(tolerance {PROB_TOL:.0e}) [{card}]")
        if not diff <= PROB_TOL:
            raise RuntimeError(f"infer {k}: card and CPU differ by {diff}")

    # eval-step time: host clock around steps that end in a synchronize
    warmup, steps = 5, 50
    for _ in range(warmup):
        eval_step(images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        eval_step(images, labels)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    if k1.launches != steps:
        raise RuntimeError(f"K1 launched {k1.launches} times in {steps} "
                           "eval steps")
    say(f"eval step (batch {BATCH}, canvas 40): {dt * 1e3:.4f} ms/step "
        f"(host clock, {steps} steps after {warmup} warm-up), "
        f"{BATCH / dt:.1f} images/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B [{card}]")
    return eval_step, images, labels


# --------------------------------------------------------------- train

KERNELS = ("K1", "K2+K3", "K4f", "K4b")   # in the order of the kernel rows


def kernel_counts():
    """Every kernel's launch count, by kernel id."""
    from scae_tpu_torch.kernels import decoder_ll_dense as k4
    from scae_tpu_torch.kernels import decoder_ll_gather as k1

    return {"K1": k1.launches, "K2+K3": k1.bwd_launches,
            "K4f": k4.launches, "K4b": k4.bwd_launches}


def zero_kernel_counts():
    from scae_tpu_torch.kernels import decoder_ll_dense as k4
    from scae_tpu_torch.kernels import decoder_ll_gather as k1

    k1.launches = k1.bwd_launches = k4.launches = k4.bwd_launches = 0


def check_kernel_counts(card, rows, what, expected):
    """Read every launch count after a run from zero; fail unless each
    equals ``expected`` (0 for a kernel not named); add them to the kernel
    rows' ``launches`` when ``rows`` is given."""
    counts = kernel_counts()
    want = {k: expected.get(k, 0) for k in KERNELS}
    say(f"launches over {what}: "
        + ", ".join(f"{k} {counts[k]}" for k in KERNELS) + f" [{card}]")
    if counts != want:
        raise RuntimeError(f"launches over {what}: {counts}, expected {want}")
    if rows is not None:
        for row, k in zip(rows, KERNELS):
            row["launches"] = (row["launches"] or 0) + counts[k]


def train_state(torch, device, noise, model_params):
    """The model from seed 0 on ``device`` with the harness' optimizer:
    RMSprop, lr 3e-5, momentum 0.9, eps 1e-2/B^2, the learning rate times
    0.997 per epoch of 55,000 MNIST training images. Without ``noise`` the
    presence noise of both encoders is off."""
    from scae_tpu_torch.factory import make_scae
    from scae_tpu_torch.optim import make_optimizer
    from scae_tpu_torch.parallel.train_step import TrainState

    params = dict(model_params)
    if not noise:
        params.update(
            pcae_encoder_params=dict(noise_scale=0.0),
            ocae_decoder_capsule_params=dict(noise_type=None,
                                             noise_scale=0.0))
    model = make_scae(params, device=device, seed=0)
    opt = make_optimizer(model.parameters(), "rmsprop", 3e-5,
                         batch_size=BATCH, momentum=0.9,
                         lr_decay_rate=0.997, decay_steps=55000 // BATCH)
    return TrainState(model, opt, seed=0)


def keep_gradients(state):
    """Make ``state.optimizer.step`` keep a copy of the gradients it gets."""
    kept = []
    step = state.optimizer.step

    def recording(grads):
        kept[:] = [None if g is None else g.detach().clone() for g in grads]
        step(grads)

    state.optimizer.step = recording
    return kept


def card_vs_cpu_step(torch, card, tag, model_params, images, labels,
                     augment, expected):
    """One train step with noise off from the same weights on the card and
    on the CPU: every loss term within TERM_RTOL, every parameter gradient
    within GRAD_RTOL of its largest entry; the card step's launch counts
    must be ``expected``."""
    from scae_tpu_torch.parallel.train_step import make_raw_train_step

    cuda = torch.device("cuda")
    card_state = train_state(torch, cuda, False, model_params)
    cpu_state = train_state(torch, "cpu", False, model_params)
    cpu_state.model.load_state_dict(
        {k: v.cpu() for k, v in card_state.model.state_dict().items()})
    got, want = keep_gradients(card_state), keep_gradients(cpu_state)
    zero_kernel_counts()
    card_terms = make_raw_train_step(card_state, augment, cuda)(images,
                                                                 labels)
    torch.cuda.synchronize()
    check_kernel_counts(card, None, f"the {tag} card-vs-CPU step",
                        expected)
    cpu_terms = make_raw_train_step(cpu_state, augment, "cpu")(images,
                                                               labels)
    batch = len(labels)
    for k, v in card_terms.items():
        v, ref = float(v), float(cpu_terms[k])
        if k == "accuracy":
            tol, diff = 1.0 / batch, abs(v - ref)
        else:
            tol, diff = TERM_RTOL, abs(v - ref) / max(1.0, abs(ref))
        say(f"  {tag} train card vs CPU {k}: card {v!r} cpu {ref!r} diff "
            f"{diff:.3e} (tolerance {tol:.1e}) [{card}]")
        if not (math.isfinite(v) and diff <= tol):
            raise RuntimeError(f"{tag} train {k}: card and CPU differ by "
                               f"{diff}")
    names = [n for n, _ in card_state.model.named_parameters()]
    worst = (0.0, "")
    for name, a, b in zip(names, got, want):
        if a is None or b is None:
            if not (a is None and b is None):
                raise RuntimeError(f"gradient of {name}: card {a is None} "
                                   f"and CPU {b is None} disagree on None")
            continue
        scale = float(b.abs().max())
        err = float((a.cpu() - b).abs().max())
        tol = GRAD_RTOL * scale + 1e-7
        if not (bool(torch.isfinite(a).all()) and err <= tol):
            raise RuntimeError(f"{tag}: gradient of {name}: card and CPU "
                               f"differ by {err} (largest |gradient| "
                               f"{scale}, tolerance {tol})")
        if err / (scale + 1e-30) >= worst[0]:
            worst = (err / (scale + 1e-30), name)
    say(f"  {tag} train card vs CPU (batch {batch}): {len(names)} parameter "
        f"gradients agree, worst {worst[0]:.3e} of its largest |gradient| "
        f"({worst[1]}; tolerance {GRAD_RTOL:.0e}) [{card}]")


def train_phase(torch, card, rows, tag, model_params, per_step):
    """The card-vs-CPU step at CPU_BATCH, then the main path: one real
    step (noise on, translation by up to 6) at batch 128 whose launch
    counts must be ``per_step``, then 5 warm-up and 20 timed steps."""
    import numpy as np

    from scae_tpu_torch.parallel.train_step import make_raw_train_step
    from scae_tpu_torch.train.loop import make_augment_fn

    cuda = torch.device("cuda")
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (BATCH, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (BATCH,)).astype(np.int64)

    card_vs_cpu_step(torch, card, tag, model_params, images[:CPU_BATCH],
                     labels[:CPU_BATCH],
                     make_augment_fn(canvas=40, max_shift=0), per_step)

    state = train_state(torch, cuda, True, model_params)
    step = make_raw_train_step(state, make_augment_fn(canvas=40,
                                                      max_shift=6), cuda)
    zero_kernel_counts()
    metrics = step(images, labels)
    torch.cuda.synchronize()
    check_kernel_counts(card, rows, f"the {tag} train path (1 train step, "
                        f"batch {BATCH})", per_step)
    for k, v in metrics.items():
        say(f"  {tag} train {k} = {float(v)!r} [{card}]")

    warmup, steps = 5, 20
    for _ in range(warmup):
        step(images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_kernel_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(images, labels)["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite {tag} train losses: {losses}")
    counts = kernel_counts()
    if any(counts[k] != steps * per_step.get(k, 0) for k in KERNELS):
        raise RuntimeError(f"launches in {steps} {tag} train steps: "
                           f"{counts}")
    say(f"  {tag} train losses over the timed steps: first {losses[0]!r}, "
        f"last {losses[-1]!r} [{card}]")
    say(f"{tag} train step (batch {BATCH}, 28x28 uint8 -> 40x40, translate "
        f"6, noise on, RMSprop): {dt * 1e3:.4f} ms/step (host clock, "
        f"{steps} steps after {warmup + 1} warm-up), {BATCH / dt:.1f} "
        f"images/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B, of which {held} B were "
        f"held before the timed steps (earlier phases' models included) "
        f"[{card}]")
    return step, images, labels, state.model


def eval_timing(torch, card, rows, tag, model, per_step):
    """The eval step at batch 128 on ``model``: one step whose launch counts
    must be ``per_step``, finite terms, then 5 warm-up and 20 timed steps."""
    import numpy as np

    from scae_tpu_torch.parallel.train_step import make_raw_eval_step

    cuda = torch.device("cuda")
    eval_step = make_raw_eval_step(model, canvas=40, device=cuda)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (BATCH, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (BATCH,)).astype(np.int64)
    zero_kernel_counts()
    metrics = eval_step(images, labels)
    torch.cuda.synchronize()
    check_kernel_counts(card, rows, f"the {tag} eval path (1 eval step, "
                        f"batch {BATCH})", per_step)
    for k, v in metrics.items():
        say(f"  {tag} eval {k} = {float(v)!r} [{card}]")
        if not math.isfinite(float(v)):
            raise RuntimeError(f"{tag} eval term {k} is not finite")
    warmup, steps = 5, 20
    for _ in range(warmup):
        eval_step(images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        eval_step(images, labels)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    say(f"{tag} eval step (batch {BATCH}, canvas 40): {dt * 1e3:.4f} ms/step "
        f"(host clock, {steps} steps after {warmup} warm-up), "
        f"{BATCH / dt:.1f} images/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B [{card}]")
    return eval_step, images, labels


def cifar10_phase(torch, card):
    """One train step of the shipped cifar10 model (M=64, C=3: K2+K3 splits
    its capsules over two blocks) with noise off, card against CPU."""
    import numpy as np

    from scae_tpu_torch.factory import CIFAR10_MODEL_PARAMS

    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (CPU_BATCH, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, (CPU_BATCH,)).astype(np.int64)
    card_vs_cpu_step(torch, card, "cifar10", CIFAR10_MODEL_PARAMS, images,
                     labels, None, {"K1": 1, "K2+K3": 1})


def profile_phase(torch, name, step, images, labels, n, card):
    """Device time by kernel name over ``n`` steps, and the device's busy
    time per step beside the step's host-clock time under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    step(images, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(images, labels)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    # the device-side events (kernels, copies, fills) alone: an operator's
    # row repeats the time of the kernels it launched
    busy_ms = sum(getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0)
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / n
    say(f"profile of {n} {name} step(s): device busy {busy_ms:.4f} ms per "
        f"step, host clock {host_ms:.4f} ms per step under the profiler, "
        f"idle share {1 - busy_ms / host_ms:.1%} [{card}]")
    say(events.table(sort_by="cuda_time_total", row_limit=25))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of the eval and "
                         "train steps")
    args = ap.parse_args(argv)

    import torch

    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS
    from scae_tpu_torch.kernels import _build
    from scae_tpu_torch.kernels import decoder_ll_dense as k4
    from scae_tpu_torch.kernels import decoder_ll_gather as k1

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only "
              "on a CUDA card", file=sys.stderr, flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("env"):
        say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, device "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        card = gpu_name_and_power_limit()
        say(f"nvidia-smi: {card}")
        nvcc = _build.find_nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, check=True, timeout=60)
        say(f"nvcc {nvcc}: {version.stdout.strip().splitlines()[-1]}")

    with phase("build"):
        sources = {"K1": (k1, k1.SOURCE), "K2+K3": (k1, k1.BWD_SOURCE),
                   "K4f": (k4, k4.SOURCE), "K4b": (k4, k4.BWD_SOURCE)}
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            built = dict(zip(sources, pool.map(
                lambda ms: ms[0].build_info(ms[1]), sources.values())))
        for kernel, info in built.items():
            say(f"{kernel} library {info.path}: built in {info.seconds:.2f} s"
                f" (cached: {info.cached}), nvcc "
                f"{' '.join(_build.NVCC_FLAGS)}, loaded with ctypes")
            for line in info.log.splitlines():
                if any(w in line for w in ("registers", "spill",
                                           "Compiling")):
                    say(f"  ptxas: {line.strip()}")

    with phase("kernel"):
        rows = [kernel_phase(torch, card), bwd_kernel_phase(torch, card),
                *dense_kernel_phase(torch, card)]

    with phase("slice"):
        eval_step, images, labels = slice_phase(torch, card, rows)

    with phase("train"):
        train_step, train_images, train_labels, _ = train_phase(
            torch, card, rows, "gather", FLAGSHIP_MODEL_PARAMS,
            {"K1": 1, "K2+K3": 1})

    with phase("pallas"):
        pallas_params = dict(FLAGSHIP_MODEL_PARAMS,
                             pcae_decoder_params=dict(fused_impl="pallas"))
        pallas_step, _, _, pallas_model = train_phase(
            torch, card, rows, "pallas", pallas_params,
            {"K4f": 1, "K4b": 1})
        pallas_eval, _, _ = eval_timing(torch, card, rows, "pallas",
                                        pallas_model, {"K4f": 1})

    with phase("cifar10"):
        cifar10_phase(torch, card)

    if args.profile:
        with phase("profile"):
            profile_phase(torch, "eval", eval_step, images, labels, 5, card)
            profile_phase(torch, "train", train_step, train_images,
                          train_labels, 5, card)
            profile_phase(torch, "pallas eval", pallas_eval, images, labels,
                          5, card)
            profile_phase(torch, "pallas train", pallas_step, train_images,
                          train_labels, 5, card)

    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
