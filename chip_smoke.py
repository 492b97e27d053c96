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
          K1 is the gather forward (decoder likelihood; also at the
          cifar10 shape and at poses that put pixels on texel centres and
          edges), K2+K3 its backward (also at the cifar10 shape, M=64,
          C=3, and at the identity and zero poses, each case twice for the
          same bits; the two printed beside their previous designs' times,
          with their occupancy and waves); K4f and K4b the dense forward and
          backward (fused_impl="pallas"), also at the identity and zero
          poses and at a 17x17 template, K4b run twice for the same bits;
          K5f and K5b the banded ones (fused_impl="pallas_banded") at the
          flagship, cifar10, M=13, edge and off-canvas poses (empty row
          windows), identity and zero poses, 17x17 templates and
          per-example alpha, K5b twice for the same bits (K4b and K5b are
          one run-scatter kernel, printed beside their previous designs'
          times and timed at the cifar10 shape too); K6 the set
          attention at the flagship's two shapes, with soft presences and
          with a set whose presence is all 0, twice for the same bits,
          beside PyTorch's scaled_dot_product_attention on the same inputs
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
  banded  the same train phase with fused_impl="pallas_banded" (K5f and
          K5b) and the set transformer's use_pallas_attention (K6, four
          launches per step: three set-attention blocks and the final
          attention), and its eval step at batch 128
  cifar10 one train step of the shipped cifar10 model (3x32x32, M=64) with
          noise off at batch 32 on the card and on the CPU, through K1 and
          K2+K3
  probe   the toolchain probes P1 (x * 2 + 1) and P2 (a float32 product)
          against their plain versions, timed beside torch.matmul; the
          probe entry point (python -m scae_tpu_torch.tools.probe) in this
          process, where it must launch each probe once, and as a
          subprocess, which must exit 0
  trainer the training CLI (scae_tpu_torch.train.cli.main) with the shipped
          model=mnist config at full width (bf16 convs, fused_impl auto) on
          synthetic data cut to 2,048 training images: 2 epochs, a resume
          to epoch 3, then mode=test; the metrics JSONL, the image grids,
          train_seed.json, the resume step and the per-class recall are
          checked, and K1 and K2+K3 must launch once per train step (K1
          also once per eval batch, never in the grids' forward); the
          median images/s of the logged chunks and the peak memory. Then 4
          steps at batch 32 with noise and translation off and f32 convs,
          on the card and on the CPU: their per-step JSONL losses within
          1e-3 relative; and the same 4 steps on the card interrupted after
          2 and resumed, against the uninterrupted card run

Every number is printed beside the card's name and power limit. Imports
torch, numpy, the standard library and scae_tpu_torch only. Exits
non-zero, with no result line, when CUDA is absent or any check fails. The
line before the last is the card's name and power limit; before it, a JSON
line of per-kernel numbers (K1-K6, P1 and P2); the last line is the JSON
result.
"""

import argparse
import concurrent.futures
import contextlib
import json
import io
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 128            # eval and train batch of the flagship
CPU_BATCH = 32         # batch of the card-vs-CPU train-step comparison
KERNEL_TOL = 1e-4      # abs, kernel vs its plain version (f32 ulps of O(10))
# backward kernel vs its plain version, relative to each output's largest
# |entry| (for the three 0-d scalar gradients, to max(|value|, 1)): both are
# f32 sums over pixels (and, for alpha, examples) taken in other orders
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
    Operations per (capsule, pixel) pair: the function's work, as it was
    fixed when K1 was first ported and kept since, so that the shares of
    every design of the kernel compare (a design's own work, such as the
    copies of the persistent kernel, is not counted):
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
    or its small PyTorch kernels (zeroing, the alpha sum) on the card.

    The time is the mean over the launches the profiler recorded. On the
    card's machine it now and then records fewer than were made (windows
    of 200 launches have read 193 to 199 of one kernel); such a window is
    reported with the positions of the launches that lack a record
    (``unrecorded_launches``), and one that recorded none, or more than
    ``iters``, is an error. A small fill kernel opens and closes the
    window."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.empty(1, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        marker.zero_()
        for _ in range(iters):
            fn()
        marker.zero_()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in events)
    if not 0 < count <= iters:
        raise RuntimeError(f"{count} profiler records match {kernel} over "
                           f"{iters} launches")
    if count < iters:
        say(f"the profiler recorded {count} of the {iters} launches of "
            f"{kernel}; the time is the mean over those {count}. "
            f"{unrecorded_launches(torch, prof)}")
    total_us = sum(getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0.0) for e in events)
    return total_us / count / 1e3


def unrecorded_launches(torch, prof):
    """Which kernel launches of a profiler window have no device record:
    their positions, in launch order, among all the window's launches
    (the opening fill kernel is the first), from the runtime calls'
    correlation ids."""
    try:
        raw = list(prof.profiler.kineto_results.events())
    except AttributeError:
        return "Which launches lack a record is not known here."
    cuda = torch.autograd.DeviceType.CUDA
    recorded = {e.correlation_id() for e in raw if e.device_type() == cuda}
    launches = sorted((e for e in raw if e.name() == "cudaLaunchKernel"),
                      key=lambda e: e.start_ns())
    lost = [i for i, e in enumerate(launches)
            if e.correlation_id() not in recorded]
    spans = []
    for i in lost:
        if spans and spans[-1][1] == i - 1:
            spans[-1][1] = i
        else:
            spans.append([i, i])
    where = ", ".join(f"{a}" if a == b else f"{a}-{b}" for a, b in spans)
    return (f"{len(lost)} of the window's {len(launches)} kernel launches "
            f"have no device record: {where or 'none'}.")


# Device time per launch of the redesigned kernels' previous designs at the
# flagship, as PERF.md section 6 records them (NVIDIA H100 80GB HBM3, 700 W;
# K1 and K2+K3 before PR 9, K4b and K5b before PR 10): the yardstick the
# redesigned kernels are printed beside.
PREVIOUS_MS = {"K1": (0.0593, 0.0606), "K2+K3": (0.5929, 0.6075),
               "K4b": (0.6580, 0.6623), "K5b": (0.6667, 0.6711)}
IDENTITY_POSE = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
ZERO_POSE = [0.0] * 6


def occupancy(torch, blocks_per_sm, blocks):
    """Blocks per SM, the card's slots for them and the waves a grid of
    ``blocks`` takes, as text."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = blocks_per_sm * sms
    return (f"{blocks_per_sm} blocks per SM "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor) x {sms} SMs = "
            f"{slots} slots, {blocks} blocks: {blocks / slots:.2f} waves")


def yardstick(kernel, ms, bound_ms):
    lo, hi = PREVIOUS_MS[kernel]
    return (f"previous design {lo:.4f}-{hi:.4f} ms per launch (recorded, "
            f"PERF.md section 6; roofline share {bound_ms / hi:.1%}-"
            f"{bound_ms / lo:.1%}), this design {ms:.4f} ms "
            f"({ms / lo:.1%} of the previous design's best)")


def kernel_phase(torch, card):
    from scae_tpu_torch.kernels import decoder_ll_gather as k1

    cases = [
        # (name, shape, pose noise, edge, fixed pose)
        ("flagship", FLAGSHIP_SHAPE, 0.6, False, None),
        ("edge: raw pose noise 4.0, zero presences, degenerate poses, M=13",
         (BATCH, 13, 1, 11, 11, 40, 40), 4.0, True, None),
        ("colour: C=3, 14x14 templates, >48 KB shared memory",
         (16, 16, 3, 14, 14, 32, 32), 0.6, False, None),
        ("cifar10: M=64, C=3, two 93 KB example buffers", CIFAR10_SHAPE,
         0.6, False, None),
        ("identity pose, 11x11 canvas: coordinates on texel centres",
         (BATCH, 40, 1, 11, 11, 11, 11), 0.6, False, IDENTITY_POSE),
        ("twice the scale, 22x22 canvas: coordinates on texel edges",
         (BATCH, 40, 1, 11, 11, 22, 22), 0.6, False,
         [2.0, 0.0, 0.0, 0.0, 2.0, 0.0]),
        ("zero pose: every coordinate the template's centre",
         FLAGSHIP_SHAPE, 0.6, False, ZERO_POSE),
    ]
    flagship_err = None
    for name, shape, noise, edge, fixed in cases:
        args = k1_inputs(torch, shape, seed=1, pose_noise=noise, edge=edge,
                         fixed_pose=fixed)
        buffers = k1.forward_buffers(*shape[1:5])
        smem = k1.shared_memory_bytes(*shape[1:5], buffers=buffers)
        got = k1.decoder_ll_gather(*args)
        torch.cuda.synchronize()
        want = k1.decoder_ll_gather_plain(*args)
        for g in got:
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"K1 {name}: non-finite output")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        say(f"K1 {name} {shape}: {buffers} example buffer(s), shared memory "
            f"{smem} B, max abs err {err:.3e} (tolerance {KERNEL_TOL:.0e}) "
            f"[{card}]")
        if not err < KERNEL_TOL:
            raise RuntimeError(f"K1 {name}: max abs err {err} exceeds "
                               f"{KERNEL_TOL}")
        if flagship_err is None:
            flagship_err = err

    args = k1_inputs(torch, FLAGSHIP_SHAPE, seed=2)
    ms = kernel_device_ms(torch, lambda: k1.decoder_ll_gather(*args),
                          "decoder_ll_gather_fwd_kernel")
    call_ms = time_cuda(torch, lambda: k1.decoder_ll_gather(*args),
                        iters=200, warmup=20)
    plain_ms = time_cuda(torch, lambda: k1.decoder_ll_gather_plain(*args),
                         iters=20, warmup=3)
    bound_ms, bound_by, n_bytes, ops = k1_bound_ms(FLAGSHIP_SHAPE)
    B, M, C, Ht, Wt, H, W = FLAGSHIP_SHAPE
    buffers = k1.forward_buffers(M, C, Ht, Wt)
    per_sm = k1.blocks_per_sm(k1.SOURCE, M, C, Ht, Wt, 0, buffers)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    items = B * k1.forward_tiles(H * W)
    blocks = min(items, per_sm * sms)
    say(f"K1 flagship time: kernel {ms:.4f} ms (device time per launch over "
        f"200 launches, torch.profiler), wrapper call {call_ms:.4f} ms (200 "
        f"back-to-back calls, CUDA events), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us by "
        f"{bound_by} ({n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP), "
        f"library_ms: none (no single PyTorch call computes this), "
        f"roofline share {bound_ms / ms:.1%}; "
        f"{yardstick('K1', ms, bound_ms)}; persistent grid: "
        f"{occupancy(torch, per_sm, blocks)}, {items} items of "
        f"{-(-H * W // k1.forward_tiles(H * W))} pixels, "
        f"{items / blocks:.2f} per block [{card}]")
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
    Operations per (capsule, pixel) pair: the function's work, as it was
    fixed when the backward was first ported and kept since, so that the
    shares of every design of the kernel compare (the run scatter's keys,
    run sums and tap-by-tap writes of the present designs, K2+K3's and
    K4b's and K5b's, are their own cost and are not counted; the four
    scatter products and adds below are the template gradient's, whichever
    way it is summed):
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


def cifar10_bwd_time(torch, card, name, fwd, bwd, kernel, note,
                     layout=None):
    """Prints a backward kernel's device time per launch at its main-path
    call (upstream gradient -1/B, no target gradient) on the cifar10 shape
    at batch 128, beside bwd_bound_ms of those inputs; ``layout`` turns the
    inputs into the kernel's own (the banded wrapper's sort and pad)."""
    cifar = (BATCH,) + CIFAR10_SHAPE[1:]
    raw = k1_inputs(torch, cifar, seed=2)
    args = layout(raw) if layout else raw
    _, num, den = fwd(*args)
    g = torch.full((BATCH, 3, 32, 32), -1.0 / BATCH, device="cuda")
    ms = kernel_device_ms(
        torch, lambda: bwd(g, num, den, *args, target_grad=False), kernel)
    bound = bwd_bound_ms(torch, raw, target_grad=False)
    say(f"{name} cifar10 time {cifar}: kernel {ms:.4f} ms (device time per "
        f"launch over 200 launches, torch.profiler; {note}), bound "
        f"{bound[0] * 1e3:.2f} us by {bound[1]} ({bound[3] / 1e9:.3f} GFLOP), "
        f"roofline share {bound[0] / ms:.1%} [{card}]")


def bwd_kernel_phase(torch, card):
    """The backward kernel against the plain backward (autograd of K1's
    plain version) at K1's shapes, with per-example alpha, at the cifar10
    shape and at the identity and zero poses; every case run twice for the
    same bits; its time."""
    import numpy as np

    from scae_tpu_torch.kernels import decoder_ll_gather as k1

    cases = [
        # (name, shape, pose noise, edge, per-example alpha, fixed pose)
        ("flagship", FLAGSHIP_SHAPE, 0.6, False, False, None),
        ("edge: raw pose noise 4.0, zero presences, degenerate poses, M=13",
         (BATCH, 13, 1, 11, 11, 40, 40), 4.0, True, False, None),
        ("colour: C=3, 14x14 templates", (16, 16, 3, 14, 14, 32, 32), 0.6,
         False, False, None),
        ("per-example alpha", FLAGSHIP_SHAPE, 0.6, False, True, None),
        ("cifar10: M=64, C=3, 11x11", CIFAR10_SHAPE, 0.6, False, False,
         None),
        ("identity pose, 11x11 canvas: coordinates on texel centres",
         (BATCH, 40, 1, 11, 11, 11, 11), 0.6, False, False, IDENTITY_POSE),
        ("zero pose: every coordinate the template's centre",
         FLAGSHIP_SHAPE, 0.6, False, False, ZERO_POSE),
    ]
    flagship_err = None
    for name, shape, noise, edge, alpha_batched, fixed in cases:
        args = k1_inputs(torch, shape, seed=1, pose_noise=noise, edge=edge,
                         alpha_batched=alpha_batched, fixed_pose=fixed)
        B, C, H, W = shape[0], shape[2], shape[5], shape[6]
        g = torch.from_numpy(np.random.RandomState(3).randn(
            B, C, H, W).astype(np.float32) / B).cuda()
        _, num, den = k1.decoder_ll_gather(*args)
        got = k1.decoder_ll_gather_bwd(g, num, den, *args)
        again = k1.decoder_ll_gather_bwd(g, num, den, *args)
        torch.cuda.synchronize()
        want = k1.decoder_ll_gather_bwd_plain(g, num, den, *args)
        smem = k1.bwd_shared_memory_bytes(*shape[2:5])
        worst = 0.0
        for out, a, b, c in zip(GRAD_NAMES, got, want, again):
            if not bool(torch.isfinite(a).all()):
                raise RuntimeError(f"K2+K3 {name}: non-finite {out}")
            if not torch.equal(a, c):
                raise RuntimeError(f"K2+K3 {name}: d{out} differs between "
                                   "two runs on the same inputs")
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
            # (the zero pose's pose gradient is 0 everywhere, on both sides)
            worst = max(worst, err / scale if scale else err)
        say(f"K2+K3 {name}: one block of {k1.BWD_WARPS} warps per (capsule, "
            f"example), shared memory {smem} B, worst relative err "
            f"{worst:.3e}, a second run bit-identical [{card}]")
        if flagship_err is None:
            flagship_err = max(float((a - b).abs().max())
                               for a, b in zip(got, want))

    # the main path's call: the loss's constant upstream gradient -1/B,
    # no target gradient; and the same call at the cifar10 shape, batch 128
    cifar10_bwd_time(torch, card, "K2+K3", k1.decoder_ll_gather,
                     k1.decoder_ll_gather_bwd, "decoder_ll_gather_bwd_kernel",
                     "the previous design took 1.5733-1.5896 ms, PERF.md "
                     "section 6")

    args = k1_inputs(torch, FLAGSHIP_SHAPE, seed=2)
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
    B, M, C, Ht, Wt, H, W = FLAGSHIP_SHAPE
    per_sm = k1.blocks_per_sm(k1.BWD_SOURCE, C, Ht, Wt)
    say(f"K2+K3 flagship time: kernel {ms:.4f} ms (device time per launch "
        f"over 200 launches, torch.profiler), wrapper call {call_ms:.4f} ms "
        f"(200 back-to-back calls, CUDA events, with the sums of the scalar "
        f"terms and of alpha's gradient over the batch), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us by "
        f"{bound_by} ({n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP, "
        f"{n_hit} of {BATCH * 40 * 1600} capsule-pixel pairs touch their "
        f"template), library_ms: none (no single PyTorch call computes "
        f"this), roofline share {bound_ms / ms:.1%}; "
        f"{yardstick('K2+K3', ms, bound_ms)}; grid (M + 1, B): "
        f"{occupancy(torch, per_sm, (M + 1) * B)} [{card}]")
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

    identity, zero = IDENTITY_POSE, ZERO_POSE
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
    # same count of what these inputs need; the run scatter's bookkeeping
    # (keys, run sums, the writes tap by tap) is this kernel's own cost
    bound_ms, bound_by, n_bytes, ops, n_hit = bwd_bound_ms(
        torch, args, target_grad=False)
    say(f"K4b flagship time: kernel {ms:.4f} ms (device time per launch "
        f"over 200 launches, torch.profiler), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us by {bound_by} ({n_bytes / 1e6:.2f} MB, "
        f"{ops / 1e9:.3f} GFLOP: bwd_bound_ms's count, {n_hit} of "
        f"{BATCH * 40 * 1600} capsule-pixel pairs touch their template; the "
        f"run scatter's keys, run sums and tap-by-tap writes not counted), "
        f"library_ms: none, roofline share {bound_ms / ms:.1%}; "
        f"{yardstick('K4b', ms, bound_ms)} [{card}]")
    cifar10_bwd_time(torch, card, "K4b", k4.decoder_ll_dense_fwd,
                     k4.decoder_ll_dense_bwd, "decoder_ll_dense_bwd_kernel",
                     "the previous design was not timed at this shape")
    rows.append(dict(name="decoder_ll_dense_bwd", route="cuda",
                     source="scae_tpu_torch/csrc/decoder_ll_dense_bwd.cu",
                     replaces="scae_tpu/ops/pallas_decoder_ll.py:414",
                     launches=None, max_abs_err=errs["bwd"], ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None))
    return rows


# ------------------------------------------------------------ K5f, K5b

def banded_kernel_phase(torch, card):
    """K5f and K5b against their plain version (ops/decoder_ll.py with f32
    taps, the y-taps masked by the row windows) on the wrapper's sorted,
    padded inputs, at the main path's shape and at edge shapes, K5b twice
    for the same bits; their times."""
    import numpy as np

    from scae_tpu_torch.kernels import decoder_ll_banded as k5

    identity, zero = IDENTITY_POSE, ZERO_POSE
    cases = [
        # (name, shape, pose noise, edge, per-example alpha, fixed pose)
        ("flagship", FLAGSHIP_SHAPE, 0.6, False, False, None),
        ("cifar10: M=64, C=3, 4 bands", (BATCH,) + CIFAR10_SHAPE[1:], 0.6,
         False, False, None),
        ("edge: raw pose noise 4.0, zero presences, degenerate poses, M=13 "
         "(padded to 16)", (BATCH, 13, 1, 11, 11, 40, 40), 4.0, True, False,
         None),
        ("off canvas: every row window empty", (BATCH, 40, 1, 11, 11, 40, 40),
         0.6, False, False, [1.0, 0.0, 3.0, 0.0, 1.0, 3.0]),
        ("identity pose, 11x11 canvas: coordinates at texel centres",
         (BATCH, 40, 1, 11, 11, 11, 11), 0.6, False, False, identity),
        ("zero pose: every coordinate the template's centre",
         FLAGSHIP_SHAPE, 0.6, False, False, zero),
        ("17x17 templates", (32, 40, 1, 17, 17, 40, 40), 0.6, False, False,
         None),
        ("per-example alpha", FLAGSHIP_SHAPE, 0.6, False, True, None),
    ]
    errs = {}
    for name, shape, noise, edge, alpha_batched, fixed in cases:
        args = k1_inputs(torch, shape, seed=1, pose_noise=noise, edge=edge,
                         alpha_batched=alpha_batched, fixed_pose=fixed)
        args = (*k5.sort_and_pad(*args[:4]), *args[4:])
        B, C, H, W = shape[0], shape[2], shape[5], shape[6]
        win = k5.h_windows(args[2], shape[3], H, W, k5.band_rows(H, W))
        trips = win[..., 1].float()
        got = k5.decoder_ll_banded_fwd(*args)
        torch.cuda.synchronize()
        want = k5.decoder_ll_banded_plain(*args)
        for x in got:
            if not bool(torch.isfinite(x).all()):
                raise RuntimeError(f"K5f {name}: non-finite output")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        say(f"K5f {name} {shape}: {tuple(win.shape[1:3])} bands x groups, "
            f"window rows mean {float(trips.mean()):.2f} of {shape[3]}, "
            f"{int((trips == 0).sum())} empty windows, shared memory "
            f"{k5.shared_memory_bytes(*shape[2:5])} B, max abs err "
            f"{err:.3e} (tolerance {KERNEL_TOL:.0e}) [{card}]")
        if not err < KERNEL_TOL:
            raise RuntimeError(f"K5f {name}: max abs err {err} exceeds "
                               f"{KERNEL_TOL}")
        errs.setdefault("fwd", err)

        g = torch.from_numpy(np.random.RandomState(3).randn(
            B, C, H, W).astype(np.float32) / B).cuda()
        _, num, den = got
        out = k5.decoder_ll_banded_bwd(g, num, den, *args)
        again = k5.decoder_ll_banded_bwd(g, num, den, *args)
        torch.cuda.synchronize()
        ref = k5.decoder_ll_banded_bwd_plain(g, num, den, *args)
        worst = 0.0
        for grad_name, a, b, c in zip(GRAD_NAMES, out, ref, again):
            if not bool(torch.isfinite(a).all()):
                raise RuntimeError(f"K5b {name}: non-finite {grad_name}")
            if not torch.equal(a, c):
                raise RuntimeError(f"K5b {name}: d{grad_name} differs "
                                   "between two runs on the same inputs")
            scale = float(b.abs().max())
            if b.dim() == 0:
                scale = max(scale, 1.0)
            gerr = float((a - b).abs().max())
            tol = BWD_TOL * scale
            if not gerr <= tol:
                raise RuntimeError(f"K5b {name}: d{grad_name} max abs err "
                                   f"{gerr} exceeds {tol}")
            worst = max(worst, gerr / scale if scale else gerr)
        say(f"K5b {name} {shape}: shared memory "
            f"{k5.bwd_shared_memory_bytes(*shape[2:5])} B, worst err "
            f"{worst:.3e} of each gradient's largest |entry| (tolerance "
            f"{BWD_TOL:.0e}), a second run bit-identical [{card}]")
        errs.setdefault("bwd", max(float((a - b).abs().max())
                                   for a, b in zip(out, ref)))

    raw = k1_inputs(torch, FLAGSHIP_SHAPE, seed=2)
    args = (*k5.sort_and_pad(*raw[:4]), *raw[4:])
    ms = kernel_device_ms(torch, lambda: k5.decoder_ll_banded_fwd(*args),
                          "decoder_ll_banded_fwd_kernel")
    plain_ms = time_cuda(torch, lambda: k5.decoder_ll_banded_plain(*args),
                         iters=10, warmup=2)
    # the same function on the same inputs as K1's and K4f's: their count
    bound_ms, bound_by, n_bytes, ops = k1_bound_ms(FLAGSHIP_SHAPE)
    say(f"K5f flagship time: kernel {ms:.4f} ms (device time per launch over "
        f"200 launches, torch.profiler), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us by {bound_by} ({n_bytes / 1e6:.2f} MB, "
        f"{ops / 1e9:.3f} GFLOP: K1's count), library_ms: none, roofline "
        f"share {bound_ms / ms:.1%} [{card}]")
    rows = [dict(name="decoder_ll_banded_fwd", route="cuda",
                 source="scae_tpu_torch/csrc/decoder_ll_banded.cu",
                 replaces="scae_tpu/ops/pallas_decoder_ll_banded.py:523",
                 launches=None, max_abs_err=errs["fwd"], ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None)]

    # the main path's call: upstream gradient -1/B, no target gradient
    _, num, den = k5.decoder_ll_banded_fwd(*args)
    g = torch.full((BATCH, 1, 40, 40), -1.0 / BATCH, device="cuda")

    def main_path_call():
        return k5.decoder_ll_banded_bwd(g, num, den, *args,
                                        target_grad=False)

    ms = kernel_device_ms(torch, main_path_call,
                          "decoder_ll_banded_bwd_kernel")
    plain_ms = time_cuda(torch, lambda: k5.decoder_ll_banded_bwd_plain(
        g, num, den, *args, target_grad=False), iters=10, warmup=2)
    # K2+K3's and K4b's count on the unsorted inputs: the same function
    bound_ms, bound_by, n_bytes, ops, n_hit = bwd_bound_ms(
        torch, raw, target_grad=False)
    say(f"K5b flagship time: kernel {ms:.4f} ms (device time per launch "
        f"over 200 launches, torch.profiler), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us by {bound_by} ({n_bytes / 1e6:.2f} MB, "
        f"{ops / 1e9:.3f} GFLOP: bwd_bound_ms's count, {n_hit} of "
        f"{BATCH * 40 * 1600} capsule-pixel pairs touch their template; "
        f"K4b's run scatter, with its window tests, not counted), "
        f"library_ms: none, roofline share {bound_ms / ms:.1%}; "
        f"{yardstick('K5b', ms, bound_ms)} [{card}]")
    cifar10_bwd_time(torch, card, "K5b", k5.decoder_ll_banded_fwd,
                     k5.decoder_ll_banded_bwd, "decoder_ll_banded_bwd_kernel",
                     "the previous design was not timed at this shape",
                     layout=lambda a: (*k5.sort_and_pad(*a[:4]), *a[4:]))
    rows.append(dict(name="decoder_ll_banded_bwd", route="cuda",
                     source="scae_tpu_torch/csrc/decoder_ll_banded_bwd.cu",
                     replaces="scae_tpu/ops/pallas_decoder_ll_banded.py:549",
                     launches=None, max_abs_err=errs["bwd"], ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None))
    return rows


# ------------------------------------------------------------------ K6

ATTENTION_SHAPES = (   # (B*H, N, M, d_k, d_v) of the flagship's attentions
    ("set-attention block (x3 per step)", (BATCH, 40, 40, 16, 16)),
    ("final attention (x1 per step)", (BATCH, 32, 40, 256, 256)),
)


def attention_bound_ms(shape):
    """Least time of K6 on the card: the larger of bytes moved over the
    memory rate and f32 operations over the f32 rate.

    Bytes: Q, K, V and presence read once, the output written once.
    Operations: 2 d_k per score (its dot product), 4 per score for the
    mask and the scaling (1 - p, times 1e9, subtract, divide), 5 per score
    for the softmax (max, subtract, exp, sum, divide), 2 d_v per score for
    the weighted sum of the values.
    """
    B, N, M, dk, dv = shape
    n_bytes = 4 * (B * N * dk + B * M * dk + B * M * dv + B * M + B * N * dv)
    ops = B * N * M * (2 * dk + 9 + 2 * dv)
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, ops


ATTENTION_PRESENCES = {  # kind: what it checks
    "soft": "soft presences (one-hot softmax: the 1e9 penalties of "
            "presences in [0, 1) dwarf every score)",
    "zero": "one set all absent (uniform weights, no NaN)",
    "ones": "all present, as qkv_attention builds for no presence (the "
            "weights follow the scores)",
    "binary": "presences 0 or 1 (the weights follow the scores)",
    "near one": "presences 1 or the two f32 values below it (penalties 60 "
                "and 119: the order of mask and scale shows at d_k 256)",
}


def attention_inputs(torch, shape, seed, kind):
    """Q, K, V from N(0, 1) and (B, M) presences of one kind of
    ``ATTENTION_PRESENCES``, on the card."""
    import numpy as np

    B, N, M, dk, dv = shape
    rng = np.random.RandomState(seed)
    p = rng.rand(B, M)
    if kind == "zero":
        p[0] = 0.0
    elif kind == "ones":
        p = np.ones((B, M))
    elif kind == "binary":
        p = (p < 0.5).astype(np.float64)
    elif kind == "near one":
        p = 1.0 - np.floor(p * 3) * 2.0 ** -24
    return [torch.from_numpy(np.asarray(a, np.float32)).cuda() for a in
            (rng.randn(B, N, dk), rng.randn(B, M, dk), rng.randn(B, M, dv),
             p)]


def attention_kernel_phase(torch, card):
    """K6 against its plain version at the flagship's two shapes, under
    each kind of presence of ``ATTENTION_PRESENCES``, twice for the same
    bits; its time, the plain version's, and that of PyTorch's
    scaled_dot_product_attention on the same inputs (the library column,
    never called by the port)."""
    from scae_tpu_torch.kernels import attention as k6

    worst, times = 0.0, {}
    for label, shape in ATTENTION_SHAPES:
        for kind, what in ATTENTION_PRESENCES.items():
            args = attention_inputs(torch, shape, 1, kind)
            got = k6.attention(*args)
            again = k6.attention(*args)
            torch.cuda.synchronize()
            want = k6.attention_plain(*args)
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"K6 {label}: non-finite output")
            if not torch.equal(got, again):
                raise RuntimeError(f"K6 {label}: two runs differ")
            err = float((got - want).abs().max())
            say(f"K6 {label} {shape}, {what}: shared memory "
                f"{k6.shared_memory_bytes(*shape[1:])} B, max abs err "
                f"{err:.3e} (tolerance {KERNEL_TOL:.0e}), a second run "
                f"bit-identical [{card}]")
            if not err < KERNEL_TOL:
                raise RuntimeError(f"K6 {label}: max abs err {err} exceeds "
                                   f"{KERNEL_TOL}")
            worst = max(worst, err)
        args = attention_inputs(torch, shape, 2, "binary")
        q, k, v, p = args
        mask = (-(1.0 - p) * 1e9 / math.sqrt(shape[3]))[:, None, :] \
            .expand(shape[0], shape[1], shape[2]).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_err = float((sdpa(q, k, v, attn_mask=mask)
                          - k6.attention_plain(*args)).abs().max())
        ms = kernel_device_ms(torch, lambda: k6.attention(*args),
                              "attention_fwd_kernel")
        plain_ms = time_cuda(torch, lambda: k6.attention_plain(*args),
                             iters=50, warmup=5)
        library_ms = time_cuda(torch, lambda: sdpa(q, k, v, attn_mask=mask),
                               iters=200, warmup=20)
        bound_ms, bound_by, n_bytes, ops = attention_bound_ms(shape)
        say(f"K6 {label} time: kernel {ms:.4f} ms (device time per launch "
            f"over 200 launches, torch.profiler), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {library_ms:.4f} ms (200 calls, "
            f"CUDA events, TF32 off, max abs diff from the plain version "
            f"{sdpa_err:.3e}), bound {bound_ms * 1e3:.2f} us by {bound_by} "
            f"({n_bytes / 1e6:.2f} MB, {ops / 1e9:.4f} GFLOP), roofline "
            f"share {bound_ms / ms:.1%} [{card}]")
        times[label] = (ms, plain_ms, library_ms, bound_ms, bound_by)
    # the row: the final attention, the largest of the four launches
    ms, plain_ms, library_ms, bound_ms, bound_by = times[
        ATTENTION_SHAPES[1][0]]
    return dict(name="attention_fwd", route="cuda",
                source="scae_tpu_torch/csrc/attention.cu",
                replaces="scae_tpu/ops/pallas_attention.py:99",
                launches=None, max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


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

# in the order of the kernel rows
KERNELS = ("K1", "K2+K3", "K4f", "K4b", "K5f", "K5b", "K6", "P1", "P2")


def kernel_counts():
    """Every kernel's launch count, by kernel id."""
    from scae_tpu_torch.kernels import attention as k6
    from scae_tpu_torch.kernels import decoder_ll_banded as k5
    from scae_tpu_torch.kernels import decoder_ll_dense as k4
    from scae_tpu_torch.kernels import decoder_ll_gather as k1
    from scae_tpu_torch.kernels import probe as kp

    return {"K1": k1.launches, "K2+K3": k1.bwd_launches,
            "K4f": k4.launches, "K4b": k4.bwd_launches,
            "K5f": k5.launches, "K5b": k5.bwd_launches, "K6": k6.launches,
            "P1": kp.affine_launches, "P2": kp.matmul_launches}


def zero_kernel_counts():
    from scae_tpu_torch.kernels import attention as k6
    from scae_tpu_torch.kernels import decoder_ll_banded as k5
    from scae_tpu_torch.kernels import decoder_ll_dense as k4
    from scae_tpu_torch.kernels import decoder_ll_gather as k1
    from scae_tpu_torch.kernels import probe as kp

    k1.launches = k1.bwd_launches = k4.launches = k4.bwd_launches = 0
    k5.launches = k5.bwd_launches = k6.launches = 0
    kp.affine_launches = kp.matmul_launches = 0


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


def train_state(torch, device, noise, model_params, attention=False):
    """The model from seed 0 on ``device`` with the harness' optimizer:
    RMSprop, lr 3e-5, momentum 0.9, eps 1e-2/B^2, the learning rate times
    0.997 per epoch of 55,000 MNIST training images. Without ``noise`` the
    presence noise of both encoders is off. ``attention``: the set
    transformer's use_pallas_attention on (K6), set on the built model as
    the JAX package's testing-only flag is (the factory has no knob)."""
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
    model.obj_encoder.use_pallas_attention = attention
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
                     augment, expected, attention=False):
    """One train step with noise off from the same weights on the card and
    on the CPU: every loss term within TERM_RTOL, every parameter gradient
    within GRAD_RTOL of its largest entry; the card step's launch counts
    must be ``expected``."""
    from scae_tpu_torch.parallel.train_step import make_raw_train_step

    cuda = torch.device("cuda")
    card_state = train_state(torch, cuda, False, model_params, attention)
    cpu_state = train_state(torch, "cpu", False, model_params, attention)
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


def train_phase(torch, card, rows, tag, model_params, per_step,
                attention=False):
    """The card-vs-CPU step at CPU_BATCH, then the main path: one real
    step (noise on, translation by up to 6) at batch 128 whose launch
    counts must be ``per_step``, then 5 warm-up and 20 timed steps.
    ``attention``: the set transformer's use_pallas_attention on."""
    import numpy as np

    from scae_tpu_torch.parallel.train_step import make_raw_train_step
    from scae_tpu_torch.train.loop import make_augment_fn

    cuda = torch.device("cuda")
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (BATCH, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (BATCH,)).astype(np.int64)

    card_vs_cpu_step(torch, card, tag, model_params, images[:CPU_BATCH],
                     labels[:CPU_BATCH],
                     make_augment_fn(canvas=40, max_shift=0), per_step,
                     attention)

    state = train_state(torch, cuda, True, model_params, attention)
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
    """One train step of the shipped cifar10 model (M=64, C=3) with noise
    off, card against CPU."""
    import numpy as np

    from scae_tpu_torch.factory import CIFAR10_MODEL_PARAMS

    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (CPU_BATCH, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, (CPU_BATCH,)).astype(np.int64)
    card_vs_cpu_step(torch, card, "cifar10", CIFAR10_MODEL_PARAMS, images,
                     labels, None, {"K1": 1, "K2+K3": 1})


# --------------------------------------------------------------- probe

def probe_bounds():
    """Least times of P1 and P2 at the probe's shapes, each the larger of
    bytes over the memory rate and f32 operations over the f32 rate.
    P1: 4,096 bytes read and 4,096 written, 2 operations per element.
    P2: a, b read and the product written once (512 KB), 2 K operations
    (a multiply and an add) per output element."""
    out = {}
    for name, n_bytes, ops in (
            ("P1", 4 * 2 * 8 * 128, 2 * 8 * 128),
            ("P2", 4 * (256 * 128 + 128 * 256 + 256 * 256),
             2 * 256 * 128 * 256)):
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     n_bytes, ops)
    return out


def probe_phase(torch, card, rows):
    """P1 and P2 against their plain versions at the probe's shapes and at
    ragged ones; their times beside the bound, the plain version and
    torch.matmul; the probe entry point in this process (the main path:
    each probe launched once) and as a subprocess (exit code 0). Appends
    rows P1 and P2."""
    import numpy as np

    from scae_tpu_torch.kernels import probe as kp
    from scae_tpu_torch.tools import probe as probe_tool

    cuda = torch.device("cuda")
    x_np, a_np, b_np = probe_tool.probe_inputs()
    rng = np.random.RandomState(3)
    affine_cases = [("probe (8, 128)", x_np),
                    ("ragged (1000, 777), N(0, 100)",
                     (rng.randn(1000, 777) * 100).astype(np.float32))]
    matmul_cases = [("probe (256, 128) x (128, 256)", a_np, b_np),
                    ("ragged (100, 37) x (37, 53)",
                     rng.randn(100, 37).astype(np.float32),
                     rng.randn(37, 53).astype(np.float32))]
    errs = {}
    for name, xa in affine_cases:
        x = torch.from_numpy(xa).to(cuda)
        got = kp.affine_probe(x)
        torch.cuda.synchronize()
        err = float((got - kp.affine_probe_plain(x)).abs().max())
        say(f"P1 {name}: max abs err {err:.3e} against x * 2 + 1 "
            f"(tolerance 0: one rounding either way) [{card}]")
        if err != 0.0:
            raise RuntimeError(f"P1 {name}: max abs err {err}")
        errs.setdefault("P1", err)
    for name, aa, ba in matmul_cases:
        a, b = torch.from_numpy(aa).to(cuda), torch.from_numpy(ba).to(cuda)
        got = kp.matmul_probe(a, b)
        torch.cuda.synchronize()
        err = float((got - kp.matmul_probe_plain(a, b)).abs().max())
        say(f"P2 {name}: max abs err {err:.3e} against torch.matmul "
            f"(f32, TF32 off; tolerance {KERNEL_TOL:.0e}, the JAX probe's "
            f"atol) [{card}]")
        if not err < KERNEL_TOL:
            raise RuntimeError(f"P2 {name}: max abs err {err} exceeds "
                               f"{KERNEL_TOL}")
        errs.setdefault("P2", err)
    try:
        kp.matmul_probe(torch.from_numpy(a_np).to(cuda),
                        torch.from_numpy(a_np).to(cuda))
    except ValueError as e:
        say(f"P2 refuses (256, 128) x (256, 128): {e}")
    else:
        raise RuntimeError("P2 took mismatched inner sizes")

    # the main path: the probe's entry point, every count 0 before it
    zero_kernel_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = probe_tool.main(device=cuda)
    torch.cuda.synchronize()
    for line in out.getvalue().splitlines():
        say(f"  probe: {line}")
    if rc != 0:
        raise RuntimeError(f"the probe entry point returned {rc}")
    check_kernel_counts(card, None, "the probe entry point",
                        {"P1": 1, "P2": 1})
    probe_counts = kernel_counts()

    proc = subprocess.run(
        [sys.executable, "-m", "scae_tpu_torch.tools.probe"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in (proc.stdout + proc.stderr).strip().splitlines():
        say(f"  python -m scae_tpu_torch.tools.probe: {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"python -m scae_tpu_torch.tools.probe exited "
                           f"{proc.returncode}")

    x = torch.from_numpy(x_np).to(cuda)
    a, b = torch.from_numpy(a_np).to(cuda), torch.from_numpy(b_np).to(cuda)
    # one elementwise launch computing 1 + 2 * x: 2 * x is exact, so the
    # sum is rounded once, as in P1
    one = torch.ones((), device=cuda)
    bounds = probe_bounds()
    for kid, fn, plain, kernel, library, what in (
            ("P1", lambda: kp.affine_probe(x),
             lambda: kp.affine_probe_plain(x), "probe_affine_kernel",
             lambda: torch.add(one, x, alpha=2), "torch.add(1, x, alpha=2)"),
            ("P2", lambda: kp.matmul_probe(a, b),
             lambda: kp.matmul_probe_plain(a, b), "probe_matmul_kernel",
             lambda: torch.matmul(a, b), "torch.matmul")):
        lib_err = float((library() - plain()).abs().max())
        if lib_err > (0.0 if kid == "P1" else KERNEL_TOL):
            raise RuntimeError(f"{kid}: {what} differs from the plain "
                               f"version by {lib_err}")
        ms = kernel_device_ms(torch, fn, kernel)
        plain_ms = time_cuda(torch, plain, iters=200, warmup=20)
        library_ms = time_cuda(torch, library, iters=200, warmup=20)
        bound_ms, bound_by, n_bytes, ops = bounds[kid]
        say(f"{kid} time: kernel {ms:.4f} ms (device time per launch over "
            f"200 launches, torch.profiler), plain {plain_ms:.4f} ms (200 "
            f"calls, CUDA events), library {what} {library_ms:.4f} ms "
            f"(200 calls, CUDA events; {lib_err:.1e} from the plain "
            f"version), bound {bound_ms * 1e6:.2f} ns by {bound_by} "
            f"({n_bytes} B, "
            f"{ops} FLOP), roofline share {bound_ms / ms:.2%} [{card}]")
        rows.append(dict(
            name="probe_affine" if kid == "P1" else "probe_matmul",
            route="cuda", source="scae_tpu_torch/csrc/probe.cu",
            replaces="tools/pallas_probe.py:" + ("17" if kid == "P1"
                                                 else "39"),
            launches=probe_counts[kid], max_abs_err=errs[kid], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms))


# ------------------------------------------------------------- trainer

# the JAX package's JSONL names of a train record of the mnist config
TRAIN_KEYS = ("rec_ll_loss", "log_prob_loss", "prior_within_sparsity_loss",
              "prior_between_sparsity_loss",
              "posterior_within_sparsity_loss",
              "posterior_between_sparsity_loss", "cpr_dynamic_reg_loss",
              "prior_cls_xe", "posterior_cls_xe", "accuracy", "loss",
              "images_per_sec", "learning_rate")
LOSS_KEYS = TRAIN_KEYS[:9] + ("loss",)
TRAINER_RTOL = 1e-3    # card vs CPU and resumed vs straight, per-step losses


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def train_records(records):
    return [r for r in records if "images_per_sec" in r]


def run_cli(cli, argv, device=None):
    """``cli.main(argv)``, its printed lines echoed; (result, output)."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = cli.main(argv, device=device)
    for line in out.getvalue().splitlines():
        say(f"  cli: {line}")
    return result, out.getvalue()


def training_wall_time(out):
    """(images, seconds, images/s) of the line a Trainer run prints: its
    trained images over its training wall time, evals excluded."""
    m = re.search(r"trained (\d+) images in (\S+) s of training wall time"
                  r".*: (\S+) images/s", out)
    if m is None:
        raise RuntimeError("the CLI printed no training wall time")
    return int(m.group(1)), float(m.group(2)), float(m.group(3))


def trainer_phase(torch, card, rows, tmp):
    """The training CLI on the shipped mnist config (full width) over
    synthetic data: 2 epochs, a resume to epoch 3, mode=test; the launch
    counts of each, the JSONL, grids, seed record and recall."""
    from scae_tpu_torch.kernels import decoder_ll_gather as k1
    from scae_tpu_torch.train import cli, loop
    from scae_tpu_torch.train.checkpoint import CheckpointManager

    base = ["model=mnist", "data_loader.source=synthetic",
            "data_loader.synthetic_train=2560", "data_loader.val_size=512",
            "data_loader.synthetic_test=512", "trainer.max_epochs=2",
            "trainer.log_every_steps=5", "trainer.max_eval_batches=2",
            f"trainer.checkpoint_dir={tmp}/ckpt",
            f"trainer.log_dir={tmp}/logs"]
    jsonl = os.path.join(tmp, "logs", "metrics.jsonl")

    # the grids' forward must launch no kernel: it reads only the modes
    write_viz = loop.Trainer.write_viz
    viz_calls = []

    def counted_write_viz(self, *args, **kw):
        before = kernel_counts()
        write_viz(self, *args, **kw)
        torch.cuda.synchronize()
        if kernel_counts() != before:
            raise RuntimeError(f"the grids' forward launched kernels: "
                               f"{before} -> {kernel_counts()}")
        viz_calls.append(1)

    loop.Trainer.write_viz = counted_write_viz
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_kernel_counts()
        t0 = time.perf_counter()
        state, out = run_cli(cli, base)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        trained, train_s, train_rate = training_wall_time(out)
        peak = torch.cuda.max_memory_allocated()
        records = read_jsonl(jsonl)
        train = train_records(records)
        evals = [r for r in records if "val_loss" in r]
        steps = state.step
        if steps != 2 * 16 or len(evals) != 2 or len(viz_calls) != 2:
            raise RuntimeError(f"2 epochs ran {steps} steps (expected 32), "
                               f"{len(evals)} evals, {len(viz_calls)} "
                               "grid writes (expected 2 each)")
        check_kernel_counts(card, rows, f"the trainer CLI ({steps} train "
                            f"steps, {len(evals)} evals of 2 batches)",
                            {"K1": steps + 2 * len(evals), "K2+K3": steps})
        for r in train:
            missing = [k for k in TRAIN_KEYS if k not in r]
            if missing:
                raise RuntimeError(f"JSONL train record at step {r['step']} "
                                   f"lacks {missing}")
            if not all(math.isfinite(r[k]) for k in TRAIN_KEYS):
                raise RuntimeError(f"non-finite JSONL record {r}")
        images = sorted(os.listdir(os.path.join(tmp, "logs", "images")))
        for kind in ("reconstructions", "templates",
                     "transformed_templates"):
            if not any(n.startswith(kind + "_step") for n in images):
                raise RuntimeError(f"no {kind} grid among {images}")
        if not os.path.exists(os.path.join(tmp, "ckpt", "train_seed.json")):
            raise RuntimeError("train_seed.json was not written")
        if trained != steps * BATCH:
            raise RuntimeError(f"the CLI reports {trained} trained images "
                               f"for {steps} steps of {BATCH}")
        rates = [r["images_per_sec"] for r in train]
        # the first chunk (cuDNN's warm-up) and its share of the training
        # wall time
        warm_s = train[0]["step"] * BATCH / rates[0]
        say(f"trainer CLI, model=mnist (batch {BATCH}, 2,048 synthetic "
            f"training images, 2 epochs = {steps} steps in "
            f"{len(train)} logged chunks, 2 evals of 2 batches, grids, "
            f"checkpoints): {seconds!r} s in all; end to end "
            f"{train_rate!r} images/s ({trained} images over {train_s!r} s "
            f"of training wall time, from each period's first dispatch to "
            f"its last read; the other {seconds - train_s!r} s are set-up, "
            f"evals, grids and checkpoints); the first chunk (cuDNN's "
            f"warm-up) takes {warm_s!r} s of it, "
            f"{warm_s / train_s:.1%}; images_per_sec median "
            f"{statistics.median(rates):.1f} over the chunks (each: "
            + ", ".join(f"{v:.1f}" for v in rates) + f"); losses first "
            f"{train[0]['loss']!r}, last {train[-1]['loss']!r}; "
            f"max_memory_allocated {peak} B, of which {held} B were held "
            f"before (earlier phases' models included) [{card}]")

        saved = CheckpointManager(os.path.join(tmp, "ckpt")).latest_step
        zero_kernel_counts()
        state, out = run_cli(cli, base + ["trainer.max_epochs=3",
                                          "resume=true"])
        torch.cuda.synchronize()
        resumed = train_records(read_jsonl(jsonl))[len(train):]
        if (saved != 32 or f"resumed from step {saved}" not in out
                or resumed[0]["step"] != saved + 5 or state.step != 48):
            raise RuntimeError(f"resume: saved {saved}, first logged step "
                               f"{resumed[0]['step']}, final {state.step}")
        check_kernel_counts(card, rows, "the resumed trainer CLI (16 train "
                            "steps, 1 eval of 2 batches)",
                            {"K1": 16 + 2, "K2+K3": 16})
        trained, train_s, train_rate = training_wall_time(out)
        say(f"trainer CLI resume: from step {saved} to {state.step}, first "
            f"logged step {resumed[0]['step']}, end to end "
            f"{train_rate!r} images/s ({trained} images over {train_s!r} s "
            f"of training wall time), images_per_sec median "
            f"{statistics.median(r['images_per_sec'] for r in resumed):.1f}"
            f" [{card}]")

        zero_kernel_counts()
        metrics, out = run_cli(cli, base + ["mode=test"])
        torch.cuda.synchronize()
        recalls = [k for k in metrics if k.startswith("test_class")]
        if "per-class recall:" not in out or len(recalls) < 2:
            raise RuntimeError(f"mode=test printed no per-class recall: "
                               f"{sorted(metrics)}")
        for k, v in metrics.items():
            if not math.isfinite(v):
                raise RuntimeError(f"test metric {k} = {v}")
        check_kernel_counts(card, rows, "mode=test (4 eval batches; the "
                            "recall pass reads no likelihood)", {"K1": 4})
        say(f"trainer CLI mode=test: test_loss {metrics['test_loss']!r}, "
            f"test_accuracy {metrics['test_accuracy']!r} [{card}]")
    finally:
        loop.Trainer.write_viz = write_viz


def trainer_card_vs_cpu_phase(torch, card, tmp):
    """4 steps at batch 32 with noise and translation off and f32 convs on
    the card and on the CPU from the same seed: per-step JSONL losses
    within TRAINER_RTOL; then the card run interrupted after 2 steps and
    resumed, against the uninterrupted one (within the same tolerance; it
    was set while K2+K3 added through atomics, whose order changed the last
    bits from run to run; the kernel is now deterministic, and the gap the
    line prints says whether anything else, such as cuDNN's choice of
    algorithm, still moves them)."""
    from scae_tpu_torch.config import load_config
    from scae_tpu_torch.train import cli, loop

    def overrides(tag):
        return ["model=mnist", "data_loader.source=synthetic",
                "data_loader.batch_size=32",
                "data_loader.synthetic_train=160", "data_loader.val_size=32",
                "data_loader.synthetic_test=32", "trainer.max_epochs=1",
                "trainer.log_every_steps=1", "trainer.max_eval_batches=1",
                "trainer.augment.max_shift=0",
                "model.pcae_encoder_params.noise_scale=0.0",
                "model.ocae_decoder_capsule_params.noise_type=null",
                "model.ocae_decoder_capsule_params.noise_scale=0.0",
                "model.pcae_cnn_encoder_params.compute_dtype=null",
                f"trainer.checkpoint_dir={tmp}/{tag}/ckpt",
                f"trainer.log_dir={tmp}/{tag}/logs"]

    def losses(tag):
        return train_records(read_jsonl(
            os.path.join(tmp, tag, "logs", "metrics.jsonl")))

    run_cli(cli, overrides("card"))
    run_cli(cli, overrides("cpu"), device="cpu")
    trainer = loop.Trainer(load_config("config", overrides("split")))
    try:
        trainer.run(max_steps=2)
    finally:
        trainer.close()
    run_cli(cli, overrides("split") + ["resume=true"])
    on_card, on_cpu, split = losses("card"), losses("cpu"), losses("split")
    if [r["step"] for r in on_card] != [1, 2, 3, 4] or \
            [r["step"] for r in split] != [1, 2, 3, 4] or len(on_cpu) != 4:
        raise RuntimeError(f"steps logged: card "
                           f"{[r['step'] for r in on_card]}, resumed "
                           f"{[r['step'] for r in split]}")
    for what, got, want in (("card vs CPU", on_card, on_cpu),
                            ("card resumed after 2 vs straight", split,
                             on_card)):
        worst = (0.0, None, None)
        for g, w in zip(got, want):
            for k in LOSS_KEYS:
                gap = abs(g[k] - w[k]) / max(1.0, abs(w[k]))
                if gap >= worst[0]:
                    worst = (gap, k, g["step"])
                if not gap <= TRAINER_RTOL:
                    raise RuntimeError(f"trainer {what}: {k} at step "
                                       f"{g['step']}: {g[k]!r} vs {w[k]!r}")
        say(f"trainer {what} (batch 32, 4 steps, noise and translation "
            f"off, f32 convs, TF32 off): per-step losses "
            + ", ".join(f"{g['loss']!r}/{w['loss']!r}"
                        for g, w in zip(got, want))
            + f"; largest gap {worst[0]:.3e} relative to max(1, |ref|) "
            f"({worst[1]} at step {worst[2]}; tolerance "
            f"{TRAINER_RTOL:.0e}) [{card}]")


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
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0)
                  for e in device) / 1e3 / n
    per_step = sum(e.count for e in device) / n
    say(f"profile of {n} {name} step(s): device busy {busy_ms:.4f} ms per "
        f"step, {per_step:.1f} device operations (kernels, copies, fills) "
        f"per step, host clock {host_ms:.4f} ms per step under the "
        f"profiler, idle share {1 - busy_ms / host_ms:.1%} [{card}]")
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
    from scae_tpu_torch.kernels import attention as k6
    from scae_tpu_torch.kernels import decoder_ll_banded as k5
    from scae_tpu_torch.kernels import decoder_ll_dense as k4
    from scae_tpu_torch.kernels import decoder_ll_gather as k1
    from scae_tpu_torch.kernels import probe as kp

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
        sources = {"K1": (k1.build_info, k1.SOURCE),
                   "K2+K3": (k1.build_info, k1.BWD_SOURCE),
                   "K4f": (k4.build_info, k4.SOURCE),
                   "K4b": (k4.build_info, k4.BWD_SOURCE),
                   "K5f": (k5.build_info, k5.SOURCE),
                   "K5b": (k5.build_info, k5.BWD_SOURCE),
                   "K6": (lambda _: k6.build_info(), k6.SOURCE),
                   "P1+P2": (lambda _: kp.build_info(), kp.SOURCE)}
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            built = dict(zip(sources, pool.map(
                lambda fs: fs[0](fs[1]), sources.values())))
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
                *dense_kernel_phase(torch, card),
                *banded_kernel_phase(torch, card),
                attention_kernel_phase(torch, card)]

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

    with phase("banded"):
        banded_params = dict(
            FLAGSHIP_MODEL_PARAMS,
            pcae_decoder_params=dict(fused_impl="pallas_banded"))
        banded_step, _, _, banded_model = train_phase(
            torch, card, rows, "banded", banded_params,
            {"K5f": 1, "K5b": 1, "K6": 4}, attention=True)
        banded_eval, _, _ = eval_timing(torch, card, rows, "banded",
                                        banded_model, {"K5f": 1, "K6": 4})

    with phase("cifar10"):
        cifar10_phase(torch, card)

    with phase("probe"):
        probe_phase(torch, card, rows)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        with phase("trainer"):
            trainer_phase(torch, card, rows, os.path.join(tmp, "flagship"))
        with phase("trainer card vs cpu"):
            trainer_card_vs_cpu_phase(torch, card, tmp)

    if args.profile:
        with phase("profile"):
            profile_phase(torch, "eval", eval_step, images, labels, 5, card)
            profile_phase(torch, "train", train_step, train_images,
                          train_labels, 5, card)
            profile_phase(torch, "pallas eval", pallas_eval, images, labels,
                          5, card)
            profile_phase(torch, "pallas train", pallas_step, train_images,
                          train_labels, 5, card)
            profile_phase(torch, "banded eval", banded_eval, images, labels,
                          5, card)
            profile_phase(torch, "banded train", banded_step, train_images,
                          train_labels, 5, card)

    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
