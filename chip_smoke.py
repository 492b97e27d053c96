#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``scae_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # the run that proves the port
    python3 chip_smoke.py --profile  # adds torch.profiler breakdowns of
                                     # the eager steps and the graph scan
    python3 chip_smoke.py --trainer-steps 8 [--eager-control]
        # only the training CLI's card-vs-CPU comparison over 8 steps,
        # each step's gap printed (a measurement; no result line)
    python3 chip_smoke.py --mesh     # only the mesh phase (no result line)
    python3 chip_smoke.py --tools    # only the tools phase (no result line)
    python3 chip_smoke.py --serve    # only the serve phase, without the
                                     # export tool (no result line)

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
          poses and at a 17x17 template, each run twice for the same bits
          (K4f printed beside its previous design's time with its plan,
          occupancy and waves, and timed at the cifar10 shape too);
          K5f and K5b the banded ones (fused_impl="pallas_banded") at the
          flagship, cifar10, M=13, edge and off-canvas poses (empty row
          windows), identity and zero poses, 17x17 templates and
          per-example alpha, each twice for the same bits (K5f printed
          beside its previous design's time with its plan, registers,
          occupancy and waves; K4b and K5b are one run-scatter kernel,
          printed beside their previous designs' times; all three timed at
          the cifar10 shape too); K6 the set
          attention at the flagship's two shapes under five kinds of
          presence, twice for the same bits, beside PyTorch's
          scaled_dot_product_attention on the same inputs (device time
          from the profiler and CUDA events), its previous design's time,
          its plan, occupancy and waves; V1f and V1b the object
          capsules' vote head (kernels/capsule_votes.py) at the mnist40
          and cifar10 shapes, deterministic and noisy, each twice for the
          same bits, timed beside the plain version and their bound by
          bytes
  slice   the flagship SCAE (1x40x40, M=40, O=32, 11x11 templates), built
          on the card from a seeded generator, through the eval step and
          the infer function at batch 128; the kernels' launch counts over
          that run (V1f, the vote head, in every forward of every phase,
          V1b in every backward; in the Trainer's runs and the tools V1f
          once besides in each forward they make op by op); the same
          weights and input through the port on the CPU, term by term;
          the eval step's time, images per second and peak device memory
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
  graph   the train scan (make_train_scan), which on the card replays a
          CUDA graph of one train step per row, on the three paths at batch
          128 and full width, noise and translation on: gather (K1, K2+K3),
          dense (K4f, K4b) and banded with the attention flag (K5f, K5b,
          K6 x 4). From one state, 8 captured and replayed steps against 8
          eager ones through the fused train step, and a second eager run
          as the control, once with cuDNN's deterministic algorithms and
          once with its default ones: the loss within 1e-4 relative per
          step; each wrapper called once per kernel of a step over the
          graph scan's run (by the capture: a replay calls none) and once
          per step eagerly; with the deterministic ones every loss term
          within 1e-4 and every parameter within 1e-3 of its largest entry
          (the default ones differ between any two runs: the line prints
          the control's gaps beside the graph's). Then the kernels that 5
          replays run, from torch.profiler's device records: each path's
          kernels as often as 5 eager steps launch them. Then 20 steps of
          the eager loop and of the graph scan timed in turns (eager,
          graph, graph, eager): host ms per step, images/s, peak memory.
          Last, RAdam with LookAhead on the gather path: 12 steps whose
          replays take three branch graphs in one memory pool, against
          the eager loop (every term within 1e-4, every parameter within
          1e-3), and the scan's peak memory
  cifar10 one train step of the shipped cifar10 model (3x32x32, M=64) with
          noise off at batch 32 on the card and on the CPU, through K1 and
          K2+K3
  probe   the toolchain probes P1 (x * 2 + 1) and P2 (a float32 product)
          against their plain versions, timed beside torch.add and
          torch.matmul (P2 with its previous design's time, its plan,
          registers, occupancy and waves); the
          probe entry point (python -m scae_tpu_torch.tools.probe) in this
          process, where it must launch each probe once, and as a
          subprocess, which must exit 0
  trainer the training CLI (scae_tpu_torch.train.cli.main) with the shipped
          model=mnist config at full width (bf16 convs, fused_impl auto),
          its scans replaying CUDA graphs, on
          synthetic data cut to 2,048 training images: 2 epochs, a resume
          to epoch 3, then mode=test; the metrics JSONL, the image grids,
          train_seed.json, the resume step and the per-class recall are
          checked, and K1 and K2+K3 must launch for each scan's warm-up
          step and its one capture and nowhere else (never in the grids'
          forward); the median images/s of the logged chunks and the peak
          memory. Then 4 steps at batch 32 with noise and translation off
          and f32 convs, on the card (steps 2-4 replayed) and on the CPU:
          their per-step JSONL losses within 1e-3 relative, and the card's
          within 1e-3 of a card run through the eager loop; and the same 4
          steps on the card interrupted after 2 and resumed, against the
          uninterrupted card run. Then the Trainer's options through the
          CLI on the same data: a seed probe of 2 candidates of 1 epoch
          with template_init=patches (the winner, train_seed.json, each
          candidate's template logits at step 0 against its crops), and a
          run warm-started from its checkpoints (the parameters against
          the source's best) with head_refit (the refit checkpoint at the
          last step + 1, with val_loss, only the posterior head changed);
          K1 and K2+K3 launch for each scan's warm-up steps and capture
          (the counters scan.captures.train and .eval) and nowhere else
  serve   the flagship (the factory's weights from seed 0 on the card)
          exported with serve.export_serving and a polymorphic batch
          twice, on fused_impl="xla" and with use_pallas_attention (K6 by
          name, scae_tpu_torch::attention_fwd); each artifact loaded in a
          fresh interpreter (the xla one with torch and the vote head's
          op alone) and held to the
          live infer function at batch 128 and 65 (predictions equal,
          floats within rtol 1e-4, atol 1e-5), the kernels of one call
          from torch.profiler's records (K6 4 times with the flag, none
          without); the flag-on artifact's K6 launches over its first
          call (4 in its graph's warm-up call, 4 in the capture) and the
          runtime assertions of its program; an artifact exported on the
          CPU and moved to the card against the card's own. Then the
          serving graphs (a CUDA graph replayed per batch size) of the
          two artifacts and of the live infer function with the flag off
          and on, under cuDNN's deterministic algorithms, at batch 128 and
          65: each replay bit for bit the surface's eager call, the first
          call's launches, one capture a batch size, K6 4 times a replay
          in the profiler's records (none without the flag), a call's
          outputs untouched by the next calls; device ms per call, ms per
          call on CUDA events and images/s at batch 128 of each surface,
          eager and graph in turns (eager, graph, graph, eager), and
          tools.bench_serving on the flag-on artifact the same way; then
          python -m scae_tpu_torch.tools.export_model on the refit run's
          checkpoints, which must exit 0. ``--serve`` runs this phase
          alone, without the export tool
  tools   the port's model tools (scae_tpu_torch/tools/) on the card: two
          model=mnist members (full width, f32 convs) trained through the
          CLI for 1 epoch of a synthetic 1,024 / 512 / 256 split shared by
          split_seed; ensemble_eval, ensemble_pool (a group a member,
          --dump-probs), probe_eval (--c-grid 100) and probe_calibrate
          (--c-star, probe_eval's) on them; the card's calibrated
          checkpoint exported with the attention flag at batch 128, then
          verify_serving_readout and bench_serving on it. Each tool on the
          card and with --device cpu. Against the CPU: the models' class
          probabilities within 2e-3 (the probes' printed: their fits stop
          at the iteration cap), the same C*, each accuracy within the
          examples whose argmax the probabilities leave unsettled (top
          two within 2e-3 or twice the gap, or members disagreeing); the
          launch counts (K1 and K2+K3 in the members' graph scans, K6 4 a
          call of the artifact, none in the tools' forwards, which never
          read the likelihood) and each tool's seconds. Then the
          examples: examples.train_resume_demo on the card (2 epochs, a
          resume to 4), and examples.infer_demo on its checkpoint on the
          card and on the CPU (f32 convs): the same predictions,
          confidences within 1e-4. Last, tools.pool_inprocess.train_members
          with two model=mnist members (seeds 3 then 1, the members'
          recipe) under deterministic cuDNN: the second bit for bit seed 1
          trained alone
  mesh    the mesh (parallel/mesh.py) on the one card. Two gloo processes (NCCL
          refuses two ranks on one card) from the state of a one-process run (a
          process of its own too, so that it takes cuDNN's algorithms as the
          ranks do: a process keeps one a shape, and the earlier phases' scans
          searched this one's), f32 convs, TF32 off, deterministic cuDNN, the
          flagship at global batch 128 on the gather path: 2x1 (64 images a
          process) and 1x2 (the capsule banks split by shard_state), 8 eager
          steps each: every step's loss within 2e-3 of one process's, the
          parameters within 1e-3 of each tensor's largest entry after every
          step on 1x2 and after the first on 2x1 (each step's gap printed
          beside a control: one process again under cuDNN's default
          algorithms), the first batch's gradients (entry by entry on 1x2, in
          norm on 2x1, within 1e-3), K1, K2+K3, V1f and V1b once a step on each
          process, each run's host ms and device busy per step beside one
          process's; one 2x1 banded step with the attention flag (K5f 1, K5b 1,
          K6 4 a process). Then the CLI on model=mnist under
          torch.distributed.run with a world-1 NCCL group, whose graphs capture
          the collectives (counted as they are issued into the capture),
          against the CLI with no group, both with the scans' timed search of
          cuDNN's algorithms off (JSONL losses bit for bit, or the gap
          printed); then the CLI on two gloo processes: 2 epochs, a resume,
          mode=test, process 0 alone logging and checkpointing. The step ranks
          also export the flag-on flagship on 2x1 at global batch 128
          (serve.export_serving(mesh=)) and call it: predictions equal to the
          one-process artifact's, every other output within 1e-4 of its largest
          entry, K6 4 and V1f 1 a call on each rank. Last, the CLI with
          trainer.seed_probe.n=2 and head_refit on two gloo processes (the
          probe alone with no group as the reference): the ranks continue the
          same seed, each candidate's score beside one process's, process 0
          alone saves the checkpoints, the refit's once. ``--mesh`` runs this
          phase alone.

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


# Every profiler window opens with LEAD_IN_SPINS launches of PyTorch's spin
# kernel (torch.cuda._sleep, about 0.1 ms each on the H100), which the host
# waits for before the timed calls. On the card's machine torch.profiler
# loses the device records of a window's first launches: 2 to 76 of them in
# most windows, once every one of a 200-launch window of K6. The spins take
# that loss and are never timed. A window that still records nothing of what
# it times is taken again, up to PROFILER_WINDOWS times.
LEAD_IN_SPINS = 8
LEAD_IN_CYCLES = 200_000
SPIN_KERNEL = "spin_kernel"
PROFILER_WINDOWS = 3


def profiler_window(torch, fn, iters):
    """One torch.profiler window over ``iters`` calls of ``fn``, opened by
    the lead-in spins and closed by one more spin."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN_SPINS):
            torch.cuda._sleep(LEAD_IN_CYCLES)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    return prof


def kernel_device_ms(torch, fn, kernel, iters=200, warmup=20):
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel``, over ``iters`` calls of ``fn``, from torch.profiler: the
    kernel alone, without the wrapper's checks and allocations on the host
    or its small PyTorch kernels (zeroing, the alpha sum) on the card.

    The time is the mean over the launches the profiler recorded. A window
    that recorded fewer than were made is reported with the positions of
    the launches that lack a record (``unrecorded_launches``); one that
    recorded none is taken again (``PROFILER_WINDOWS``), and one that
    recorded more than ``iters`` is an error."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for window in range(1, PROFILER_WINDOWS + 1):
        prof = profiler_window(torch, fn, iters)
        events = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in events)
        if count or window == PROFILER_WINDOWS:
            break
        say(f"profiler window {window} of {PROFILER_WINDOWS} recorded no "
            f"launch of {kernel}; {unrecorded_launches(torch, prof)} "
            f"Taking another window.")
    if not 0 < count <= iters:
        raise RuntimeError(f"{count} profiler records match {kernel} over "
                           f"{iters} launches, in the last of {window} "
                           f"windows")
    if count < iters:
        say(f"the profiler recorded {count} of the {iters} launches of "
            f"{kernel}; the time is the mean over those {count}. "
            f"{unrecorded_launches(torch, prof)}")
    total_us = sum(getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0.0) for e in events)
    return total_us / count / 1e3


def device_ms_per_call(torch, fn, iters=200, warmup=20):
    """Device time per call of ``fn``: every device operation (kernels,
    copies, fills) that torch.profiler records over ``iters`` calls, the
    lead-in spins excepted, a library call's counterpart of
    ``kernel_device_ms``. Each operation adds the mean over the records it
    has times its records per call (its count over ``iters``, rounded), so
    that records the profiler loses (see ``profiler_window``) do not bias
    the time down; a loss is reported, and a window with no device
    operation is taken again."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for window in range(1, PROFILER_WINDOWS + 1):
        prof = profiler_window(torch, fn, iters)
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and SPIN_KERNEL not in e.key]
        if device:
            break
        say(f"profiler window {window} of {PROFILER_WINDOWS} recorded no "
            f"device operation of the call; "
            f"{unrecorded_launches(torch, prof)}")
    else:
        raise RuntimeError(f"the profiler recorded no device operation in "
                           f"{PROFILER_WINDOWS} windows")
    total_us = 0.0
    for e in device:
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0.0))
        per_call = round(e.count / iters)
        if per_call == 0:       # not in every call: its share of the calls
            total_us += us / iters
            continue
        if e.count != per_call * iters:
            say(f"the profiler recorded {e.count} of the {per_call * iters} "
                f"records of {e.key} over {iters} calls; its time is the "
                f"mean over those {e.count}")
        total_us += us / e.count * per_call
    return total_us / 1e3


def unrecorded_launches(torch, prof):
    """Which kernel launches of a profiler window have no device record:
    their positions, in launch order, among all the window's launches
    (the ``LEAD_IN_SPINS`` spins are the first), from the runtime calls'
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
# each the range over the calls that timed that design): the yardstick the
# redesigned kernels are printed beside.
PREVIOUS_MS = {"K1": (0.0593, 0.0606), "K2+K3": (0.5929, 0.6075),
               "K4b": (0.6580, 0.6623), "K5b": (0.6667, 0.6711),
               "K4f": (0.0794, 0.0825), "K5f": (0.0710, 0.0750),
               "P2": (0.0044, 0.0045),
               "K6 set-attention block": (0.0114, 0.0116),
               "K6 final attention": (0.0539, 0.0551)}
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
    from portbench.counts.roofline import k1_bound_ms
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

def dense_plan_text(k4, shape):
    """K4f's plan for a shape, as text."""
    p = k4.forward_plan(shape)
    return (f"{p['tiles']} tile(s) of {p['threads']} threads x "
            f"{k4.FWD_PIXELS} pixels, ring of {k4.FWD_STAGES} x "
            f"{p['chunk']} capsules, shared memory {p['smem']} B")


def dense_occupancy_text(torch, k4, shape):
    """K4f's plan for a shape with its blocks per SM and waves."""
    p = k4.forward_plan(shape)
    per_sm = k4.blocks_per_sm(shape[2], shape[3], shape[4], p["threads"],
                              p["chunk"])
    return (f"plan: {dense_plan_text(k4, shape)}; "
            f"{occupancy(torch, per_sm, p['blocks'])}")


def dense_kernel_phase(torch, card):
    """K4f and K4b against their plain version (ops/decoder_ll.py with f32
    taps and its hand-derived backward) at the main path's shape and at
    edge shapes, K4b twice for the same bits; their times."""
    import numpy as np

    from portbench.counts.roofline import k1_bound_ms
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
        repeat = k4.decoder_ll_dense_fwd(*args)
        torch.cuda.synchronize()
        want = k4.decoder_ll_dense_plain(*args)
        for x, y in zip(got, repeat):
            if not bool(torch.isfinite(x).all()):
                raise RuntimeError(f"K4f {name}: non-finite output")
            if not torch.equal(x, y):
                raise RuntimeError(f"K4f {name}: two runs differ")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        say(f"K4f {name} {shape}: {dense_plan_text(k4, shape)}, max abs "
            f"err {err:.3e} (tolerance {KERNEL_TOL:.0e}), a second run "
            f"bit-identical [{card}]")
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
        f"roofline share {bound_ms / ms:.1%}; "
        f"{yardstick('K4f', ms, bound_ms)}; "
        f"{dense_occupancy_text(torch, k4, FLAGSHIP_SHAPE)} [{card}]")
    cifar = (BATCH,) + CIFAR10_SHAPE[1:]
    cifar_args = k1_inputs(torch, cifar, seed=2)
    cifar_ms = kernel_device_ms(
        torch, lambda: k4.decoder_ll_dense_fwd(*cifar_args),
        "decoder_ll_dense_fwd_kernel")
    cifar_bound = k1_bound_ms(cifar)
    say(f"K4f cifar10 time {cifar}: kernel {cifar_ms:.4f} ms (device time "
        f"per launch over 200 launches, torch.profiler; the previous design "
        f"was not timed at this shape), bound {cifar_bound[0] * 1e3:.2f} us "
        f"by {cifar_bound[1]} ({cifar_bound[3] / 1e9:.3f} GFLOP), roofline "
        f"share {cifar_bound[0] / cifar_ms:.1%}; "
        f"{dense_occupancy_text(torch, k4, cifar)} [{card}]")
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

def banded_plan_text(k5, shape):
    """K5f's plan for a shape, as text."""
    p = k5.forward_plan(shape, k5.fwd_registers(shape[2]))
    return (f"{p['bands']} bands x {p['threads']} threads x {p['pixels']} "
            f"pixels, ring of {min(p['chunks'], 2)} x {p['chunk']} capsules "
            f"({p['chunks']} chunk(s)), shared memory {p['smem']} B")


def banded_occupancy_text(torch, k5, shape):
    """K5f's plan for a shape with its registers, blocks per SM and
    waves."""
    B, M, C, Ht, Wt, H, W = shape
    regs = k5.fwd_registers(C)
    p = k5.forward_plan(shape, regs)
    per_sm = k5.blocks_per_sm(C, M, Ht, Wt, p["threads"], p["pixels"],
                              p["chunk"])
    return (f"plan: {banded_plan_text(k5, shape)}, {regs} registers (ring "
            f"sized for {p['register_blocks']} blocks per SM); "
            f"{occupancy(torch, per_sm, p['blocks'])}")


def banded_kernel_phase(torch, card):
    """K5f and K5b against their plain version (ops/decoder_ll.py with f32
    taps, the y-taps masked by the row windows) on the wrapper's sorted,
    padded inputs, at the main path's shape and at edge shapes, K5b twice
    for the same bits; their times."""
    import numpy as np

    from portbench.counts.roofline import k1_bound_ms
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
        repeat = k5.decoder_ll_banded_fwd(*args)
        torch.cuda.synchronize()
        want = k5.decoder_ll_banded_plain(*args)
        for x, y in zip(got, repeat):
            if not bool(torch.isfinite(x).all()):
                raise RuntimeError(f"K5f {name}: non-finite output")
            if not torch.equal(x, y):
                raise RuntimeError(f"K5f {name}: two runs differ")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        padded = (shape[0], args[0].shape[1]) + shape[2:]
        say(f"K5f {name} {shape}: {tuple(win.shape[1:3])} bands x groups, "
            f"window rows mean {float(trips.mean()):.2f} of {shape[3]}, "
            f"{int((trips == 0).sum())} empty windows, "
            f"{banded_plan_text(k5, padded)}, max abs err {err:.3e} "
            f"(tolerance {KERNEL_TOL:.0e}), a second run bit-identical "
            f"[{card}]")
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
        f"share {bound_ms / ms:.1%}; {yardstick('K5f', ms, bound_ms)}; "
        f"{banded_occupancy_text(torch, k5, FLAGSHIP_SHAPE)} [{card}]")
    cifar = (BATCH,) + CIFAR10_SHAPE[1:]
    raw_cifar = k1_inputs(torch, cifar, seed=2)
    cifar_args = (*k5.sort_and_pad(*raw_cifar[:4]), *raw_cifar[4:])
    cifar_ms = kernel_device_ms(
        torch, lambda: k5.decoder_ll_banded_fwd(*cifar_args),
        "decoder_ll_banded_fwd_kernel")
    cifar_bound = k1_bound_ms(cifar)
    say(f"K5f cifar10 time {cifar}: kernel {cifar_ms:.4f} ms (device time "
        f"per launch over 200 launches, torch.profiler; the previous design "
        f"was not timed at this shape), bound {cifar_bound[0] * 1e3:.2f} us "
        f"by {cifar_bound[1]} ({cifar_bound[3] / 1e9:.3f} GFLOP), roofline "
        f"share {cifar_bound[0] / cifar_ms:.1%}; "
        f"{banded_occupancy_text(torch, k5, cifar)} [{card}]")
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


def attention_plan_text(k6, shape):
    """K6's plan for a shape (B, N, M, d_k, d_v), as text."""
    p = k6.plan(*shape[1:])
    return (f"{p['tiles']} tile(s) per batch row of {p['warps']} warps x "
            f"{p['rows_per_warp']} query rows, "
            f"{'16-byte' if p['vec'] else '4-byte'} copies, shared memory "
            f"{p['smem']} B")


def attention_occupancy_text(torch, k6, shape):
    """K6's plan for a shape with its blocks per SM and waves."""
    p = k6.plan(*shape[1:])
    per_sm = k6.blocks_per_sm(*shape[1:], p["rows_per_warp"], p["warps"],
                              p["vec"])
    return (f"plan: {attention_plan_text(k6, shape)}; "
            f"{occupancy(torch, per_sm, shape[0] * p['tiles'])}")


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
            say(f"K6 {label} {shape}, {what}: {attention_plan_text(k6, shape)}"
                f", max abs err {err:.3e} (tolerance {KERNEL_TOL:.0e}), a "
                f"second run bit-identical [{card}]")
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
        library_device_ms = device_ms_per_call(
            torch, lambda: sdpa(q, k, v, attn_mask=mask))
        bound_ms, bound_by, n_bytes, ops = attention_bound_ms(shape)
        short = label.split(" (")[0]
        say(f"K6 {label} time: kernel {ms:.4f} ms (device time per launch "
            f"over 200 launches, torch.profiler), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {library_device_ms:.4f} ms of "
            f"device time per call (every device operation of 200 calls, "
            f"torch.profiler) and {library_ms:.4f} ms per call on CUDA "
            f"events (200 calls; TF32 off, max abs diff from the plain "
            f"version {sdpa_err:.3e}), bound {bound_ms * 1e3:.2f} us by "
            f"{bound_by} ({n_bytes / 1e6:.2f} MB, {ops / 1e9:.4f} GFLOP), "
            f"roofline share {bound_ms / ms:.1%}; "
            f"{yardstick('K6 ' + short, ms, bound_ms)}; "
            f"{attention_occupancy_text(torch, k6, shape)} [{card}]")
        times[label] = (ms, plain_ms, library_device_ms, bound_ms, bound_by)
    # the row: the final attention, the largest of the four launches; its
    # library time is device time, as the kernel's
    ms, plain_ms, library_ms, bound_ms, bound_by = times[
        ATTENTION_SHAPES[1][0]]
    return dict(name="attention_fwd", route="cuda",
                source="scae_tpu_torch/csrc/attention.cu",
                replaces="scae_tpu/ops/pallas_attention.py:99",
                launches=None, max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


# ------------------------------------------------ V1f and V1b (vote head)

VOTE_SHAPES = (("mnist40", (BATCH, 32, 40)), ("cifar10", (BATCH, 32, 64)))
VOTE_RTOL, VOTE_ATOL = 1e-5, 1e-6   # V1f: the plain version's rounding
VOTE_BWD_TOL = 1e-5                 # V1b: of each gradient's largest entry


def vote_inputs(torch, shape, seed, noise):
    """The head's inputs at (B, O, V): all_param in the capsule banks' (O,
    B) row order, as the layer gives it, the own parameters, a capsule
    dropout draw and, with ``noise``, the noise's uniform draws; then
    seeded gradients of the six outputs."""
    B, O, V = shape
    g = torch.Generator().manual_seed(seed)

    def rand(*s, scale=1.0):
        return (torch.randn(s, generator=g) * scale).cuda()

    all_param = rand(O, B, 8 * V + 7, scale=0.7).transpose(0, 1)
    exist = torch.bernoulli(torch.full((B, O, 1), 0.7), generator=g).cuda()
    draws = ((torch.rand(B, O, 1, generator=g).cuda(),
              torch.rand(B, O, V, generator=g).cuda()) if noise
             else (None, None))
    args = (all_param, rand(1, O, V, 6, scale=0.5), rand(1, O, 1, 6,
            scale=0.5), rand(1, O, 1), rand(1, O, V), rand(1, O, V), exist,
            *draws, False, True, True, noise, 4.0)
    grads = [rand(*s) for s in ((B, O, V, 3, 3), (B, O, V), (B, O, V),
                                (B, O, 1), (B, O, V), ())]
    return args, grads


def vote_bound_ms(shape, noise):
    """The least time of V1f and of V1b by bytes (each input read once,
    each output written once; float32) at the H100's 3.35 TB/s."""
    B, O, V = shape
    A = 8 * V + 7
    own = O * A                           # cpr_static and caps_bias_*
    rows = B * O * A                      # all_param, or its gradient
    per_vote = B * O * V
    draws = B * O * (V + 1) if noise else 0
    fwd = 4 * (rows + own + B * O + draws + 9 * per_vote + 3 * per_vote
               + B * O)
    bwd = 4 * (rows + own + B * O + draws + 9 * per_vote + 3 * per_vote
               + B * O + rows + own)
    return fwd / PEAK_BYTES_S * 1e3, bwd / PEAK_BYTES_S * 1e3, fwd, bwd


def capsule_votes_kernel_phase(torch, card):
    """V1f and V1b against the plain version at the mnist40 and cifar10
    shapes (B 128, O 32, V 40 and 64), deterministic and with the uniform
    noise, each twice for the same bits; their device time (every kernel
    of a launch: V1f's and its regulariser's sum, V1b's rows and columns),
    the plain version's forward and forward plus backward, and the bound
    by bytes."""
    from scae_tpu_torch.kernels import capsule_votes as cv

    def through(fn, args, grads):
        leaves = [a.detach().requires_grad_() for a in args[:6]]
        outs = fn(*leaves, *args[6:])
        loss = sum((o * g).sum() for o, g in zip(outs, grads))
        return ([o.detach() for o in outs],
                list(torch.autograd.grad(loss, leaves)))

    worst, row = 0.0, None
    for label, shape in VOTE_SHAPES:
        for noise in (None, "uniform"):
            args, grads = vote_inputs(torch, shape, 1, noise)
            got = through(cv.capsule_votes, args, grads)
            again = through(cv.capsule_votes, args, grads)
            want = through(cv.capsule_votes_plain, args, grads)
            torch.cuda.synchronize()
            for a, b in zip(got[0] + got[1], again[0] + again[1]):
                if not torch.equal(a, b):
                    raise RuntimeError(f"V1 {label}: two runs differ")
            fwd_err = 0.0
            for a, b in zip(got[0], want[0]):
                if not bool(torch.isfinite(a).all()):
                    raise RuntimeError(f"V1f {label}: non-finite output")
                if not torch.allclose(a, b, rtol=VOTE_RTOL, atol=VOTE_ATOL):
                    raise RuntimeError(f"V1f {label}: off the plain version "
                                       f"by {float((a - b).abs().max())}")
                fwd_err = max(fwd_err, float((a - b).abs().max()))
            bwd_err = 0.0
            for a, b in zip(got[1], want[1]):
                err = float((a - b).abs().max()) / float(b.abs().max())
                if not err <= VOTE_BWD_TOL:
                    raise RuntimeError(f"V1b {label}: off the plain version "
                                       f"by {err} of the largest entry")
                bwd_err = max(bwd_err, err)
            say(f"V1f/V1b {label} {shape}, noise {noise}: forward max abs "
                f"err {fwd_err:.3e} (rtol {VOTE_RTOL:.0e}, atol "
                f"{VOTE_ATOL:.0e}), backward {bwd_err:.3e} of the largest "
                f"entry (tolerance {VOTE_BWD_TOL:.0e}); a second run "
                f"bit-identical [{card}]")
            worst = max(worst, fwd_err)

        args, grads = vote_inputs(torch, shape, 2, "uniform")
        leaves = [a.detach().requires_grad_() for a in args[:6]]

        def fwd():
            return cv.capsule_votes(*leaves, *args[6:])

        outs = fwd()

        def bwd():
            torch.autograd.grad(outs, leaves, grads, retain_graph=True)

        def plain_step():
            o = cv.capsule_votes_plain(*leaves, *args[6:])
            torch.autograd.grad(o, leaves, grads)

        ms = {k: kernel_device_ms(torch, f, k) for k, f in (
            ("capsule_votes_fwd_kernel", fwd),
            ("capsule_votes_reg_kernel", fwd),
            ("capsule_votes_bwd_kernel", bwd),
            ("capsule_votes_columns_kernel", bwd))}
        v1f = ms["capsule_votes_fwd_kernel"] + ms["capsule_votes_reg_kernel"]
        v1b = (ms["capsule_votes_bwd_kernel"]
               + ms["capsule_votes_columns_kernel"])
        op_ms = device_ms_per_call(torch, lambda: (fwd(), bwd()))
        plain_fwd_ms = time_cuda(
            torch, lambda: cv.capsule_votes_plain(*leaves, *args[6:]),
            iters=50, warmup=5)
        plain_device_ms = device_ms_per_call(torch, plain_step, iters=50,
                                             warmup=5)
        plain_ms = time_cuda(torch, plain_step, iters=50, warmup=5)
        fwd_bound, bwd_bound, fwd_bytes, bwd_bytes = vote_bound_ms(
            shape, "uniform")
        say(f"V1f/V1b {label} time (device time per launch over 200 "
            f"launches, torch.profiler): V1f {v1f:.4f} ms ("
            f"{ms['capsule_votes_fwd_kernel']:.4f} + regulariser "
            f"{ms['capsule_votes_reg_kernel']:.4f}), bound "
            f"{fwd_bound * 1e3:.2f} us by bytes ({fwd_bytes / 1e6:.2f} MB), "
            f"roofline share {fwd_bound / v1f:.1%}; V1b {v1b:.4f} ms (rows "
            f"{ms['capsule_votes_bwd_kernel']:.4f} + columns "
            f"{ms['capsule_votes_columns_kernel']:.4f}), bound "
            f"{bwd_bound * 1e3:.2f} us ({bwd_bytes / 1e6:.2f} MB), roofline "
            f"share {bwd_bound / v1b:.1%}; every device operation of the op "
            f"forward and backward {op_ms:.4f} ms; the plain version: "
            f"forward {plain_fwd_ms:.4f} ms on CUDA events, forward and "
            f"backward {plain_device_ms:.4f} ms of device time "
            f"(torch.profiler) and {plain_ms:.4f} ms on CUDA events; "
            f"{cv.rows_per_block(shape[2])} rows a block, "
            f"{cv.shared_memory_bytes(shape[2])} B of shared memory "
            f"[{card}]")
        if label == "mnist40":
            row = dict(name="capsule_votes", route="cuda",
                       source="scae_tpu_torch/csrc/capsule_votes.cu",
                       replaces=None, launches=None, max_abs_err=worst,
                       ms=v1f + v1b, plain_ms=plain_ms,
                       bound_ms=fwd_bound + bwd_bound, bound_by="bytes",
                       library_ms=None)
    return row


# ------------------------------- L1f and L1b (capsule mixture likelihood)

LL_SHAPES = (("mnist40", (BATCH, 32, 40)), ("cifar10", (BATCH, 32, 64)))
LL_RTOL, LL_ATOL = 1e-5, 1e-6   # L1f: the plain version's rounding
LL_BWD_TOL = 1e-5               # L1b: of each gradient's largest entry
# L1f's outputs that are PyTorch's bits at these shapes: those of the argmax
# and the comparison, the posterior (torch.softmax's sum in order) and the
# mixing logits and log-probabilities (torch.logsumexp's sum in fours)
LL_EXACT = ("vote_presence_binary", "winner", "winner_presence",
            "is_from_capsule", "posterior_mixing_prob", "mixing_logit",
            "mixing_log_prob")
LL_OUTPUTS = ("log_prob", "vote_presence_binary", "winner",
              "winner_presence", "soft_winner", "soft_winner_presence",
              "posterior_mixing_prob", "mixing_log_prob", "mixing_logit",
              "is_from_capsule")


def likelihood_inputs(torch, shape, seed, grads="all"):
    """The likelihood's inputs at (B, O, M): the votes as the vote head
    leaves them (the (B, O, M, 6) view of 3 x 3 matrices), scales, vote
    presences (a few under log_safe's floor), the dummy vote, part poses
    and presences; then seeded gradients of the outputs that take one:
    every one (``grads="all"``), or log_prob's and the posterior's alone,
    as a training step gives them (``"train"``)."""
    from scae_tpu_torch.kernels import capsule_likelihood as cl

    B, O, M = shape
    g = torch.Generator().manual_seed(seed)

    def rand(*s, scale=1.0):
        return (torch.randn(s, generator=g) * scale).cuda()

    vote = rand(B, O, M, 3, 3, scale=0.5)[..., :-1, :].reshape(B, O, M, 6)
    vp = torch.rand(B, O, M, generator=g)
    vp[vp < 0.02] = 0.0
    args = (vote, (torch.rand(B, O, M, generator=g) * 1.5 + 0.3).cuda(),
            vp.cuda(), rand(1, 1, M, 6, scale=0.5), rand(B, M, 6, scale=0.5),
            torch.rand(B, M, generator=g).cuda())
    shapes = dict(zip(cl.GRAD_OUTPUTS, ((), (B, M, 6), (B, M), (B, M, 6),
                                        (B, M), (B, O, M), (B, O + 1, M),
                                        (B, O + 1, M))))
    kept = (cl.GRAD_OUTPUTS if grads == "all"
            else ("log_prob", "posterior_mixing_prob"))
    return args, [rand(*shapes[n]) if n in kept else None
                  for n in cl.GRAD_OUTPUTS]


def likelihood_through(torch, fn, args, grads):
    """(outputs, gradients of the six inputs) of ``fn`` for a loss that
    weighs each output by its ``grads`` entry (None: left out); presence
    may be None (no gradient)."""
    from scae_tpu_torch.kernels import capsule_likelihood as cl

    leaves = [None if a is None else a.detach().requires_grad_()
              for a in args]
    outs = fn(*leaves)
    loss = sum((outs[LL_OUTPUTS.index(n)] * g).sum()
               for n, g in zip(cl.GRAD_OUTPUTS, grads) if g is not None)
    wrt = [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    return ([o.detach() for o in outs],
            [None if t is None else next(got) for t in leaves])


def likelihood_bound_ms(shape):
    """The least time of L1f, and of L1b in a training step (log_prob's and
    the posterior's gradients), by bytes (each input read once, each output
    written once) at the H100's 3.35 TB/s."""
    B, O, M = shape
    bom, bm = B * O * M, B * M
    inputs = 4 * (6 * bom + 2 * bom + 6 * M + 6 * bm + bm)
    fwd = inputs + 4 * (bom + 6 * bm + bm + 6 * bm + bm + bom
                        + 2 * (bom + bm) + 1) + 8 * bm
    bwd = inputs + 4 * (1 + bom) + 4 * (6 * bom + 2 * bom)
    return fwd / PEAK_BYTES_S * 1e3, bwd / PEAK_BYTES_S * 1e3, fwd, bwd


def capsule_likelihood_kernel_phase(torch, card):
    """L1f and L1b against the plain version at the mnist40 and cifar10
    shapes (B 128, O 32, M 40 and 64), with every output's gradient, with
    a training step's and with presence None, each twice for the same
    bits; their device time (every kernel of a launch: L1f's and log_prob's
    sum; L1b), the plain version's device time and device operations a
    step, and the bound by bytes."""
    from scae_tpu_torch.kernels import capsule_likelihood as cl

    worst, row = 0.0, None
    for label, shape in LL_SHAPES:
        for grads_kind, with_presence in (("all", True), ("train", True),
                                          ("all", False)):
            args, grads = likelihood_inputs(torch, shape, 1, grads_kind)
            if not with_presence:
                args = (*args[:5], None)
            got, again, want = (likelihood_through(torch, fn, args, grads)
                                for fn in (cl.capsule_likelihood,
                                           cl.capsule_likelihood,
                                           cl.capsule_likelihood_plain))
            torch.cuda.synchronize()
            for a, b in zip(got[0] + got[1], again[0] + again[1]):
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    raise RuntimeError(f"L1 {label}: two runs differ")
            fwd_err = 0.0
            for name, a, b in zip(LL_OUTPUTS, got[0], want[0]):
                if name in LL_EXACT:
                    if not torch.equal(a, b):
                        raise RuntimeError(f"L1f {label}: {name} is not the "
                                           f"plain version's")
                    continue
                if not bool(torch.isfinite(a).all()):
                    raise RuntimeError(f"L1f {label}: non-finite {name}")
                if not torch.allclose(a, b, rtol=LL_RTOL, atol=LL_ATOL):
                    raise RuntimeError(f"L1f {label}: {name} off the plain "
                                       f"version by "
                                       f"{float((a - b).abs().max())}")
                fwd_err = max(fwd_err, float((a - b).abs().max()))
            bwd_err = 0.0
            for name, a, b in zip(cl.INPUTS, got[1], want[1]):
                if b is None:
                    if a is not None:
                        raise RuntimeError(f"L1b {label}: a gradient of "
                                           f"{name}, which the plain version "
                                           f"does not reach")
                    continue
                err = float((a - b).abs().max()) / float(b.abs().max())
                if not err <= LL_BWD_TOL:
                    raise RuntimeError(f"L1b {label}: {name} off the plain "
                                       f"version by {err} of its largest "
                                       f"entry")
                bwd_err = max(bwd_err, err)
            if grads_kind == "train":
                # a training step's: autograd of the plain version's bits
                for name, a, b in zip(cl.INPUTS[:3], got[1], want[1]):
                    if not torch.equal(a, b):
                        raise RuntimeError(
                            f"L1b {label}: {name}'s gradient differs from "
                            f"autograd's in {int((a != b).sum())} of "
                            f"{a.numel()} entries")
            say(f"L1f/L1b {label} {shape}, gradients {grads_kind}, presence "
                f"{'given' if with_presence else 'None'}: forward max abs "
                f"err {fwd_err:.3e} (rtol {LL_RTOL:.0e}, atol "
                f"{LL_ATOL:.0e}; {', '.join(LL_EXACT)} exact), backward "
                f"{bwd_err:.3e} of the largest entry (tolerance "
                f"{LL_BWD_TOL:.0e}"
                + ("; the votes', scales' and presences' autograd's bits"
                   if grads_kind == "train" else "")
                + f"); a second run bit-identical [{card}]")
            worst = max(worst, fwd_err)

        # as in a training step: the part poses and presences detached
        args, grads = likelihood_inputs(torch, shape, 2, "train")
        leaves = [a.detach().requires_grad_(i < 4) for i, a in enumerate(args)]
        kept = [(LL_OUTPUTS.index(n), g) for n, g in zip(cl.GRAD_OUTPUTS,
                                                         grads)
                if g is not None]

        def fwd():
            return cl.capsule_likelihood(*leaves)

        outs = fwd()

        def bwd():
            torch.autograd.grad([outs[i] for i, _ in kept], leaves[:3],
                                [g for _, g in kept], retain_graph=True)

        def plain_step():
            o = cl.capsule_likelihood_plain(*leaves)
            torch.autograd.grad([o[i] for i, _ in kept], leaves[:3],
                                [g for _, g in kept])

        ms = {k: kernel_device_ms(torch, f, k) for k, f in (
            ("capsule_likelihood_fwd_kernel", fwd),
            ("capsule_likelihood_sum_kernel", fwd),
            ("capsule_likelihood_bwd_kernel", bwd))}
        l1f = (ms["capsule_likelihood_fwd_kernel"]
               + ms["capsule_likelihood_sum_kernel"])
        l1b = ms["capsule_likelihood_bwd_kernel"]
        op_ms = device_ms_per_call(torch, lambda: (fwd(), bwd()))
        plain_device_ms = device_ms_per_call(torch, plain_step, iters=50,
                                             warmup=5)
        plain_ms = time_cuda(torch, plain_step, iters=50, warmup=5)
        prof = profiler_window(torch, plain_step, 20)
        plain_ops = sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and SPIN_KERNEL not in e.key) / 20
        fwd_bound, bwd_bound, fwd_bytes, bwd_bytes = likelihood_bound_ms(
            shape)
        say(f"L1f/L1b {label} time (device time per launch over 200 "
            f"launches, torch.profiler), a training step's gradients: L1f "
            f"{l1f:.4f} ms ({ms['capsule_likelihood_fwd_kernel']:.4f} + "
            f"log_prob's sum {ms['capsule_likelihood_sum_kernel']:.4f}), "
            f"bound {fwd_bound * 1e3:.2f} us by bytes "
            f"({fwd_bytes / 1e6:.2f} MB), roofline share "
            f"{fwd_bound / l1f:.1%}; L1b {l1b:.4f} ms, bound "
            f"{bwd_bound * 1e3:.2f} us ({bwd_bytes / 1e6:.2f} MB), roofline "
            f"share {bwd_bound / l1b:.1%}; every device operation of the op "
            f"forward and backward {op_ms:.4f} ms; the plain version "
            f"forward and backward: {plain_device_ms:.4f} ms of device time "
            f"in {plain_ops:.1f} device operations (torch.profiler), "
            f"{plain_ms:.4f} ms on CUDA events; {cl.GROUP} lanes a point, "
            f"{cl.blocks(*shape[::2])} blocks of {cl.THREADS} threads, "
            f"{cl.shared_memory_bytes(shape[1])} B of shared memory "
            f"[{card}]")
        if label == "cifar10":
            row = dict(name="capsule_likelihood", route="cuda",
                       source="scae_tpu_torch/csrc/capsule_likelihood.cu",
                       replaces=None, launches=None, max_abs_err=worst,
                       ms=l1f + l1b, plain_ms=plain_ms,
                       bound_ms=fwd_bound + bwd_bound, bound_by="bytes",
                       library_ms=None)
    return row


# --------------------------------------------------------------- slice

def slice_phase(torch, card, rows):
    import numpy as np

    from scae_tpu_torch import serve
    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS, make_scae
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS
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
    # returns none of it, and the decoder computes it only when read. The
    # vote head runs in both: once in the eval step, and in the infer
    # graph's warm-up call and its capture.
    zero_kernel_counts()
    metrics = eval_step(images, labels)
    served = infer(canvas_images)
    torch.cuda.synchronize()
    check_kernel_counts(card, rows, "the eval path (1 eval step, 1 infer "
                        "call)", {"K1": 1, "V1f": 1 + WARMUP_STEPS + 1})

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
    zero_kernel_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        eval_step(images, labels)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    if kernel_counts()["K1"] != steps:
        raise RuntimeError(f"K1 launched {kernel_counts()['K1']} times in "
                           f"{steps} eval steps")
    say(f"eval step (batch {BATCH}, canvas 40): {dt * 1e3:.4f} ms/step "
        f"(host clock, {steps} steps after {warmup} warm-up), "
        f"{BATCH / dt:.1f} images/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B [{card}]")
    return eval_step, images, labels


# --------------------------------------------------------------- train

# the kernel rows, in the order main() builds them, and the launch counters
# each row adds up (V1f and V1b share the capsule_votes row)
KERNEL_ROWS = (("K1",), ("K2+K3",), ("K4f",), ("K4b",), ("K5f",), ("K5b",),
               ("K6",), ("V1f", "V1b"), ("P1",), ("P2",))
KERNELS = tuple(k for ids in KERNEL_ROWS for k in ids)
# the vote head in a train step: its forward once (V1f), its backward once
# (V1b); an eval step or a serving call runs V1f alone
VOTES = {"V1f": 1, "V1b": 1}
# the capsule likelihood's kernels run where the vote head's do, in every
# forward and backward of the object decoder: each id launches (and runs)
# as often as the vote head's id it names; ``kernel_counts`` and
# ``check_kernel_records`` hold them to that
LIKELIHOOD = {"L1f": "V1f", "L1b": "V1b"}


# the counters (utils/trace.py) as zero_kernel_counts last found them
_counted = None


def zero_kernel_counts():
    """Count launches and the scans' captures from zero again."""
    global _counted
    from scae_tpu_torch.utils import trace

    _counted = trace.Since()


def kernel_counts():
    """Every kernel's launches since ``zero_kernel_counts``, by kernel id
    (the counters ``kernels.launches.<id>``); raises unless L1f and L1b
    launched as often as V1f and V1b (``LIKELIHOOD``)."""
    ids = (*KERNELS, *LIKELIHOOD)
    counts = dict(zip(ids, _counted.launches(*ids)))
    for likelihood, votes in LIKELIHOOD.items():
        if counts[likelihood] != counts[votes]:
            raise RuntimeError(f"{likelihood} launched {counts[likelihood]} "
                               f"times, {votes} {counts[votes]}: the object "
                               f"decoder runs both")
    return {k: counts[k] for k in KERNELS}


def scan_captures():
    """The graphs the train and eval scans captured since
    ``zero_kernel_counts`` (the counters ``scan.captures.<kind>``)."""
    return {k: _counted[f"scan.captures.{k}"] for k in ("train", "eval")}


def add_launches(rows, counts):
    """Add ``counts`` (by kernel id) to the kernel rows' ``launches``."""
    for row, ids in zip(rows, KERNEL_ROWS):
        row["launches"] = (row["launches"] or 0) + sum(counts[k] for k in ids)


@contextlib.contextmanager
def eager_forwards():
    """Count the model's forwards that run op by op on the card, outside
    the scans' graphs: each launches V1f once. They are the batches of
    ``loop.forward_outputs`` (the recall pass, the head refit's features,
    the tools) and the calls of ``Trainer.write_viz`` (the grids); yields
    {"batches": n, "grids": n}, filled as the runs go."""
    from scae_tpu_torch.train import loop

    seen = {"batches": 0, "grids": 0}
    forward, write_viz = loop.forward_outputs, loop.Trainer.write_viz

    def counting_forward(model, dataset, canvas, batch_size, device,
                         outputs):
        if str(device).startswith("cuda"):
            seen["batches"] += -(-len(dataset.images) // batch_size)
        return forward(model, dataset, canvas, batch_size, device, outputs)

    def counting_write_viz(self, *args, **kwargs):
        if self.device.type == "cuda":
            seen["grids"] += 1
        return write_viz(self, *args, **kwargs)

    loop.forward_outputs = counting_forward
    loop.Trainer.write_viz = counting_write_viz
    try:
        yield seen
    finally:
        loop.forward_outputs = forward
        loop.Trainer.write_viz = write_viz


def check_kernel_counts(card, rows, what, expected, counts=None):
    """Read every launch count after a run from zero (or take ``counts``,
    read so before); fail unless each equals ``expected`` (0 for a kernel
    not named); add them to the kernel rows' ``launches`` when ``rows`` is
    given."""
    counts = kernel_counts() if counts is None else counts
    want = {k: expected.get(k, 0) for k in KERNELS}
    say(f"launches over {what}: "
        + ", ".join(f"{k} {counts[k]}" for k in KERNELS) + f" [{card}]")
    if counts != want:
        raise RuntimeError(f"launches over {what}: {counts}, expected {want}")
    if rows is not None:
        add_launches(rows, counts)


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

    def recording(grads, plan=None):
        kept[:] = [None if g is None else g.detach().clone() for g in grads]
        step(grads, plan)

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
    check_kernel_counts(card, None, f"{steps} timed {tag} train steps",
                        {k: steps * v for k, v in per_step.items()})
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


# --------------------------------------------------------------- graph

GRAPH_STEPS = 8        # graph-scan steps held to as many eager ones
TIMED_STEPS = 20       # steps of each timed run, eager and graph in turns
# graph scan vs eager loop from one state, noise on: the same kernels in
# the same order; with cuDNN's default algorithms some backward sums change
# order from run to run, which RMSprop's eps of 1e-2/B^2 turns into
# parameter gaps between any two runs, so the parameter bound is held
# under its deterministic ones
GRAPH_LOSS_RTOL = 1e-4     # per step, relative to max(1, |eager|)
GRAPH_PARAM_RTOL = 1e-3    # per parameter after the steps, of its largest


def param_gap(torch, got, want):
    """(largest gap of a parameter relative to its largest |entry| in
    ``want``, that parameter's name) between two models."""
    worst = (0.0, "")
    for (name, a), b in zip(got.named_parameters(), want.parameters()):
        a, b = a.detach(), b.detach()
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"parameter {name} is not finite")
        gap = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
        if gap >= worst[0]:
            worst = (gap, name)
    return worst


def step_gap(got, want, tag, what, enforce):
    """The largest per-step gap of any loss term between ``got`` (a
    scan's dict of (K,) tensors) and ``want`` (K eager metric dicts),
    relative to max(1, |want|). ``enforce``: the terms held to
    GRAPH_LOSS_RTOL (and the accuracy, if named, to one example)."""
    worst = (0.0, None, None)
    for k in want[0]:
        for j, w in enumerate(want):
            g, w = float(got[k][j]), float(w[k])
            if k == "accuracy":
                tol, gap = 1.0 / BATCH, abs(g - w)
            else:
                tol, gap = GRAPH_LOSS_RTOL, abs(g - w) / max(1.0, abs(w))
            if not math.isfinite(g) or (k in enforce and not gap <= tol):
                raise RuntimeError(f"{tag} {what}: {k} at step {j + 1}: "
                                   f"{g!r} vs {w!r}")
            if k != "accuracy" and gap >= worst[0]:
                worst = (gap, k, j + 1)
    return worst


def graph_agreement(torch, card, tag, model_params, per_step, attention,
                    data, idxs, deterministic):
    """From one state, with noise and translation on: the train scan's
    warm-up rows, then GRAPH_STEPS rows captured and replayed, against the
    same rows through the eager fused train step, and through it again
    from a third copy (the control: what two eager runs differ by). The
    loss within GRAPH_LOSS_RTOL per step; each wrapper called as often as
    in one eager step over the graph scan's run (by its one capture: the
    replays call none) and ``per_step`` times a step in the eager loop;
    with
    ``deterministic`` (cuDNN's deterministic algorithms, set for all three
    runs) every loss term within GRAPH_LOSS_RTOL too, and every parameter
    within GRAPH_PARAM_RTOL of its largest entry. Returns the scan, its
    state and the first eager step."""
    from scae_tpu_torch.parallel import train_step as ts
    from scae_tpu_torch.train.loop import make_augment_fn

    cuda = torch.device("cuda")
    mode = "deterministic cuDNN" if deterministic else "default cuDNN"
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        augment = make_augment_fn(canvas=40, max_shift=6)
        graph, eager, control = (train_state(torch, cuda, True,
                                             model_params, attention)
                                 for _ in range(3))
        scan = ts.make_train_scan(augment, cuda)
        steps = [ts.make_fused_train_step(s, augment, cuda)
                 for s in (eager, control)]
        on_card = torch.from_numpy(idxs).to(cuda)
        warm = ts.WARMUP_STEPS
        # the scan's warm-up rows run eagerly on a side stream; the eager
        # states take the same rows
        scan(graph, data, idxs[:warm])
        for step in steps:
            for idx in on_card[:warm]:
                step(data, idx)
        torch.cuda.synchronize()

        block = slice(warm, warm + GRAPH_STEPS)
        zero_kernel_counts()
        t0 = time.perf_counter()
        _, got = scan(graph, data, idxs[block])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        # the wrappers launch into the capture; the replays call none
        check_kernel_counts(card, None, f"the {tag} graph scan "
                            f"({GRAPH_STEPS} steps at batch {BATCH}: one "
                            f"capture, {GRAPH_STEPS} replays; {mode})",
                            per_step)
        zero_kernel_counts()
        want = [steps[0](data, idx) for idx in on_card[block]]
        torch.cuda.synchronize()
        check_kernel_counts(card, None, f"the {tag} eager loop "
                            f"({GRAPH_STEPS} steps; {mode})",
                            {k: GRAPH_STEPS * v for k, v in per_step.items()})
        twice = [steps[1](data, idx) for idx in on_card[block]]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = before
    if not graph.step == eager.step == control.step:
        raise RuntimeError(f"{tag}: steps {graph.step}, {eager.step}, "
                           f"{control.step}")
    # every term with deterministic cuDNN; with its default ones the loss,
    # the acceptance's bound: some of its terms move between any two eager
    # runs by half the bound (the control's gap says how much)
    loss = step_gap(got, want, tag, "graph vs eager",
                    set(want[0]) if deterministic else {"loss"})
    loss_c = step_gap({k: torch.stack([t[k] for t in twice])
                       for k in twice[0]}, want, tag, "eager vs eager", ())
    par, par_c = (param_gap(torch, s.model, eager.model)
                  for s in (graph, control))
    say(f"  {tag} graph vs eager ({mode}), per-step loss: "
        + ", ".join(f"{float(g)!r}/{float(w['loss'])!r}"
                    for g, w in zip(got["loss"], want))
        + f"; largest gap of any term {loss[0]:.3e} relative to max(1, "
        f"|eager|) ({loss[1]} at step {loss[2]}; tolerance "
        f"{GRAPH_LOSS_RTOL:.0e}), of a second eager run {loss_c[0]:.3e}; "
        f"after {GRAPH_STEPS} steps the largest parameter gap "
        f"{par[0]:.3e} of its largest |entry| ({par[1]}), of a second "
        f"eager run {par_c[0]:.3e} ({par_c[1]}); the graph scan's first "
        f"call (capture included) {first_s:.3f} s [{card}]")
    if deterministic and not par[0] <= GRAPH_PARAM_RTOL:
        raise RuntimeError(f"{tag} graph vs eager ({mode}): parameter "
                           f"{par[1]} differs by {par[0]:.3e} of its "
                           f"largest entry")
    return scan, graph, steps[0]


# the kernels' names in the profiler's records (of V1f, V1b and L1f, the
# first of their kernels: the regulariser's sum, the columns pass and
# log_prob's sum follow each)
KERNEL_NAMES = {"K1": "decoder_ll_gather_fwd_kernel",
                "K2+K3": "decoder_ll_gather_bwd_kernel",
                "K4f": "decoder_ll_dense_fwd_kernel",
                "K4b": "decoder_ll_dense_bwd_kernel",
                "K5f": "decoder_ll_banded_fwd_kernel",
                "K5b": "decoder_ll_banded_bwd_kernel",
                "K6": "attention_fwd_kernel",
                "V1f": "capsule_votes_fwd_kernel",
                "V1b": "capsule_votes_bwd_kernel",
                "L1f": "capsule_likelihood_fwd_kernel",
                "L1b": "capsule_likelihood_bwd_kernel"}
RECORD_STEPS = 5       # graph steps in each window of kernel records


def kernel_records(torch, fn):
    """How many times each kernel of KERNEL_NAMES ran on the card in one
    call of ``fn``, from torch.profiler's device records (they hold the
    kernels of a replayed graph too), in one ``profiler_window``."""
    events = profiler_window(torch, fn, 1).key_averages()
    return {k: sum(e.count for e in events if name in e.key)
            for k, name in KERNEL_NAMES.items()}


def check_kernel_records(torch, card, what, fn, expected):
    """Fail unless ``kernel_records`` of ``fn`` equals ``expected`` (0 for
    a kernel not named; L1f and L1b as often as V1f and V1b unless named).
    The profiler may lose a window's first records (see
    ``profiler_window``): a window that differs is reported and taken
    again, calling ``fn`` anew, up to PROFILER_WINDOWS windows."""
    want = {k: expected.get(k, expected.get(LIKELIHOOD.get(k), 0))
            for k in KERNEL_NAMES}
    for window in range(1, PROFILER_WINDOWS + 1):
        got = kernel_records(torch, fn)
        if got == want:
            break
        say(f"profiler window {window} of {PROFILER_WINDOWS} over {what} "
            f"recorded {got}, expected {want}")
    say(f"kernels run over {what} (torch.profiler's device records): "
        + ", ".join(f"{k} {got[k]}" for k in KERNEL_NAMES) + f" [{card}]")
    if got != want:
        raise RuntimeError(f"kernels run over {what}: {got}, expected "
                           f"{want}")


def graph_path(torch, card, tag, model_params, per_step, attention):
    """The train scan on the card (``make_train_scan``: a CUDA graph of one
    step, replayed per row) against the eager loop through the fused
    train step, at batch 128: ``graph_agreement`` with cuDNN's
    deterministic algorithms and with its default ones; the kernels that
    RECORD_STEPS replays run, from the profiler's records: ``per_step``
    times each; then, on the default run's states, TIMED_STEPS steps of
    each timed in turns (eager, graph, graph, eager). Returns what the
    profile phase needs, and the data and a state's unused rows."""
    import numpy as np

    from scae_tpu_torch.parallel import train_step as ts

    cuda = torch.device("cuda")
    rng = np.random.RandomState(3)
    n = 4096
    data = {"image": torch.from_numpy(rng.randint(
                0, 256, (n, 28, 28)).astype(np.uint8)).to(cuda),
            "label": torch.from_numpy(rng.randint(
                0, 10, (n,)).astype(np.int64)).to(cuda)}
    warm = ts.WARMUP_STEPS
    idxs = rng.randint(0, n, (warm + GRAPH_STEPS
                              + PROFILER_WINDOWS * RECORD_STEPS
                              + 4 * TIMED_STEPS + 8, BATCH)).astype(np.int64)
    graph_agreement(torch, card, tag, model_params, per_step, attention,
                    data, idxs, True)
    scan, graph_state, eager = graph_agreement(
        torch, card, tag, model_params, per_step, attention, data, idxs,
        False)
    on_card = torch.from_numpy(idxs).to(cuda)

    start = warm + GRAPH_STEPS
    windows = iter(range(start, start + PROFILER_WINDOWS * RECORD_STEPS,
                         RECORD_STEPS))

    def record_window():
        first = next(windows)
        scan(graph_state, data, idxs[first:first + RECORD_STEPS])

    zero_kernel_counts()
    check_kernel_records(torch, card, f"{RECORD_STEPS} replayed {tag} "
                         f"train steps", record_window,
                         {k: RECORD_STEPS * v for k, v in per_step.items()})
    check_kernel_counts(card, None, f"the {tag} replays under the profiler "
                        "(no wrapper called)", {})
    start += PROFILER_WINDOWS * RECORD_STEPS

    def run_eager(rows_):
        for idx in on_card[rows_]:
            eager(data, idx)

    def run_graph(rows_):
        scan(graph_state, data, idxs[rows_])

    times = {"eager": [], "graph": []}
    for turn, (kind, fn) in enumerate((("eager", run_eager),
                                       ("graph", run_graph),
                                       ("graph", run_graph),
                                       ("eager", run_eager))):
        part = slice(start + turn * TIMED_STEPS,
                     start + (turn + 1) * TIMED_STEPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn(part)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / TIMED_STEPS
        times[kind].append(dt)
        say(f"{tag} {kind} train loop, turn {turn + 1} of 4 (batch "
            f"{BATCH}, 28x28 uint8 -> 40x40, translate 6, noise on, "
            f"RMSprop): {dt * 1e3:.4f} ms/step (host clock, {TIMED_STEPS} "
            f"steps), {BATCH / dt:.1f} images/s, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B, memory_reserved "
            f"{torch.cuda.memory_reserved()} B [{card}]")
    e, g = (statistics.mean(times[k]) for k in ("eager", "graph"))
    say(f"{tag} train step, eager / graph (means of the two turns each): "
        f"{e * 1e3:.4f} / {g * 1e3:.4f} ms/step, {BATCH / e:.1f} / "
        f"{BATCH / g:.1f} images/s, x{e / g:.2f} [{card}]")
    return (scan, graph_state, data, idxs[start + 4 * TIMED_STEPS:]), data


BRANCH_STEPS = 12      # RAdam with LookAhead: steps from one state


def graph_branches(torch, card, data):
    """RAdam with LookAhead (k=6, the config's) through the gather path's
    graph scan at batch 128 and full width, with cuDNN's deterministic
    algorithms: BRANCH_STEPS steps, the warm-up one and then replays in
    chunks of 5 and 6, which take three branches (RAdam's SGD steps 2-5,
    its rectified ones from step 6, LookAhead's syncs at steps 6 and 12),
    each its own graph, all in one memory pool; against the eager loop
    from the same state, every loss term within GRAPH_LOSS_RTOL and every
    parameter within GRAPH_PARAM_RTOL of its largest entry. Prints the
    peak memory of the graph scan's run, captures included."""
    import numpy as np

    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS
    from scae_tpu_torch.optim import make_optimizer
    from scae_tpu_torch.parallel import train_step as ts
    from scae_tpu_torch.train.loop import make_augment_fn

    cuda = torch.device("cuda")
    rng = np.random.RandomState(4)
    idxs = rng.randint(0, len(data["label"]),
                       (BRANCH_STEPS, BATCH)).astype(np.int64)
    augment = make_augment_fn(canvas=40, max_shift=6)
    states = [train_state(torch, cuda, True, FLAGSHIP_MODEL_PARAMS)
              for _ in range(2)]
    for state in states:
        state.optimizer = make_optimizer(
            state.model.parameters(), "radam", 3e-5, batch_size=BATCH,
            use_lookahead=True, lookahead_k=6)
    graph, eager = states
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        scan = ts.make_train_scan(augment, cuda)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_kernel_counts()
        got = [scan(graph, data, idxs[rows])[1]
               for rows in (slice(0, 1), slice(1, 6), slice(6, 12))]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        captures = kernel_counts()["K2+K3"] - ts.WARMUP_STEPS
        check_kernel_counts(card, None, f"RAdam with LookAhead's graph scan "
                            f"({BRANCH_STEPS} steps: {ts.WARMUP_STEPS} "
                            f"warm-up, 3 captures)",
                            {k: ts.WARMUP_STEPS + 3
                             for k in ("K1", "K2+K3", "V1f", "V1b")})
        _, want = ts.make_eager_train_scan(augment, cuda)(eager, data, idxs)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = before
    got = {k: torch.cat([g[k] for g in got]) for k in got[0]}
    loss = step_gap(got, [{k: v[j] for k, v in want.items()}
                          for j in range(BRANCH_STEPS)],
                    "RAdam with LookAhead", "graph vs eager", set(want))
    par = param_gap(torch, graph.model, eager.model)
    say(f"RAdam with LookAhead (k=6), gather path, graph vs eager "
        f"(deterministic cuDNN, {BRANCH_STEPS} steps, {captures} branch "
        f"graphs in one pool): largest gap of any term {loss[0]:.3e} "
        f"relative to max(1, |eager|), largest parameter gap {par[0]:.3e} "
        f"of its largest |entry| ({par[1]}); the graph scan's "
        f"max_memory_allocated {peak} B, of which {held} B were held "
        f"before [{card}]")
    if not par[0] <= GRAPH_PARAM_RTOL:
        raise RuntimeError(f"RAdam with LookAhead graph vs eager: parameter "
                           f"{par[1]} differs by {par[0]:.3e} of its "
                           f"largest entry")


def graph_phase(torch, card):
    """``graph_path`` on the three likelihood paths at full width: gather
    (K1, K2+K3), dense (K4f, K4b) and banded with the attention flag
    (K5f, K5b, K6 x 4); then ``graph_branches`` on the gather path.
    Returns the gather path's."""
    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS

    gather, data = graph_path(torch, card, "gather", FLAGSHIP_MODEL_PARAMS,
                              {"K1": 1, "K2+K3": 1, **VOTES}, False)
    graph_path(torch, card, "pallas", dict(
        FLAGSHIP_MODEL_PARAMS, pcae_decoder_params=dict(fused_impl="pallas")),
        {"K4f": 1, "K4b": 1, **VOTES}, False)
    graph_path(torch, card, "banded", dict(
        FLAGSHIP_MODEL_PARAMS,
        pcae_decoder_params=dict(fused_impl="pallas_banded")),
        {"K5f": 1, "K5b": 1, "K6": 4, **VOTES}, True)
    graph_branches(torch, card, data)
    return gather


def cifar10_phase(torch, card):
    """One train step of the shipped cifar10 model (M=64, C=3) with noise
    off, card against CPU."""
    import numpy as np

    from scae_tpu_torch.factory import CIFAR10_MODEL_PARAMS

    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (CPU_BATCH, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, (CPU_BATCH,)).astype(np.int64)
    card_vs_cpu_step(torch, card, "cifar10", CIFAR10_MODEL_PARAMS, images,
                     labels, None, {"K1": 1, "K2+K3": 1, **VOTES})


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
        p = kp.matmul_plan(*a.shape, b.shape[1])
        say(f"P2 {name}: {p['blocks']} blocks of {p['bm']}x{p['bn']}, "
            f"{p['chunks']} chunk(s) of {p['kc']}, max abs err {err:.3e} "
            f"against torch.matmul "
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
        library_ms = device_ms_per_call(torch, library)
        library_event_ms = time_cuda(torch, library, iters=200, warmup=20)
        bound_ms, bound_by, n_bytes, ops = bounds[kid]
        extra = ""
        if kid == "P2":
            plan = kp.matmul_plan(*a.shape, b.shape[1])
            per_sm = kp.matmul_blocks_per_sm(plan, a.shape[1])
            extra = (f"; {yardstick('P2', ms, bound_ms)}, "
                     f"{ms / library_ms:.1%} of {what}'s device time; plan: "
                     f"{plan['bm']}x{plan['bn']} tiles of {plan['tm']}x"
                     f"{plan['tn']} a thread, depths in {plan['ks']} "
                     f"slice(s), {plan['threads']} threads, "
                     f"{plan['chunks']} chunk(s) of {plan['kc']}, "
                     f"{kp.matmul_registers(plan)} registers, shared memory "
                     f"{plan['smem']} B; "
                     f"{occupancy(torch, per_sm, plan['blocks'])}")
        say(f"{kid} time: kernel {ms:.4f} ms (device time per launch over "
            f"200 launches, torch.profiler), plain {plain_ms:.4f} ms (200 "
            f"calls, CUDA events), library {what} {library_ms:.4f} ms of "
            f"device time per call (every device operation of 200 calls, "
            f"torch.profiler) and {library_event_ms:.4f} ms per call on "
            f"CUDA events (200 calls; {lib_err:.1e} from the plain "
            f"version), bound {bound_ms * 1e6:.2f} ns by {bound_by} "
            f"({n_bytes} B, "
            f"{ops} FLOP), roofline share {bound_ms / ms:.2%}{extra} "
            f"[{card}]")
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
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS
    from scae_tpu_torch.train import cli, loop
    from scae_tpu_torch.train.checkpoint import CheckpointManager

    # the scans replay graphs: a wrapper launches for each scan's warm-up
    # steps and its one capture (one graph: RMSprop has one branch, and a
    # Trainer's data and state keep their addresses), never in a replay;
    # V1f besides once in each eager forward (``eager_forwards``)
    warm = WARMUP_STEPS

    def once_each(forwards):
        return {"K1": 2 * (warm + 1), "K2+K3": warm + 1,
                "V1f": 2 * (warm + 1) + forwards["grids"]
                + forwards["batches"], "V1b": warm + 1}

    captured = ("the wrappers launch for the train and eval scans' warm-up "
                "steps and their one capture each, V1f besides in each "
                "grids' forward")
    base = ["model=mnist", "data_loader.source=synthetic",
            "data_loader.synthetic_train=2560", "data_loader.val_size=512",
            "data_loader.synthetic_test=512", "trainer.max_epochs=2",
            "trainer.log_every_steps=5", "trainer.max_eval_batches=2",
            f"trainer.checkpoint_dir={tmp}/ckpt",
            f"trainer.log_dir={tmp}/logs"]
    jsonl = os.path.join(tmp, "logs", "metrics.jsonl")

    # the grids' forward reads only the modes: no likelihood kernel, the
    # vote head once
    write_viz = loop.Trainer.write_viz
    viz_calls = []

    def counted_write_viz(self, *args, **kw):
        before = kernel_counts()
        write_viz(self, *args, **kw)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in kernel_counts().items()}
        if launched != dict(dict.fromkeys(KERNELS, 0), V1f=1):
            raise RuntimeError(f"the grids' forward launched {launched}, "
                               "expected V1f once and nothing else")
        viz_calls.append(1)

    loop.Trainer.write_viz = counted_write_viz
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_kernel_counts()
        t0 = time.perf_counter()
        with eager_forwards() as forwards:
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
                            f"steps, {len(evals)} evals of 2 batches; "
                            f"{captured})", once_each(forwards))
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
        with eager_forwards() as forwards:
            state, out = run_cli(cli, base + ["trainer.max_epochs=3",
                                              "resume=true"])
        torch.cuda.synchronize()
        resumed = train_records(read_jsonl(jsonl))[len(train):]
        if (saved != 32 or f"resumed from step {saved}" not in out
                or resumed[0]["step"] != saved + 5 or state.step != 48):
            raise RuntimeError(f"resume: saved {saved}, first logged step "
                               f"{resumed[0]['step']}, final {state.step}")
        check_kernel_counts(card, rows, "the resumed trainer CLI (16 train "
                            f"steps, 1 eval of 2 batches; {captured})",
                            once_each(forwards))
        trained, train_s, train_rate = training_wall_time(out)
        say(f"trainer CLI resume: from step {saved} to {state.step}, first "
            f"logged step {resumed[0]['step']}, end to end "
            f"{train_rate!r} images/s ({trained} images over {train_s!r} s "
            f"of training wall time), images_per_sec median "
            f"{statistics.median(r['images_per_sec'] for r in resumed):.1f}"
            f" [{card}]")

        zero_kernel_counts()
        with eager_forwards() as forwards:
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
                            "recall pass reads no likelihood; the wrappers "
                            "launch for the eval scan's warm-up step and "
                            "its one capture, V1f besides in each of the "
                            f"recall pass's {forwards['batches']} batches)",
                            {"K1": warm + 1,
                             "V1f": warm + 1 + forwards["batches"]})
        say(f"trainer CLI mode=test: test_loss {metrics['test_loss']!r}, "
            f"test_accuracy {metrics['test_accuracy']!r} [{card}]")
        return trainer_options(torch, card, rows, tmp, base)
    finally:
        loop.Trainer.write_viz = write_viz


def trainer_card_vs_cpu_phase(torch, card, tmp, steps=4, eager=True,
                              resume=True, held=4):
    """``steps`` steps at batch 32 with noise and translation off and f32
    convs on the card and on the CPU from the same seed: per-step JSONL
    losses within TRAINER_RTOL over the first ``held`` steps (every step's
    gap is printed). On the card the train scan runs step 1 eagerly (its
    warm-up) and replays its graph for the others; with ``eager``, a
    control run with the Trainer's scan swapped for the eager loop
    (``make_eager_train_scan``) is held to it and to the CPU's too. With
    ``resume``, the card run interrupted after 2 steps and resumed (a new
    Trainer: step 3 eager, then replays), against the uninterrupted one
    (within the same tolerance; it was set while K2+K3 added through
    atomics, whose order changed the last bits from run to run; the kernel
    is now deterministic, and the gap the line prints says whether
    anything else, such as cuDNN's choice of algorithm, still moves
    them)."""
    from scae_tpu_torch.config import load_config
    from scae_tpu_torch.train import cli, loop

    def overrides(tag):
        return ["model=mnist", "data_loader.source=synthetic",
                "data_loader.batch_size=32",
                f"data_loader.synthetic_train={32 * steps + 32}",
                "data_loader.val_size=32",
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
    tags = ["card", "cpu"]
    pairs = [("card vs CPU", "card", "cpu")]
    if eager:
        from scae_tpu_torch.parallel.train_step import make_eager_train_scan

        graph_scan = loop.make_train_scan
        loop.make_train_scan = make_eager_train_scan
        try:
            run_cli(cli, overrides("eager"))
        finally:
            loop.make_train_scan = graph_scan
        tags.append("eager")
        pairs += [("card (graph) vs card eager", "card", "eager"),
                  ("card eager vs CPU", "eager", "cpu")]
    if resume:
        trainer = loop.Trainer(load_config("config", overrides("split")))
        try:
            trainer.run(max_steps=2)
        finally:
            trainer.close()
        run_cli(cli, overrides("split") + ["resume=true"])
        tags.append("split")
        pairs.append(("card resumed after 2 vs straight", "split", "card"))
    runs = {tag: losses(tag) for tag in tags}
    if any([r["step"] for r in v] != list(range(1, steps + 1))
           for v in runs.values()):
        raise RuntimeError("steps logged: " + ", ".join(
            f"{tag} {[r['step'] for r in v]}" for tag, v in runs.items()))
    failed = []
    for what, a, b in pairs:
        got, want = runs[a], runs[b]
        worst, per_step = (0.0, None, None), []
        for g, w in zip(got, want):
            gaps = {k: abs(g[k] - w[k]) / max(1.0, abs(w[k]))
                    for k in LOSS_KEYS}
            k = max(gaps, key=gaps.get)
            per_step.append(f"{gaps[k]:.3e} ({k})")
            if gaps[k] >= worst[0]:
                worst = (gaps[k], k, g["step"])
            if g["step"] <= held and not gaps[k] <= TRAINER_RTOL:
                failed.append(f"trainer {what}: {k} at step {g['step']}: "
                              f"{g[k]!r} vs {w[k]!r}")
        say(f"trainer {what} (batch 32, {steps} steps, noise and "
            f"translation off, f32 convs, TF32 off): per-step losses "
            + ", ".join(f"{g['loss']!r}/{w['loss']!r}"
                        for g, w in zip(got, want))
            + "; per-step largest gap relative to max(1, |ref|): "
            + ", ".join(per_step)
            + f"; largest {worst[0]:.3e} ({worst[1]} at step {worst[2]}; "
            f"tolerance {TRAINER_RTOL:.0e} over steps 1-{held}) [{card}]")
    if failed:
        raise RuntimeError("; ".join(failed))


def patch_crops(images, seed, shape):
    """The template logits that template_init=patches draws for ``seed``
    from uint8 images (N, H, W), written out here as the JAX loop's rule:
    an image, a row, a column from RandomState(seed); a crop of mean 0.05
    or less redrawn until 50 M draws; clipped to [0.01, 0.99], then the
    logit (the mnist config's template nonlinearity is the sigmoid)."""
    import numpy as np

    _, M, _, Ht, Wt = shape
    imgs = images.astype(np.float32) / 255.0
    N, H, W = imgs.shape
    rng = np.random.RandomState(seed)
    crops, tries = [], 0
    while len(crops) < M:
        i = rng.randint(N)
        y, x = rng.randint(H - Ht + 1), rng.randint(W - Wt + 1)
        c = imgs[i, y:y + Ht, x:x + Wt][None]
        if c.mean() > 0.05 or tries > 50 * M:
            crops.append(c)
        tries += 1
    p = np.clip(np.stack(crops)[None], 0.01, 0.99).astype(np.float32)
    return np.log(p / (1.0 - p))


def trainer_options(torch, card, rows, tmp, base):
    """The Trainer's four options through the CLI on the trainer phase's
    config and data: a seed probe of two candidates of one epoch with
    template_init=patches (2 epochs in all), then a run warm-started from
    its checkpoints with head_refit. Checks the winner and train_seed.json,
    each candidate's patched templates at step 0, the warm-start
    parameters against the source's best checkpoint, the refit checkpoint
    at the last step + 1 with the monitor's metric and only the head
    changed, the returned state's parameters against the last training
    checkpoint's, and that K1 and K2+K3 launch for each scan's warm-up steps and
    capture and nowhere else (the graphs each run captured are counted by
    ``scan_captures``). Returns the refit run's checkpoint directory."""
    from scae_tpu_torch.train import cli, loop
    from scae_tpu_torch.train.checkpoint import CheckpointManager

    def run_counted(argv, what):
        zero_kernel_counts()
        t0 = time.perf_counter()
        with eager_forwards() as forwards:
            state, out = run_cli(cli, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        caps = scan_captures()
        check_kernel_counts(
            card, rows, f"{what} ({caps['train']} train and {caps['eval']} "
            "eval graphs captured; the wrappers launch for each scan's "
            "warm-up steps and its capture, V1f besides in each eager "
            f"forward: {forwards})", graph_counts_expected(caps, forwards))
        if not caps["train"]:
            raise RuntimeError(f"{what}: the train scan captured no graph")
        say(f"{what}: {seconds!r} s [{card}]")
        return state, out

    def dirs(name):
        return [f"trainer.checkpoint_dir={tmp}/{name}/ckpt",
                f"trainer.log_dir={tmp}/{name}/logs"]

    patched = {}
    patch = loop.Trainer._maybe_patch_templates
    init_state = loop.Trainer.init_state
    warm = {}

    def recording_patch(self, state, train_ds, seed):
        state = patch(self, state, train_ds, seed)
        patched[seed] = (self.model.template_generator.template_logits
                         .detach().cpu().clone(), train_ds.images)
        return state

    def recording_init(self, seed):
        state = init_state(self, seed)
        warm.setdefault("params", {k: v.detach().cpu().clone() for k, v
                                   in self.model.state_dict().items()})
        return state

    loop.Trainer._maybe_patch_templates = recording_patch
    try:
        state, out = run_counted(
            base + dirs("probe") + ["trainer.seed_probe.n=2",
                                    "trainer.seed_probe.epochs=1",
                                    "trainer.template_init=patches"],
            "the trainer CLI with a seed probe of 2 candidates of 1 epoch "
            "and template_init=patches, 2 epochs in all")
    finally:
        loop.Trainer._maybe_patch_templates = patch
    winner = int(re.search(r"seed probe winner: (\d+)", out).group(1))
    with open(os.path.join(tmp, "probe", "ckpt", "train_seed.json")) as f:
        recorded = json.load(f)["seed"]
    spe = state.step // 2       # steps per epoch: the run took 2 epochs
    if (sorted(patched) != [42, 43] or recorded != winner
            or f"continuing probe winner from step {spe}\n" not in out
            or state.step != 2 * spe or state.seed != winner):
        raise RuntimeError(f"seed probe: patched {sorted(patched)}, winner "
                           f"{winner}, recorded {recorded}, final step "
                           f"{state.step} of seed {state.seed}")
    for seed, (logits, images) in sorted(patched.items()):
        want = patch_crops(images, seed, tuple(logits.shape))
        if not torch.equal(logits, torch.from_numpy(want)):
            raise RuntimeError(f"candidate {seed}'s templates at step 0 "
                               "are not its crops")
    say(f"seed probe: winner {winner} (train_seed.json {recorded}), "
        f"continued from step {spe} to {state.step}; both candidates' "
        f"template logits at step 0 equal their crops bit for bit [{card}]")

    source = os.path.join(tmp, "probe", "ckpt")
    loop.Trainer.init_state = recording_init
    try:
        state, out = run_counted(
            base + dirs("refit") + [f"init_from={source}",
                                    "trainer.head_refit=true"],
            "the trainer CLI warm-started from the probe run, with "
            "head_refit")
    finally:
        loop.Trainer.init_state = init_state
    src = CheckpointManager(source, monitor="val_loss")
    best = src.best_step
    if "val_loss" not in src.metrics(best):
        raise RuntimeError(f"the source's best {best} has no val_loss")
    want = src.restore_params(step=best)
    if sorted(want) != sorted(warm["params"]) or not all(
            torch.equal(warm["params"][k], v) for k, v in want.items()):
        raise RuntimeError(f"the warm start is not the source's best "
                           f"checkpoint {best}")
    mgr = CheckpointManager(os.path.join(tmp, "refit", "ckpt"),
                            monitor="val_loss")
    refit_step = mgr.latest_step
    refit_best = int(re.search(r"\(best was ckpt (\d+)\)", out).group(1))
    if (state.step != 2 * spe or refit_step != state.step + 1
            or "val_loss" not in (mgr.metrics(refit_step) or {})
            or "head_refit: C*=" not in out):
        raise RuntimeError(f"head_refit: final step {state.step}, latest "
                           f"checkpoint {refit_step} with "
                           f"{mgr.metrics(refit_step)}")
    before = mgr.restore_params(step=refit_best)
    after = mgr.restore_params(step=refit_step)
    changed = sorted(k for k in after if not torch.equal(after[k],
                                                         before[k]))
    if changed != ["posterior_classifier.bias",
                   "posterior_classifier.weight"]:
        raise RuntimeError(f"head_refit changed {changed}")
    # the run returns its last training state, not the refit's
    last = mgr.restore_params(step=state.step)
    got = state.model.state_dict()
    if sorted(got) != sorted(last) or not all(
            torch.equal(got[k].cpu(), v) for k, v in last.items()):
        raise RuntimeError(f"the refit run returned other parameters than "
                           f"its last training checkpoint {state.step}")
    say(f"warm start: parameters equal the source's best checkpoint {best} "
        f"bit for bit; head_refit: checkpoint {refit_step} (last step + 1) "
        f"with val_loss {mgr.metrics(refit_step)['val_loss']!r}, only the "
        f"posterior head changed from checkpoint {refit_best}; the run "
        f"returned its last training state (step {state.step}) [{card}]")
    return os.path.join(tmp, "refit", "ckpt")


# -------------------------------------------------------------- serve

SERVE_BATCHES = (BATCH, BATCH // 2 + 1)   # 128 and 65
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-5      # artifact vs live, as export_model
SERVE_ITERS = 50
SERVE_PROFILED = 10   # calls a profiler window of a timing turn holds

# Run in a fresh interpreter by ``check_artifact_apart``: loads an artifact
# (with torch and the vote head's op, which every artifact calls, alone, or
# through scae_tpu_torch.serve.load_serving), holds
# it to the live outputs saved beside it at each batch, and reads the
# kernels that one call runs from torch.profiler's device records.
ARTIFACT_CHECK = """
import json, sys
import torch
# the live outputs were computed with TF32 off: convolutions and products
# in full float32 here too (an artifact does not carry the backend flags)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
artifact, saved_path, how, expected = sys.argv[1:5]
saved = torch.load(saved_path)
if how == "torch":
    import scae_tpu_torch.kernels.capsule_votes
    call = torch.export.load(artifact + "/model.pt2").module()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] == "scae_tpu"
                    or m.startswith(("scae_tpu_torch.models",
                                     "scae_tpu_torch.serve")))
    if leaked:
        raise RuntimeError(f"loading with torch and the vote head's op "
                           f"alone imported {leaked}")
else:
    from scae_tpu_torch.serve import load_serving
    call = load_serving(artifact)
import chip_smoke
gaps = {}
with torch.no_grad():
    for b in chip_smoke.SERVE_BATCHES:
        got = call(saved["x"][:b].cuda())
        gaps[b] = chip_smoke.serve_gaps(torch, got, saved[b])
    chip_smoke.check_kernel_records(
        torch, "", f"one call of the artifact ({how})",
        lambda: call(saved["x"].cuda()), json.loads(expected))
print(json.dumps({"gaps": gaps, "modules": how}))
"""


def serve_gaps(torch, got, want):
    """{output: largest gap} of an artifact's outputs against the live
    ones; raises unless the predictions are equal and every other output
    is within SERVE_RTOL / SERVE_ATOL."""
    if sorted(got) != sorted(want):
        raise RuntimeError(f"outputs {sorted(got)} != {sorted(want)}")
    gaps = {}
    for k in sorted(want):
        g, w = got[k].detach().cpu(), want[k].cpu()
        if k.endswith("prediction"):
            gaps[k] = int((g != w).sum())
            if gaps[k]:
                raise RuntimeError(f"{k}: {gaps[k]} predictions differ")
        else:
            gaps[k] = float((g - w).abs().max())
            if not torch.allclose(g, w, rtol=SERVE_RTOL, atol=SERVE_ATOL):
                raise RuntimeError(f"{k}: off by {gaps[k]}, beyond rtol "
                                   f"{SERVE_RTOL} atol {SERVE_ATOL}")
    return gaps


def check_artifact_apart(torch, card, artifact, saved, how, expected):
    """``ARTIFACT_CHECK`` on ``artifact`` in a fresh interpreter (the
    repo's root on the path, for scae_tpu_torch and this file's helpers);
    fails unless it exits 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", ARTIFACT_CHECK, artifact, saved, how,
         json.dumps(expected)], cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    for line in (out.stdout + out.stderr).splitlines():
        say(f"  fresh interpreter: {line}")
    if out.returncode != 0:
        raise RuntimeError(f"the artifact check ({how}) exited "
                           f"{out.returncode}")
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for b, gaps in result["gaps"].items():
        say(f"artifact {os.path.basename(artifact)} loaded with {how} in a "
            f"fresh interpreter, batch {b} against the live infer function:"
            f" " + ", ".join(f"{k} {v:.3e}" if isinstance(v, float)
                             else f"{k} {v} differ"
                             for k, v in gaps.items()) + f" [{card}]")


def serve_phase(torch, card, rows, tmp, ckpt_dir, overrides):
    """The serving export of the flagship (1x40x40, M=40, O=32, 11x11
    templates; the factory's weights from seed 0 on the card): two
    polymorphic-batch artifacts, on fused_impl="xla" and with the set
    transformer's use_pallas_attention (K6 by name), each loaded in a fresh
    interpreter (the xla one with torch and the vote head's op alone) and
    held to the live infer function at batch 128 and 65, with the kernels
    of one call from the
    profiler's records; the flag-on artifact's K6 launch count over its
    first call (the warm-up and the capture of its graph); an artifact
    exported on the CPU and moved to the card against the card's own; then
    ``serve_graph_checks`` (each surface's CUDA graphs against its eager
    call) and, where ``ckpt_dir`` is given,
    ``python -m scae_tpu_torch.tools.export_model`` on the trainer phase's
    checkpoint directory."""
    from scae_tpu_torch import serve
    from scae_tpu_torch.factory import make_scae
    from scae_tpu_torch.kernels import attention as k6
    from scae_tpu_torch.kernels import capsule_likelihood as cl
    from scae_tpu_torch.kernels import capsule_votes as cv
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS

    os.makedirs(tmp, exist_ok=True)
    cuda = torch.device("cuda")
    flagged_model, params, x = serve_model_and_input(torch)
    model = make_scae(params, device=cuda, seed=0)   # the flag off
    shape = tuple(params["image_shape"])
    live = {False: serve.make_infer_fn(model, device=cuda),
            True: serve.make_infer_fn(flagged_model, device=cuda)}
    artifacts = {}
    for flag in (False, True):
        name = "pallas_attention" if flag else "xla"
        path = os.path.join(tmp, f"artifact_{name}")
        zero_kernel_counts()
        t0 = time.perf_counter()
        serve.export_serving(flagged_model if flag else model,
                             image_shape=shape, batch_size=None,
                             out_dir=path, device=cuda,
                             model_config=params, polymorphic_batch=True)
        seconds = time.perf_counter() - t0
        check_kernel_counts(card, None, f"the export of the {name} "
                            "artifact (traced with the op's fake "
                            "implementation)", {})
        with open(os.path.join(path, serve.MANIFEST_NAME)) as f:
            manifest = json.load(f)
        want_ops = sorted([k6.OP, cl.OP, cv.OP] if flag else [cl.OP, cv.OP])
        if manifest["custom_ops"] != want_ops:
            raise RuntimeError(f"{name} artifact calls "
                               f"{manifest['custom_ops']}, expected "
                               f"{want_ops}")
        size = os.path.getsize(os.path.join(path, serve.ARTIFACT_NAME))
        say(f"exported the {name} artifact in {seconds!r} s: {size} B, "
            f"custom ops {manifest['custom_ops']}, device "
            f"{manifest['device']} [{card}]")
        saved = {b: {k: v.cpu() for k, v in live[flag](x[:b]).items()}
                 for b in SERVE_BATCHES}
        saved["x"] = x
        saved_path = os.path.join(tmp, f"live_{name}.pt")
        torch.save(saved, saved_path)
        check_artifact_apart(torch, card, path, saved_path,
                             "scae_tpu_torch" if flag else "torch",
                             {"K6": 4, "V1f": 1} if flag else {"V1f": 1})
        artifacts[name] = (path, saved)

    # the main path: every count at 0 just before the first call of the
    # flag-on artifact (its graph's warm-up and capture), read just after
    flagged = serve.load_serving(artifacts["pallas_attention"][0])
    xc = x.to(cuda)
    zero_kernel_counts()
    out = flagged(xc)
    torch.cuda.synchronize()
    check_kernel_counts(card, rows, "the first call of the flag-on artifact"
                        f" at batch {BATCH} (three set-attention blocks and "
                        "the final attention through "
                        "scae_tpu_torch::attention_fwd, the vote head "
                        "through scae_tpu_torch::capsule_votes_fwd, in the "
                        f"graph's {WARMUP_STEPS} warm-up call and its "
                        "capture)", {"K6": 4 * (WARMUP_STEPS + 1),
                                     "V1f": WARMUP_STEPS + 1})
    serve_gaps(torch, out, artifacts["pallas_attention"][1][BATCH])
    say("assertions in the flag-on artifact's program: "
        + json.dumps(program_assertions(flagged.program)) + f" [{card}]")

    # an export on the CPU, moved to the card, against the card's own
    cpu_model = make_scae(params, device="cpu", seed=0)
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    moved_path = os.path.join(tmp, "artifact_cpu")
    serve.export_serving(cpu_model, image_shape=shape, batch_size=None,
                         out_dir=moved_path, device="cpu",
                         model_config=params, polymorphic_batch=True)
    moved = serve.load_serving(moved_path, device=cuda)
    own = serve.load_serving(artifacts["xla"][0])
    gaps = serve_gaps(torch, moved(xc), own(xc))
    say(f"the xla artifact exported on the CPU and moved to the card "
        f"(move_to_device_pass) against the card's own export, batch "
        f"{BATCH}: " + ", ".join(f"{k} {v}" for k, v in gaps.items())
        + f" [{card}]")

    t0 = time.perf_counter()
    serve_graph_checks(torch, card, {
        "xla artifact": (lambda: serve.load_serving(artifacts["xla"][0]),
                         False),
        "flag-on artifact": (lambda: serve.load_serving(
            artifacts["pallas_attention"][0]), True),
        "live infer (xla)": (lambda: serve.make_infer_fn(model,
                                                         device=cuda), False),
        "live infer (flag on)": (lambda: serve.make_infer_fn(
            flagged_model, device=cuda), True)}, x)
    t1 = time.perf_counter()
    serve_bench_turns(torch, card, artifacts["pallas_attention"][0])
    say(f"serving graphs: the checks and turns took {t1 - t0!r} s, "
        f"bench_serving's turns {time.perf_counter() - t1!r} s [{card}]")

    if ckpt_dir is None:
        return
    # the export tool on the trainer phase's checkpoints
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(tmp, "artifact_tool")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "scae_tpu_torch.tools.export_model",
         ckpt_dir, "--out", out_dir, "--polymorphic-batch", "--",
         *overrides], cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=600)
    for line in (run.stdout + run.stderr).splitlines():
        say(f"  export_model: {line}")
    if run.returncode != 0:
        raise RuntimeError(f"export_model exited {run.returncode}")
    result = json.loads(run.stdout.strip().splitlines()[-1])
    say(f"export_model on {ckpt_dir}: step {result['step']}, "
        f"{time.perf_counter() - t0!r} s, exit 0 [{card}]")


def program_assertions(program) -> dict:
    """{operator: count} of the runtime assertions and range constraints
    in an ExportedProgram's graph (a polymorphic batch may add some)."""
    found = {}
    for n in program.graph.nodes:
        name = str(n.target)
        if n.op == "call_function" and any(
                w in name for w in ("assert", "constrain_range")):
            found[name] = found.get(name, 0) + 1
    return found


def output_gaps(torch, got, want) -> dict:
    """{output: the largest gap relative to the output's largest entry
    (predictions: how many differ)}."""
    gaps = {}
    for k in sorted(want):
        g, w = got[k], want[k]
        if k.endswith("prediction"):
            gaps[k] = int((g != w).sum())
        else:
            gaps[k] = float((g.double() - w.double()).abs().max()
                            / w.double().abs().max().clamp_min(1e-30))
    return gaps


def serve_graph_checks(torch, card, surfaces, x):
    """Each serving surface (``surfaces``: name -> (a function that makes
    it, whether it has the attention flag)), which on the card replays a
    CUDA graph per batch size, against its own eager call
    (``.eager``). Under cuDNN's deterministic algorithms, at batch 128 and
    65: the first call's launch counts (V1f once in the warm-up call and
    once in the capture, K6 4 times in each with the flag, nothing else),
    every output of the replay bit for bit the eager call's (else the
    largest gap relative to each output's largest entry, and a failure),
    one capture a batch size and none for a second call, V1f once and K6 4
    times (none without the flag) a replay in the profiler's records, and
    a call's outputs untouched by the next call. Then, under the default
    algorithms, each surface made anew and timed in turns (eager, graph,
    graph, eager) at batch 128: device ms per call (profiler), ms per call
    on CUDA events and images/s."""
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS
    from scae_tpu_torch.utils import trace

    cuda = torch.device("cuda")
    xc = x.to(cuda)
    other = (1.0 - xc).flip(-1).contiguous()
    failures = []
    was = deterministic_cudnn(torch)
    try:
        for what, (make, flag) in surfaces.items():
            surface = make()
            captured = trace.Since()
            for b in SERVE_BATCHES:
                zero_kernel_counts()
                got = surface(xc[:b])
                torch.cuda.synchronize()
                counts = kernel_counts()
                want_counts = {"V1f": WARMUP_STEPS + 1}
                if flag:
                    want_counts["K6"] = 4 * (WARMUP_STEPS + 1)
                try:
                    check_kernel_counts(card, None, f"the {what}'s first "
                                        f"call at batch {b}", want_counts,
                                        counts)
                except RuntimeError as error:
                    failures.append(str(error))
                want = surface.eager(xc[:b])
                same = all(torch.equal(got[k], want[k]) for k in want) \
                    and sorted(got) == sorted(want)
                gaps = output_gaps(torch, got, want)
                say(f"serving graph, {what}, batch {b}: the replay "
                    + ("bit for bit the eager call" if same else
                       "differs from the eager call: " + ", ".join(
                           f"{k} {v!r}" for k, v in gaps.items())
                       + " (each of its largest entry; predictions: how "
                       "many differ)")
                    + f"; launches over the first call (warm-up and "
                    f"capture): K6 {counts['K6']}, V1f {counts['V1f']} "
                    f"[{card}]")
                if not same:
                    failures.append(f"{what} batch {b}: replay != eager")
            captures = captured["graphs.captures"]
            surface(xc)
            if captured["graphs.captures"] != captures or \
                    captures != len(SERVE_BATCHES):
                failures.append(f"{what}: {captures} captures for "
                                f"{len(SERVE_BATCHES)} batch sizes, "
                                f"{captured['graphs.captures']} after a "
                                "second call")
            say(f"serving graph, {what}: {captures} captures for batch "
                f"sizes {list(SERVE_BATCHES)}, none for a second call "
                f"[{card}]")
            check_kernel_records(torch, card, f"one replay of the {what} "
                                 f"at batch {BATCH}", lambda: surface(xc),
                                 {"K6": 4, "V1f": 1} if flag else
                                 {"V1f": 1})
            first = surface(xc)
            kept = {k: v.clone() for k, v in first.items()}
            second = surface(other)
            third = surface(xc)
            torch.cuda.synchronize()
            untouched = all(torch.equal(first[k], kept[k]) for k in kept)
            moved = any(not torch.equal(second[k], first[k])
                        for k in first if not k.endswith("prediction"))
            if not untouched or not moved or \
                    not all(torch.equal(third[k], kept[k]) for k in kept):
                failures.append(f"{what}: outputs overwritten by a later "
                                "call, or one input's outputs returned "
                                "for another")
            say(f"serving graph, {what}: a call's outputs untouched by the "
                f"next two calls (fresh tensors: {untouched}); another "
                f"input's outputs differ: {moved} [{card}]")
    finally:
        deterministic_cudnn(torch, was[0])
    if failures:
        raise RuntimeError("serving graphs: " + "; ".join(failures))

    # eager against graph in turns, on surfaces made anew under the
    # default algorithms
    for what, (make, _) in surfaces.items():
        surface = make()
        turns = (("eager", surface.eager), ("graph", surface),
                 ("graph", surface), ("eager", surface.eager))
        for mode, fn in turns:
            call = lambda: fn(xc)  # noqa: E731
            device_ms = device_ms_per_call(torch, call,
                                           iters=SERVE_PROFILED, warmup=5)
            ms = time_cuda(torch, call, SERVE_ITERS, 5)
            say(f"serving, {what}, {mode}, batch {BATCH}: {device_ms!r} ms "
                f"of device time per call (torch.profiler, {SERVE_PROFILED} "
                f"calls), {ms!r} ms per call on CUDA events "
                f"({SERVE_ITERS} calls), "
                f"{BATCH / ms * 1e3!r} images/s [{card}]")


def serve_bench_turns(torch, card, artifact):
    """``tools.bench_serving`` on the flag-on artifact (batch 128, best of
    BENCH_REPEATS), eager and graph in turns (eager, graph, graph, eager):
    the eager turns with ``serve``'s graphs left out, the graph turns as
    the tool runs."""
    from scae_tpu_torch import serve
    from scae_tpu_torch.tools import bench_serving

    graphed = serve._graphed
    for mode in ("eager", "graph", "graph", "eager"):
        if mode == "eager":
            serve._graphed = lambda *args, **kwargs: None
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                result = bench_serving.main([artifact, "--repeats",
                                             str(BENCH_REPEATS)])
        finally:
            serve._graphed = graphed
        say(f"bench_serving, {mode}, the flag-on flagship artifact at batch "
            f"{result['batch_size']}: the artifact "
            f"{result['artifact_images_per_sec']!r} images/s, the live xla "
            f"model {result['live_images_per_sec']!r} images/s (best of "
            f"{BENCH_REPEATS}, synchronized) [{card}]")


# -------------------------------------------------------------- tools

# the members the model tools act on: model=mnist at full width, f32
# convolutions and taps (the card is held to the CPU), one epoch of the
# synthetic 1,024 / 512 / 256 split shared through split_seed
TOOLS_CLI = ["model=mnist", "data_loader.source=synthetic",
             "data_loader.synthetic_train=1536", "data_loader.val_size=512",
             "data_loader.synthetic_test=256", "data_loader.split_seed=7",
             "model.pcae_cnn_encoder_params.compute_dtype=null",
             "model.pcae_decoder_params.fused_tap_dtype=float32",
             "trainer.max_epochs=1", "trainer.log_every_steps=4"]
TOOLS_SEEDS = (1, 2)
# card vs CPU, abs, on the models' class probabilities (the forwards' and
# the artifact's); the logistic probes' (and a head they rewrote) are
# printed, not held: at C=100 their float64 fits stop at the
# 5,000-iteration cap on one epoch's flat features, card and CPU at other
# points (3.3e-3 apart in one call)
TOOLS_PROB_TOL = 2e-3
BENCH_REPEATS = 20
TOOLS = ("ensemble_eval", "ensemble_pool", "probe_eval", "probe_calibrate",
         "verify_serving_readout", "bench_serving")


def unsettled(arrays, tol):
    """The rows (a boolean mask) on which some weighted mean of the
    probability arrays (each (n, K)) may have its two largest entries
    within ``tol``: where the arrays disagree on the argmax, or one
    array's top two lie within ``tol``. Elsewhere every mean keeps the
    argmax with a margin above ``tol``, so a card-vs-CPU gap of at most
    ``tol / 2`` cannot move a prediction there."""
    import numpy as np

    arrays = np.stack(arrays)
    top = np.sort(arrays, axis=-1)
    best = arrays.argmax(-1)
    return (np.any(best != best[0], axis=0)
            | np.any(top[..., -1] - top[..., -2] <= tol, axis=0))


@contextlib.contextmanager
def recorded_probabilities():
    """Record, in call order, every class-probability array the tools
    compute, as (kind, array): "model" for the forwards' outputs whose
    rows sum to 1 (``loop.forward_outputs``) and a serving artifact's
    ``posterior_cls_prob``, "probe" for the logistic probes'
    (``logreg.LogisticFit.scores``, softmaxed) and for every output after
    the first of those (a model whose head a probe rewrote)."""
    import numpy as np

    from scae_tpu_torch import serve
    from scae_tpu_torch.train import logreg, loop

    arrays = []
    forward, scores, call = (loop.forward_outputs,
                             logreg.LogisticFit.scores,
                             serve.ServingModel.__call__)

    def keep(kind, a):
        a = np.asarray(a, np.float64)
        if a.ndim == 2 and np.allclose(a.sum(-1), 1.0, atol=1e-3):
            probed = any(k == "probe" for k, _ in arrays)
            arrays.append(("probe" if probed else kind, a))

    def recording_forward(*args, **kwargs):
        out = forward(*args, **kwargs)
        for a in out:
            keep("model", a)
        return out

    def recording_scores(self, X):
        s = scores(self, X)
        e = np.exp(s - s.max(axis=1, keepdims=True))
        keep("probe", e / e.sum(axis=1, keepdims=True))
        return s

    def recording_call(self, image):
        out = call(self, image)
        keep("model", out["posterior_cls_prob"].detach().cpu().numpy())
        return out

    loop.forward_outputs = recording_forward
    logreg.LogisticFit.scores = recording_scores
    serve.ServingModel.__call__ = recording_call
    try:
        yield arrays
    finally:
        loop.forward_outputs = forward
        logreg.LogisticFit.scores = scores
        serve.ServingModel.__call__ = call


def tools_argv(name, tmp, where, c_star=None):
    """The arguments of tool ``name`` in the tools phase's directory
    ``tmp``, on the card or (``where`` "cpu") with --device cpu;
    probe_calibrate is baked at ``c_star``, its side's pooled C*."""
    ckpts = [os.path.join(tmp, f"member{s}", "ckpt") for s in TOOLS_SEEDS]
    spec = os.path.join(tmp, "spec.json")
    artifact = os.path.join(tmp, "artifact")
    argv = {
        "ensemble_eval": ckpts + ["--"] + TOOLS_CLI,
        "ensemble_pool": [spec, "--dump-probs",
                          os.path.join(tmp, f"pool_{where}.npz")],
        # one of the four default Cs, the C* of every earlier run: each fit
        # takes 6-16 s on the host, and the script stays under 700 s
        "probe_eval": [spec, "--c-grid", "100"],
        "probe_calibrate": [ckpts[0], "--out",
                            os.path.join(tmp, f"calibrated_{where}"),
                            "--c-star", str(c_star), "--"] + TOOLS_CLI,
        "verify_serving_readout": [artifact, "--ckpt",
                                   os.path.join(tmp, "calibrated_card"),
                                   "--"] + TOOLS_CLI,
        "bench_serving": [artifact, "--repeats",
                          str(BENCH_REPEATS if where == "card" else 2)],
    }[name]
    return (["--device", "cpu"] if where == "cpu" else []) + argv


def run_tool(torch, name, argv):
    """``scae_tpu_torch.tools.<name>.main(argv)`` in this process, its
    output captured: its result, the probabilities it computed
    (``recorded_probabilities``), its seconds, output and launch
    counts."""
    import importlib

    module = importlib.import_module(f"scae_tpu_torch.tools.{name}")
    zero_kernel_counts()
    t0 = time.perf_counter()
    with recorded_probabilities() as arrays, eager_forwards() as forwards, \
            contextlib.redirect_stdout(io.StringIO()) as text:
        result = module.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"result": result, "arrays": arrays,
            "seconds": time.perf_counter() - t0, "text": text.getvalue(),
            "counts": kernel_counts(), "forwards": forwards}


def tools_phase(torch, card, rows, tmp):
    """The port's model tools on the card against the same tools with
    ``--device cpu`` on the same checkpoints: two model=mnist members
    trained through the CLI (graph scans), then ensemble_eval,
    ensemble_pool (a group a member), probe_eval and probe_calibrate on
    them; the card's calibrated checkpoint exported with the attention
    flag (K6) at batch 128, and verify_serving_readout and bench_serving
    on the artifact.
    Each tool's launch counts are held to the ones its batches imply, its
    models' class probabilities to the CPU run's within TOOLS_PROB_TOL,
    its C* to the CPU run's, and each accuracy to the CPU run's within
    the ``unsettled`` rows."""
    import numpy as np

    from scae_tpu_torch import serve
    from scae_tpu_torch.config import load_config
    from scae_tpu_torch.factory import make_scae
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS
    from scae_tpu_torch.train import cli
    from scae_tpu_torch.train.checkpoint import CheckpointManager

    os.makedirs(tmp, exist_ok=True)
    n_train, n_val, n_test = 1024, 512, 256
    n_batches = -(-n_test // BATCH)
    for seed in TOOLS_SEEDS:
        out = os.path.join(tmp, f"member{seed}")
        zero_kernel_counts()
        t0 = time.perf_counter()
        with eager_forwards() as forwards:
            run_cli(cli, TOOLS_CLI + [f"seed={seed}",
                                      f"trainer.checkpoint_dir={out}/ckpt",
                                      f"trainer.log_dir={out}/logs"])
        torch.cuda.synchronize()
        caps = scan_captures()
        check_kernel_counts(
            card, rows, f"training member {seed} through the CLI "
            f"({caps['train']} train and {caps['eval']} eval graphs "
            f"captured; eager forwards {forwards})",
            graph_counts_expected(caps, forwards))
        say(f"tools: member {seed} (model=mnist, f32 convs, 1 epoch of "
            f"{n_train} images, batch {BATCH}) trained in "
            f"{time.perf_counter() - t0!r} s [{card}]")
    with open(os.path.join(tmp, "spec.json"), "w") as f:
        json.dump({"split_seed": 7, "groups": [
            {"name": f"m{seed}", "overrides": TOOLS_CLI,
             "members": [{"run": os.path.join(tmp, f"member{seed}", "ckpt"),
                          "log": os.path.join(tmp, f"member{seed}",
                                              "logs")}]}
            for seed in TOOLS_SEEDS]}, f)

    runs = {"card": {}, "cpu": {}}
    for name in TOOLS:
        if name == "verify_serving_readout":
            # the card's calibrated checkpoint, exported with the
            # attention flag
            mk = dict(load_config("config", TOOLS_CLI)["model"])
            mk["pcae_decoder_params"] = dict(mk["pcae_decoder_params"],
                                             fused_impl="xla")
            model = make_scae(mk, device=torch.device("cuda"))
            model.load_state_dict(CheckpointManager(os.path.join(
                tmp, "calibrated_card")).restore_params(
                    step=runs["card"]["probe_calibrate"]["result"]["step"]))
            model.obj_encoder.use_pallas_attention = True
            serve.export_serving(model, image_shape=mk["image_shape"],
                                 batch_size=BATCH,
                                 out_dir=os.path.join(tmp, "artifact"),
                                 device=torch.device("cuda"),
                                 model_config=mk)
        for where, done in runs.items():
            # probe_calibrate bakes its side's pooled C*
            c_star = done.get("probe_eval", {}).get("result", {}).get(
                "c_star")
            done[name] = run_tool(torch, name,
                                  tools_argv(name, tmp, where, c_star))

    failures = []
    # the artifact's calls replay one graph (batch 128): K6 launches 4
    # times in its warm-up call and 4 in its capture, none in a replay, and
    # V1f once in each; bench_serving's live model replays a graph of its
    # own. The forwards of the other tools run op by op: V1f once a batch.
    expected = {"verify_serving_readout": {"K6": 4 * (WARMUP_STEPS + 1),
                                           "V1f": WARMUP_STEPS + 1},
                "bench_serving": {"K6": 4 * (WARMUP_STEPS + 1),
                                  "V1f": 2 * (WARMUP_STEPS + 1)}}
    accuracies = {
        "ensemble_eval": {"prior_acc": n_test, "posterior_acc": n_test,
                          "ensemble_acc": n_test},
        "ensemble_pool": {k: n_test for k in (
            "pooled_prior", "pooled_posterior", "pooled_valw_posterior",
            "pooled_tophalf_posterior", "group_m1_posterior",
            "group_m2_posterior")},
        "probe_eval": {"mean_val_acc": n_val, "member_test_accs": n_test,
                       "pooled_test": n_test, "group_m1_test": n_test,
                       "group_m2_test": n_test},
        "probe_calibrate": {"val_before": n_val, "val_probe": n_val,
                            "val_after": n_val},
        "verify_serving_readout": {"test_accuracy": n_test},
        "bench_serving": {}}
    for name in TOOLS:
        card_run, cpu_run = runs["card"][name], runs["cpu"][name]
        for where, run in (("card", card_run), ("cpu", cpu_run)):
            for line in run["text"].splitlines():
                say(f"  {name} ({where}): {line}")
        want = dict(expected.get(name, {}))
        want["V1f"] = want.get("V1f", 0) + card_run["forwards"]["batches"]
        check_kernel_counts(card, rows, f"{name} on the card (eager "
                            f"forwards {card_run['forwards']})", want,
                            card_run["counts"])
        if any(cpu_run["counts"].values()):
            failures.append(f"{name} with --device cpu launched "
                            f"{cpu_run['counts']}")
        card_res, cpu_res = card_run["result"], cpu_run["result"]
        # bench_serving calls the artifact 21 times on the card, 3 on the
        # CPU: its probabilities are not paired
        pairs = [] if name == "bench_serving" else list(
            zip(card_run["arrays"], cpu_run["arrays"]))
        if name != "bench_serving" and \
                len(card_run["arrays"]) != len(cpu_run["arrays"]):
            failures.append(f"{name}: {len(card_run['arrays'])} probability"
                            f" arrays on the card, {len(cpu_run['arrays'])}"
                            " on the CPU")
        gaps = {"model": 0.0, "probe": 0.0}
        for (kind, a), (kind_cpu, b) in pairs:
            if kind != kind_cpu or a.shape != b.shape:
                failures.append(f"{name}: {kind} {a.shape} against "
                                f"{kind_cpu} {b.shape}")
                continue
            gaps[kind] = max(gaps[kind], float(np.abs(a - b).max()))
        if not gaps["model"] <= TOOLS_PROB_TOL:
            failures.append(f"{name}: the models' class probabilities "
                            f"{gaps['model']:.3e} apart, beyond "
                            f"{TOOLS_PROB_TOL}")
        if card_res.get("c_star") != cpu_res.get("c_star"):
            failures.append(f"{name}: C* {card_res.get('c_star')} on the "
                            f"card, {cpu_res.get('c_star')} on the CPU")
        # a prediction moves only where the top two lie within twice the
        # largest gap of the probabilities it was taken from
        margin = max(TOOLS_PROB_TOL, 2 * max(gaps.values()))
        notes = []
        for key, n in accuracies[name].items():
            arrays = [a for _, a in card_run["arrays"] + cpu_run["arrays"]
                      if len(a) == n]
            allowed = int(unsettled(arrays, margin).sum()) if arrays else 0
            got, want = np.asarray(card_res[key]), np.asarray(cpu_res[key])
            # examples apart (a mean over members counts a member's one
            # example as a part of one; the JSON's 6 decimals as none)
            off = math.ceil(float(np.max(np.abs(got - want))) * n - 1e-3)
            notes.append(f"{key} {card_res[key]} (cpu {cpu_res[key]}, "
                         f"{off} of {n} examples apart, {allowed} "
                         "unsettled)")
            if off > allowed:
                failures.append(f"{name}: {key} differs by {off} "
                                f"examples, {allowed} unsettled")
        say(f"tools: {name}: {card_run['seconds']!r} s on the card, "
            f"{cpu_run['seconds']!r} s with --device cpu; the models' "
            f"class probabilities within {gaps['model']:.3e} of the CPU's, "
            f"the probes' within {gaps['probe']:.3e} ({len(pairs)} arrays)"
            + (f"; C* {card_res['c_star']}" if "c_star" in card_res else "")
            + "".join(f"; {note}" for note in notes) + f" [{card}]")
    pool = {w: np.load(os.path.join(tmp, f"pool_{w}.npz"))
            for w in ("card", "cpu")}
    dump_gap = max(float(np.abs(pool["card"][k] - pool["cpu"][k]).max())
                   for k in ("prior", "posterior"))
    if not dump_gap <= TOOLS_PROB_TOL or not np.array_equal(
            pool["card"]["labels"], pool["cpu"]["labels"]):
        failures.append(f"ensemble_pool --dump-probs: {dump_gap:.3e} apart")
    bench = runs["card"]["bench_serving"]["result"]
    if sorted(bench) != sorted(runs["cpu"]["bench_serving"]["result"]) \
            or bench["backend"] != "cuda":
        failures.append(f"bench_serving: keys {sorted(bench)} on the card")
    say(f"tools: bench_serving at batch {bench['batch_size']}: the "
        f"flag-on artifact {bench['artifact_images_per_sec']} images/s, "
        f"the live xla model {bench['live_images_per_sec']} images/s "
        f"(best of {BENCH_REPEATS}, synchronized) [{card}]")
    say("tools: host seconds on the card: " + json.dumps(
        {name: run["seconds"] for name, run in runs["card"].items()})
        + f" [{card}]")
    if failures:
        raise RuntimeError("tools phase: " + "; ".join(failures))
    demos_check(torch, card, rows, os.path.join(tmp, "demo"))
    pool_check(torch, card, rows, os.path.join(tmp, "pool"))


# the infer demo's forward in f32 on both sides (the demo trains with the
# shipped bf16 convolutions, whose rounding the card and the CPU need not
# share); its confidences card against CPU, abs
DEMO_F32 = ["model.pcae_cnn_encoder_params.compute_dtype=null"]
DEMO_CONF_TOL = 1e-4


def graph_counts_expected(caps, forwards):
    """The launches of a Trainer's runs whose scans' captures are ``caps``
    (``scan_captures``) and whose eager forwards are
    ``forwards`` (``eager_forwards``): K1 and V1f in each scan's warm-up
    steps and in its capture, K2+K3 and V1b in the train scans', V1f
    besides once in each eager forward."""
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS

    per = WARMUP_STEPS + 1
    return {"K1": per * (caps["train"] + caps["eval"]),
            "K2+K3": per * caps["train"],
            "V1f": per * (caps["train"] + caps["eval"]) + forwards["grids"]
            + forwards["batches"],
            "V1b": per * caps["train"]}


def demos_check(torch, card, rows, work):
    """``examples.train_resume_demo`` on the card (its small model, 2
    epochs, then a resume to epoch 4), then ``examples.infer_demo`` on its
    checkpoint on the card and on the CPU: the same predictions and labels,
    confidences within DEMO_CONF_TOL."""
    from scae_tpu_torch.examples import infer_demo, train_resume_demo
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS

    zero_kernel_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text, \
            eager_forwards() as forwards:
        state = train_resume_demo.main([work])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for line in text.getvalue().splitlines():
        say(f"  train_resume_demo: {line}")
    caps = scan_captures()
    check_kernel_counts(card, rows, "examples.train_resume_demo (its "
                        f"{caps['train']} train and {caps['eval']} eval "
                        f"graphs captured; eager forwards {forwards})",
                        graph_counts_expected(caps, forwards))
    # 512 synthetic images, 128 held out for validation, batch 32
    if "[demo] interrupted at step 24;" not in text.getvalue() or \
            state.step != 48 or "resumed from step 24" not in \
            text.getvalue():
        raise RuntimeError(f"train_resume_demo: stopped at step "
                           f"{state.step}, expected 24 then 48")
    say(f"tools: examples.train_resume_demo on the card: 24 steps, resumed "
        f"at step 24 to 48, in {seconds!r} s [{card}]")

    argv = [*train_resume_demo.OVERRIDES, *DEMO_F32,
            f"trainer.checkpoint_dir={work}/ckpt",
            f"trainer.log_dir={work}/infer_logs"]
    runs = {}
    for where in ("card", "cpu"):
        zero_kernel_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            runs[where] = infer_demo.main(
                argv + [f"--out={work}/infer_{where}"]
                + (["--device=cpu"] if where == "cpu" else []))
        if where == "card":
            torch.cuda.synchronize()
            check_kernel_counts(card, rows, "examples.infer_demo on the "
                                "card (no likelihood kernel on its forward; "
                                "V1f in its graph's warm-up call and "
                                "capture)", {"V1f": WARMUP_STEPS + 1})
        for line in text.getvalue().splitlines():
            say(f"  infer_demo ({where}): {line}")
        say(f"tools: examples.infer_demo ({where}) in "
            f"{time.perf_counter() - t0!r} s")
    got, want = runs["card"]["records"], runs["cpu"]["records"]
    gap = max(abs(g["confidence"] - w["confidence"])
              for g, w in zip(got, want))
    if len(got) != len(want) or any(
            (g["index"], g["pred"], g["label"]) != (
                w["index"], w["pred"], w["label"])
            for g, w in zip(got, want)) or not gap <= DEMO_CONF_TOL + 1e-9:
        raise RuntimeError(f"infer_demo: the card's {len(got)} records "
                           f"differ from the CPU's {len(want)} (largest "
                           f"confidence gap {gap})")
    say(f"tools: examples.infer_demo on the card against the CPU from the "
        f"same checkpoint (step {runs['card']['step']}): {len(got)} "
        f"predictions equal, confidences within {gap!r} (4 decimals), "
        f"accuracy {runs['card']['accuracy']!r} [{card}]")


def pool_check(torch, card, rows, work):
    """``tools.pool_inprocess.train_members`` with two model=mnist members
    (the tools phase's recipe: f32 convs, one epoch of the synthetic
    1,024 / 512 / 256 split; seeds 3 then 1) under cuDNN's deterministic
    algorithms, against seed 1 trained alone through the Trainer: every
    parameter bit for bit, and the other member different."""
    from scae_tpu_torch.config import load_config
    from scae_tpu_torch.tools import pool_inprocess
    from scae_tpu_torch.train.checkpoint import CheckpointManager
    from scae_tpu_torch.train.loop import Trainer

    def final(ckpt):
        mgr = CheckpointManager(ckpt)
        return mgr.latest_step, mgr.restore_params(mgr.latest_step)

    was = deterministic_cudnn(torch)
    try:
        zero_kernel_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                eager_forwards() as forwards:
            pool_inprocess.train_members(
                members=[("m0", 1, ["seed=3"]), ("m1", 1, ["seed=1"])],
                log_root=f"{work}/logs", ckpt_root=f"{work}/ckpt",
                base_overrides=TOOLS_CLI)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_kernel_counts(card, rows, "pool_inprocess.train_members (2 "
                            f"members; eager forwards {forwards})",
                            graph_counts_expected(scan_captures(),
                                                  forwards))
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = Trainer(load_config("config", TOOLS_CLI + [
                "seed=1", f"trainer.checkpoint_dir={work}/solo",
                f"trainer.log_dir={work}/solo_logs"]))
            trainer.run(max_epochs=1)
            trainer.close()
    finally:
        deterministic_cudnn(torch, was[0])
    (m_step, pooled), (s_step, solo) = final(f"{work}/ckpt/m1"), final(
        f"{work}/solo")
    _, other = final(f"{work}/ckpt/m0")
    differ = [k for k in solo if not torch.equal(solo[k], pooled[k])]
    if m_step != s_step or sorted(solo) != sorted(pooled) or differ or \
            all(torch.equal(other[k], solo[k]) for k in solo):
        raise RuntimeError(f"pool_inprocess: member m1 (step {m_step}) "
                           f"against the solo run (step {s_step}): "
                           f"{len(differ)} parameters differ")
    say(f"tools: pool_inprocess.train_members, 2 model=mnist members of 1 "
        f"epoch in {seconds!r} s: member m1 (after m0, seed 3) bit for bit "
        f"seed 1 trained alone ({len(solo)} parameters, step {s_step}, "
        f"deterministic cuDNN); m0 differs [{card}]")


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
    return busy_ms


def profile_graph_phase(torch, card, scan, state, data, idxs, n,
                        eager_busy_ms):
    """The graph scan's device busy time per step over ``n`` replays, beside
    the host clock. Where the profiler records no device time inside the
    graph, the eager train window's busy time (``eager_busy_ms``) stands in
    for it, and the line says so."""
    from torch.profiler import ProfilerActivity, profile

    scan(state, data, idxs[:1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scan(state, data, idxs[1:1 + n])
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0)
                  for e in device) / 1e3 / n
    per_step = sum(e.count for e in device) / n
    if busy_ms > 0:
        source = "the profiler's device records inside the graph"
    else:
        busy_ms, source = eager_busy_ms, ("the eager train window's device "
                                          "busy time: the profiler recorded "
                                          "no device time inside the graph")
    say(f"profile of {n} graph train step(s) (gather): device busy "
        f"{busy_ms:.4f} ms per step (from {source}), {per_step:.1f} device "
        f"operations recorded per step, host clock {host_ms:.4f} ms per step "
        f"under the profiler, idle share {1 - busy_ms / host_ms:.1%} "
        f"[{card}]")
    say(events.table(sort_by="cuda_time_total", row_limit=25))


# ----------------------------------------------------------------- mesh

MESH_STEPS = 8         # eager steps of each mesh run held to one process
MESH_TIMED = 10        # further steps timed on the host clock
MESH_PROFILED = 3      # steps of each device-busy window
MESH_LOSS_RTOL = 2e-3  # per step, the ROADMAP's trajectory tolerance
# per parameter, of its largest entry: held after the first step of 2x1
# (rounding alone moves 8 steps by ~1e-2: RMSprop's eps of 1e-2/B^2 turns
# near-zero gradients' rounding into whole steps, and the routing's argmax
# compounds it; the phase's control measures that), and after every step
# of 1x2, whose arithmetic is one process's
MESH_PARAM_RTOL = 1e-3
MESH_TIMEOUT = 600     # seconds for one launch of ranks
MESH_CLI = ["model=mnist", "data_loader.source=synthetic",
            "data_loader.synthetic_train=1536", "data_loader.val_size=512",
            "data_loader.synthetic_test=256", "trainer.max_epochs=2",
            "trainer.log_every_steps=4", "trainer.max_eval_batches=2"]
HERE = os.path.dirname(os.path.abspath(__file__))


def mesh_batches(n):
    """``n`` global batches of the flagship: (128, 28, 28) uint8 images and
    their labels, each from its own seed."""
    import numpy as np

    out = []
    for k in range(n):
        rng = np.random.RandomState(100 + k)
        out.append((rng.randint(0, 256, (BATCH, 28, 28)).astype(np.uint8),
                    rng.randint(0, 10, (BATCH,)).astype(np.int64)))
    return out


def deterministic_cudnn(torch, on=True):
    """cuDNN's deterministic algorithms (and no autotuning) on or off; the
    previous setting."""
    was = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False if on else was[1]
    return was


def step_times(torch, step, batches, n, barrier=None):
    """Host ms per step over ``n`` steps (each synchronised), after an
    optional barrier that lines the ranks up; then the device's busy ms
    per step over MESH_PROFILED steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    if barrier is not None:
        barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n):
        step(*batches[k % len(batches)])
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(MESH_PROFILED):
            step(*batches[k % len(batches)])
        torch.cuda.synchronize()
    busy_ms = sum(getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  ) / 1e3 / MESH_PROFILED
    return host_ms, busy_ms


def state_gap(torch, got, want):
    """(largest gap of a parameter relative to its largest |entry| in
    ``want``, that parameter's name, how many exceed MESH_PARAM_RTOL)
    between two state dicts."""
    worst, over = (0.0, ""), 0
    for name, ref in want.items():
        ref = ref.float()
        gap = float((got[name].to(ref.device).float() - ref).abs().max()) / (
            float(ref.abs().max()) + 1e-30)
        over += gap > MESH_PARAM_RTOL
        if gap >= worst[0]:
            worst = (gap, name)
    return worst[0], worst[1], over


def first_batch_grads(torch, model, mesh=None, banks=None):
    """(The gradients of the loss (noise off) of the mesh phase's first
    global batch, padded to 40x40, for each of ``model``'s parameters, by
    name; the capsule MLPs' first pre-activations (b, O, hidden) of this
    process's rows, as the forward computed them). Under ``mesh`` the
    gradients are the global batch's, the split banks (``banks``)
    gathered."""
    from scae_tpu_torch.parallel import mesh as mesh_lib
    from scae_tpu_torch.parallel.train_step import loss_and_grads
    from scae_tpu_torch.train.data import pad_to_canvas

    images, labels = mesh_batches(1)[0]
    images = pad_to_canvas(torch.from_numpy(images)[:, None].float() / 255,
                           40)
    mlps = model.obj_decoder.capsule_layer.mlps
    inputs = []
    hook = mlps.register_forward_pre_hook(
        lambda module, args: inputs.append(args[0].detach()))
    try:
        _, grads = loss_and_grads(model, images, labels,
                                  torch.device("cuda"), mesh)
    finally:
        hook.remove()
    # StackedMLP's first layer, the batched matmul its forward runs
    with torch.no_grad():
        pre = torch.baddbmm(mlps.bias_0[:, None, :],
                            inputs[0].transpose(0, 1), mlps.kernel_0)
    out = {}
    for (name, p), g in zip(model.named_parameters(), grads):
        g = torch.zeros_like(p) if g is None else g   # a parameter unused
        if banks and name in banks:
            g = mesh_lib.gather_tensor(g, mesh, banks[name])
        out[name] = g.cpu()
    return out, pre.transpose(0, 1).cpu()


def kink_flips(torch, want_grads, got_grads, want_pre, got_pre):
    """Where the 2x1 run's first batch meets relu's kink on the other side
    from one process's, in the capsule MLPs' first layer: (how many
    pre-activations, the largest |pre-activation| of them, how many sit at
    the (capsule, unit) of the first bias's worst gradient entry)."""
    flips = (got_pre > 0) != (want_pre > 0)
    name = "obj_decoder.capsule_layer.mlps.bias_0"
    worst = int((got_grads[name] - want_grads[name]).abs().argmax())
    c, u = divmod(worst, want_grads[name].shape[1])
    largest = float(want_pre[flips].abs().max()) if flips.any() else 0.0
    return int(flips.sum()), largest, int(flips[:, c, u].sum())


def grad_gaps(want, got):
    """((largest gap of an entry relative to its tensor's largest |entry|
    in ``want``, that tensor, how many of its entries are off by more than
    1e-4 of it, its entries), (largest norm of a tensor's difference
    relative to its norm in ``want``, that tensor)) between two dicts of
    gradients."""
    entry, norm = (0.0, "", 0, 0), (0.0, "")
    for name, g in want.items():
        diff = (got[name] - g).abs()
        largest = float(g.abs().max()) + 1e-30
        gap = float(diff.max()) / largest
        if gap >= entry[0]:
            entry = (gap, name, int((diff > 1e-4 * largest).sum()),
                     g.numel())
        norm = max(norm, (float(diff.norm()) / (float(g.norm()) + 1e-30),
                          name))
    return entry, norm


def mesh_steps_rank(torch, out):
    """A rank of the mesh phase's step runs (two gloo processes on one
    card): 2x1 and 1x2 (its banks split by shard_state) from the same
    state as the main process's run, MESH_STEPS eager flagship steps each,
    the launch counts and losses, the parameters (rank 0 saves them), the
    host and device times; then one banded 2x1 step with the attention
    flag."""
    import torch.distributed as dist

    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS
    from scae_tpu_torch.parallel import mesh as mesh_lib
    from scae_tpu_torch.parallel import train_step as ts
    from scae_tpu_torch.train.loop import make_augment_fn

    cuda = torch.device("cuda")
    assert mesh_lib.maybe_initialize_distributed("gloo")
    rank = dist.get_rank()
    augment = make_augment_fn(canvas=40, max_shift=6)
    batches = mesh_batches(MESH_STEPS)
    result = {"rank": rank}
    for tag, shape in (("2x1", (2, 1)), ("1x2", (1, 2))):
        mesh = mesh_lib.make_mesh(*shape)
        state = train_state(torch, cuda, True, FLAGSHIP_MODEL_PARAMS)
        if shape[1] > 1:
            ts.shard_state(state, mesh)
        step = ts.make_raw_train_step(state, augment, cuda, mesh)
        banks = len(state.banks)
        zero_kernel_counts()
        losses, gaps = [], []
        for k, b in enumerate(batches, 1):
            losses.append(float(step(*b)["loss"]))
            # the whole parameters after each step, against one process's
            if shape[1] > 1:
                ts.unshard_state(state, mesh)
            if rank == 0:
                gaps.append(state_gap(torch, state.model.state_dict(),
                                      torch.load(os.path.join(
                                          out, f"single_{k}.pt"))))
            if shape[1] > 1:
                ts.shard_state(state, mesh)
        torch.cuda.synchronize()
        counts = kernel_counts()
        # the first batch's gradients from the initial state
        fresh = train_state(torch, cuda, True, FLAGSHIP_MODEL_PARAMS)
        if shape[1] > 1:
            ts.shard_state(fresh, mesh)
        grads, pre = first_batch_grads(torch, fresh.model, mesh,
                                       fresh.banks)
        if rank == 0:
            torch.save(grads, os.path.join(out, f"grads_{tag}.pt"))
        if tag == "2x1":
            torch.save(pre, os.path.join(out, f"pre_{tag}_{rank}.pt"))
        del fresh
        host_ms, busy_ms = step_times(torch, step, batches, MESH_TIMED,
                                      dist.barrier)
        result[tag] = {"losses": losses, "counts": counts, "banks": banks,
                       "gaps": gaps, "host_ms": host_ms, "busy_ms": busy_ms}
    mesh = mesh_lib.make_mesh(2, 1)
    state = train_state(torch, cuda, True, dict(
        FLAGSHIP_MODEL_PARAMS,
        pcae_decoder_params=dict(fused_impl="pallas_banded")),
        attention=True)
    zero_kernel_counts()
    metrics = ts.make_raw_train_step(state, augment, cuda, mesh)(*batches[0])
    torch.cuda.synchronize()
    result["banded"] = {"loss": float(metrics["loss"]),
                        "counts": kernel_counts()}
    del state
    result["serve"] = mesh_serve_rank(torch, out, rank)
    say("MESH_RANK " + json.dumps(result))
    dist.destroy_process_group()


def serve_model_and_input(torch):
    """The serve phase's flagship (the factory's weights from seed 0 on
    the card, fused_impl="xla") with the attention flag on, its config,
    and its input batch of 128 (on the host)."""
    import numpy as np

    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS, make_scae

    params = dict(FLAGSHIP_MODEL_PARAMS,
                  pcae_decoder_params=dict(fused_impl="xla"))
    model = make_scae(params, device=torch.device("cuda"), seed=0)
    model.obj_encoder.use_pallas_attention = True
    x = torch.from_numpy(np.random.RandomState(0).rand(
        BATCH, *params["image_shape"]).astype(np.float32))
    return model, params, x


def mesh_serve_rank(torch, out, rank):
    """A rank's part of the mesh export: the flag-on flagship exported on
    the 2x1 mesh at global batch 128 (each rank traces 64 rows, rank 0
    writes), loaded back and called with the global batch; its outputs
    saved for the main process; the export's and the call's launch
    counts."""
    from scae_tpu_torch import serve
    from scae_tpu_torch.parallel import mesh as mesh_lib

    model, params, x = serve_model_and_input(torch)
    mesh = mesh_lib.make_mesh(2, 1)
    path = os.path.join(out, "mesh_artifact")
    zero_kernel_counts()
    t0 = time.perf_counter()
    serve.export_serving(model, image_shape=params["image_shape"],
                         batch_size=BATCH, out_dir=path,
                         device=torch.device("cuda"), mesh=mesh,
                         model_config=params)
    export_seconds = time.perf_counter() - t0
    export_counts = kernel_counts()
    loaded = serve.load_serving(path)
    xc = x.cuda()
    zero_kernel_counts()
    loaded(xc)     # the warm-up call and the capture of the rank's graph
    torch.cuda.synchronize()
    counts = kernel_counts()
    t0 = time.perf_counter()
    got = loaded(xc)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    torch.save({k: v.cpu() for k, v in got.items()},
               os.path.join(out, f"mesh_serve_{rank}.pt"))
    return {"export_seconds": export_seconds,
            "export_counts": export_counts, "counts": counts,
            "call_ms": call_ms,
            "manifest": {k: loaded.manifest[k] for k in (
                "batch_axis", "nr_devices", "mesh", "input",
                "custom_ops")}}


def nccl_capture_check(torch):
    """Under a world-1 NCCL group: the flagship train scan's graph against
    the eager loop from the same state over 4 rows; the all-reduces and
    all-gathers issued while a graph was being captured (a world-1 NCCL
    all-reduce in place may launch no kernel, so these calls are what shows
    the capture took the collectives); and the NCCL kernels in 2 replays
    and in 2 eager steps, from the profiler's device records. Returns
    (bit for bit, largest loss gap, collectives captured, NCCL kernels per
    replay, per eager step)."""
    import numpy as np
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS
    from scae_tpu_torch.parallel import mesh as mesh_lib
    from scae_tpu_torch.parallel import train_step as ts
    from scae_tpu_torch.train.loop import make_augment_fn

    cuda = torch.device("cuda")
    mesh = mesh_lib.make_mesh()
    rng = np.random.RandomState(7)
    data = {"image": torch.from_numpy(rng.randint(
                0, 256, (512, 28, 28)).astype(np.uint8)).to(cuda),
            "label": torch.from_numpy(rng.randint(0, 10, (512,))).to(cuda)}
    idxs = np.stack([np.random.RandomState(k).permutation(512)[:BATCH]
                     for k in range(6)])
    captured = []
    calls = {name: getattr(dist, name) for name in ("all_reduce",
                                                    "all_gather")}

    def counting(name):
        def call(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                captured.append(name)
            return calls[name](*args, **kwargs)
        return call

    losses, nccl = [], []
    try:
        for name in calls:
            setattr(dist, name, counting(name))
        for make in (ts.make_train_scan, ts.make_eager_train_scan):
            state = train_state(torch, cuda, True, FLAGSHIP_MODEL_PARAMS)
            scan = make(make_augment_fn(canvas=40, max_shift=6), cuda, mesh)
            _, metrics = scan(state, data, idxs[:4])
            losses.append(metrics["loss"].cpu())
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                scan(state, data, idxs[4:])
                torch.cuda.synchronize()
            nccl.append(sum(
                e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "nccl" in e.key.lower()) / 2)
    finally:
        for name, fn in calls.items():
            setattr(dist, name, fn)
    gap = float((losses[0] - losses[1]).abs().max())
    return (torch.equal(losses[0], losses[1]), gap, len(captured), nccl[0],
            nccl[1])


def mesh_cli_rank(torch, out, argv):
    """A run of the training CLI with cuDNN's deterministic algorithms, its
    logs and checkpoints in ``out``: under a world-1 NCCL group (launched
    by torch.distributed.run) or with none. The scans' timed search of
    cuDNN's algorithms is off (``graphs.cudnn_search`` replaced by a
    context that changes nothing): it picks among the deterministic
    algorithms by their times, which differ from process to process, and
    two processes would then differ by the algorithms' rounding, not by
    the group. Prints its result line: the step, the launch counts, the
    graphs captured and, under the group, the NCCL capture check."""
    import torch.distributed as dist

    from scae_tpu_torch.parallel import train_step
    from scae_tpu_torch.train import cli

    deterministic_cudnn(torch)
    train_step.cudnn_search = contextlib.nullcontext
    zero_kernel_counts()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        state = cli.main(argv + [f"trainer.checkpoint_dir={out}/ckpt",
                                 f"trainer.log_dir={out}/logs"])
    torch.cuda.synchronize()
    for line in text.getvalue().splitlines():
        say(f"  cli: {line}")
    result = {"step": state.step, "counts": kernel_counts(),
              "captures": scan_captures(),
              "wall": training_wall_time(text.getvalue()),
              "group": dist.is_initialized()}
    if dist.is_initialized():
        result["backend"] = dist.get_backend()
        result["nccl_check"] = nccl_capture_check(torch)
    say("MESH_CLI " + json.dumps(result))
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_options_rank(torch, out, argv):
    """A run of the training CLI with a seed probe and a head refit, with
    cuDNN's deterministic algorithms, its logs and checkpoints in
    ``out``: under a group launched by torch.distributed.run, or with
    none. Prints its result line: the seed it continued, the probe's two
    unrounded scores, the checkpoints this process saved, its launch
    counts."""
    import torch.distributed as dist

    from scae_tpu_torch.train import cli, loop
    from scae_tpu_torch.train.checkpoint import CheckpointManager

    deterministic_cudnn(torch)
    scores, saves = [], []
    evaluate, save = loop.Trainer.evaluate, CheckpointManager.save

    def recording_evaluate(self, dataset, max_batches=None):
        metrics, viz = evaluate(self, dataset, max_batches)
        scores.append(metrics.get("val_rec_ll_loss"))
        return metrics, viz

    def recording_save(self, step, state, metrics=None):
        done = save(self, step, state, metrics)
        if done:
            saves.append(int(step))
        return done

    loop.Trainer.evaluate = recording_evaluate
    CheckpointManager.save = recording_save
    zero_kernel_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        state = cli.main(argv + [f"trainer.checkpoint_dir={out}/ckpt",
                                 f"trainer.log_dir={out}/logs"])
    torch.cuda.synchronize()
    for line in text.getvalue().splitlines():
        say(f"  cli: {line}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    result = json.dumps({
        "rank": rank, "seed": state.seed, "step": state.step,
        "scores": scores[:2], "saves": saves, "counts": kernel_counts(),
        "seconds": time.perf_counter() - t0})
    say("MESH_OPTIONS " + result)
    # the ranks share one standard output, where their lines may mix
    with open(os.path.join(out, f"result_{rank}.json"), "w") as f:
        f.write(result)
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_single_rank(torch, out):
    """The mesh phase's one-process reference, with cuDNN's deterministic
    algorithms: MESH_STEPS eager flagship steps from the ranks' state,
    its parameters after each step (``single_<k>.pt``, for rank 0 to
    compare with), the host and device times; the control (one process
    again under cuDNN's default algorithms: what rounding alone moves the
    same steps by); the first batch's gradients and the capsule MLPs'
    pre-activations, and the control's gap to them; one banded step with
    the attention flag. Writes them to ``single.pt`` in ``out``."""
    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS
    from scae_tpu_torch.parallel.train_step import make_raw_train_step
    from scae_tpu_torch.train.loop import make_augment_fn

    cuda = torch.device("cuda")
    augment = make_augment_fn(canvas=40, max_shift=6)
    batches = mesh_batches(MESH_STEPS)

    def one_process():
        state = train_state(torch, cuda, True, FLAGSHIP_MODEL_PARAMS)
        step = make_raw_train_step(state, augment, cuda)
        losses, params = [], []
        for b in batches:
            losses.append(float(step(*b)["loss"]))
            params.append({k: v.detach().cpu().clone()
                           for k, v in state.model.state_dict().items()})
        return step, losses, params

    deterministic_cudnn(torch)
    step, losses, params = one_process()
    for k, p in enumerate(params, 1):
        torch.save(p, os.path.join(out, f"single_{k}.pt"))
    host_ms, busy_ms = step_times(torch, step, batches, MESH_TIMED)
    deterministic_cudnn(torch, False)
    _, control_losses, control = one_process()
    deterministic_cudnn(torch)
    want_grads, want_pre = first_batch_grads(torch, train_state(
        torch, cuda, True, FLAGSHIP_MODEL_PARAMS).model)
    deterministic_cudnn(torch, False)
    control_grads = grad_gaps(want_grads, first_batch_grads(
        torch, train_state(torch, cuda, True, FLAGSHIP_MODEL_PARAMS).model)[0])
    deterministic_cudnn(torch)
    banded = train_state(torch, cuda, True, dict(
        FLAGSHIP_MODEL_PARAMS,
        pcae_decoder_params=dict(fused_impl="pallas_banded")),
        attention=True)
    banded_loss = float(make_raw_train_step(banded, augment, cuda)(
        *batches[0])["loss"])
    torch.save({
        "losses": losses, "host_ms": host_ms, "busy_ms": busy_ms,
        "control_gaps": [state_gap(torch, c, p)
                         for c, p in zip(control, params)],
        "control_loss_gap": max(abs(a - b) / max(1.0, abs(b))
                                for a, b in zip(control_losses, losses)),
        "want_grads": want_grads, "want_pre": want_pre,
        "control_grads": control_grads, "banded_loss": banded_loss},
        os.path.join(out, "single.pt"))


def mesh_rank(argv) -> int:
    """The ranks' entry point: ``--mesh-rank single OUT``, ``--mesh-rank
    steps OUT``, ``--mesh-rank cli OUT [overrides]`` or ``--mesh-rank
    options OUT [overrides]``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    role, out, rest = argv[0], argv[1], argv[2:]
    if role == "single":
        mesh_single_rank(torch, out)
    elif role == "steps":
        deterministic_cudnn(torch)
        mesh_steps_rank(torch, out)
    elif role == "cli":
        mesh_cli_rank(torch, out, rest)
    elif role == "options":
        mesh_options_rank(torch, out, rest)
    else:
        raise SystemExit(f"unknown mesh rank role {role!r}")
    return 0


def result_lines(output, tag):
    return [json.loads(line.split(tag, 1)[1]) for line in output.splitlines()
            if line.startswith(tag)]


def run_checked(cmd, what, timeout=MESH_TIMEOUT):
    """Run ``cmd`` from this script's directory with the package on the
    path; its output, or RuntimeError with its end."""
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"{what} exited with {out.returncode}: "
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    say(f"{what}: exit 0 in {seconds:.1f} s")
    return out.stdout + out.stderr


def mesh_nccl_runs(card, tmp):
    """The CLI on model=mnist under a world-1 NCCL group, its graphs
    capturing the collectives, against the CLI with no group; returns the
    no-group run's images/s end to end."""
    script = os.path.abspath(__file__)
    runs = {}
    for tag, launcher in (
            ("nccl", [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", "1"]),
            ("none", [sys.executable])):
        out = os.path.join(tmp, f"cli_{tag}")
        text = run_checked(launcher + [script, "--mesh-rank", "cli", out,
                                       *MESH_CLI],
                           f"the CLI on model=mnist, {tag} group")
        runs[tag] = (result_lines(text, "MESH_CLI ")[0],
                     train_records(read_jsonl(os.path.join(out, "logs",
                                                           "metrics.jsonl"))))
    (nccl, nccl_records), (plain, plain_records) = runs["nccl"], runs["none"]
    if nccl.get("backend") != "nccl" or plain["group"]:
        raise RuntimeError(f"groups: {nccl.get('backend')}, {plain['group']}")
    if nccl["captures"]["train"] < 1 or nccl["counts"] != plain["counts"]:
        raise RuntimeError(f"the NCCL CLI captured {nccl['captures']} with "
                           f"launches {nccl['counts']}, no group "
                           f"{plain['captures']} with {plain['counts']}")
    if [r["step"] for r in nccl_records] != [r["step"]
                                             for r in plain_records]:
        raise RuntimeError("the NCCL and no-group CLI logged other steps")
    gaps = [abs(a[k] - b[k]) / max(1.0, abs(b[k]))
            for a, b in zip(nccl_records, plain_records) for k in LOSS_KEYS]
    same = all(a[k] == b[k] for a, b in zip(nccl_records, plain_records)
               for k in LOSS_KEYS)
    if not max(gaps) <= TRAINER_RTOL:
        raise RuntimeError(f"the NCCL CLI's losses are {max(gaps):.3e} off "
                           "the no-group CLI's")
    equal, gap, in_capture, per_replay, per_eager = nccl["nccl_check"]
    if not (in_capture > 0 and per_replay == per_eager and gap <= 1e-4):
        raise RuntimeError(f"NCCL capture: {in_capture} collectives "
                           f"captured, {per_replay} NCCL kernels a replay, "
                           f"{per_eager} an eager step, loss gap {gap}")
    say(f"mesh: the CLI on model=mnist under a world-1 NCCL group "
        f"(torch.distributed.run, deterministic cuDNN, its algorithms by "
        f"the heuristic in both runs): "
        f"{nccl['captures']['train']} train and {nccl['captures']['eval']} "
        f"eval graphs captured with their collectives, launches "
        f"{ {k: nccl['counts'][k] for k in ('K1', 'K2+K3', *VOTES)} } as "
        f"with no "
        f"group; its {len(nccl_records)} logged steps' loss terms "
        + ("equal the no-group CLI's bit for bit" if same else
           f"differ from the no-group CLI's by up to {max(gaps):.3e} "
           "relative (not bit for bit: the world-1 all-reduces return their "
           "input, so the gap is the graphs' own, run to run)")
        + f"; end to end {nccl['wall'][2]!r} images/s against "
        f"{plain['wall'][2]!r} with no group [{card}]")
    say(f"mesh: the flagship graph scan under the NCCL group: "
        f"{in_capture} collectives issued into its capture, "
        f"{per_replay:.0f} NCCL kernels in each replay's device records, "
        f"{per_eager:.0f} in each eager step; 4 rows "
        + ("bit for bit the eager loop" if equal else
           f"within {gap:.3e} of the eager loop")
        + f" [{card}]")
    return plain["wall"][2]


def mesh_two_process_cli(card, tmp, plain_rate):
    """The CLI on two gloo processes on the card: 2 epochs, a resume,
    mode=test; process 0 alone logs and checkpoints."""
    cli2 = os.path.join(tmp, "cli_2x1")
    base = MESH_CLI + ["trainer.mesh.n_data=2", "trainer.mesh.backend=gloo",
                       f"trainer.checkpoint_dir={cli2}/ckpt",
                       f"trainer.log_dir={cli2}/logs"]
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "2", "-m", "scae_tpu_torch.train.cli"]
    texts = [run_checked(launch + base + extra, f"the CLI on 2 gloo "
                         f"processes{what}")
             for extra, what in (([], ""), (["trainer.max_epochs=3",
                                             "resume=true"], ", resumed"),
                                 (["mode=test"], ", mode=test"))]
    records = read_jsonl(os.path.join(cli2, "logs", "metrics.jsonl"))
    train = train_records(records)
    steps = [r["step"] for r in train]
    if steps != [4, 8, 12, 16, 20, 24]:
        raise RuntimeError(f"the 2-process CLI logged steps {steps}")
    for text in texts:
        if text.count("distributed: process 0/2 (gloo)") != 1 or \
                "distributed: process 1/2" in text:
            raise RuntimeError("the 2-process CLI's processes announced "
                               "themselves other than once from process 0")
    if texts[0].count("mesh on gloo: the scans run the eager step") != 1:
        raise RuntimeError("the gloo rule was not said once")
    if texts[1].count("resumed from step 16") != 1 or \
            "per-class recall" in texts[2] or \
            texts[2].count("test @ ckpt") != 1:
        raise RuntimeError("the 2-process resume or mode=test misbehaved")
    ckpts = sorted(os.listdir(os.path.join(cli2, "ckpt")))
    if any(".tmp" in n for n in ckpts) or "24" not in ckpts:
        raise RuntimeError(f"the 2-process checkpoints: {ckpts}")
    wall = [training_wall_time(t) for t in texts[:2]]
    test = [r for r in records if "test_loss" in r][-1]
    say(f"mesh: the CLI on 2 gloo processes on one card (model=mnist, "
        f"batch {BATCH} split {BATCH // 2} + {BATCH // 2}, scans eager): 2 "
        f"epochs, a resume to "
        f"3, mode=test; process 0 alone logged steps {steps} and wrote "
        f"checkpoints {ckpts}; test_loss {test['test_loss']!r}; end to end "
        f"{wall[0][2]!r} and {wall[1][2]!r} images/s, against "
        f"{plain_rate!r} for one process with graphs (deterministic "
        f"cuDNN there) [{card}]")


MESH_SERVE_RTOL = 1e-4  # mesh artifact vs one process, of each output's
#                        largest |entry| (predictions equal)
MESH_PROBE = ["trainer.seed_probe.n=2", "trainer.seed_probe.epochs=1"]


def mesh_serving_check(torch, card, rows, tmp, ranks):
    """The 2x1 mesh artifact (flag on, global batch 128) that the step
    ranks exported and called, against the one-process artifact of the
    same model at batch 128: predictions equal, every other output within
    MESH_SERVE_RTOL of its largest entry; K6 4 times and V1f once in the
    warm-up call and in the capture of each rank's graph, and neither in
    the export."""
    from scae_tpu_torch import serve
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS

    model, params, x = serve_model_and_input(torch)
    path = os.path.join(tmp, "single_artifact")
    serve.export_serving(model, image_shape=params["image_shape"],
                         batch_size=BATCH, out_dir=path,
                         device=torch.device("cuda"), model_config=params)
    want = {k: v.cpu() for k, v in serve.load_serving(path)(
        x.cuda()).items()}
    failures = []
    for r in ranks:
        res = r["serve"]
        got = torch.load(os.path.join(tmp, f"mesh_serve_{r['rank']}.pt"))
        gaps = {}
        for k in sorted(want):
            if k.endswith("prediction"):
                gaps[k] = int((got[k] != want[k]).sum())
                ok = gaps[k] == 0
            else:
                gaps[k] = float((got[k] - want[k]).abs().max()
                                / want[k].abs().max().clamp_min(1e-30))
                ok = gaps[k] <= MESH_SERVE_RTOL
            if not ok or got[k].shape != want[k].shape:
                failures.append(f"mesh artifact rank {r['rank']}: {k} "
                                f"off by {gaps[k]}")
        m = res["manifest"]
        launches = {k: res["counts"][k] for k in KERNELS}
        if (m["batch_axis"], m["nr_devices"], m["mesh"]) != (
                "data", 2, {"n_data": 2, "n_model": 1}) or \
                m["input"]["shape"][0] != BATCH:
            failures.append(f"mesh artifact manifest {m}")
        expected = dict.fromkeys(KERNELS, 0)
        expected.update(K6=4 * (WARMUP_STEPS + 1), V1f=WARMUP_STEPS + 1)
        if launches != expected or any(res["export_counts"].values()):
            failures.append(f"mesh artifact rank {r['rank']}: launches "
                            f"{launches}, export {res['export_counts']}")
        add_launches(rows, launches)
        say(f"mesh serving: the flag-on flagship exported on 2x1 (2 gloo "
            f"processes, global batch {BATCH}, {BATCH // 2} rows a "
            f"process) in {res['export_seconds']!r} s, rank {r['rank']}: "
            f"K6 {launches['K6']} and V1f {launches['V1f']} in the first "
            f"call (the warm-up call and the capture of the rank's graph), "
            f"a replayed call "
            f"{res['call_ms']!r} ms with the gather, none in the export; "
            f"against the one-process artifact: "
            + ", ".join(f"{k} {v}" + (" differ" if isinstance(v, int)
                                      else "") for k, v in gaps.items())
            + f" (each of its largest entry) [{card}]")
    return failures


def mesh_options_runs(card, tmp):
    """The CLI with a seed probe of 2 candidates and head_refit on two
    gloo processes, and with the probe alone and no group: the ranks agree
    on the winner, each candidate's score beside one process's, and
    process 0 alone saves the checkpoints, the refit's once."""
    script = os.path.abspath(__file__)
    one_out, two_out = (os.path.join(tmp, "options_one"),
                        os.path.join(tmp, "options_2x1"))
    # the reference for the scores: one process, the probe alone
    run_checked([sys.executable, script, "--mesh-rank", "options", one_out,
                 *MESH_CLI, *MESH_PROBE],
                "the CLI with a seed probe, no group")
    run_checked(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", script, "--mesh-rank", "options", two_out,
         *MESH_CLI, *MESH_PROBE, "trainer.head_refit=true",
         "trainer.mesh.n_data=2", "trainer.mesh.backend=gloo"],
        "the CLI with a seed probe and head_refit, 2 gloo processes")

    def result(out, rank):
        with open(os.path.join(out, f"result_{rank}.json")) as f:
            return json.load(f)

    one = result(one_out, 0)
    two = [result(two_out, rank) for rank in range(2)]
    failures = []
    last = one["step"]
    kept = sorted(int(n) for n in os.listdir(os.path.join(two_out, "ckpt"))
                  if n.isdigit())
    if two[0]["seed"] != two[1]["seed"]:
        failures.append(f"the 2-process ranks continued seeds "
                        f"{[r['seed'] for r in two]}")
    if two[0]["saves"] != [last, last + 1] or two[1]["saves"] or \
            kept != [last, last + 1] or one["saves"] != [last]:
        failures.append(f"checkpoints: process 0 saved {two[0]['saves']}, "
                        f"process 1 {two[1]['saves']}, kept {kept}; one "
                        f"process saved {one['saves']}")
    for r in two:
        say(f"mesh: the CLI with trainer.seed_probe.n=2 and head_refit on "
            f"2 gloo processes, rank {r['rank']}: continued seed "
            f"{r['seed']} to step {r['step']} (one process: seed "
            f"{one['seed']}, step {one['step']}); the candidates' scores "
            + ", ".join(f"{s!r} (one process {o!r}, gap "
                        f"{abs(s - o) / abs(o):.2e})"
                        for s, o in zip(r["scores"], one["scores"]))
            + f"; checkpoints saved {r['saves']}; launches K1 "
            f"{r['counts']['K1']}, K2+K3 {r['counts']['K2+K3']}, V1f "
            f"{r['counts']['V1f']}, V1b {r['counts']['V1b']}; "
            f"{r['seconds']!r} s (one process {one['seconds']!r} s) "
            f"[{card}]")
    return failures


def mesh_phase(torch, card, rows, tmp):
    """The mesh (parallel/mesh.py) on the one card: two gloo processes
    against the single-process run from the same state, a world-1 NCCL
    group whose graphs capture the collectives against no group, and the
    training CLI on two gloo processes."""
    from scae_tpu_torch.parallel import mesh as mesh_lib

    os.makedirs(tmp, exist_ok=True)
    failures = []   # raised at the phase's end, after every part has run
    was = deterministic_cudnn(torch)
    try:
        # the single-process run the ranks are held to, in a process of its
        # own as theirs are: cuDNN keeps one algorithm a shape a process, and
        # this process holds the ones earlier phases' scans searched
        run_checked([sys.executable, os.path.abspath(__file__),
                     "--mesh-rank", "single", tmp],
                    "the one-process reference")
        ref = torch.load(os.path.join(tmp, "single.pt"))
        losses, host_ms, busy_ms = ref["losses"], ref["host_ms"], \
            ref["busy_ms"]
        control_gaps, control_loss_gap = ref["control_gaps"], \
            ref["control_loss_gap"]
        want_grads, want_pre = ref["want_grads"], ref["want_pre"]
        control_grads, banded_loss = ref["control_grads"], \
            ref["banded_loss"]
        say(f"mesh: one process, {MESH_STEPS} eager flagship steps (batch "
            f"{BATCH}, f32 convs, TF32 off, deterministic cuDNN, gather "
            f"path): losses {losses} [{card}]")
        say(f"mesh: the control, one process under cuDNN's default "
            f"algorithms: losses within "
            f"{control_loss_gap:.3e}"
            f" of the deterministic run; the worst parameter's gap of its "
            f"largest entry after each step "
            + ", ".join(f"{g:.2e}" for g, _, _ in control_gaps)
            + f" (after step {MESH_STEPS}: {control_gaps[-1][1]}, "
            f"{control_gaps[-1][2]} tensors above {MESH_PARAM_RTOL:.0e}) "
            f"[{card}]")

        outputs = mesh_lib.run_local(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             "steps", tmp], 2, MESH_TIMEOUT,
            env=dict(os.environ, PYTHONPATH=HERE), cwd=HERE)
        ranks = [result_lines(o, "MESH_RANK ")[0] for o in outputs]
        failures = []
        for tag, per_rank in (("2x1", BATCH // 2), ("1x2", BATCH)):
            gaps = ranks[0][tag]["gaps"]
            held = gaps[:1] if tag == "2x1" else gaps
            worst, name, over = max(held)
            say(f"mesh {tag}: the worst parameter's gap of its largest "
                f"entry after each step "
                + ", ".join(f"{g:.2e}" for g, _, _ in gaps)
                + f" (the control's: "
                + ", ".join(f"{g:.2e}" for g, _, _ in control_gaps)
                + f"); after step {MESH_STEPS}: {gaps[-1][0]:.3e} "
                f"({gaps[-1][1]}), {gaps[-1][2]} tensors above "
                f"{MESH_PARAM_RTOL:.0e}; held to {MESH_PARAM_RTOL:.0e} "
                + ("after step 1" if tag == "2x1" else "after every step")
                + f": {worst:.3e} ({name}) [{card}]")
            if not worst <= MESH_PARAM_RTOL:
                failures.append(f"mesh {tag}: parameter {name} is "
                                f"{worst:.3e} of its largest entry off the "
                                "single-process run")
            grads = torch.load(os.path.join(tmp, f"grads_{tag}.pt"))
            entry, norm = grad_gaps(want_grads, grads)
            if tag == "2x1":
                flips, largest, at_worst = kink_flips(
                    torch, want_grads, grads, want_pre, torch.cat([
                        torch.load(os.path.join(tmp, f"pre_2x1_{r}.pt"))
                        for r in range(2)]))
                say(f"mesh 2x1: the first batch in the capsule MLPs' "
                    f"first layer: {flips} of {want_pre.numel()} "
                    f"pre-activations on the other side of relu's kink "
                    f"from one process's, each within {largest:.3e} of 0; "
                    f"{at_worst} at the (capsule, unit) of mlps.bias_0's "
                    f"worst gradient entry [{card}]")
            # 1x2 computes what one process computes; 2x1 convolves 64
            # images where one process convolves 128, so a unit whose
            # input lies within rounding of relu's kink can go either way
            # and move one entry by an example's share: its bound is on
            # each gradient's norm
            held = entry if tag == "1x2" else norm
            say(f"mesh {tag}: the first batch's gradients (noise off, the "
                f"global batch's) against one process's: each entry within "
                f"{entry[0]:.3e} of its tensor's largest |gradient| "
                f"({entry[1]}: {entry[2]} of its {entry[3]} entries off by "
                f"more than 1e-4 of it), each tensor's difference "
                f"{norm[0]:.3e} of "
                f"its norm ({norm[1]}); the control's "
                f"{control_grads[0][0]:.3e} ({control_grads[0][1]}) and "
                f"{control_grads[1][0]:.3e} "
                f"({control_grads[1][1]}); held to {GRAD_RTOL:.0e} "
                + ("entry by entry" if tag == "1x2" else "in norm")
                + f" [{card}]")
            if not held[0] <= GRAD_RTOL:
                failures.append(f"mesh {tag}: gradient of {held[1]} is "
                                f"{held[0]:.3e} off")
            for r in ranks:
                res = r[tag]
                gaps = [abs(a - b) / max(1.0, abs(b))
                        for a, b in zip(res["losses"], losses)]
                launches = {k: res["counts"][k] for k in KERNELS}
                expected = {k: MESH_STEPS if k in ("K1", "K2+K3", *VOTES)
                            else 0 for k in KERNELS}
                say(f"mesh {tag} (gloo, 2 processes on one card, batch "
                    f"{per_rank} a process) rank {r['rank']}: "
                    f"{MESH_STEPS} steps, launches K1 {launches['K1']}, "
                    f"K2+K3 {launches['K2+K3']}, V1f {launches['V1f']} and "
                    f"V1b {launches['V1b']} (one each a step), losses "
                    f"within {max(gaps):.3e} of one process (tolerance "
                    f"{MESH_LOSS_RTOL:.0e}; each step: "
                    + ", ".join(f"{g:.1e}" for g in gaps)
                    + f"); {res['host_ms']:.3f} ms per step "
                    f"on the host clock and {res['busy_ms']:.3f} ms of "
                    f"device busy, against one process's {host_ms:.3f} ms "
                    f"and {busy_ms:.3f} ms [{card}]")
                if not max(gaps) <= MESH_LOSS_RTOL:
                    failures.append(f"mesh {tag} rank {r['rank']}: losses "
                                    f"{res['losses']} against {losses}")
                if launches != expected:
                    failures.append(f"mesh {tag} rank {r['rank']}: "
                                    f"launches {launches}, expected "
                                    f"{expected}")
                if tag == "1x2" and res["banks"] != 11:
                    failures.append(f"mesh 1x2: {res['banks']} banks "
                                    "split, expected 11")
                add_launches(rows, launches)
        for r in ranks:
            res = r["banded"]
            launches = {k: res["counts"][k] for k in KERNELS}
            expected = dict.fromkeys(KERNELS, 0)
            expected.update({"K5f": 1, "K5b": 1, "K6": 4, **VOTES})
            gap = abs(res["loss"] - banded_loss) / max(1.0, abs(banded_loss))
            if launches != expected or not gap <= MESH_LOSS_RTOL:
                failures.append(f"mesh banded rank {r['rank']}: launches "
                                f"{launches} (expected {expected}), loss "
                                f"{res['loss']} against {banded_loss}")
            add_launches(rows, launches)
            say(f"mesh 2x1 banded step with the attention flag, rank "
                f"{r['rank']}: launches K5f {launches['K5f']}, K5b "
                f"{launches['K5b']}, K6 {launches['K6']}, V1f "
                f"{launches['V1f']}, V1b {launches['V1b']}; loss "
                f"{res['loss']!r} against one process's {banded_loss!r} "
                f"(gap {gap:.3e}) [{card}]")
        failures += mesh_serving_check(torch, card, rows, tmp, ranks)
    finally:
        deterministic_cudnn(torch, was[0])
        torch.backends.cudnn.benchmark = was[1]

    plain_rate = None
    try:
        plain_rate = mesh_nccl_runs(card, tmp)
    except Exception as error:   # the rest of the phase still runs
        failures.append(f"the world-1 NCCL comparison: {error}")
    try:
        mesh_two_process_cli(card, tmp, plain_rate)
    except Exception as error:
        failures.append(f"the CLI on 2 processes: {error}")
    try:
        failures += mesh_options_runs(card, tmp)
    except Exception as error:
        failures.append(f"the seed probe and head refit on 2 processes: "
                        f"{error}")
    if failures:
        raise RuntimeError("mesh phase: " + "; ".join(failures))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--mesh-rank"]:
        return mesh_rank(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of the eval and "
                         "train steps")
    ap.add_argument("--trainer-steps", type=int, metavar="N",
                    help="run only the training CLI's card-vs-CPU "
                         "comparison, over N steps, and print each step's "
                         "gap (held to its bound over the first 4 steps); "
                         "prints no result line")
    ap.add_argument("--eager-control", action="store_true",
                    help="with --trainer-steps: also run the CLI on the "
                         "card with its train scan swapped for the eager "
                         "loop")
    ap.add_argument("--mesh", action="store_true",
                    help="run only the mesh phase (after env and build); "
                         "prints no result line")
    ap.add_argument("--tools", action="store_true",
                    help="run only the tools phase (after env and build); "
                         "prints no result line")
    ap.add_argument("--serve", action="store_true",
                    help="run only the serve phase, without the export "
                         "tool (after env and build); prints no result "
                         "line")
    args = ap.parse_args(argv)

    import torch

    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS
    from scae_tpu_torch.kernels import _build
    from scae_tpu_torch.kernels import attention as k6
    from scae_tpu_torch.kernels import capsule_likelihood as cl
    from scae_tpu_torch.kernels import capsule_votes as cv
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

    if args.trainer_steps:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, \
                phase("trainer card vs cpu"):
            trainer_card_vs_cpu_phase(
                torch, card, tmp, steps=args.trainer_steps,
                eager=args.eager_control, resume=False,
                held=min(4, args.trainer_steps))
        return 0

    with phase("build"):
        sources = {"K1": (k1.build_info, k1.SOURCE),
                   "K2+K3": (k1.build_info, k1.BWD_SOURCE),
                   "K4f": (k4.build_info, k4.SOURCE),
                   "K4b": (k4.build_info, k4.BWD_SOURCE),
                   "K5f": (k5.build_info, k5.SOURCE),
                   "K5b": (k5.build_info, k5.BWD_SOURCE),
                   "K6": (lambda _: k6.build_info(), k6.SOURCE),
                   "P1+P2": (lambda _: kp.build_info(), kp.SOURCE),
                   "V1f+V1b": (lambda _: cv.build_info(), cv.SOURCE),
                   "L1f+L1b": (lambda _: cl.build_info(), cl.SOURCE)}
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

    if args.mesh or args.tools or args.serve:
        rows = [{"launches": None} for _ in KERNEL_ROWS]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            if args.serve:
                with phase("serve"):
                    serve_phase(torch, card, rows, os.path.join(tmp, "serve"),
                                None, [])
            if args.tools:
                with phase("tools"):
                    tools_phase(torch, card, rows, os.path.join(tmp, "tools"))
            if args.mesh:
                with phase("mesh"):
                    mesh_phase(torch, card, rows, os.path.join(tmp, "mesh"))
        return 0

    with phase("kernel"):
        rows = [kernel_phase(torch, card), bwd_kernel_phase(torch, card),
                *dense_kernel_phase(torch, card),
                *banded_kernel_phase(torch, card),
                attention_kernel_phase(torch, card),
                capsule_votes_kernel_phase(torch, card)]
        # outside KERNEL_ROWS: its launches are the vote head's (LIKELIHOOD)
        likelihood_row = capsule_likelihood_kernel_phase(torch, card)

    with phase("slice"):
        eval_step, images, labels = slice_phase(torch, card, rows)

    with phase("train"):
        train_step, train_images, train_labels, _ = train_phase(
            torch, card, rows, "gather", FLAGSHIP_MODEL_PARAMS,
            {"K1": 1, "K2+K3": 1, **VOTES})

    with phase("pallas"):
        pallas_params = dict(FLAGSHIP_MODEL_PARAMS,
                             pcae_decoder_params=dict(fused_impl="pallas"))
        pallas_step, _, _, pallas_model = train_phase(
            torch, card, rows, "pallas", pallas_params,
            {"K4f": 1, "K4b": 1, **VOTES})
        pallas_eval, _, _ = eval_timing(torch, card, rows, "pallas",
                                        pallas_model, {"K4f": 1, "V1f": 1})

    with phase("banded"):
        banded_params = dict(
            FLAGSHIP_MODEL_PARAMS,
            pcae_decoder_params=dict(fused_impl="pallas_banded"))
        banded_step, _, _, banded_model = train_phase(
            torch, card, rows, "banded", banded_params,
            {"K5f": 1, "K5b": 1, "K6": 4, **VOTES}, attention=True)
        banded_eval, _, _ = eval_timing(
            torch, card, rows, "banded", banded_model,
            {"K5f": 1, "K6": 4, "V1f": 1})

    with phase("graph"):
        graph_scan = graph_phase(torch, card)

    with phase("cifar10"):
        cifar10_phase(torch, card)

    with phase("probe"):
        probe_phase(torch, card, rows)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        with phase("trainer"):
            refit_ckpt = trainer_phase(torch, card, rows,
                                       os.path.join(tmp, "flagship"))
        with phase("trainer card vs cpu"):
            trainer_card_vs_cpu_phase(torch, card, tmp)
        with phase("serve"):
            serve_phase(torch, card, rows, os.path.join(tmp, "serve"),
                        refit_ckpt, ["model=mnist"])
        with phase("tools"):
            tools_phase(torch, card, rows, os.path.join(tmp, "tools"))
        with phase("mesh"):
            mesh_phase(torch, card, rows, os.path.join(tmp, "mesh"))

    if args.profile:
        with phase("profile"):
            profile_phase(torch, "eval", eval_step, images, labels, 5, card)
            eager_busy = profile_phase(torch, "train", train_step,
                                       train_images, train_labels, 5, card)
            profile_graph_phase(torch, card, *graph_scan, 5, eager_busy)
            profile_phase(torch, "pallas eval", pallas_eval, images, labels,
                          5, card)
            profile_phase(torch, "pallas train", pallas_step, train_images,
                          train_labels, 5, card)
            profile_phase(torch, "banded eval", banded_eval, images, labels,
                          5, card)
            profile_phase(torch, "banded train", banded_step, train_images,
                          train_labels, 5, card)

    rows.append(dict(likelihood_row, launches=rows[
        KERNEL_ROWS.index(tuple(LIKELIHOOD.values()))]["launches"]))
    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
