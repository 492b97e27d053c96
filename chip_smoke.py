#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``scae_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # the run that proves the port
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown

Phases, each announced when it starts and when it ends, with its seconds:

  env     torch / CUDA versions, the card's name and power limit, nvcc
  build   the CUDA kernels, built from csrc/ with nvcc, and ptxas's report
  kernel  each kernel against its plain PyTorch version at the main path's
          shapes and at edge shapes; the kernel's time, the plain
          version's, and the least time the card could take (the bound)
  slice   the flagship SCAE (1x40x40, M=40, O=32, 11x11 templates), built
          on the card from a seeded generator, through the eval step and
          the infer function at batch 128; the kernels' launch counts over
          that run; the same weights and input through the port on the CPU,
          term by term; the eval step's time, images per second and peak
          device memory

Imports torch, numpy, the standard library and scae_tpu_torch only. Exits
non-zero, with no result line, when CUDA is absent or any check fails. The
line before the last is the card's name and power limit; before it, a JSON
line of per-kernel numbers; the last line is the JSON result.
"""

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

BATCH = 128            # eval batch of the flagship
KERNEL_TOL = 1e-4      # abs, kernel vs its plain version (f32 ulps of O(10))
TERM_RTOL = 1e-4       # card vs CPU, per loss term, relative to max(1, |cpu|)
PROB_TOL = 1e-4        # card vs CPU, abs, on presences and probabilities
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

def k1_inputs(torch, shape, seed, pose_noise=0.6, edge=False):
    """Random decoder-likelihood inputs, made with numpy from a seed.
    ``edge``: every third presence exactly 0, and two hand-built degenerate
    poses (a near-zero scale at the canvas corner, a translation off it)."""
    import numpy as np

    from scae_tpu_torch.ops.geometry import geometric_transform

    B, M, C, Ht, Wt, H, W = shape
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    templates = t(rng.rand(B, M, C, Ht, Wt))
    alpha = t(rng.randn(1, M, 1, Ht, Wt))
    pose = geometric_transform(t(rng.randn(B, M, 6) * pose_noise))
    presence = rng.rand(B, M)
    if edge:
        presence[:, ::3] = 0.0
        pose[:, 0] = t([0.01, 0.0, 1.0, 0.0, 0.01, 1.0])
        pose[:, 1] = t([1.01, 0.0, -1.0, 0.0, 1.01, 0.0])
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


def kernel_phase(torch):
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
            f"{err:.3e} (tolerance {KERNEL_TOL:.0e})")
        if not err < KERNEL_TOL:
            raise RuntimeError(f"K1 {name}: max abs err {err} exceeds "
                               f"{KERNEL_TOL}")
        if flagship_err is None:
            flagship_err = err

    args = k1_inputs(torch, cases[0][1], seed=2)
    ms = time_cuda(torch, lambda: k1.decoder_ll_gather(*args),
                   iters=200, warmup=20)
    plain_ms = time_cuda(torch, lambda: k1.decoder_ll_gather_plain(*args),
                         iters=20, warmup=3)
    bound_ms, bound_by, n_bytes, ops = k1_bound_ms(cases[0][1])
    say(f"K1 flagship time: kernel {ms:.4f} ms (200 launches, CUDA events), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us by "
        f"{bound_by} ({n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP), "
        f"library_ms: none (no single PyTorch call computes this), "
        f"roofline share {bound_ms / ms:.1%}")
    return dict(name="decoder_ll_gather_fwd", route="cuda",
                source="scae_tpu_torch/csrc/decoder_ll_gather.cu",
                replaces="scae_tpu/ops/pallas_decoder_ll_gather.py:565",
                launches=None, max_abs_err=flagship_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# --------------------------------------------------------------- slice

def slice_phase(torch, k1_row):
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
    k1.launches = 0
    metrics = eval_step(images, labels)
    served = infer(canvas_images)
    torch.cuda.synchronize()
    launches = k1.launches
    say(f"K1 launches over the main path (1 eval step, 1 infer call): "
        f"{launches}")
    if launches != 1:
        raise RuntimeError(f"K1 launched {launches} times, expected 1")
    k1_row["launches"] = launches

    terms = {k: float(v) for k, v in metrics.items()}
    for k, v in terms.items():
        say(f"  eval {k} = {v!r}")
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
            f"(tolerance {tol:.1e})")
        if not diff <= tol:
            raise RuntimeError(f"{k}: card and CPU differ by {diff}")
    for k in ("part_presence", "part_pose", "caps_presence",
              "prior_cls_prob", "posterior_cls_prob"):
        diff = float((served[k].cpu() - cpu_served[k]).abs().max())
        say(f"  card vs CPU infer {k}: max abs diff {diff:.3e} "
            f"(tolerance {PROB_TOL:.0e})")
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
        f"{torch.cuda.max_memory_allocated()} B")
    return model, eval_step, images, labels


def profile_phase(torch, eval_step, images, labels):
    """Device time by kernel name over a few eval steps."""
    from torch.profiler import ProfilerActivity, profile

    eval_step(images, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            eval_step(images, labels)
        torch.cuda.synchronize()
    say(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the eval step")
    args = ap.parse_args(argv)

    import torch

    from scae_tpu_torch.kernels import _build
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
        info = k1.build_info()
        say(f"K1 library {info.path}: built in {info.seconds:.2f} s "
            f"(cached: {info.cached}), nvcc {' '.join(_build.NVCC_FLAGS)}, "
            "loaded with ctypes")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                say(f"  ptxas: {line.strip()}")

    with phase("kernel"):
        k1_row = kernel_phase(torch)

    with phase("slice"):
        model, eval_step, images, labels = slice_phase(torch, k1_row)

    if args.profile:
        with phase("profile"):
            profile_phase(torch, eval_step, images, labels)

    say(json.dumps({"kernels": [k1_row]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
