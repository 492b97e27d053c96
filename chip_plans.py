"""Times other launch plans of the dense likelihood forward (K4f) and the
set attention (K6) beside their planners' plans, on a CUDA card.

    python3 chip_plans.py [--rounds 3]

The wrappers launch only their planners' plans; this script calls the
kernels' C entry points with each plan itself. Each plan is held against
the plain version within chip_smoke.KERNEL_TOL and timed as chip_smoke.py
times a kernel: device time per launch over 200 launches (torch.profiler),
in rounds that take the plans in turn. K4f at the flagship and cifar10
shapes, each chunk of its two-buffer ring (capsules a buffer), with the
planner's pixel tiles; K6 at the flagship's two attention shapes, each
tile plan (rows a warp x warps, 16-byte or 4-byte rows). Prints each
plan's shared memory and blocks per SM, a line per reading, then each
plan's median over the rounds, beside the card's name and power limit.
Exits non-zero when CUDA is absent or a plan disagrees with the plain
version.
"""

import argparse
import statistics
import sys

import chip_smoke
from chip_smoke import say

K4F_SHAPES = (("flagship", chip_smoke.FLAGSHIP_SHAPE),
              ("cifar10", (chip_smoke.BATCH,) + chip_smoke.CIFAR10_SHAPE[1:]))
K4F_CHUNKS = (32, 16, 8, 1)
K6_PLANS = ((2, 8, True), (2, 4, True), (1, 8, True), (2, 2, True),
            (2, 8, False), (2, 4, False))


def k4f_launcher(torch, k4, args, chunk):
    """A call that launches K4f on ``args`` with this chunk and the
    planner's pixel tiles, and the plan as a dict."""
    from scae_tpu_torch.kernels import _build
    from scae_tpu_torch.kernels._common import output_grid, raise_on, scalars

    templates, alpha, pose, presence, bg, mix, scale, target, out = args
    B, M, C, Ht, Wt = templates.shape
    H, W = out
    tiles, threads = k4.pixel_tiling(H * W)
    scal = scalars(templates.device, bg, mix, scale)
    grid_x, grid_y = output_grid(out, templates.device)
    outs = [torch.empty(s, dtype=torch.float32, device=templates.device)
            for s in ((B, C, H, W), (B, C, H * W), (B, 1, H * W))]
    fn, err, _ = _build.load(k4.SOURCE, *k4._SIGNATURES[k4.SOURCE])
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(*(t.data_ptr() for t in (templates, alpha, pose, presence,
                                         target, scal, grid_x, grid_y,
                                         *outs)),
                B, M, C, Ht, Wt, H, W, int(alpha.shape[0] != 1), tiles,
                threads, chunk, stream)
        raise_on(rc, err, "decoder_ll_dense")
        return outs

    plan = dict(tiles=tiles, threads=threads, chunk=chunk, blocks=B * tiles)
    return call, plan


def k6_launcher(torch, k6, args, rows_per_warp, warps, vec):
    """A call that launches K6 on ``args`` with this tile plan."""
    from scae_tpu_torch.kernels import _build
    from scae_tpu_torch.kernels._common import raise_on

    q, k, v, p = args
    B, N, d_k = q.shape
    M, d_v = v.shape[1:]
    out = torch.empty((B, N, d_v), dtype=torch.float32, device=q.device)
    fn, err, _ = _build.load(k6.SOURCE, *k6._SIGNATURE)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(*(t.data_ptr() for t in (q, k, v, p, out)), B, N, M, d_k,
                d_v, rows_per_warp, warps, int(vec), stream)
        raise_on(rc, err, "attention")
        return out

    return call


def max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def sweep(torch, card, rounds, cases):
    """Check every (label, call, plain outputs, kernel name, text) case,
    then time them in turn for ``rounds`` rounds; print the medians."""
    times = {label: [] for label, *_ in cases}
    for label, call, want, _, text in cases:
        got = call()
        got = got if isinstance(got, list) else [got]
        err = max_err(got, want)
        say(f"{label}: {text}, max abs err {err:.3e} (tolerance "
            f"{chip_smoke.KERNEL_TOL:.0e}) [{card}]")
        if not err < chip_smoke.KERNEL_TOL:
            raise RuntimeError(f"{label}: max abs err {err}")
    for r in range(rounds):
        for label, call, _, kernel, _ in cases:
            ms = chip_smoke.kernel_device_ms(torch, call, kernel)
            times[label].append(ms)
            say(f"round {r + 1} {label}: {ms:.4f} ms per launch [{card}]")
    for label, *_ in cases:
        t = times[label]
        say(f"median {label}: {statistics.median(t):.4f} ms per launch "
            f"(device time, 200 launches, {len(t)} rounds: "
            f"{', '.join(f'{x:.4f}' for x in t)}) [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from scae_tpu_torch.kernels import attention as k6
    from scae_tpu_torch.kernels import decoder_ll_dense as k4

    if not torch.cuda.is_available():
        print("chip_plans: CUDA is not available", file=sys.stderr)
        return 1
    card = chip_smoke.gpu_name_and_power_limit()
    say(f"nvidia-smi: {card}")

    cases = []
    for name, shape in K4F_SHAPES:
        inputs = chip_smoke.k1_inputs(torch, shape, seed=2)
        want = k4.decoder_ll_dense_plain(*inputs)
        planned = k4.forward_plan(shape)
        for chunk in K4F_CHUNKS:
            call, p = k4f_launcher(torch, k4, inputs, chunk)
            per_sm = k4.blocks_per_sm(*shape[2:5], p["threads"], chunk)
            mark = " (the planner's)" if chunk == planned["chunk"] else ""
            text = (f"{p['tiles']} tile(s) of {p['threads']} threads, "
                    f"shared memory "
                    f"{k4.shared_memory_bytes(*shape[2:5], chunk)} B; "
                    f"{chip_smoke.occupancy(torch, per_sm, p['blocks'])}")
            cases.append((f"K4f {name} {shape} ring {k4.FWD_STAGES} x "
                          f"{chunk}{mark}", call, want,
                          "decoder_ll_dense_fwd_kernel", text))
    for name, shape in chip_smoke.ATTENTION_SHAPES:
        inputs = chip_smoke.attention_inputs(torch, shape, 2, "binary")
        want = [k6.attention_plain(*inputs)]
        planned = k6.plan(*shape[1:])
        for r, warps, vec in K6_PLANS:
            per_sm = k6.blocks_per_sm(*shape[1:], r, warps, vec)
            tiles = -(-shape[1] // (r * warps))
            mark = " (the planner's)" if (r, warps, vec) == (
                planned["rows_per_warp"], planned["warps"],
                planned["vec"]) else ""
            smem = k6.shared_memory_bytes(*shape[1:], r, warps, vec)
            text = (f"shared memory {smem} B; "
                    f"{chip_smoke.occupancy(torch, per_sm, shape[0] * tiles)}")
            cases.append((f"K6 {name.split(' (')[0]} {shape} {r} row(s) x "
                          f"{warps} warps, {'16' if vec else '4'}-byte"
                          f"{mark}",
                          k6_launcher(torch, k6, inputs, r, warps, vec),
                          want, "attention_fwd_kernel", text))
    sweep(torch, card, args.rounds, cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
