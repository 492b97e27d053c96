"""Times other launch plans of the dense and banded likelihood forwards
(K4f, K5f), the set attention (K6) and the matmul probe (P2) beside their
planners' plans, on a CUDA card.

    python3 chip_plans.py [--rounds 3] [--only K5f,P2]

The wrappers launch their planners' plans; this script launches each
plan itself (K4f and K6 through their C entry points, K5f and P2 through
their launchers' plan argument). Each plan is held against the plain
version within chip_smoke.KERNEL_TOL and timed as chip_smoke.py times a
kernel: device time per launch over 200 launches (torch.profiler), in
rounds that take the plans in turn. K4f at the flagship and cifar10
shapes, each chunk of its two-buffer ring (capsules a buffer), with the
planner's pixel tiles; K5f at the same shapes, each chunk and one or two
pixels a thread; K6 at the flagship's two attention shapes, each tile
plan (rows a warp x warps, 16-byte or 4-byte rows); P2 at the probe's
shape, each tile and K in one chunk or two, beside torch.matmul's device
time. Prints each plan's shared memory and blocks per SM, a line per
reading, then each plan's median over the rounds, beside the card's name
and power limit. Exits non-zero when CUDA is absent or a plan disagrees
with the plain version.
"""

import argparse
import statistics
import sys

import chip_smoke
from chip_smoke import say

K4F_SHAPES = (("flagship", chip_smoke.FLAGSHIP_SHAPE),
              ("cifar10", (chip_smoke.BATCH,) + chip_smoke.CIFAR10_SHAPE[1:]))
K4F_CHUNKS = (32, 16, 8, 1)
K5F_CHUNKS = {"flagship": (8, 16, 24, 40), "cifar10": (8, 16, 32, 64)}
K5F_PIXELS = (1, 2)
P2_KCS = (128, 64)      # K = 128 in one chunk, or two halves
GROUPS = ("K4f", "K5f", "K6", "P2")
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


def k5f_cases(torch, k5):
    """K5f at the flagship and cifar10 shapes, every chunk of K5F_CHUNKS
    and the planner's, one and two pixels a thread."""
    cases = []
    for name, shape in K4F_SHAPES:
        raw = chip_smoke.k1_inputs(torch, shape, seed=2)
        args = (*k5.sort_and_pad(*raw[:4]), *raw[4:])
        want = k5.decoder_ll_banded_plain(*args)
        B, M, C, Ht, Wt, H, W = shape
        planned = k5.forward_plan(shape, k5.fwd_registers(C))
        chunks = sorted(set(K5F_CHUNKS[name]) | {planned["chunk"]})
        for pixels in K5F_PIXELS:
            for chunk in chunks:
                threads = k5.threads_per_block(H, W, pixels)
                plan = dict(threads=threads, pixels=pixels, chunk=chunk)
                per_sm = k5.blocks_per_sm(C, M, Ht, Wt, threads, pixels,
                                          chunk)
                blocks = planned["blocks"]
                mark = " (the planner's)" if (chunk, pixels) == (
                    planned["chunk"], planned["pixels"]) else ""
                text = (f"{threads} threads, registers "
                        f"{k5.fwd_registers(C, pixels)}, shared memory "
                        f"{k5.shared_memory_bytes(C, Ht, Wt, chunk, M)} B; "
                        f"{chip_smoke.occupancy(torch, per_sm, blocks)}")
                cases.append((
                    f"K5f {name} {shape} chunk {chunk} x {pixels} px{mark}",
                    lambda a=args, p=plan: k5._launch(*a, plan=p), want,
                    "decoder_ll_banded_fwd_kernel", text))
    return cases


def p2_cases(torch, kp):
    """P2 at the probe's shape, every tile and chunk; torch.matmul's device
    time is printed beside them once a round."""
    from scae_tpu_torch.tools import probe as probe_tool

    _, a_np, b_np = probe_tool.probe_inputs()
    a = torch.from_numpy(a_np).cuda()
    b = torch.from_numpy(b_np).cuda()
    want = [kp.matmul_probe_plain(a, b)]
    planned = kp.matmul_plan(*a.shape, b.shape[1])
    cases = []
    for tile in kp.MATMUL_TILES:
        for kc in P2_KCS:
            plan = kp.matmul_plan(*a.shape, b.shape[1], tile, kc)
            per_sm = kp.matmul_blocks_per_sm(plan, a.shape[1])
            mark = " (the planner's)" if plan == planned else ""
            text = (f"{plan['threads']} threads, {plan['chunks']} chunk(s) "
                    f"of {plan['kc']}, registers {kp.matmul_registers(plan)}"
                    f", shared memory {plan['smem']} B; "
                    f"{chip_smoke.occupancy(torch, per_sm, plan['blocks'])}")
            cases.append((f"P2 {tile[0]}x{tile[1]} tile, {tile[2]}x{tile[3]} "
                          f"a thread, {tile[4]} slice(s), kc {kc}{mark}",
                          lambda p=plan: kp._matmul_launch(a, b, p), want,
                          "probe_matmul_kernel", text))
    return cases, lambda: torch.matmul(a, b)


def max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def sweep(torch, card, rounds, cases, library=None):
    """Check every (label, call, plain outputs, kernel name, text) case,
    then time them in turn for ``rounds`` rounds; print the medians.
    ``library``: (label, call) of a PyTorch call timed once a round as
    device time per call, beside the cases."""
    times = {label: [] for label, *_ in cases}
    if library is not None:
        times[library[0]] = []
    for label, call, want, _, text in cases:
        got = call()
        got = list(got) if isinstance(got, (list, tuple)) else [got]
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
        if library is not None:
            ms = chip_smoke.device_ms_per_call(torch, library[1])
            times[library[0]].append(ms)
            say(f"round {r + 1} {library[0]}: {ms:.4f} ms of device time "
                f"per call [{card}]")
    for label in times:
        t = times[label]
        say(f"median {label}: {statistics.median(t):.4f} ms per launch "
            f"(device time, 200 launches, {len(t)} rounds: "
            f"{', '.join(f'{x:.4f}' for x in t)}) [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated kernels to sweep, of "
                         + ", ".join(GROUPS))
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"--only takes {', '.join(GROUPS)}")

    import torch

    from scae_tpu_torch.kernels import attention as k6
    from scae_tpu_torch.kernels import decoder_ll_banded as k5
    from scae_tpu_torch.kernels import decoder_ll_dense as k4
    from scae_tpu_torch.kernels import probe as kp

    if not torch.cuda.is_available():
        print("chip_plans: CUDA is not available", file=sys.stderr)
        return 1
    card = chip_smoke.gpu_name_and_power_limit()
    say(f"nvidia-smi: {card}")

    cases = []
    for name, shape in K4F_SHAPES if "K4f" in only else ():
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
    if "K5f" in only:
        cases += k5f_cases(torch, k5)
    for name, shape in chip_smoke.ATTENTION_SHAPES if "K6" in only else ():
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
    library = None
    if "P2" in only:
        p2, matmul = p2_cases(torch, kp)
        cases += p2
        library = ("torch.matmul (256, 128) x (128, 256)", matmul)
    sweep(torch, card, args.rounds, cases, library)
    return 0


if __name__ == "__main__":
    sys.exit(main())
