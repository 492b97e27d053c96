"""The profiled sub-window of a traced run: torch.profiler's device
records, reduced to the device's busy time, each kernel's launches and
time, the operations that took most time and the longest idle gaps named
by the harness span the host was in.

torch.profiler on the card's machine loses the device records of a
window's first launches, so the window opens with lead-in spins
(``torch.cuda._sleep``) that the host waits for, and which are never
counted. The harness marks its calls into the program with
``record_function`` spans named ``portbench.<what>``; the sub-window
itself is the span ``portbench.window``.
"""

import contextlib
import time

LEAD_IN_SPINS = 8
LEAD_IN_CYCLES = 200_000
SPIN = "spin_kernel"
WINDOW = "portbench.window"


def span(torch, name, on):
    """A ``record_function`` span where ``on``, else nothing."""
    if on:
        return torch.profiler.record_function("portbench." + name)
    return contextlib.nullcontext()


def profile(torch, fn):
    """Run ``fn()`` inside a profiled window; returns the summary:
    busy_s, window_s, kernels {name: (launches, seconds)}, breakdown."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN_SPINS):
            torch.cuda._sleep(LEAD_IN_CYCLES)
        torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return summarize(prof.profiler.kineto_results.events(), wall)


def _is_device(e, cuda):
    return e.device_type() == cuda and not e.is_user_annotation()


def summarize(events, wall):
    """The summary of a profiled window's kineto events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == WINDOW and not _is_device(
        e, cuda)]
    if not win:
        raise RuntimeError("the profiled window's span is missing")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    device, host = [], []
    for e in events:
        if _is_device(e, cuda):
            if SPIN in e.name() or e.end_ns() <= w0 or e.start_ns() >= w1:
                continue
            device.append((max(e.start_ns(), w0), min(e.end_ns(), w1),
                           e.name()))
        elif e.name().startswith("portbench.") and e.name() != WINDOW:
            host.append((e.start_ns(), e.end_ns(), e.name()[10:]))
    device.sort()
    kernels, busy, gaps = {}, 0, []
    cursor = w0
    for s, t, name in device:
        n, secs = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, secs + (t - s) / 1e9)
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if w1 > cursor:
        gaps.append((cursor, w1))

    def host_at(t):
        inner = [h for h in host if h[0] <= t < h[1]]
        if not inner:
            return "outside the harness's spans"
        return min(inner, key=lambda h: h[1] - h[0])[2]

    named = {}
    for g0, g1 in gaps:
        what = host_at(g0)
        named[what] = max(named.get(what, 0.0), (g1 - g0) / 1e9)
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "wall_s": wall,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[k, v[1]] for k, v in top_ops],
            "idle_gaps": sorted(([k, v] for k, v in named.items()),
                                key=lambda kv: -kv[1])[:10],
        },
    }


def kernel_seconds(summary, fragment):
    """(launches, seconds) of the kernels whose name contains
    ``fragment``, or None where the sub-window recorded none."""
    n, secs = 0, 0.0
    for name, (k, s) in summary["kernels"].items():
        if fragment in name:
            n, secs = n + k, secs + s
    return (n, secs) if n else None
