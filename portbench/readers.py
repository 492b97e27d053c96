"""Arithmetic the metrics' readers share (``metrics/<name>.py``)."""

import math

import numpy as np

from portbench.counts import flops, peaks, roofline
from portbench.trace import kernel_seconds


def percentile_ms(run, q):
    """The ``q``-th percentile, by the nearest rank, of the window's
    request latencies, in ms."""
    lat = run.stats.get("latencies_s")
    if lat is None or not len(lat):
        return None
    v = np.sort(np.asarray(lat))
    return 1e3 * float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def idle_pct(run):
    """The device's idle share of the profiled sub-window, in %."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def likelihood_shape(run):
    """(B, M, C, Ht, Wt, H, W) of the likelihood kernels' launches."""
    m = run.config["model"]
    C, H, W = m["image_shape"]
    tg = m.get("pcae_template_generator_params") or {}
    Ht, Wt = tg.get("template_size", (11, 11))
    return (run.stats["batch"], m["n_part_caps"], C, Ht, Wt, H, W)


def kernel_roofline_pct(run, fragment, bound_ms):
    """A kernel's roofline share in %: its least time over its mean device
    time per launch in the profiled sub-window."""
    if run.trace is None:
        return None
    found = kernel_seconds(run.trace, fragment)
    if found is None:
        return None
    launches, seconds = found
    return 100.0 * bound_ms / (seconds / launches * 1e3)


def k1_bound_ms(run):
    return roofline.k1_bound_ms(likelihood_shape(run))[0]


def k23_bound_ms(run):
    return roofline.k23_bound_ms(likelihood_shape(run),
                                 run.counters["k23_hits"])[0]


def train_mfu_pct(run):
    """Model FLOPs of the window's training steps and evals over its wall
    time, over the float32 peak, in %."""
    s, m = run.stats, run.config["model"]
    work = s["images"] * flops.train_flops(m) \
        + s["eval_images"] * flops.forward_flops(m)
    return 100.0 * work / s["window_s"] / peaks.F32_FLOPS


def serve_flops(run, images):
    return images * flops.forward_flops(run.config["model"])
