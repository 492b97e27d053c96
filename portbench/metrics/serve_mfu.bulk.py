"""Layer: serving model step. Forward FLOPs of the window's images over
its wall time, over the H100's float32 peak, in %."""

from portbench import readers
from portbench.counts import peaks


def read(run):
    s = run.stats
    if not s.get("window_s"):
        return None
    return 100.0 * readers.serve_flops(run, s["images"]) / s["window_s"] \
        / peaks.F32_FLOPS
