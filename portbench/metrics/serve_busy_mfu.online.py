"""Layer: serving model step. Forward FLOPs of the images served in the
profiled sub-window over the device's busy time there, over the H100's
float32 peak, in %."""

from portbench import readers
from portbench.counts import peaks


def read(run):
    if run.trace is None or not run.trace["busy_s"]:
        return None
    work = readers.serve_flops(run, run.counters["profiled_images"])
    return 100.0 * work / run.trace["busy_s"] / peaks.F32_FLOPS
