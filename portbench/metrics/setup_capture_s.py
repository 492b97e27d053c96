"""Layer: set-up. Host seconds of the warm-up calls and CUDA graph
captures in the run (the program's counters ``graphs.capture_s``, for
serving, and ``scan.capture_s``, for the scans)."""

from portbench import port_trace


def read(run):
    return port_trace.counter_sum("graphs.capture_s", "scan.capture_s")
