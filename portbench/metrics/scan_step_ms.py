"""Layer: scans. Stream time, in ms, of the train scans of the profiled
sub-window (the program's span ``scan.train``, CUDA events recorded
before its first replay and after its last) over the steps they ran."""

from portbench import port_trace


def read(run):
    found = port_trace.spans("scan.train")
    if found is None:
        return None
    ms = port_trace.device_ms(found, "scan.train")
    return None if ms is None else ms / found["scan.train"]["items"]
