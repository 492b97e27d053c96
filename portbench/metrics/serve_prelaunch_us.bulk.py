"""Layer: serving. Mean host time, in us, from a serving call's start
(the program's span ``serve.call``) to the start of its graph replay
(``graphs.replay``) in the profiled sub-window: the host path before the
device has the request's work."""

from portbench import port_trace


def read(run):
    found = port_trace.spans("serve.call", "graphs.replay")
    if found is None:
        return None
    replay = found["graphs.replay"]
    return replay["lead_ns"] / replay["calls"] / 1e3
