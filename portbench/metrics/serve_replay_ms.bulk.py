"""Layer: serving. Mean stream time, in ms, of a serving call's graph
replay (the program's span ``graphs.replay``, timed by CUDA events
recorded around it) over the profiled sub-window's calls."""

from portbench import port_trace


def read(run):
    found = port_trace.spans("serve.call", "graphs.replay")
    if found is None:
        return None
    ms = port_trace.device_ms(found, "graphs.replay")
    return None if ms is None else ms / found["serve.call"]["calls"]
