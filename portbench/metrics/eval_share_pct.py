"""Layer: scans. The eval scans' share, in %, of the stream time of the
train and eval scans of the profiled sub-window (the program's spans
``scan.eval`` and ``scan.train``)."""

from portbench import port_trace


def read(run):
    found = port_trace.spans("scan.train", "scan.eval")
    if found is None:
        return None
    train = port_trace.device_ms(found, "scan.train")
    evals = port_trace.device_ms(found, "scan.eval")
    if train is None or evals is None or train + evals <= 0:
        return None
    return 100.0 * evals / (train + evals)
