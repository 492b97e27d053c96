"""Layer: set-up. Host seconds of ``torch.export.export`` in the run (the
program's counter ``export.seconds``): the serving artifact's trace."""

from portbench import port_trace


def read(run):
    return port_trace.counter_sum("export.seconds")
