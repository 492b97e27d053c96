"""Layer: device. The share of the profiled sub-window in which no
operation ran on the device, in %."""

from portbench import readers


def read(run):
    return readers.idle_pct(run)
