"""95th percentile of the latency of all the window's requests, from when
each was due to its outputs on the host."""

from portbench.readers import percentile_ms


def read(run):
    return percentile_ms(run, 95)
