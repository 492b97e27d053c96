"""Layer: kernels. K2+K3's (the gather likelihood's backward) least time,
for the taps of a batch of the profiled epoch, over its mean device time
per launch in the profiled sub-window, in %."""

from portbench import readers


def read(run):
    if "k23_hits" not in run.counters:
        return None
    return readers.kernel_roofline_pct(run, "decoder_ll_gather_bwd_kernel",
                                       readers.k23_bound_ms(run))
