"""Layer: kernels. K1's (the gather likelihood's forward) least time over
its mean device time per launch in the profiled sub-window, in %."""

from portbench import readers


def read(run):
    return readers.kernel_roofline_pct(run, "decoder_ll_gather_fwd_kernel",
                                       readers.k1_bound_ms(run))
