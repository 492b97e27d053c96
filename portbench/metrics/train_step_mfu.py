"""Layer: model step. Model FLOPs of the window's training steps (3 x the
forward) and evals (1 x) over the window's wall time, over the H100's
float32 peak, in %."""

from portbench import readers


def read(run):
    return readers.train_mfu_pct(run) if run.stats.get("window_s") else None
