"""Process start to the window's start: building the model and its
weights, the data, the kernels' builds or loads, the export, every warm-up
and capture, and the set-up steps that the check follows."""


def read(run):
    return run.setup_s
