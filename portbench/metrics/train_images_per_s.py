"""Images trained over the whole window, evals included in its time."""


def read(run):
    s = run.stats
    return s["images"] / s["window_s"] if s.get("window_s") else None
