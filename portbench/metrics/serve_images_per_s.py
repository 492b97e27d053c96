"""Images served over the window."""


def read(run):
    s = run.stats
    return s["images"] / s["window_s"] if s.get("window_s") else None
