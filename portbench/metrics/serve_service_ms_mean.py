"""Layer: serving. Mean over the window's requests of the time from a
request's start to its outputs on the host (its wait in the queue
excluded)."""


def read(run):
    s = run.stats.get("service_s")
    return 1e3 * float(s.mean()) if s is not None and len(s) else None
