"""Kind ``serve_open_loop``: independent users querying the deployed
classifier, at a fixed rate whatever the server does.

Arrivals are a Poisson process of ``rate_per_s``: the gaps are drawn
i.i.d. exponential from the seed, and each request's size i.i.d. from
``sizes`` at ``shares``. Requests go one at a time, first come first
served, into the loaded ``ServingModel``. A request's latency runs from
when it was due to when its outputs are on the host; its service time
from its start. The window holds the requests due in its ``--seconds``;
each is served, late or not. The host sleeps towards a request's due
time only while more than 2 ms remain, and spins the last of it.

The check takes ``sample`` requests drawn from the seed among those due,
with the first of the largest among them (every due request is served).
A traced run offers the same kind of traffic, from another stream of the
seed, for ``profile_seconds`` more in the profiled sub-window.

Parameters: rate_per_s, sizes, shares, profile_seconds, sample.
"""

import math
import time

import numpy as np
import torch

from portbench import trace as trace_lib
from portbench.serving import POOL, ServeJob


def schedule(seed, rate, sizes, shares, seconds):
    """(arrival offsets in seconds, sizes) of the requests due within
    ``seconds``: Poisson arrivals at ``rate``, sizes at ``shares``."""
    rng = np.random.default_rng([seed, 3])
    n = int(rate * seconds + 10 * math.sqrt(rate * seconds) + 10)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    while arrivals[-1] < seconds:     # 10 sigma short: draw on
        arrivals = np.concatenate([arrivals, arrivals[-1] + np.cumsum(
            rng.exponential(1.0 / rate, size=n))])
    arrivals = arrivals[arrivals < seconds]
    out_sizes = rng.choice(np.asarray(sizes, dtype=np.int64),
                           size=len(arrivals), p=shares)
    return arrivals, out_sizes


def offsets(seed, sizes):
    rng = np.random.default_rng([seed, 5])
    return (rng.random(len(sizes)) * (POOL - sizes)).astype(np.int64)


def wait_until(due):
    while True:
        ahead = due - time.perf_counter()
        if ahead <= 0:
            return
        if ahead > 2e-3:
            time.sleep(ahead - 1e-3)


class Job(ServeJob):
    def __init__(self, run):
        super().__init__(run)
        p = run.params
        self.sizes = tuple(p["sizes"])
        self.rate = p["rate_per_s"]

    def offered(self, seconds, seed_shift=0):
        p = self.run.params
        arrivals, sizes = schedule(self.run.seed + seed_shift, self.rate,
                                   p["sizes"], p["shares"], seconds)
        return arrivals, sizes, offsets(self.run.seed + seed_shift, sizes)

    def serve(self, arrivals, sizes, offs, traced=False):
        """Serve the schedule from now; per request (due, start, end)."""
        t0 = time.perf_counter() + 1e-3
        times = []
        for i, (a, s, o) in enumerate(zip(arrivals, sizes, offs)):
            due = t0 + a
            wait_until(due)
            start, end = self.serve_one(i, int(o), int(s), traced)
            times.append((due, start, end))
        return t0, times

    def setup(self):
        super().setup()
        self.schedule = self.offered(self.run.seconds)
        self.wanted = self.choose_sample(self.schedule[1],
                                         self.run.params["sample"])

    def choose_sample(self, sizes, n):
        """``n`` request indices drawn from the seed among ``sizes``, with
        the first of the largest requests among them."""
        rng = np.random.default_rng([self.run.seed, 7])
        picks = set(rng.choice(len(sizes), size=min(n, len(sizes)),
                               replace=False).tolist())
        picks.add(int(np.argmax(sizes)))
        return picks

    def keep(self, i, offset, size, out):
        if i in self.wanted:
            self.sample[i] = (offset, size, out)

    def window(self, seconds):
        arrivals, sizes, offs = self.schedule
        t0, times = self.serve(arrivals, sizes, offs)
        lat = np.asarray([e - d for d, _, e in times])
        service = np.asarray([e - s for _, s, e in times])
        lateness = np.asarray([s - d for d, s, _ in times])
        self.run.stats.update(
            attempted=len(times), failed=0, latencies_s=lat,
            service_s=service, images=int(sizes.sum()),
            window_s=max(seconds, times[-1][2] - t0) if times else seconds,
            max_lateness_s=float(lateness.max()) if len(times) else 0.0)

    def profile(self):
        self.sampling = False
        arrivals, sizes, offs = self.offered(
            self.run.params["profile_seconds"], seed_shift=1)
        self.run.trace = trace_lib.profile(torch, lambda: self.serve(
            arrivals, sizes, offs, traced=True))
        self.run.counters["profiled_images"] = int(sizes.sum())

