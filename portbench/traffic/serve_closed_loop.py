"""Kind ``serve_closed_loop``: one caller scoring a dataset through the
deployed classifier, each request of ``size`` images sent as soon as the
previous one's outputs are on the host, for the window's ``--seconds``.

The requests take consecutive slices of the host image pool from an
offset drawn from the seed. The check takes ``sample`` of the requests
served in the window, drawn uniformly from the seed by reservoir
sampling as they are served, so that it always has that many however
many the window serves. A traced run goes on for ``profile_seconds`` in
the profiled sub-window.

Parameters: size, profile_seconds, sample (requests checked).
"""

import random
import time

import numpy as np
import torch

from portbench import trace as trace_lib
from portbench.serving import POOL, ServeJob


class Job(ServeJob):
    def __init__(self, run):
        super().__init__(run)
        self.size = run.params["size"]
        self.sizes = (self.size,)
        rng = np.random.default_rng([run.seed, 5])
        self.start = int(rng.integers(0, POOL // self.size)) * self.size

        self.rng = random.Random(run.seed)
        self.slots = []        # the sampled requests' indices

    def keep(self, i, offset, size, out):
        """Reservoir sampling (Algorithm R): after request ``i`` the sample
        is a uniform draw of ``sample`` requests among the first i + 1."""
        n = self.run.params["sample"]
        j = i if i < n else self.rng.randrange(i + 1)
        if j >= n:
            return
        if j < len(self.slots):
            del self.sample[self.slots[j]]
            self.slots[j] = i
        else:
            self.slots.append(i)
        self.sample[i] = (offset, size, out)

    def loop(self, stop, traced=False):
        i, images = 0, 0
        while not stop():
            offset = (self.start + i * self.size) % (POOL - POOL % self.size)
            self.serve_one(i, offset, self.size, traced)
            i += 1
            images += self.size
        return i, images

    def window(self, seconds):
        t0 = time.perf_counter()
        n, images = self.loop(lambda: time.perf_counter() - t0 >= seconds)
        wall = time.perf_counter() - t0
        self.run.stats.update(attempted=n, failed=0, images=images,
                              window_s=wall)

    def profile(self):
        self.sampling = False
        seconds = self.run.params["profile_seconds"]
        box = {}

        def go():
            t0 = time.perf_counter()
            box["n"] = self.loop(lambda: time.perf_counter() - t0 >= seconds,
                                 traced=True)

        self.run.trace = trace_lib.profile(torch, go)
        self.run.counters["profiled_images"] = box["n"][1]
