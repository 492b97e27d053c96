"""CUDA graphs of one step, for the scans of ``parallel/train_step.py``.

JAX runs a scan's K steps as one compiled program. The port's counterpart
on the card captures one step in a ``torch.cuda.CUDAGraph`` and replays it
once per step: one launch from the host in place of the eager step's
~1,140. The graph reads its per-step inputs from static device buffers,
which the scan writes before each replay, and leaves its outputs in one
static vector, which the scan copies out after it.

A graph holds the step as captured: the addresses of every tensor it
reads, the shapes, and the Python branches taken at capture. A scan keys
its graphs by what they depend on (``tensors_key``), so that it captures
again when any of it changes. Before its first capture a scan runs
``WARMUP_STEPS`` eager steps on a side stream, as PyTorch's whole-network
capture recipe does: they initialise what is made at first use (cuDNN
and cuBLAS handles, the kernels' builds and launch plans). The recipe
runs a few; one is enough here, and the card's tests capture after it on
every likelihood path. A capture that fails raises; nothing falls back
to the eager loop.

A kernel wrapper counts its launches where it launches: at capture it
launches into the graph and counts once; a replay runs the graph's
kernels without calling any wrapper and counts nothing. What a replay
runs is read from the profiler's records of it (the card's tests and
chip_smoke.py's graph phase).
"""

import contextlib
import gc
from typing import Callable, Sequence

import torch

WARMUP_STEPS = 1


def tensors_key(tensors) -> tuple:
    """(address, shape, dtype) of each tensor: what a graph that reads
    them depends on."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


@contextlib.contextmanager
def side_stream(device):
    """Run the block on a fresh stream that first waits for the current
    one; the current stream waits for it afterwards."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


@contextlib.contextmanager
def collector_off():
    """Keep Python's garbage collector off for the block. A CUDA graph
    that the collector frees while another is being captured (a dropped
    scan's graphs in a reference cycle) destroys its executable graph,
    which CUDA refuses during a capture and which then invalidates the
    capture. Garbage made meanwhile waits for the next collection."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """``fn()``, a step that returns one tensor, captured in a CUDA graph.

    ``generators``: CUDA generators the step draws from; each is
    registered with the graph, so a replay draws from the generator's seed
    and offset as they stand when it is replayed (the scan re-seeds them
    before each replay). ``pool``: the memory pool the capture allocates
    from (``torch.cuda.graph_pool_handle()``), shared by graphs that never
    run at once; a private one when None. ``replay()`` runs the step and
    returns its output tensor, which the next replay overwrites.
    """

    def __init__(self, fn: Callable[[], torch.Tensor],
                 generators: Sequence[torch.Generator] = (), pool=None):
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        with collector_off(), torch.cuda.graph(self.graph, pool=pool):
            self.out = fn()

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.out
