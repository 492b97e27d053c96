"""CUDA graphs of one step, for the scans of ``parallel/train_step.py``,
and of one call, for serving (``serve.py``).

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
to the eager loop. A scan's warm-up steps and captures run under
``cudnn_search``: cuDNN times its convolution algorithms in the warm-up,
and the graph holds the ones it timed fastest in place of its
heuristic's choice (serving's ``CallGraphs`` keep the heuristic's).

A kernel wrapper counts its launches where it launches: at capture it
launches into the graph and counts once; a replay runs the graph's
kernels without calling any wrapper and counts nothing. What a replay
runs is read from the profiler's records of it (the card's tests and
chip_smoke.py's graph phase).

Under a mesh (``parallel/mesh.py``) the step's collectives are captured
with the rest of it where the process group runs NCCL, whose collectives
are stream work that a graph can hold. Gloo's collectives run on the host
and wait for the card, which no graph can hold: under gloo the scans run
the eager step instead (``captures_collectives``, the one place of that
rule, which says so once on process 0).

Serving takes the same recipe per call (``CallGraphs``): JAX serves one
compiled program a call, the port one replay of a graph captured per input
shape and dtype and per ``tensors_key`` of the tensors the call reads,
after ``WARMUP_STEPS`` eager calls on a side stream. Each call copies its
input into the graph's static input, replays, and returns clones of the
static outputs, so that the next call never overwrites what a caller
holds. A call does not walk the model to key its graphs: it checks a
snapshot of the slots the graphs read (``Slots``), a flat comparison, and
walks the model in full (the counter ``graphs.rekeys``) only at the first
call and after the check has seen a change.
"""

import contextlib
import gc
import operator
from typing import Callable, Optional, Sequence

import torch

from scae_tpu_torch.parallel.mesh import is_process_zero
from scae_tpu_torch.utils import trace

WARMUP_STEPS = 1
_told = False   # whether captures_collectives has said its rule


def tensors_key(tensors) -> tuple:
    """(address, shape, dtype) of each tensor: what a graph that reads
    them depends on."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


def captures_collectives(mesh) -> bool:
    """Whether a scan on the card may capture its step in a graph under
    ``mesh`` (a live mesh, or None): without one, or under NCCL, yes; under
    any other backend (gloo) no, and the scan runs the eager step. Says so
    once, on process 0."""
    global _told
    if mesh is None or mesh.backend == "nccl":
        return True
    if not _told and is_process_zero():
        print(f"[scae_tpu_torch] mesh on {mesh.backend}: the scans run the "
              f"eager step on the card ({mesh.backend}'s collectives cannot "
              "be captured in a CUDA graph; NCCL's are)", flush=True)
    _told = True
    return False


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


_CUDNN_SWITCHES = ("enabled", "benchmark", "deterministic", "allow_tf32")


@contextlib.contextmanager
def cudnn_search():
    """Let cuDNN time its algorithms for each convolution the block runs
    at a shape it has not met, and keep the one it timed fastest
    (``torch.backends.cudnn.benchmark``). Its choices are cached per
    shape for the process, whichever way they were made, so a capture
    after a searched warm-up step replays the searched algorithms, and
    a convolution met first without the search keeps its heuristic
    choice. Where algorithms run within the timing's noise of each other,
    two processes may keep different ones. The caller's ``deterministic``
    (the search then times only deterministic algorithms) and
    ``allow_tf32`` hold inside; every cuDNN switch is as it was after the
    block, also where it raises."""
    cudnn = torch.backends.cudnn
    before = {name: getattr(cudnn, name) for name in _CUDNN_SWITCHES}
    cudnn.benchmark = True
    try:
        yield
    finally:
        for name, value in before.items():
            setattr(cudnn, name, value)


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


def module_tensors(module) -> list:
    """Every tensor that ``module`` holds: its parameters, its buffers and
    the tensors set as plain attributes of it or of a submodule (the
    constants of an ExportedProgram's module)."""
    out = [*module.parameters(), *module.buffers()]
    for m in module.modules():
        out += [v for v in vars(m).values() if isinstance(v, torch.Tensor)]
    return out


_data_ptr = torch.Tensor.data_ptr
_shape = operator.attrgetter("shape")
_dtype = operator.attrgetter("dtype")


class Slots:
    """A snapshot of the slots of ``module`` (None: no module) that hold
    what a graph of its call reads: each submodule in its parent's
    ``_modules``, each parameter in its owner's ``_parameters``, each
    buffer in its owner's ``_buffers`` and each tensor set as a plain
    attribute in its owner's ``__dict__`` (an ExportedProgram module's
    constants), with the size of each of those dicts; and the tensors of
    ``module_tensors(module)`` with their (address, shape, dtype), whose
    ``tensors_key`` is ``key``.

    ``hold()`` says whether all of it still stands, without walking the
    module: flat comparisons, occupants by identity, tensors by address,
    shape and dtype. A tensor written in place holds; a slot whose
    occupant was replaced (a new parameter, buffer, tensor attribute or
    submodule), a slot added or removed, or a tensor moved to other
    storage, shape or dtype (``.data =``) does not."""

    def __init__(self, module):
        self.dicts, self.owners, self.names, self.occupants = [], [], [], []
        for m in () if module is None else module.modules():
            attrs = vars(m)
            for d in (m._modules, m._parameters, m._buffers, attrs):
                self.dicts.append(d)
                for name, v in d.items():
                    if d is not attrs or isinstance(v, torch.Tensor):
                        self.owners.append(d)
                        self.names.append(name)
                        self.occupants.append(v)
        self.sizes = list(map(len, self.dicts))
        self.tensors = [] if module is None else module_tensors(module)
        self.key = tensors_key(self.tensors)
        self.ptrs = list(map(_data_ptr, self.tensors))
        self.shapes = list(map(_shape, self.tensors))
        self.dtypes = list(map(_dtype, self.tensors))

    def hold(self) -> bool:
        return (list(map(len, self.dicts)) == self.sizes
                and all(map(operator.is_, map(dict.get, self.owners,
                                              self.names), self.occupants))
                and list(map(_data_ptr, self.tensors)) == self.ptrs
                and list(map(_shape, self.tensors)) == self.shapes
                and list(map(_dtype, self.tensors)) == self.dtypes)


def _clone(out):
    """Fresh copies of a graph's static outputs: a tensor, or a dict,
    tuple or list of them."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    return type(out)(_clone(v) for v in out)


class StepGraph:
    """``fn()``, a step that returns a tensor (or a dict, tuple or list of
    them), captured in a CUDA graph.

    ``generators``: CUDA generators the step draws from; each is
    registered with the graph, so a replay draws from the generator's seed
    and offset as they stand when it is replayed (the scan re-seeds them
    before each replay). ``pool``: the memory pool the capture allocates
    from (``torch.cuda.graph_pool_handle()``), shared by graphs that never
    run at once; a private one when None. ``capture_error_mode``: as
    ``torch.cuda.graph``'s, its default where None ("thread_local" lets
    other threads, such as a process group's, query the card meanwhile).
    ``replay()`` runs the step and returns its output, whose tensors the
    next replay overwrites.
    """

    def __init__(self, fn: Callable[[], torch.Tensor],
                 generators: Sequence[torch.Generator] = (), pool=None,
                 capture_error_mode: Optional[str] = None):
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        mode = {} if capture_error_mode is None else {
            "capture_error_mode": capture_error_mode}
        with collector_off(), torch.cuda.graph(self.graph, pool=pool,
                                               **mode):
            self.out = fn()

    def replay(self):
        self.graph.replay()
        return self.out


class CallGraphs:
    """``fn(x)`` on the card, replayed from a CUDA graph per input: one
    graph for each shape and dtype of ``x``, all in one memory pool (they
    never run at once), captured at the first call that needs it after
    ``WARMUP_STEPS`` eager calls on a side stream. ``module`` holds the
    tensors ``fn`` reads besides ``x`` (a model, or an ExportedProgram's
    module; None where ``fn`` reads none). The graphs are keyed by
    ``tensors_key`` of ``module_tensors(module)``: where it changes (a
    tensor replaced, not written in place), every graph is dropped and
    the call captures anew. A call checks a snapshot of the slots the
    graphs read (``Slots.hold``) and walks ``module`` in full only where
    the check fails, and at the first call. ``capture_error_mode`` as for
    ``StepGraph``.

    A call copies ``x`` into the graph's static input, replays and
    returns clones of the static outputs. It runs under the caller's
    context (``torch.inference_mode()`` for serving) for the warm-up and
    the capture alike. ``fn`` must take nothing from the host inside the
    call: a capture that fails raises; nothing falls back to ``fn``.

    A call's spans (``utils/trace.py``) are ``graphs.key`` (the check, and
    the walk where it runs), ``graphs.capture`` (where it captures),
    ``graphs.copy_in``, ``graphs.replay`` (with its stream time on the
    card) and ``graphs.clone``; the counters ``graphs.captures`` (graphs
    captured), ``graphs.capture_s`` (host
    seconds of the warm-ups and captures), ``graphs.rekeys`` (full walks
    of ``module``) and ``graphs.recaptures`` (graphs dropped for a changed
    key) are always on."""

    def __init__(self, fn: Callable, module: Optional[torch.nn.Module],
                 device, capture_error_mode: Optional[str] = None):
        self.fn, self.module, self.device = fn, module, device
        self.mode = {} if capture_error_mode is None else {
            "capture_error_mode": capture_error_mode}
        self.slots = None    # Slots of what the graphs read
        self.graphs = {}     # (shape, dtype) -> (static input, StepGraph)
        self.pool = None

    def __call__(self, x: torch.Tensor):
        with trace.span("graphs.key"):
            old = self.slots
            if old is None or not old.hold():
                trace.count("graphs.rekeys")
                self.slots = Slots(self.module)
                if old is None or self.slots.key != old.key:
                    if self.graphs:
                        trace.count("graphs.recaptures", len(self.graphs))
                    # free the old graphs' memory before capturing again
                    self.graphs, self.pool = {}, None
        shape = (tuple(x.shape), x.dtype)
        if shape not in self.graphs:
            with trace.span("graphs.capture"), \
                    trace.timed("graphs.capture_s"):
                static = x.clone()
                with side_stream(self.device):
                    for _ in range(WARMUP_STEPS):
                        self.fn(static)
                if self.pool is None:
                    self.pool = torch.cuda.graph_pool_handle()
                self.graphs[shape] = (static, StepGraph(
                    lambda: self.fn(static), pool=self.pool, **self.mode))
                trace.count("graphs.captures")
        static, graph = self.graphs[shape]
        with trace.span("graphs.copy_in"):
            static.copy_(x)
        with trace.span("graphs.replay", device=self.device.type == "cuda"):
            out = graph.replay()
        with trace.span("graphs.clone"):
            return _clone(out)
