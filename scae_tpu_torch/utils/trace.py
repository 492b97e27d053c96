"""Spans and counters of scae_tpu_torch: the port's one tracing module.

A span (``span(name)``) marks a piece of host work where it happens: the
serving call and its parts, the scans, the reads of a chunk's metrics. It
is silent unless a ``torch.profiler`` is recording: then it enters
``record_function("scae_tpu_torch.<name>")``, which shows in the
profiler's trace (``trainer.profile.start_step`` writes it as a Chrome
trace), and keeps an in-memory record of its host start and end
(``time.perf_counter_ns``), its parent (the enclosing span of the same
thread), its request (the outermost span, shared by every span of one
call) and its ``items``. With ``device=True`` it also records a pair of
CUDA events on the current stream, whose stream time ``summary()``
resolves. Device spans are never recorded inside a graph capture, and no
span runs inside a graph replay: a replay runs no Python.

Counters (``count``, ``add_seconds``, ``timed``) are always on; they sit
on cold paths only: kernel builds, exports, captures, and the kernels'
launches (``LAUNCHES`` + a kernel's id, counted by
``kernels/_common.py::launch``), which run only where a step or a call is
eager or captured, never in a replay. ``Since`` reads them as their
growth since it was made.

``summary()`` reduces the records by span name; the records stay until
``reset()``. Nothing is written out: the profiler's trace is the
operator's export, and a benchmark reads ``summary()`` in its process.
"""

import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "scae_tpu_torch."
MAX_RECORDS = 1_000_000

_OFF = contextlib.nullcontext()
_seq = itertools.count(1)
_local = threading.local()       # .stack: the open spans of a thread
_lock = threading.Lock()
_records = []
_dropped = 0
_counters = {}


class Record:
    """One finished span. ``seq`` numbers spans in the order they were
    entered; ``parent`` and ``request`` are seqs (``request`` the
    outermost span's, its own for a span with no parent); ``start`` and
    ``end`` are host ns; ``child_ns`` the host time of its direct
    children; ``events`` a (start, end) pair of CUDA events or None."""

    __slots__ = ("seq", "name", "parent", "request", "items", "start", "end",
                 "child_ns", "events")

    def __init__(self, seq, name, parent=None, request=None, items=1,
                 start=0, end=0, child_ns=0, events=None):
        self.seq, self.name, self.parent = seq, name, parent
        self.request = seq if request is None else request
        self.items, self.start, self.end = items, start, end
        self.child_ns, self.events = child_ns, events


class _Span:
    __slots__ = ("record", "device", "annotation")

    def __init__(self, name, device, items):
        self.record = Record(0, name, items=items)
        self.device = device

    def __enter__(self):
        rec = self.record
        if self.device and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the device span {rec.name!r} was entered "
                               "inside a CUDA graph capture")
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec.seq = next(_seq)
        if stack:
            rec.parent, rec.request = stack[-1].seq, stack[-1].request
        else:
            rec.request = rec.seq
        self.annotation = torch.profiler.record_function(PREFIX + rec.name)
        self.annotation.__enter__()
        if self.device:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        stack.append(rec)
        rec.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.record
        rec.end = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += rec.end - rec.start
        self.annotation.__exit__(*exc)
        _keep(rec)
        return False


def _keep(rec):
    global _dropped
    if len(_records) < MAX_RECORDS:
        _records.append(rec)
    else:
        with _lock:
            _dropped += 1


def span(name: str, device: bool = False, items: int = 1):
    """A context manager that marks ``name``'s host work (and, with
    ``device``, its stream time) while a profiler records; otherwise one
    shared null context that reads no clock and records nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, items)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def add_seconds(name: str, seconds: float):
    """Add ``seconds`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + seconds


@contextlib.contextmanager
def timed(name: str):
    """Add the block's host seconds to the counter ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_seconds(name, time.perf_counter() - t0)


# + a kernel's id (K1, K2+K3, K4f, K4b, K5f, K5b, K6, V1f, V1b, P1, P2):
# its launch counter
LAUNCHES = "kernels.launches."


def counters() -> dict:
    """A copy of every counter, with ``trace.dropped``: spans not kept
    past ``MAX_RECORDS``."""
    with _lock:
        return {**_counters, "trace.dropped": _dropped}


class Since:
    """The counters read as their growth since this object was made."""

    def __init__(self):
        self.start = counters()

    def __getitem__(self, name: str):
        """How much the counter ``name`` grew (0 where it never counted)."""
        return counters().get(name, 0) - self.start.get(name, 0)

    def launches(self, *kernels: str) -> tuple:
        """How many times each of ``kernels`` was launched."""
        return tuple(self[LAUNCHES + k] for k in kernels)


def reset():
    """Forget every record and counter."""
    global _dropped
    with _lock:
        _records.clear()
        _counters.clear()
        _dropped = 0


def summarize(records, device_ns=None) -> dict:
    """{name: {calls, items, total_ns, self_ns, max_ns, lead_ns,
    device_ns}} of ``records``: host totals; self time is a span's time
    less its direct children's; ``lead_ns`` sums each span's start less
    its request's start (0 for the outermost); ``device_ns`` sums the
    stream time ``device_ns[seq]`` of the spans that have one (None where
    none has)."""
    device_ns = device_ns or {}
    roots = {r.seq: r.start for r in records if r.parent is None}
    out = {}
    for r in records:
        s = out.setdefault(r.name, dict(calls=0, items=0, total_ns=0,
                                        self_ns=0, max_ns=0, lead_ns=0,
                                        device_ns=None))
        took = r.end - r.start
        s["calls"] += 1
        s["items"] += r.items
        s["total_ns"] += took
        s["self_ns"] += took - r.child_ns
        s["max_ns"] = max(s["max_ns"], took)
        s["lead_ns"] += r.start - roots.get(r.request, r.start)
        if r.seq in device_ns:
            s["device_ns"] = (s["device_ns"] or 0) + device_ns[r.seq]
    return out


def summary() -> dict:
    """``summarize`` of every record kept, the device spans' stream time
    resolved from their events after one synchronisation."""
    records = list(_records)
    on_device = [r for r in records if r.events is not None]
    if on_device:
        torch.cuda.synchronize()
    device_ns = {r.seq: int(r.events[0].elapsed_time(r.events[1]) * 1e6)
                 for r in on_device}
    return summarize(records, device_ns)
