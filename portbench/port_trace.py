"""What the readers of the program's own spans and counters share
(``scae_tpu_torch.utils.trace``). Its spans record only while a profiler
records, so their summary covers the profiled sub-window of a traced run;
its counters run from the process's start. A program without the module,
or one that recorded nothing, gives None, never an error."""


def _module():
    try:
        from scae_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def spans(*names):
    """The program's summary by span name (``trace.summary()``), or None
    where it lacks one of ``names``."""
    trace = _module()
    if trace is None:
        return None
    found = trace.summary()
    return found if all(n in found for n in names) else None


def device_ms(found, name):
    """The stream time of span ``name`` in ms, or None where it has none."""
    ns = found[name]["device_ns"]
    return None if ns is None else ns / 1e6


def counter_sum(*names):
    """The sum of the counters ``names`` that the program keeps, or None
    where it keeps none of them."""
    trace = _module()
    if trace is None:
        return None
    found = trace.counters()
    values = [found[n] for n in names if n in found]
    return float(sum(values)) if values else None
