"""The benchmark's general part: it finds a cell's files by name, checks
for the card, sets the configuration's math mode, runs the cell's traffic
kind (set-up, the measured window, a profiled sub-window after it in a
traced run, the comparison with the reference), reads the metrics and
prints the result.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives:

    configs/<config>.json       a configuration: the model, its precision,
                                optimizer and data sizes
    traffic/<traffic>.json      a traffic mix: its kind and parameters
    traffic/<kind>.py           the code of a kind (``Job``)
    workloads/<cell>.json       a cell's own parameters (a rate) and the
                                limits of its comparison
    metrics/<metric>.py         a metric's reader: ``read(run)``, a number
                                or None where it finds nothing to read
"""

import importlib.util
import json
import os
import re
import sys
import time

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "scae_tpu")


class Refused(Exception):
    """A run that must not measure: it prints no result."""


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, prefix):
    name = prefix + re.sub(r"\W", "_", os.path.basename(path)[:-3])
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(name, root=ROOT):
    """(benchmark, cell entry, config, traffic parameters with the cell's
    own merged over them, the cell's limits) of the cell ``name``."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    pb = os.path.join(root, "portbench")
    config = read_json(os.path.join(pb, "configs", cell["config"] + ".json"))
    traffic = read_json(os.path.join(pb, "traffic", cell["traffic"] + ".json"))
    own = read_json(os.path.join(pb, "workloads", name + ".json"))
    limits = own.pop("limits", {})
    return bench, cell, config, {**traffic, **own}, limits


def cell_metrics(bench, cell_name, trace):
    """The metrics a run of the cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones (each listed for the cell, or, without a
    ``workloads`` key, in every cell that reports what it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and (("workloads" in m) or m["moves"] in names)]


class Run:
    """One run: its cell, configuration, parameters and seed, and what
    the traffic kind records for the metrics' readers: ``stats`` (the
    window's counts and times), ``counters`` and ``trace`` (the profiled
    sub-window's summary, ``trace.py``)."""

    def __init__(self, name, config, params, limits, seed, seconds, trace,
                 device, control=None, fault=None):
        self.name, self.config, self.params = name, config, params
        self.limits, self.seed, self.seconds = limits, seed, seconds
        self.traced, self.device = trace, device
        self.control, self.fault = control, fault
        self.stats, self.counters = {}, {}
        self.trace = None
        self.setup_s = None

    def phase(self, name):
        """Times a part of set-up into ``counters["setup_phases"]``."""
        return _Phase(self, name)


class _Phase:
    def __init__(self, run, name):
        self.run, self.name = run, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        phases = self.run.counters.setdefault("setup_phases", {})
        phases[self.name] = time.perf_counter() - self.t0


def set_math_mode(torch, precision, control=None):
    """The configuration's TF32 switches; the control ``tf32`` turns both
    on (the program's own path one precision below float32)."""
    tf32 = control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32 or precision["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = tf32 or precision["cudnn_tf32"]


def execute(run, t_start):
    """Set-up, window, profiled sub-window (traced runs), release, check.
    Returns the checks [(name, value, limit)] and the device's peak."""
    import torch

    set_math_mode(torch, run.config["precision"], run.control)
    kind = load_module(os.path.join(PB, "traffic",
                                    run.params["kind"] + ".py"),
                       "portbench_kind_")
    job = kind.Job(run)
    job.setup()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.time() - t_start
    job.window(run.seconds)
    if run.traced:
        job.profile()
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    job.release()
    checks = job.check()
    return checks, peak


def read_metrics(run, metrics):
    out = {}
    for m in metrics:
        reader = load_module(os.path.join(PB, "metrics", m["name"] + ".py"),
                             "portbench_metric_")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def loaded_forbidden():
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def is_correct(checks):
    return all(v == v and v <= lim for _, v, lim in checks)


def card_name_and_limit(torch):
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
        limit = out.splitlines()[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return torch.cuda.get_device_name(0), limit


def main(args, t_start):
    """Run the cell ``args.workload``; returns the exit code."""
    try:
        bench, cell, config, params, limits = cell_files(args.workload)
    except (Refused, OSError, KeyError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ". No result.", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    run = Run(args.workload, config, params, limits, args.seed, args.seconds,
              bool(args.trace), torch.device("cuda", 0))
    torch.cuda.reset_peak_memory_stats()
    checks, peak = execute(run, t_start)
    metrics = read_metrics(run, cell_metrics(bench, args.workload,
                                             run.traced))
    found = loaded_forbidden()
    if found:
        print(f"portbench: modules {found} were loaded; the benchmark runs "
              "the PyTorch port alone. No result.", file=sys.stderr)
        return 3
    kind, limit = card_name_and_limit(torch)
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": int(peak), "power_limit": limit}
    result = {"correct": is_correct(checks),
              "attempted": run.stats.get("attempted", 0),
              "failed": run.stats.get("failed", 0),
              "metrics": metrics, "device": device}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    print(f"setup_s {run.setup_s!r}, phases "
          f"{run.counters.get('setup_phases')}", file=sys.stderr)
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
