"""The port's spans and counters (``scae_tpu_torch.utils.trace``) on the
CPU: silent and free while no profiler records; under one, the serving
call's spans nest (host records and the profiler's own events); the
summary's arithmetic; the counters; ``CallGraphs``' span order with the
stand-in graphs of test_torch_serve_graphs.py; and the benchmark's six
readers of them (``portbench/metrics``), None where nothing was recorded.
The device spans' stream time needs the card (tests/test_torch_gpu.py).
"""

import contextlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scae_tpu_torch import serve
from scae_tpu_torch.factory import make_scae
from scae_tpu_torch.parallel import graphs
from scae_tpu_torch.utils import trace

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MODEL = dict(
    image_shape=(1, 24, 24), n_classes=10, n_part_caps=8, n_obj_caps=4,
    pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
    pcae_template_generator_params=dict(template_size=(5, 5)),
    ocae_encoder_set_transformer_params=dict(dim_hidden=8, dim_out=16),
    ocae_decoder_capsule_params=dict(dim_caps=8, hidden_sizes=(16,)),
    pcae_decoder_params=dict(fused_impl="xla"))


@pytest.fixture(autouse=True)
def clean():
    trace.reset()
    yield
    trace.reset()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def images(b, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(
        b, *MODEL["image_shape"]).astype(np.float32))


# ------------------------------------------------------------- off path

def test_off_path_is_one_null_context_and_touches_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(trace.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    first = trace.span("a")
    assert isinstance(first, contextlib.nullcontext)
    assert trace.span("b", device=True, items=7) is first
    with trace.span("c"):
        with trace.span("d", device=True):
            pass
    assert trace.summary() == {}


def test_serving_call_off_path_records_nothing(tmp_path):
    model = make_scae(MODEL, device="cpu", seed=0)
    infer = serve.make_infer_fn(model, device="cpu")
    infer(images(2))
    assert trace.summary() == {}


# --------------------------------------------------------- under a profiler

def test_serving_call_spans_nest_in_records_and_in_the_profiler(tmp_path):
    model = make_scae(MODEL, device="cpu", seed=0)
    serve.export_serving(model, image_shape=MODEL["image_shape"],
                         batch_size=None, out_dir=str(tmp_path),
                         device="cpu", polymorphic_batch=True)
    assert trace.counters()["export.seconds"] > 0
    loaded = serve.load_serving(str(tmp_path), device="cpu")
    with recording() as prof:
        loaded(images(3))
        loaded.eager(images(2, seed=1))
    recs = sorted(trace._records, key=lambda r: r.seq)
    assert [r.name for r in recs] == ["serve.call", "serve.input"] * 2
    for call, inner in (recs[:2], recs[2:]):
        assert call.parent is None and call.request == call.seq
        assert inner.parent == call.seq and inner.request == call.seq
        assert call.start <= inner.start <= inner.end <= call.end
        assert call.child_ns == inner.end - inner.start
    assert recs[0].request != recs[2].request
    found = trace.summary()
    assert found["serve.call"]["calls"] == 2
    assert found["serve.input"]["lead_ns"] == sum(
        i.start - c.start for c, i in (recs[:2], recs[2:]))
    assert found["serve.call"]["device_ns"] is None
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(trace.PREFIX)]
    calls = sorted((e for e in events if e.name() == "scae_tpu_torch."
                    "serve.call"), key=lambda e: e.start_ns())
    inputs = sorted((e for e in events if e.name() == "scae_tpu_torch."
                     "serve.input"), key=lambda e: e.start_ns())
    assert len(calls) == len(inputs) == 2
    for c, i in zip(calls, inputs):
        assert c.start_ns() <= i.start_ns() <= i.end_ns() <= c.end_ns()


def test_a_failing_call_closes_its_spans():
    loaded = serve.ServingModel.__new__(serve.ServingModel)
    loaded.manifest = {"input": {"shape": [None, 1, 24, 24]}}
    loaded.device, loaded.mesh = torch.device("cpu"), None
    loaded._call = None
    with recording():
        with pytest.raises(ValueError):
            loaded.eager(torch.zeros(2, 1, 5, 5))
        with trace.span("after"):
            pass
    found = trace.summary()
    assert found["serve.input"]["calls"] == 1
    after = [r for r in trace._records if r.name == "after"][0]
    assert after.parent is None


# --------------------------------------------------------- arithmetic

def synthetic():
    R = trace.Record
    return [
        # request 1: a root of 100 ns with two children, one nesting a third
        R(1, "call", start=0, end=100, child_ns=60),
        R(2, "part", parent=1, request=1, start=10, end=40, child_ns=5),
        R(3, "leaf", parent=2, request=1, start=20, end=25),
        R(4, "part", parent=1, request=1, start=50, end=80, items=3),
        # request 5: a second root
        R(5, "call", start=200, end=350, child_ns=20),
        R(6, "part", parent=5, request=5, start=300, end=320),
    ]


def test_summary_totals_self_max_lead_and_device_time():
    found = trace.summarize(synthetic(), device_ns={4: 1000, 6: 500})
    assert found["call"] == dict(calls=2, items=2, total_ns=250,
                                 self_ns=250 - 80, max_ns=150, lead_ns=0,
                                 device_ns=None)
    assert found["part"] == dict(calls=3, items=5, total_ns=80,
                                 self_ns=75, max_ns=30,
                                 lead_ns=10 + 50 + 100, device_ns=1500)
    assert found["leaf"]["lead_ns"] == 20
    assert found["leaf"]["self_ns"] == 5


def test_counters_add_and_reset():
    trace.count("a")
    trace.count("a", 4)
    trace.add_seconds("s", 0.25)
    trace.add_seconds("s", 0.5)
    assert trace.counters() == {"a": 5, "s": 0.75, "trace.dropped": 0}
    trace.reset()
    assert trace.counters() == {"trace.dropped": 0}


def test_records_past_the_cap_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    with recording():
        for _ in range(5):
            with trace.span("x"):
                pass
    assert trace.summary()["x"]["calls"] == 3
    assert trace.counters()["trace.dropped"] == 2
    trace.reset()
    assert trace.summary() == {}


# ------------------------------------------------------ CallGraphs' spans

class EagerGraph:
    """Stands in for ``StepGraph`` as in test_torch_serve_graphs.py."""

    def __init__(self, fn, generators=(), pool=None, **mode):
        self.fn = fn
        self.out = fn()

    def replay(self):
        new = self.fn()
        for k, v in self.out.items():
            v.copy_(new[k])
        return self.out


@pytest.fixture
def eager_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "StepGraph", EagerGraph)
    monkeypatch.setattr(graphs, "side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())


def test_call_graphs_span_order_and_counters(eager_graphs):
    model = make_scae(MODEL, device="cpu", seed=0)

    def fn(x):
        return serve.infer_outputs(model(x, deterministic=True))

    calls = graphs.CallGraphs(fn, model, torch.device("cpu"))
    with torch.inference_mode(), recording():
        calls(images(2))
        calls(images(2, seed=1))
    recs = sorted(trace._records, key=lambda r: r.seq)
    first = ["graphs.key", "graphs.capture", "graphs.copy_in",
             "graphs.replay", "graphs.clone"]
    assert [r.name for r in recs] == first + [n for n in first
                                              if n != "graphs.capture"]
    assert all(r.parent is None for r in recs)
    assert trace.counters()["graphs.capture_s"] > 0
    assert "graphs.recaptures" not in trace.counters()
    assert trace.counters()["graphs.rekeys"] == 1
    # a replaced tensor drops the one graph: a recapture
    model.prior_classifier.weight = torch.nn.Parameter(
        model.prior_classifier.weight.detach() / 2)
    with torch.inference_mode():
        calls(images(2))
    assert trace.counters()["graphs.recaptures"] == 1
    assert trace.counters()["graphs.rekeys"] == 2
    assert trace.counters()["graphs.captures"] == 2
    # on the CPU no replay records stream time
    assert trace.summary()["graphs.replay"]["device_ns"] is None


def test_read_spans_nest_under_an_enclosing_span():
    from scae_tpu_torch.train import loop

    with recording():
        with trace.span("outer"):
            read = loop._start_read({"loss": torch.tensor([1.0, 2.0])})
            assert loop._finish_read(read) == {"loss": 2.0}
    found = trace.summary()
    assert found["read.start"]["calls"] == found["read.wait"]["calls"] == 1
    outer = found["outer"]
    assert outer["self_ns"] == outer["total_ns"] - (
        found["read.start"]["total_ns"] + found["read.wait"]["total_ns"])


def test_train_scan_on_the_cpu_runs_the_eager_loop_without_scan_spans():
    """The scans' spans are the card's graph path's: the CPU's eager loop
    records none of them."""
    from scae_tpu_torch.optim import make_optimizer
    from scae_tpu_torch.parallel import train_step as ts

    model = make_scae(MODEL, device="cpu", seed=0)
    state = ts.TrainState(model, make_optimizer(model.parameters(),
                                                "rmsprop", 1e-3,
                                                batch_size=2), seed=1)
    rng = np.random.RandomState(0)
    data = {"image": torch.from_numpy(rng.randint(0, 256, (8, 24, 24))
                                      .astype(np.uint8)),
            "label": torch.from_numpy(rng.randint(0, 10, (8,)))}
    scan = ts.make_train_scan(device="cpu")
    with recording():
        scan(state, data, np.array([[0, 1], [2, 3]]))
    assert not any(n.startswith("scan.") for n in trace.summary())


# ------------------------------------------------------ the readers

READERS = ("serve_prelaunch_us.bulk", "serve_replay_ms.bulk",
           "scan_step_ms", "eval_share_pct", "setup_export_s",
           "setup_capture_s")


def reader(name):
    path = os.path.join(REPO, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "trace_reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def span_stats(calls=1, items=1, lead_ns=0, device_ns=None):
    return dict(calls=calls, items=items, total_ns=0, self_ns=0, max_ns=0,
                lead_ns=lead_ns, device_ns=device_ns)


SUMMARY = {
    "serve.call": span_stats(calls=4),
    "graphs.replay": span_stats(calls=4, lead_ns=4 * 300_000,
                                device_ns=4 * 1_100_000),
    "scan.train": span_stats(calls=2, items=100, device_ns=480_000_000),
    "scan.eval": span_stats(calls=1, items=39, device_ns=20_000_000),
}
COUNTERS = {"export.seconds": 14.5, "graphs.capture_s": 0.75,
            "scan.capture_s": 1.25, "trace.dropped": 0}
WANT = {"serve_prelaunch_us.bulk": 300.0, "serve_replay_ms.bulk": 1.1,
        "scan_step_ms": 4.8, "eval_share_pct": 4.0, "setup_export_s": 14.5,
        "setup_capture_s": 2.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_summary(monkeypatch, name):
    monkeypatch.setattr(trace, "summary", lambda: SUMMARY)
    monkeypatch.setattr(trace, "counters", lambda: COUNTERS)
    assert reader(name)(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_where_nothing_was_recorded(name):
    assert reader(name)(None) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_a_program_without_the_module(monkeypatch,
                                                              name):
    import scae_tpu_torch.utils

    monkeypatch.delattr(scae_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "scae_tpu_torch.utils.trace", None)
    assert reader(name)(None) is None


@pytest.mark.parametrize("name", ["serve_replay_ms.bulk", "scan_step_ms",
                                  "eval_share_pct"])
def test_device_readers_find_nothing_without_stream_time(monkeypatch, name):
    host_only = {k: dict(v, device_ns=None) for k, v in SUMMARY.items()}
    monkeypatch.setattr(trace, "summary", lambda: host_only)
    assert reader(name)(None) is None
