"""Serving's CUDA graphs, host side, on the CPU (``parallel.graphs.
CallGraphs`` behind ``serve.make_infer_fn`` and ``serve.ServingModel``).

The graphs themselves need the card (tests/test_torch_gpu.py holds each
replay to the eager call bit for bit). Here a stand-in graph whose replay
runs the captured call eagerly checks the bookkeeping: a warm-up and one
capture for each input shape and dtype, none for a second call, all in one
pool; a new capture, and the old graphs dropped, where a tensor the call
reads is replaced; fresh output tensors every call; a failing capture
raises. And the CPU surfaces stay eager and return fresh tensors.
"""

import contextlib

import numpy as np
import pytest
import torch

from scae_tpu_torch import serve
from scae_tpu_torch.factory import make_scae
from scae_tpu_torch.parallel import graphs

torch.set_num_threads(1)

MODEL = dict(
    image_shape=(1, 24, 24), n_classes=10, n_part_caps=8, n_obj_caps=4,
    pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
    pcae_template_generator_params=dict(template_size=(5, 5)),
    ocae_encoder_set_transformer_params=dict(dim_hidden=8, dim_out=16),
    ocae_decoder_capsule_params=dict(dim_caps=8, hidden_sizes=(16,)),
    pcae_decoder_params=dict(fused_impl="xla"))


class EagerGraph:
    """Stands in for ``StepGraph``: the capture runs the call once (as a
    capture records it), each replay runs it again on the static input
    as it stands and returns the same output objects, overwritten, as a
    graph's static outputs are."""

    made = []

    def __init__(self, fn, generators=(), pool=None, **mode):
        self.fn, self.pool, self.mode = fn, pool, mode
        self.out = fn()
        EagerGraph.made.append(self)

    def replay(self):
        new = self.fn()
        for k, v in self.out.items():
            v.copy_(new[k])
        return self.out


@pytest.fixture
def eager_graphs(monkeypatch):
    EagerGraph.made = []
    pools = []
    monkeypatch.setattr(graphs, "StepGraph", EagerGraph)
    monkeypatch.setattr(graphs, "side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: pools.append(object()) or pools[-1])
    return EagerGraph.made


def small_model():
    return make_scae(MODEL, device="cpu", seed=0)


def images(b, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(
        b, 1, 24, 24).astype(np.float32))


def forward(model):
    def fn(x):
        return serve.infer_outputs(model(x, deterministic=True))
    return fn


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_one_capture_per_shape_in_one_pool(eager_graphs):
    model = small_model()
    calls = []
    fn = forward(model)

    def counted(x):
        calls.append(tuple(x.shape))
        return fn(x)

    g = graphs.CallGraphs(counted, lambda: graphs.module_tensors(model),
                          torch.device("cpu"))
    with torch.inference_mode():
        for b in (4, 3, 4, 3, 4):
            assert_same(g(images(b, seed=b)), fn(images(b, seed=b)))
    # per shape: the warm-up calls and the capture, then one call a replay
    per = graphs.WARMUP_STEPS + 1
    assert calls[:per] == [(4, 1, 24, 24)] * per
    assert g.captures == 2 and len(eager_graphs) == 2
    assert sorted(g.graphs) == [((3, 1, 24, 24), torch.float32),
                                ((4, 1, 24, 24), torch.float32)]
    assert len({id(e.pool) for e in eager_graphs}) == 1
    assert len(calls) == 2 * per + 5


def test_the_input_dtype_is_part_of_the_key(eager_graphs):
    g = graphs.CallGraphs(lambda x: {"y": x * 2}, list, torch.device("cpu"))
    x = torch.arange(4.0)
    assert_same(g(x), {"y": x * 2})
    assert_same(g(x.double()), {"y": x.double() * 2})
    assert_same(g(x + 1), {"y": (x + 1) * 2})
    assert g.captures == 2


def test_calls_return_fresh_tensors(eager_graphs):
    model = small_model()
    g = graphs.CallGraphs(forward(model), lambda: graphs.module_tensors(
        model), torch.device("cpu"))
    with torch.inference_mode():
        first = g(images(4, seed=1))
        kept = {k: v.clone() for k, v in first.items()}
        second = g(images(4, seed=2))
        g(images(4, seed=3))
    assert_same(first, kept)
    assert not torch.equal(second["caps_presence"], first["caps_presence"])
    static = eager_graphs[0].out
    assert all(first[k] is not static[k] for k in static)


def test_a_replaced_tensor_captures_anew(eager_graphs):
    """A parameter written in place keeps the graphs; one replaced by a new
    tensor drops them all (and their pool) and captures again."""
    model = small_model()
    g = graphs.CallGraphs(forward(model), lambda: graphs.module_tensors(
        model), torch.device("cpu"))
    x = images(4)
    with torch.inference_mode():
        g(x)
        g(images(3))
    with torch.no_grad():
        model.prior_classifier.weight.mul_(2.0)
    with torch.inference_mode():
        in_place = g(x)
    assert g.captures == 2
    assert_same(in_place, forward(model)(x))
    model.prior_classifier.weight = torch.nn.Parameter(
        model.prior_classifier.weight.detach() / 2)
    with torch.inference_mode():
        again = g(x)
    assert g.captures == 3 and list(g.graphs) == [((4, 1, 24, 24),
                                                   torch.float32)]
    assert eager_graphs[2].pool is not eager_graphs[0].pool
    assert_same(again, forward(model)(x))


def test_module_tensors_see_plain_tensor_attributes():
    model = small_model()
    model.obj_encoder.constant = torch.zeros(3)
    found = graphs.module_tensors(model)
    assert any(t is model.obj_encoder.constant for t in found)
    assert all(any(t is p for t in found) for p in model.parameters())


def test_a_failing_capture_raises(eager_graphs, monkeypatch):
    def failing(*args, **kwargs):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs, "StepGraph", failing)
    model = small_model()
    g = graphs.CallGraphs(forward(model), lambda: graphs.module_tensors(
        model), torch.device("cpu"))
    with pytest.raises(RuntimeError, match="capture failed"):
        with torch.inference_mode():
            g(images(2))


def test_the_card_graphs_and_the_cpu_stays_eager():
    """``serve._graphed``: a CallGraphs on the card (the process group's
    threads allowed to query the card during a mesh's captures), none on
    the CPU."""
    def fn(x):
        return x

    got = serve._graphed(fn, list, torch.device("cuda"))
    assert isinstance(got, graphs.CallGraphs) and got.mode == {}
    on_mesh = serve._graphed(fn, list, torch.device("cuda"), mesh=object())
    assert on_mesh.mode == {"capture_error_mode": "thread_local"}
    assert serve._graphed(fn, list, torch.device("cpu")) is None


def test_cpu_infer_fn_is_eager_and_fresh():
    model = small_model()
    infer = serve.make_infer_fn(model, device="cpu")
    assert infer.graphs is None
    x = images(3)
    first, second = infer(x), infer(x)
    assert_same(first, infer.eager(x))
    assert all(first[k] is not second[k] for k in first)
    assert_same(first, second)


def test_cpu_serving_model_is_eager_and_fresh(tmp_path):
    model = small_model()
    serve.export_serving(model, image_shape=(1, 24, 24), batch_size=None,
                         out_dir=str(tmp_path), device="cpu",
                         polymorphic_batch=True)
    served = serve.load_serving(str(tmp_path))
    assert served.graphs is None
    x = images(3)
    first, second = served(x), served(x)
    assert_same(first, served.eager(x))
    assert all(first[k] is not second[k] for k in first)
    live = serve.make_infer_fn(model, device="cpu")(x)
    for k in live:
        torch.testing.assert_close(first[k], live[k], rtol=1e-4, atol=1e-5)
