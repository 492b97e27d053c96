"""Serving's CUDA graphs, host side, on the CPU (``parallel.graphs.
CallGraphs`` behind ``serve.make_infer_fn`` and ``serve.ServingModel``).

The graphs themselves need the card (tests/test_torch_gpu.py holds each
replay to the eager call bit for bit). Here a stand-in graph whose replay
runs the captured call eagerly checks the bookkeeping: a warm-up and one
capture for each input shape and dtype, none for a second call, all in one
pool; a new capture, and the old graphs dropped, where a tensor the call
reads is replaced (each kind of slot, on a module and on its exported
program's module), none where it is written in place; one full walk of the
module for any number of calls that change nothing; fresh output tensors
every call; a failing capture raises. And the CPU surfaces stay eager and
return fresh tensors.
"""

import contextlib

import numpy as np
import pytest
import torch

from scae_tpu_torch import serve
from scae_tpu_torch.factory import make_scae
from scae_tpu_torch.parallel import graphs
from scae_tpu_torch.utils import trace

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

    captured = trace.Since()
    g = graphs.CallGraphs(counted, model, torch.device("cpu"))
    with torch.inference_mode():
        for b in (4, 3, 4, 3, 4):
            assert_same(g(images(b, seed=b)), fn(images(b, seed=b)))
    # per shape: the warm-up calls and the capture, then one call a replay
    per = graphs.WARMUP_STEPS + 1
    assert calls[:per] == [(4, 1, 24, 24)] * per
    assert captured["graphs.captures"] == 2 and len(eager_graphs) == 2
    assert sorted(g.graphs) == [((3, 1, 24, 24), torch.float32),
                                ((4, 1, 24, 24), torch.float32)]
    assert len({id(e.pool) for e in eager_graphs}) == 1
    assert len(calls) == 2 * per + 5


def test_the_input_dtype_is_part_of_the_key(eager_graphs):
    captured = trace.Since()
    g = graphs.CallGraphs(lambda x: {"y": x * 2}, None, torch.device("cpu"))
    x = torch.arange(4.0)
    assert_same(g(x), {"y": x * 2})
    assert_same(g(x.double()), {"y": x.double() * 2})
    assert_same(g(x + 1), {"y": (x + 1) * 2})
    assert captured["graphs.captures"] == 2


def test_calls_return_fresh_tensors(eager_graphs):
    model = small_model()
    g = graphs.CallGraphs(forward(model), model,
                          torch.device("cpu"))
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
    captured = trace.Since()
    g = graphs.CallGraphs(forward(model), model,
                          torch.device("cpu"))
    x = images(4)
    with torch.inference_mode():
        g(x)
        g(images(3))
    with torch.no_grad():
        model.prior_classifier.weight.mul_(2.0)
    with torch.inference_mode():
        in_place = g(x)
    assert captured["graphs.captures"] == 2
    assert_same(in_place, forward(model)(x))
    model.prior_classifier.weight = torch.nn.Parameter(
        model.prior_classifier.weight.detach() / 2)
    with torch.inference_mode():
        again = g(x)
    assert captured["graphs.captures"] == 3
    assert list(g.graphs) == [((4, 1, 24, 24), torch.float32)]
    assert eager_graphs[2].pool is not eager_graphs[0].pool
    assert_same(again, forward(model)(x))


class Reads(torch.nn.Module):
    """Reads a tensor from each kind of slot: a parameter, a buffer, a
    plain tensor attribute and a submodule's parameters."""

    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.arange(4.0))
        self.register_buffer("scale", torch.full((4,), 2.0))
        self.offset = torch.ones(4)
        self.inner = torch.nn.Linear(4, 4)

    def forward(self, x):
        return {"y": self.inner(x * self.weight * self.scale + self.offset)}


def reads(kind):
    """A ``Reads``, as it is (``"module"``) or as its ExportedProgram's
    module (``"exported"``, where ``offset`` is a lifted constant: a plain
    tensor attribute of the program's module)."""
    torch.manual_seed(0)
    module = Reads()
    if kind == "exported":
        module = torch.export.export(module, (torch.rand(3, 4),)).module()
        assert isinstance(vars(module).get("offset"), torch.Tensor)
    return module


def counted(name):
    return trace.counters().get(name, 0)


def _new_parameter(m):
    m.weight = torch.nn.Parameter(m.weight.detach() + 1)


def _new_buffer(m):
    m.scale = m.scale + 1


def _new_tensor_attribute(m):
    m.offset = m.offset * 3


def _new_submodule(m):
    torch.manual_seed(1)
    m.inner = torch.nn.Linear(4, 4)


def _tensor_attribute_added(m):
    m.extra = torch.zeros(2)


def _data_same_shape(m):
    m.weight.data = m.weight.detach() * 5


def _data_new_shape(m):
    m.weight.data = m.weight.data.view(1, 4)      # same address


def _data_new_dtype(m):
    m.scale.data = m.scale.data.view(torch.int32)   # same address, shape


@pytest.mark.parametrize("kind", ["module", "exported"])
@pytest.mark.parametrize("replace", [
    _new_parameter, _new_buffer, _new_tensor_attribute, _new_submodule,
    _tensor_attribute_added, _data_same_shape, _data_new_shape,
    _data_new_dtype],
    ids=lambda f: f.__name__.lstrip("_"))
def test_each_replaced_slot_recaptures_once(eager_graphs, replace, kind):
    """Whatever slot's occupant is replaced, a slot added, or a tensor
    moved to other storage, shape or dtype, the check sees it: one full
    walk, one recapture, and the calls return the module's outputs as it
    now stands."""
    module = reads(kind)
    captured = trace.Since()
    g = graphs.CallGraphs(module, module, torch.device("cpu"))
    x = torch.rand(3, 4)
    with torch.inference_mode():
        g(x)
        assert_same(g(x), module(x))
    rekeys, recaptures = counted("graphs.rekeys"), counted("graphs.recaptures")
    replace(module)
    with torch.inference_mode():
        got = [g(x), g(x)]
        want = module(x)
    assert captured["graphs.captures"] == 2 and len(eager_graphs) == 2
    assert counted("graphs.rekeys") == rekeys + 1
    assert counted("graphs.recaptures") == recaptures + 1
    for out in got:
        assert_same(out, want)


@pytest.mark.parametrize("write", ["mul_", "load_state_dict"])
def test_an_in_place_write_keeps_the_graphs(eager_graphs, write):
    model = small_model()
    captured = trace.Since()
    g = graphs.CallGraphs(forward(model), model, torch.device("cpu"))
    x = images(4)
    with torch.inference_mode():
        g(x)
    rekeys, recaptures = counted("graphs.rekeys"), counted("graphs.recaptures")
    with torch.no_grad():
        if write == "mul_":
            model.prior_classifier.weight.mul_(2.0)
        else:
            model.load_state_dict(make_scae(MODEL, device="cpu",
                                            seed=1).state_dict())
    with torch.inference_mode():
        got = g(x)
        want = forward(model)(x)
    assert captured["graphs.captures"] == 1
    assert counted("graphs.rekeys") == rekeys
    assert counted("graphs.recaptures") == recaptures
    assert_same(got, want)


def test_calls_that_change_nothing_walk_the_model_once(eager_graphs,
                                                      monkeypatch):
    walks = []
    module_tensors = graphs.module_tensors
    monkeypatch.setattr(graphs, "module_tensors",
                        lambda m: walks.append(m) or module_tensors(m))
    model = small_model()
    captured = trace.Since()
    g = graphs.CallGraphs(forward(model), model, torch.device("cpu"))
    rekeys = counted("graphs.rekeys")
    with torch.inference_mode():
        for b in (4, 3, 4, 3, 4, 4):
            g(images(b, seed=b))
    assert walks == [model]
    assert counted("graphs.rekeys") == rekeys + 1
    assert captured["graphs.captures"] == 2


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("artifact")
    serve.export_serving(small_model(), image_shape=(1, 24, 24),
                         batch_size=None, out_dir=str(out), device="cpu",
                         polymorphic_batch=True)
    return str(out)


def test_a_loaded_artifact_recaptures_for_a_replaced_tensor(
        eager_graphs, monkeypatch, artifact):
    """``ServingModel`` keys its graphs by the program's module: one of
    its tensors replaced (this program lifts no constants; its tensors are
    parameters, ``Reads`` covers a constant) recaptures, and the call
    returns the replaced program's outputs."""
    monkeypatch.setattr(serve, "_graphed", lambda fn, module, device,
                        mesh=None: graphs.CallGraphs(fn, module, device))
    captured = trace.Since()
    served = serve.load_serving(artifact)
    assert served.graphs.module is served._call
    x = images(4)
    with torch.inference_mode():
        served(x)
        served(x)
    assert captured["graphs.captures"] == 1
    name, param = next(iter(served._call.named_parameters()))
    owner, _, leaf = name.rpartition(".")
    setattr(served._call.get_submodule(owner), leaf,
            torch.nn.Parameter(param.detach() * 2))
    recaptures = counted("graphs.recaptures")
    with torch.inference_mode():
        got = served(x)
    assert captured["graphs.captures"] == 2
    assert counted("graphs.recaptures") == recaptures + 1
    assert_same(got, served.eager(x))


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
    g = graphs.CallGraphs(forward(model), model,
                          torch.device("cpu"))
    with pytest.raises(RuntimeError, match="capture failed"):
        with torch.inference_mode():
            g(images(2))


def test_the_card_graphs_and_the_cpu_stays_eager():
    """``serve._graphed``: a CallGraphs on the card (the process group's
    threads allowed to query the card during a mesh's captures), none on
    the CPU."""
    def fn(x):
        return x

    got = serve._graphed(fn, None, torch.device("cuda"))
    assert isinstance(got, graphs.CallGraphs) and got.mode == {}
    on_mesh = serve._graphed(fn, None, torch.device("cuda"), mesh=object())
    assert on_mesh.mode == {"capture_error_mode": "thread_local"}
    assert serve._graphed(fn, None, torch.device("cpu")) is None


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
