"""cuDNN's algorithm search around the card's scans, on the CPU
(``scae_tpu_torch/parallel/graphs.py::cudnn_search``, its use in
``parallel/train_step.py::_Captures``). cuDNN's switches are process
flags that the CPU build keeps too, so here:

  * inside ``cudnn_search`` the search (``benchmark``) is on, and the
    caller's ``deterministic`` and ``allow_tf32`` (cuDNN's and cuBLAS's)
    are as the caller set them; after it every switch is back, also where
    the block raises;
  * the scans' captures (``_Captures`` through ``_graph_train_rows`` and
    ``_graph_eval_rows``, with a stand-in graph that runs the step once at
    capture, as a capture does, and again at each replay): each
    convolution of the warm-up row and of the capture runs with the
    search on, each of a replay with the caller's switches.

On the card the replays run what the capture holds; that a graph with the
searched algorithms replays the eager rows bit for bit is held by
``test_graph_scan_equals_eager_steps_under_the_search`` in
tests/test_torch_gpu.py.
"""

import contextlib

import numpy as np
import pytest
import torch

from scae_tpu_torch.factory import make_scae
from scae_tpu_torch.models.layers import TorchConv2d
from scae_tpu_torch.optim import make_optimizer
from scae_tpu_torch.parallel import graphs
from scae_tpu_torch.parallel import train_step as ts
from scae_tpu_torch.train.loop import make_augment_fn

torch.set_num_threads(1)

MODEL = dict(
    image_shape=(1, 24, 24), n_classes=10, n_part_caps=8, n_obj_caps=4,
    pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
    pcae_template_generator_params=dict(template_size=(5, 5)),
    ocae_encoder_set_transformer_params=dict(dim_hidden=8, dim_out=16),
    ocae_decoder_capsule_params=dict(dim_caps=8, hidden_sizes=(16,)))


def switches():
    cudnn = torch.backends.cudnn
    return {"enabled": cudnn.enabled, "benchmark": cudnn.benchmark,
            "deterministic": cudnn.deterministic,
            "allow_tf32": cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


@pytest.fixture
def caller():
    """The process's cuDNN and cuBLAS switches, restored after the test;
    the search off, as the cells and the Trainer leave it."""
    before = switches()
    torch.backends.cudnn.benchmark = False
    yield
    for name in ("enabled", "benchmark", "deterministic", "allow_tf32"):
        setattr(torch.backends.cudnn, name, before[name])
    torch.backends.cuda.matmul.allow_tf32 = before["matmul_allow_tf32"]


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("allow_tf32", [False, True])
def test_search_keeps_the_callers_switches(caller, allow_tf32,
                                           deterministic):
    torch.backends.cudnn.allow_tf32 = allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.deterministic = deterministic
    set_by_caller = switches()
    with graphs.cudnn_search():
        assert switches() == dict(set_by_caller, benchmark=True)
    assert switches() == set_by_caller
    with pytest.raises(ZeroDivisionError):
        with graphs.cudnn_search():
            assert switches() == dict(set_by_caller, benchmark=True)
            1 / 0
    assert switches() == set_by_caller
    # a caller that searches already keeps searching
    torch.backends.cudnn.benchmark = True
    with graphs.cudnn_search():
        pass
    assert switches() == dict(set_by_caller, benchmark=True)


class CapturingGraph:
    """Stands in for ``StepGraph`` on the CPU: the step runs once at
    capture, as the capture runs it, and again at each replay."""

    def __init__(self, fn, generators=(), pool=None):
        self.fn = fn
        with phase("capture"):
            fn()

    def replay(self):
        with phase("replay"):
            return self.fn()


PHASE = ["warm-up"]
SEEN = []    # (phase, benchmark, deterministic, allow_tf32) per convolution


@contextlib.contextmanager
def phase(name):
    PHASE.append(name)
    try:
        yield
    finally:
        PHASE.pop()


@pytest.fixture
def recorded(monkeypatch):
    """The stand-in graph, and a record of cuDNN's switches at each
    convolution of the model that ``recorded`` is given."""
    monkeypatch.setattr(ts, "StepGraph", CapturingGraph)
    monkeypatch.setattr(ts, "side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(ts, "_to_card", lambda rows, dtype, device:
                        torch.as_tensor(np.asarray(rows)).to(dtype))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    SEEN.clear()

    def record(model):
        cudnn = torch.backends.cudnn
        for m in model.modules():
            if isinstance(m, TorchConv2d):
                m.register_forward_pre_hook(lambda *_: SEEN.append((
                    PHASE[-1], cudnn.benchmark, cudnn.deterministic,
                    cudnn.allow_tf32)))
    return record


def small_data(n=12, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": torch.from_numpy(
                rng.randint(0, 256, (n, 20, 20)).astype(np.uint8)),
            "label": torch.from_numpy(rng.randint(0, 10, (n,)))}


ROWS = torch.tensor([[0, 3, 5, 9], [1, 1, 2, 8], [11, 4, 7, 6]])


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_warm_up_and_capture_search_and_replays_do_not(caller, recorded,
                                                       kind):
    """Three rows: the warm-up row, then the capture and two replays; the
    caller's deterministic algorithms without TF32, as the card's graph
    tests set them."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    model = make_scae(MODEL, device="cpu", seed=0)
    recorded(model)
    data = small_data()
    if kind == "train":
        state = ts.TrainState(model, make_optimizer(
            model.parameters(), "rmsprop", 1e-3, batch_size=4), seed=5)
        captures = ts._Captures(None, torch.device("cpu"), 4, generators=2)
        out = ts._graph_train_rows(captures, state, data, ROWS,
                                   make_augment_fn(canvas=24, max_shift=2))
    else:
        captures = ts._Captures(None, torch.device("cpu"), 4)
        with torch.inference_mode():
            out = ts._graph_eval_rows(captures, model, data, ROWS, 24)
    assert all(v.shape == (3,) for v in out.values())
    # the stack's four convolutions and the attention's
    n = len([m for m in model.modules() if isinstance(m, TorchConv2d)])
    assert SEEN == [("warm-up", True, True, False)] * n \
        + [("capture", True, True, False)] * n \
        + [("replay", False, True, False)] * 2 * n
    assert torch.backends.cudnn.benchmark is False
