"""The host side of the port's graph scans on the CPU, in seconds
(``scae_tpu_torch/parallel/train_step.py``, ``parallel/graphs.py``,
``optim.py``, ``train/loop.py``). A CUDA graph exists only on the card,
where tests/test_torch_gpu.py replays the scans; here:

  * each optimizer's eager step (its numbers filled in as 0-d float32
    tensors) and its step by a plan whose numbers are views of one vector
    (as a graph reads them) give the bits of the same arithmetic on host
    floats, the optimizers' arithmetic before the graphs, over steps that
    cross every branch; all stay within 1e-6 of optax through
    scae_tpu.optim (tests/test_torch_optim.py's tolerance: a few f32 ulps
    of parameters of order 1);
  * the branch the host picks per step for RAdam and LookAhead;
  * a persistent generator re-seeded per step draws what a fresh one
    draws;
  * the scans' captures (warm-up, index vector, numbers table, re-seeding,
    one graph per branch, all in one memory pool, the metrics' order) with
    a stand-in graph whose replay runs the captured step eagerly: bit for
    bit the eager loop;
  * ``StepGraph`` under a stand-in ``torch.cuda`` graph: the generators
    registered, the pool passed on, the garbage collector off during the
    capture, and no launch count touched by a replay;
  * ``Trainer.run``'s read order on a 3-chunk run: each chunk read after
    the next one's dispatch, its record the chunk's last step.
"""

import contextlib
import gc
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scae_tpu import optim as j_optim
from scae_tpu_torch import optim as t_optim
from scae_tpu_torch.config import load_config
from scae_tpu_torch.factory import make_scae
from scae_tpu_torch.ops.geometry import affine_to_matrix
from scae_tpu_torch.ops.math_ops import as_scalar
from scae_tpu_torch.parallel import graphs
from scae_tpu_torch.parallel import train_step as ts
from scae_tpu_torch.train import loop
from scae_tpu_torch.train.data import draw_translation
from scae_tpu_torch.utils import trace

torch.set_num_threads(1)
SHAPES = [(3, 4), (5,), ()]


# ----------------------------------------------------------- optimizers

def grad_sequence(n, seed=0):
    rng = np.random.RandomState(seed)
    return [[np.asarray(rng.randn(*s) * 10.0 ** rng.uniform(-4, 0),
                        np.float32) for s in SHAPES] for _ in range(n)]


def initial_params(seed=1):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randn(*s), np.float32) for s in SHAPES]


def on_device_numbers(plan):
    """The plan with its numbers as 0-d views of one float32 vector."""
    branch, numbers = plan
    vector = torch.tensor(numbers, dtype=torch.float32)
    return branch, tuple(vector.unbind())


def run_both(make, grads):
    """(host-float trajectory, device-number trajectory, branches): three
    copies of one optimizer over ``grads``: one updated by ``_updates`` on
    the plan's host floats, one by the eager ``step``, one stepping by
    plans whose numbers are views of one vector; the last two must match
    the first bit for bit, parameters and state, at every step."""
    copies = [make([torch.from_numpy(p) for p in initial_params()])
              for _ in range(3)]
    host, eager, dev = copies
    host_traj, dev_traj, branches = [], [], []
    for g in grads:
        g = [torch.from_numpy(x) for x in g]
        branch, numbers = host.advance()
        with torch.no_grad():
            torch._foreach_add_(host.params, host._updates(g, branch,
                                                           numbers))
        eager.step(g)
        plan = dev.advance()
        branches.append(plan[0])
        dev.step(g, on_device_numbers(plan))
        host_traj.append([p.numpy().copy() for p in host.params])
        dev_traj.append([p.numpy().copy() for p in dev.params])
        for other in (eager, dev):
            for a, b in zip(host.params + host.state_tensors(),
                            other.params + other.state_tensors()):
                assert torch.equal(a, b)
    assert host.state_dict().keys() == dev.state_dict().keys()
    return host_traj, dev_traj, branches


def run_jax(tx, grads):
    params = [jnp.asarray(p) for p in initial_params()]
    state = tx.init(params)
    traj = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        traj.append([np.asarray(p) for p in params])
    return traj


# name -> (port optimizer, JAX optimizer, steps); decay every 4 steps;
# RAdam's steps 1-10 cross its rho_t >= 5 test; LookAhead over 2k steps
LR = 1e-2
DECAY = dict(lr_decay_rate=0.5, decay_steps=4)
OPTIMIZERS = {
    "rmsprop": (lambda p: t_optim.RMSprop(p, t_optim.exponential_decay(
        LR, 4, 0.5), decay=0.99, eps=1e-5),
        lambda: optax.rmsprop(optax.exponential_decay(
            LR, 4, 0.5, staircase=True), decay=0.99, eps=1e-5,
            eps_in_sqrt=False), 10),
    "rmsprop momentum": (lambda p: t_optim.make_optimizer(
        p, "rmsprop", LR, batch_size=32, momentum=0.9, **DECAY),
        lambda: j_optim.make_optimizer("rmsprop", LR, batch_size=32,
                                       momentum=0.9, **DECAY), 10),
    "adam": (lambda p: t_optim.make_optimizer(p, "adam", LR, batch_size=32,
                                              **DECAY),
             lambda: j_optim.make_optimizer("adam", LR, batch_size=32,
                                            **DECAY), 10),
    "radam": (lambda p: t_optim.make_optimizer(p, "radam", LR, batch_size=32,
                                               **DECAY),
              lambda: j_optim.make_optimizer("radam", LR, batch_size=32,
                                             **DECAY), 10),
    "radam no sgd, weight decay": (
        lambda p: t_optim.RAdam(p, 0.05, eps=1e-8, weight_decay=0.1,
                                degenerated_to_sgd=False),
        lambda: j_optim.radam(0.05, eps=1e-8, weight_decay=0.1,
                              degenerated_to_sgd=False), 10),
    "lookahead rmsprop": (lambda p: t_optim.make_optimizer(
        p, "rmsprop", LR, batch_size=32, use_lookahead=True,
        lookahead_k=3, **DECAY),
        lambda: j_optim.make_optimizer("rmsprop", LR, batch_size=32,
                                       use_lookahead=True, lookahead_k=3,
                                       **DECAY), 6),
    "lookahead radam": (lambda p: t_optim.make_optimizer(
        p, "radam", LR, batch_size=32, use_lookahead=True, lookahead_k=6),
        lambda: j_optim.make_optimizer("radam", LR, batch_size=32,
                                       use_lookahead=True, lookahead_k=6),
        12),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_numbers_on_the_device_give_the_host_path_bits(name):
    make, make_jax, steps = OPTIMIZERS[name]
    grads = grad_sequence(steps)
    host, dev, _ = run_both(make, grads)
    for step, (a, b) in enumerate(zip(host, dev)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=f"step {step + 1}")
    want = run_jax(make_jax(), grads)
    for step, (a, b) in enumerate(zip(dev, want)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6,
                                       err_msg=f"step {step + 1}")


def radam_branch(t, b2=0.999):
    """RAdam's branch at step t from rho_t in float64 (the port takes it
    in float32; no step here lies near rho_t = 5)."""
    beta2_t = b2 ** t
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    rho_t = rho_inf - 2.0 * t * beta2_t / (1.0 - beta2_t)
    return "rect" if rho_t >= 5.0 else "sgd"


def test_the_host_picks_each_steps_branch():
    _, _, radam = run_both(OPTIMIZERS["radam"][0], grad_sequence(10))
    assert radam == [radam_branch(t) for t in range(1, 11)]
    assert radam == ["sgd"] * 5 + ["rect"] * 5
    _, _, none = run_both(OPTIMIZERS["radam no sgd, weight decay"][0],
                          grad_sequence(10))
    assert none == ["none"] * 5 + ["rect"] * 5
    _, _, la = run_both(OPTIMIZERS["lookahead rmsprop"][0], grad_sequence(6))
    assert la == [(None, False), (None, False), (None, True)] * 2
    _, _, la_radam = run_both(OPTIMIZERS["lookahead radam"][0],
                              grad_sequence(12))
    assert la_radam == [(radam_branch(t), t % 6 == 0) for t in range(1, 13)]


def test_advance_counts_the_step_and_updates_do_not():
    params = [torch.ones(3)]
    opt = t_optim.make_optimizer(params, "adam", 0.1, batch_size=8,
                                 use_lookahead=True, lookahead_k=2)
    plan = opt.advance()
    assert (opt.count, opt.base.count) == (1, 1)
    opt.step([torch.ones(3)], on_device_numbers(plan))
    opt.step([torch.ones(3)], on_device_numbers(plan))
    assert (opt.count, opt.base.count) == (1, 1)
    assert plan == ((None, False), (1.0 - 0.9, 1.0 - 0.999, -0.1))


# ----------------------------------------------------------- generators

def test_a_reseeded_generator_draws_what_a_fresh_one_draws():
    persistent = torch.Generator()
    for step in range(5):
        for data in ((step, 7), (step,)):
            seed = ts._fold_in(123, *data)
            fresh = ts._generator("cpu", seed)
            persistent.manual_seed(seed)
            want = (draw_translation(8, 6, fresh),
                    torch.rand((8, 4), generator=fresh))
            got = (draw_translation(8, 6, persistent),
                   torch.rand((8, 4), generator=persistent))
            for a, b in zip(got[0] + got[1:], want[0] + want[1:]):
                assert torch.equal(a, b)
    assert ts._step_seeds(ts.TrainState(None, None, step=4, seed=123)) == (
        ts._fold_in(123, 4, 7), ts._fold_in(123, 4))


# ------------------------------------------------- captures, host side

MODEL = dict(
    image_shape=(1, 24, 24), n_classes=10, n_part_caps=8, n_obj_caps=4,
    pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
    pcae_template_generator_params=dict(template_size=(5, 5)),
    ocae_encoder_set_transformer_params=dict(dim_hidden=8, dim_out=16),
    ocae_decoder_capsule_params=dict(dim_caps=8, hidden_sizes=(16,)))


class EagerGraph:
    """Stands in for ``StepGraph`` on the CPU: capture records the step,
    each replay runs it eagerly on the buffers as they stand."""

    made = []

    def __init__(self, fn, generators=(), pool=None):
        self.fn, self.generators, self.pool = fn, generators, pool
        EagerGraph.made.append(self)

    def replay(self):
        return self.fn()


@pytest.fixture
def eager_graphs(monkeypatch):
    EagerGraph.made = []
    monkeypatch.setattr(ts, "StepGraph", EagerGraph)
    monkeypatch.setattr(ts, "side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(ts, "_to_card", lambda rows, dtype, device:
                        torch.as_tensor(np.asarray(rows)).to(dtype))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    return EagerGraph.made


def small_data(n=12, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": torch.from_numpy(
                rng.randint(0, 256, (n, 20, 20)).astype(np.uint8)),
            "label": torch.from_numpy(rng.randint(0, 10, (n,)))}


CHUNKS = [np.array([[0, 3, 5, 9], [1, 1, 2, 8], [11, 4, 7, 6],
                    [2, 3, 4, 5], [9, 8, 7, 6]]),
          np.array([[6, 5, 4, 3], [0, 1, 2, 3], [10, 11, 0, 1],
                    [7, 7, 7, 7]])]


@pytest.mark.parametrize("optimizer", ["rmsprop", "radam lookahead"])
def test_train_captures_equal_the_eager_loop(eager_graphs, optimizer):
    """Two chunks (5 then 4 steps), noise and translation on, the rate
    halved every 3 steps: the eager warm-up step, then replays; RAdam with
    LookAhead (k=2) takes four branches in the replayed steps, each its own
    graph."""
    augment = loop.make_augment_fn(canvas=24, max_shift=2)
    kw = (dict(name="rmsprop", momentum=0.9) if optimizer == "rmsprop" else
          dict(name="radam", use_lookahead=True, lookahead_k=2))
    states = []
    for _ in range(2):
        model = make_scae(MODEL, device="cpu", seed=0)
        states.append(ts.TrainState(model, t_optim.make_optimizer(
            model.parameters(), learning_rate=1e-3, batch_size=4,
            lr_decay_rate=0.5, decay_steps=3, **kw), seed=5))
    data = small_data()
    captures = ts._Captures(None, torch.device("cpu"), 4, generators=2)
    eager = ts.make_train_scan(augment, device="cpu")
    for chunk in CHUNKS:
        got = ts._graph_train_rows(captures, states[0], data,
                                   torch.from_numpy(chunk), augment)
        _, want = eager(states[1], data, chunk)
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert captures.warmup == 0 and states[0].step == states[1].step == 9
    assert (states[0].optimizer.count, states[1].optimizer.count) == (9, 9)
    for a, b in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        assert torch.equal(a, b)
    # steps 2-9 replay: RAdam's SGD steps 2-5 and rectified ones from 6,
    # the LookAhead syncs at even steps
    want = ({None} if optimizer == "rmsprop" else
            {(b, s) for b in ("sgd", "rect") for s in (False, True)})
    assert set(captures.graphs) == want
    assert len(eager_graphs) == len(captures.graphs)
    assert all(len(g.generators) == 2 for g in eager_graphs)
    assert all(g.pool is captures.pool is not None for g in eager_graphs)


def test_eval_capture_equals_the_eager_loop(eager_graphs):
    model = make_scae(MODEL, device="cpu", seed=0)
    data = small_data()
    capture = ts._Captures(None, torch.device("cpu"), 4)
    eager = ts.make_eval_scan(model, canvas=24, device="cpu")
    with torch.inference_mode():
        for chunk in CHUNKS:
            got = ts._graph_eval_rows(capture, model, data,
                                      torch.from_numpy(chunk), 24)
            want = eager(data, chunk)
            assert list(got) == list(want)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    assert len(eager_graphs) == 1 and capture.warmup == 0


# ------------------------------------------------------------ StepGraph

class FakeCUDAGraph:
    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_capture(monkeypatch):
    """A stand-in ``torch.cuda`` graph; returns the pools it was given
    and whether the garbage collector ran while it captured."""
    seen = {"pools": [], "gc_on": []}

    @contextlib.contextmanager
    def graph(cuda_graph, pool=None):
        seen["pools"].append(pool)
        seen["gc_on"].append(gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    return seen


def test_step_graph_counts_launches_only_at_capture(fake_capture,
                                                    monkeypatch):
    """A wrapper counts where it launches: once when the capture calls it
    (into the graph); a replay calls no wrapper and adds no count. The
    generators are registered and the pool is passed on."""
    counted = trace.Since()

    def step():  # what the wrappers of a gather train step add
        trace.count(trace.LAUNCHES + "K1")
        trace.count(trace.LAUNCHES + "K2+K3")
        return torch.zeros(3)

    gen, pool = torch.Generator(), object()
    graph = graphs.StepGraph(step, [gen], pool)
    assert counted.launches("K1", "K2+K3") == (1, 1)
    assert graph.graph.generators == [gen]
    assert fake_capture["pools"] == [pool]
    for _ in range(3):
        out = graph.replay()
    assert out is graph.out and graph.graph.replays == 3
    assert counted.launches("K1", "K2+K3") == (1, 1)

    def failing():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.StepGraph(failing)


def test_step_graph_keeps_the_collector_off_during_capture(fake_capture):
    """A reference cycle that becomes garbage during a capture is not
    collected in it, even with the collector set to run at nearly every
    allocation; it is collected afterwards. The collector is on again
    after a capture, also after one that fails."""
    collected = []

    class Dropped:
        def __del__(self):
            collected.append(True)

    def step():
        cycle = [Dropped()]
        cycle.append(cycle)
        del cycle
        assert [[] for _ in range(100)] and not collected
        return torch.zeros(1)

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        graphs.StepGraph(step)
    finally:
        gc.set_threshold(*threshold)
    assert fake_capture["gc_on"] == [False] and gc.isenabled()
    gc.collect()
    assert collected == [True]
    with pytest.raises(ZeroDivisionError):
        graphs.StepGraph(lambda: 1 / 0)
    assert fake_capture["gc_on"] == [False, False] and gc.isenabled()


def test_tensors_key_sees_addresses_shapes_and_dtypes():
    a = torch.zeros(4)
    key = graphs.tensors_key([a])
    assert graphs.tensors_key([a]) == key
    a.copy_(torch.ones(4))          # a restore in place keeps the key
    assert graphs.tensors_key([a]) == key
    assert graphs.tensors_key([a.clone()]) != key
    assert graphs.tensors_key([a.view(2, 2)]) != key
    assert graphs.tensors_key([a.view(torch.int32)]) != key


def test_no_host_copies_in_the_step_helpers():
    """A Python number becomes a device fill of the same value, and the
    homogeneous row is the identity's."""
    for v, dtype in ((0.1, torch.float32), (3, torch.float32),
                     (np.float32(0.7), torch.float64)):
        got = as_scalar(v, dtype, "cpu")
        assert got.shape == () and torch.equal(
            got, torch.as_tensor(v, dtype=dtype))
    t = torch.ones(2)
    assert as_scalar(t, torch.float32, "cpu") is t
    flat = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    mat = affine_to_matrix(flat)
    assert torch.equal(mat[:, 2], torch.tensor([[0.0, 0.0, 1.0]] * 2))
    assert torch.equal(mat[:, :2].reshape(2, 6), flat)


# ----------------------------------------------------- Trainer read order

SMALL = [
    "data_loader.batch_size=16", "data_loader.source=synthetic",
    "data_loader.synthetic_train=96", "data_loader.val_size=32",
    "data_loader.synthetic_test=20", "trainer.max_epochs=1",
    "trainer.log_every_steps=1", "trainer.max_eval_batches=1",
    "trainer.augment.canvas=24", "model.image_shape=[1,24,24]",
    "model.n_part_caps=8", "model.n_obj_caps=4",
    "model.pcae_cnn_encoder_params.out_channels=[8,8,8,8]",
    "model.pcae_cnn_encoder_params.compute_dtype=null",
    "model.pcae_template_generator_params.template_size=[5,5]",
    "model.ocae_encoder_set_transformer_params.dim_hidden=8",
    "model.ocae_encoder_set_transformer_params.dim_out=16",
    "model.ocae_decoder_capsule_params.dim_caps=8",
    "model.ocae_decoder_capsule_params.hidden_sizes=[16]",
]


def test_trainer_reads_each_chunk_after_the_next_dispatch(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("SCAE_TPU_NO_TENSORBOARD", "1")
    cfg = load_config("config", SMALL + [
        f"trainer.checkpoint_dir={tmp_path}/ckpt",
        f"trainer.log_dir={tmp_path}/logs"])
    trainer = loop.Trainer(cfg, device="cpu")
    events, chunks = [], []
    build, finish = trainer.build_steps, loop._finish_read

    def build_and_record(spe):
        build(spe)
        scan = trainer.train_scan

        def recording(state, data, idxs):
            state, metrics = scan(state, data, idxs)
            chunks.append({k: v.clone() for k, v in metrics.items()})
            events.append(f"dispatch {len(chunks)}")
            return state, metrics

        trainer.train_scan = recording

    def finishing(read):
        events.append("read")
        return finish(read)

    trainer.build_steps = build_and_record
    monkeypatch.setattr(loop, "_finish_read", finishing)
    try:
        state = trainer.run(max_steps=3)
    finally:
        trainer.close()
    assert state.step == 3
    assert events == ["dispatch 1", "dispatch 2", "read", "dispatch 3",
                      "read", "read"]
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        records = [r for r in map(json.loads, f) if "images_per_sec" in r]
    assert [r["step"] for r in records] == [1, 2, 3]
    for r, metrics in zip(records, chunks):
        assert set(r) == set(metrics) | {"step", "time", "images_per_sec",
                                         "learning_rate"}
        for k, v in metrics.items():
            assert r[k] == float(v[-1]), k
        assert r["learning_rate"] == trainer.lr_at(r["step"])
        assert r["images_per_sec"] > 0
