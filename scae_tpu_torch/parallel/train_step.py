"""Train and eval steps (counterpart of scae_tpu/parallel/train_step.py:
``decode_images``, ``make_raw_train_step``, ``make_fused_train_step``,
``make_train_scan``, ``make_raw_eval_step``, ``make_fused_eval_step``,
``make_eval_scan`` and ``shard_state``).

The model holds its parameters and the optimizer its state, so a train
step updates its ``TrainState`` in place and returns it: the raw step is
``(images, labels) -> metrics`` on the state it was made for, the scan
``(state, data, idxs) -> (state, metrics)`` as JAX's. A scan's metrics
stay on the device, stacked to (K,), so the host waits for the device once
per chunk, when it reads them.

JAX runs a scan as one compiled program per chunk. On the card the scans
here replay a CUDA graph of one step per row of ``idxs`` (``graphs.py``):
one launch from the host per step, its inputs written into the graph's
static buffers before each replay (the batch's index vector, the
optimizer's per-step numbers, the seeds of two generators registered with
the graph), its metrics copied out after. The graph holds one step, not
K, because the Trainer's chunks take any length. On the CPU a scan is a
Python loop over the eager step. The raw and fused single-step entry
points stay eager on every device.

Every entry point takes a ``mesh`` (``parallel/mesh.py::make_mesh``), as
JAX's do, and computes what JAX's mesh computes: the loss and the
gradients of the global batch. Its batches and index chunks are global;
each process takes its rows, draws its noise and augmentation for the
global batch and keeps its rows, and averages the gradients and the
metrics over the data group in one all-reduce before the update, so the
logged metrics are the global batch's. ``shard_state`` splits the capsule
banks over the model group. Under NCCL a scan's collectives are captured
in its graph with the rest of the step; under gloo, whose collectives
cannot be captured, the scans run the eager step on the card too
(``graphs.captures_collectives``). Without a mesh, or with one that spans
no process group, nothing calls a collective.

Under a recording profiler the card's scans are the spans ``scan.train``
and ``scan.eval`` (``utils/trace.py``), each with its stream time and K
items, and inside them ``scan.indices``, ``scan.prepare`` and one
``scan.replay`` a replayed row; the counter ``scan.capture_s`` adds the
host seconds of the warm-up rows and the captures, and
``scan.captures.train`` and ``scan.captures.eval`` count the graphs the
scans captured (one per branch of a step, each after
``graphs.WARMUP_STEPS`` eager steps of its key).
"""

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from scae_tpu_torch.optim import Optimizer
from scae_tpu_torch.parallel import mesh as mesh_lib
from scae_tpu_torch.parallel.graphs import (
    WARMUP_STEPS,
    StepGraph,
    captures_collectives,
    cudnn_search,
    side_stream,
    tensors_key,
)
from scae_tpu_torch.train import data as data_lib
from scae_tpu_torch.utils import trace
from scae_tpu_torch.utils.device import check_model_device, resolve_device

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class TrainState:
    """What a train step updates: the model's parameters and the
    optimizer's state in place, and the step count. ``seed`` keys the
    noise and augmentation of every step. ``banks``: {name: axis} of the
    parameters that ``shard_state`` split over a model group (empty while
    every parameter is whole)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    seed: int = 0
    banks: Dict[str, int] = dataclasses.field(default_factory=dict)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _fold_in(seed: int, *data: int) -> int:
    """A seed derived from ``seed`` and each of ``data`` in turn (the role
    of ``jax.random.fold_in``; the numbers differ from JAX's)."""
    for d in data:
        seed = _splitmix64(seed ^ _splitmix64(d & _MASK64))
    return seed & ((1 << 63) - 1)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def decode_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> f32 in [0, 1]; (B, H, W) -> (B, 1, H, W); (B, H, W, C) ->
    NCHW."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    if images.dim() == 3:
        images = images[:, None]
    elif images.shape[-1] in (1, 3, 4):
        images = images.permute(0, 3, 1, 2)
    return images


def _data_mean(metrics, mesh):
    """``metrics`` averaged over ``mesh``'s data group (as they are without
    a mesh)."""
    if mesh is None:
        return metrics
    return dict(zip(metrics, mesh_lib.mean_over_data(list(metrics.values()),
                                                     mesh)))


def _eval_step(model, images, labels, canvas, device, mesh=None):
    """One eval step on this process's rows of a raw batch; see
    ``make_raw_eval_step``."""
    images = decode_images(torch.as_tensor(images).to(device))
    if canvas and images.shape[-1] != canvas:
        images = data_lib.pad_to_canvas(images, canvas)
    labels = torch.as_tensor(labels).to(device=device, dtype=torch.long)
    with mesh_lib.use(mesh):
        res = model(images, deterministic=True)
        loss, log = model.loss(res, images, labels)
        metrics = dict(log)
        metrics["loss"] = loss
        if model.n_classes:
            metrics["accuracy"] = model.calculate_accuracy(res, labels)
    return _data_mean(metrics, mesh)


def make_raw_eval_step(model, canvas: int = 0, device=None,
                       mesh=None) -> Callable:
    """``eval_step(images, labels) -> metrics`` on ``device`` (CUDA unless
    given), where ``model`` must already live.

    images: raw batch (uint8 or float, storage layout) as a numpy array or
    tensor; labels: (B,) ints. Decodes on the device, centre-pads to
    ``canvas`` when given, runs the deterministic forward and returns every
    loss term, the loss and, with classifiers, the accuracy, as 0-d
    tensors on the device. Under ``mesh`` the batch is the global one, of
    which the step takes this process's rows, and the metrics are the
    global batch's.
    """
    device = resolve_device(device)
    check_model_device(model, device)
    mesh = mesh_lib.live(mesh)

    @torch.inference_mode()
    def eval_step(images, labels):
        return _eval_step(model, mesh_lib.local_rows(images, mesh=mesh),
                          mesh_lib.local_rows(labels, mesh=mesh), canvas,
                          device, mesh)

    return eval_step


def make_fused_eval_step(model, canvas: int = 0, device=None,
                         mesh=None) -> Callable:
    """``eval_step(data, idx) -> metrics``: the raw eval step on the batch
    gathered by ``idx`` (B,) from device-resident ``data`` = {"image":
    (N, ...), "label": (N,)}, so only the indices cross from the host.
    Under ``mesh``, ``idx`` is the global batch's."""
    device = resolve_device(device)
    check_model_device(model, device)
    mesh = mesh_lib.live(mesh)

    @torch.inference_mode()
    def eval_step(data, idx):
        idx = mesh_lib.local_rows(_indices(idx, device), mesh=mesh)
        return _eval_step(model, data["image"].index_select(0, idx),
                          data["label"].index_select(0, idx), canvas, device,
                          mesh)

    return eval_step


def make_eval_scan(model, canvas: int = 0, device=None,
                   mesh=None) -> Callable:
    """``scan(data, idxs) -> metrics``: the eval step over every row of
    ``idxs`` (K, B), each metric a (K,) tensor on the device. On the CPU
    the K batches are gathered from ``data`` in one indexing up front, as
    JAX's scan gathers them outside its body; on the card each row is a
    replay of a graph of the eval step, which gathers its own batch (see
    the module's docstring). Under ``mesh`` each row is a global batch."""
    device = resolve_device(device)
    check_model_device(model, device)
    mesh = mesh_lib.live(mesh)
    graphs = device.type == "cuda" and captures_collectives(mesh)
    current = None   # the _Captures of the last call

    @torch.inference_mode()
    def scan(data, idxs):
        nonlocal current
        if not graphs:
            images, labels = _gather_chunk(data, idxs, device, mesh)
            return _stack([_eval_step(model, images[k], labels[k], canvas,
                                      device, mesh)
                           for k in range(len(images))])
        with trace.span("scan.eval", device=True, items=len(idxs)):
            idxs = _chunk_indices(idxs, device, mesh)
            key = (tensors_key([*model.parameters(), *model.buffers()]),
                   tensors_key([data["image"], data["label"]]),
                   idxs.shape[1])
            if current is None or current.key != key:
                current = None       # free the old graph's memory first
                current = _Captures(key, device, idxs.shape[1], kind="eval",
                                    mesh=mesh)
            return _graph_eval_rows(current, model, data, idxs, canvas,
                                    mesh)

    return scan


def _value_and_grad(model, params, images, labels, deterministic,
                    generator, mesh):
    """(metrics, gradients of ``params``) of the loss on this process's
    rows ``images`` (decoded) and ``labels``, each averaged over the data
    group under ``mesh``; a gradient that does not reach its parameter is
    None without a mesh and zeros with one."""
    with mesh_lib.use(mesh):
        res = model(images, deterministic=deterministic, generator=generator)
        loss, log = model.loss(res, images, labels)
        metrics = {k: v.detach() for k, v in log.items()}
        if model.n_classes:
            with torch.no_grad():
                metrics["accuracy"] = model.calculate_accuracy(res, labels)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    metrics["loss"] = loss.detach()
    if mesh is None:
        return metrics, grads
    # one all-reduce for the step: the gradients and the metrics together
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    averaged = mesh_lib.mean_over_data([*grads, *metrics.values()], mesh)
    return (dict(zip(metrics, averaged[len(grads):])),
            averaged[:len(grads)])


def loss_and_grads(model, images, labels, device=None, mesh=None,
                   deterministic: bool = True, generator=None):
    """``(metrics, grads)``: the loss terms, the loss and the accuracy of
    the raw batch ``images`` (B, ...) and ``labels`` (B,), and the gradient
    of the loss for each of ``model.parameters()`` (None where it does not
    reach one): the counterpart of ``jax.value_and_grad`` of scae_tpu's
    ``loss_fn``. Under ``mesh`` the batch is the global one and both are
    the global batch's, averaged over the data group; a split bank's
    gradients are this process's share."""
    device = resolve_device(device)
    check_model_device(model, device)
    mesh = mesh_lib.live(mesh)
    images = decode_images(torch.as_tensor(
        mesh_lib.local_rows(images, mesh=mesh)).to(device))
    labels = torch.as_tensor(mesh_lib.local_rows(labels, mesh=mesh)).to(
        device=device, dtype=torch.long)
    return _value_and_grad(model, list(model.parameters()), images, labels,
                           deterministic, generator, mesh)


def _train_body(model, optimizer, images, labels, augment_fn, device,
                aug_generator, noise_generator, plan=None, mesh=None):
    """A train step's device work on this process's rows of a raw batch:
    the augmentation drawn from ``aug_generator``, the noise from
    ``noise_generator`` (each for the global batch under ``mesh``), the
    optimizer's update by ``plan`` (see ``Optimizer.updates``)."""
    images = decode_images(torch.as_tensor(images).to(device))
    labels = torch.as_tensor(labels).to(device=device, dtype=torch.long)
    batch = {"image": images, "label": labels}
    if augment_fn is not None:
        with mesh_lib.use(mesh):
            batch = augment_fn(batch, aug_generator)
    metrics, grads = _value_and_grad(model, optimizer.params, batch["image"],
                                     labels, False, noise_generator, mesh)
    optimizer.step(grads, plan)
    return metrics


def _step_seeds(state: TrainState):
    """The seeds of step ``state.step``'s augmentation and noise."""
    return (_fold_in(state.seed, state.step, 7),
            _fold_in(state.seed, state.step))


def _train_step(state: TrainState, images, labels, augment_fn, device,
                mesh=None):
    """One eager train step on this process's rows of a raw batch; see
    ``make_raw_train_step``."""
    aug_seed, noise_seed = _step_seeds(state)
    metrics = _train_body(state.model, state.optimizer, images, labels,
                          augment_fn, device, _generator(device, aug_seed),
                          _generator(device, noise_seed), mesh=mesh)
    state.step += 1
    return metrics


def make_raw_train_step(state: TrainState, augment_fn=None,
                        device=None, mesh=None) -> Callable:
    """``train_step(images, labels) -> metrics`` on ``device`` (CUDA unless
    given), where ``state.model`` must already live.

    images: raw batch (uint8 or float, storage layout) as a numpy array or
    tensor; labels: (B,) ints. The step decodes on the device, applies
    ``augment_fn(batch, generator)`` with a generator seeded from
    (seed, step, 7), runs the forward with its noise drawn from a generator
    seeded from (seed, step), the loss, the backward and the optimizer
    step, and adds 1 to ``state.step``. It returns every loss term, the
    loss and, with classifiers, the accuracy (from detached
    probabilities), as 0-d tensors on the device. Under ``mesh`` the batch
    is the global one, of which the step takes this process's rows.
    """
    device = resolve_device(device)
    check_model_device(state.model, device)
    mesh = mesh_lib.live(mesh)

    def train_step(images, labels):
        return _train_step(state, mesh_lib.local_rows(images, mesh=mesh),
                           mesh_lib.local_rows(labels, mesh=mesh),
                           augment_fn, device, mesh)

    return train_step


def _indices(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx).to(device=device, dtype=torch.long)


def _to_card(rows, dtype, device) -> torch.Tensor:
    """Host rows on the card without waiting for it: a copy from pinned
    memory (a copy from pageable memory waits for the stream to drain)."""
    host = torch.as_tensor(np.asarray(rows)).to(dtype)
    return host.pin_memory().to(device, non_blocking=True)


def _chunk_indices(idxs, device, mesh=None) -> torch.Tensor:
    """This process's columns of a chunk's (K, B) indices on the card,
    copied without waiting."""
    with trace.span("scan.indices"):
        if not (isinstance(idxs, torch.Tensor) and idxs.device == device):
            idxs = _to_card(idxs, torch.long, device)
        if idxs.dim() != 2:
            raise ValueError(f"idxs must be (K, B), got "
                             f"{tuple(idxs.shape)}")
        return mesh_lib.local_rows(idxs.to(torch.long), dim=1, mesh=mesh)


def _gather_chunk(data, idxs, device, mesh=None):
    """The (K, b, ...) images and (K, b) labels that this process's columns
    of ``idxs`` (K, B) pick from ``data``, in one indexing each."""
    idxs = _indices(idxs, device)
    if idxs.dim() != 2:
        raise ValueError(f"idxs must be (K, B), got {tuple(idxs.shape)}")
    idxs = mesh_lib.local_rows(idxs, dim=1, mesh=mesh)
    return data["image"][idxs], data["label"][idxs]


def _stack(per_step):
    """A list of K metric dicts of 0-d tensors as one dict of (K,)
    tensors."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_fused_train_step(state: TrainState, augment_fn=None,
                          device=None, mesh=None) -> Callable:
    """``train_step(data, idx) -> metrics``: the raw step on the batch
    gathered by the index vector ``idx`` (B,) from device-resident
    ``data`` = {"image": (N, ...), "label": (N,)}, so only the indices
    cross from the host per step. Under ``mesh``, ``idx`` is the global
    batch's."""
    device = resolve_device(device)
    check_model_device(state.model, device)
    mesh = mesh_lib.live(mesh)

    def train_step(data, idx):
        idx = mesh_lib.local_rows(_indices(idx, device), mesh=mesh)
        return _train_step(state, data["image"].index_select(0, idx),
                           data["label"].index_select(0, idx), augment_fn,
                           device, mesh)

    return train_step


def make_eager_train_scan(augment_fn=None, device=None,
                          mesh=None) -> Callable:
    """``scan(state, data, idxs) -> (state, metrics)`` as
    ``make_train_scan``'s, its K steps the eager train step in a Python
    loop on any device: what ``make_train_scan`` runs on the CPU and under
    gloo, and on the card the loop that its graphs are held to. The K
    batches are gathered in one indexing up front (JAX's scan gathers them
    outside its body too)."""
    device = resolve_device(device)
    mesh = mesh_lib.live(mesh)

    def scan(state: TrainState, data, idxs):
        check_model_device(state.model, device)
        images, labels = _gather_chunk(data, idxs, device, mesh)
        return state, _stack([
            _train_step(state, images[k], labels[k], augment_fn, device,
                        mesh)
            for k in range(len(images))])

    return scan


def make_train_scan(augment_fn=None, device=None, mesh=None) -> Callable:
    """``scan(state, data, idxs) -> (state, metrics)``: K train steps, one
    per row of ``idxs`` (K, B), on device-resident ``data`` = {"image":
    (N, ...), "label": (N,)}; each metric a (K,) tensor on the device.
    ``state`` is updated in place and returned. ``device``: CUDA unless
    given.

    On the CPU this is ``make_eager_train_scan``'s loop. On the card each
    row replays a graph of the train step (see the module's docstring):
    one graph per branch of the optimizer, captured when a step first
    takes it, after ``graphs.WARMUP_STEPS`` eager steps on a side stream,
    both under ``graphs.cudnn_search``.
    A new state object, or a change of the addresses, shapes or dtypes of
    its tensors or of ``data``, or of the batch size, captures anew; a
    restore that copies in place (``load_state_dict``) keeps the graphs.
    Either way a step reads nothing back from the device. Under ``mesh``
    each row of ``idxs`` is a global batch; the card captures the step's
    collectives only under NCCL, and runs the eager loop otherwise.
    """
    device = resolve_device(device)
    mesh = mesh_lib.live(mesh)
    if device.type != "cuda" or not captures_collectives(mesh):
        return make_eager_train_scan(augment_fn, device, mesh)
    current = None   # the _Captures of the last call

    def scan(state: TrainState, data, idxs):
        nonlocal current
        check_model_device(state.model, device)
        with trace.span("scan.train", device=True, items=len(idxs)):
            idxs = _chunk_indices(idxs, device, mesh)
            model, optimizer = state.model, state.optimizer
            key = (id(state), id(model), id(optimizer),
                   tensors_key([*model.parameters(), *model.buffers(),
                                *optimizer.state_tensors()]),
                   tensors_key([data["image"], data["label"]]),
                   idxs.shape[1])
            if current is None or current.key != key:
                current = None       # free the old graphs' memory first
                # held, so that no new object takes the ids in the key
                current = _Captures(key, device, idxs.shape[1],
                                    held=(state, model, optimizer),
                                    generators=2, kind="train", mesh=mesh)
            return state, _graph_train_rows(current, state, data, idxs,
                                            augment_fn, mesh)

    return scan


class _Captures:
    """What a scan holds on the card for one key (what its graphs depend
    on): a graph per branch of the step, captured when a step first takes
    it, all in one memory pool (they never run at once, and each replay's
    output is copied out before the next replay); the static inputs they
    read (the batch's index vector, the train step's optimizer numbers and
    generators); the metrics' names, in the graphs' output order; and the
    warm-up steps still to run. ``held``: objects kept alive with it.
    ``kind``: "train" or "eval", the counter ``scan.captures.<kind>``
    that its captures add to (none where None). ``mesh``: the live mesh
    whose NCCL collectives the graphs capture, or None."""

    def __init__(self, key, device, batch, held=(), generators=0,
                 kind=None, mesh=None):
        self.key, self.device, self.held = key, device, held
        self.kind, self.mesh = kind, mesh
        self.warmup = WARMUP_STEPS
        self.idx = torch.zeros(batch, dtype=torch.long, device=device)
        self.generators = tuple(torch.Generator(device=device)
                                for _ in range(generators))
        self.numbers = None  # (n,) float32: the train step's numbers
        self.pool = None
        self.graphs = {}     # branch -> StepGraph
        self.names = None

    def batch(self, data):
        """The batch that the index vector picks from ``data``."""
        return (data["image"].index_select(0, self.idx),
                data["label"].index_select(0, self.idx))

    def graph(self, branch, body) -> StepGraph:
        """The graph of ``branch``: ``body()``'s metrics dict, captured as
        one stacked vector when first asked for."""
        if branch in self.graphs:
            return self.graphs[branch]

        def step():
            metrics = body()
            names = list(metrics)
            if self.names not in (None, names):
                raise RuntimeError(f"the step's metrics changed from "
                                   f"{self.names} to {names}")
            dtypes = {metrics[n].dtype for n in names}
            if len(dtypes) != 1:
                raise TypeError(f"the step's metrics have dtypes {dtypes}; "
                                "a graph returns them in one vector")
            self.names = names
            return torch.stack([metrics[n] for n in names])

        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        # a mesh's capture lets the process group's own threads query
        # their events meanwhile
        mode = {} if self.mesh is None else {
            "capture_error_mode": "thread_local"}
        with trace.timed("scan.capture_s"), cudnn_search():
            self.graphs[branch] = StepGraph(step, self.generators, self.pool,
                                            **mode)
        if self.kind is not None:
            trace.count(f"scan.captures.{self.kind}")
        return self.graphs[branch]

    def run(self, idxs, eager_step, replay, prepare=None):
        """One step per row of ``idxs`` (K, B), its metrics stacked to (K,)
        each: the rows that the warm-up still holds by ``eager_step(idx)``
        on a side stream, under ``cudnn_search`` as the captures are (the
        graphs hold the convolution algorithms that the warm-up timed);
        then ``prepare(n)`` before the n others, each written into the
        index vector and run by ``replay(j)`` (j counts the replayed
        rows), which returns its graph's output vector."""
        K = idxs.shape[0]
        n_eager = min(self.warmup, K)
        self.warmup -= n_eager
        rows = []
        if n_eager:
            with trace.timed("scan.capture_s"), side_stream(self.device), \
                    cudnn_search():
                rows = [eager_step(idx) for idx in idxs[:n_eager]]
        if prepare is not None:
            with trace.span("scan.prepare"):
                prepare(K - n_eager)
        out = None
        for j in range(K - n_eager):
            with trace.span("scan.replay"):
                self.idx.copy_(idxs[n_eager + j])
                vec = replay(j)
                if out is None:
                    out = torch.empty((len(vec), K - n_eager),
                                      dtype=vec.dtype, device=self.device)
                out[:, j].copy_(vec)
        names = self.names if out is not None else list(rows[0])
        stacked = {}
        for i, name in enumerate(names):
            parts = ([torch.stack([r[name] for r in rows])] if rows else []) \
                + ([out[i]] if out is not None else [])
            stacked[name] = parts[0] if len(parts) == 1 else torch.cat(parts)
        return stacked


def _graph_train_rows(captures, state, data, idxs, augment_fn, mesh=None):
    """The train scan's rows on the card. The plans of a chunk's replays
    are taken on the host up front (``Optimizer.advance``, which counts the
    steps), their numbers copied to the card in one (n, len) table, and
    each replay's row copied into the graphs' number buffer; the graph of
    the plan's branch is replayed. The two generators registered with every
    graph are seeded before each replay as the eager step seeds its fresh
    ones, so a replay draws what it draws."""
    device, optimizer = captures.device, state.optimizer
    plans, table = [], None

    def prepare(n):
        nonlocal plans, table
        plans = [optimizer.advance() for _ in range(n)]
        if n:
            table = _to_card([numbers for _, numbers in plans],
                             torch.float32, device)
            if captures.numbers is None:
                captures.numbers = torch.zeros(table.shape[1],
                                               dtype=torch.float32,
                                               device=device)

    def replay(j):
        branch = plans[j][0]
        plan = (branch, tuple(captures.numbers.unbind()))
        graph = captures.graph(branch, lambda: _train_body(
            state.model, optimizer, *captures.batch(data), augment_fn,
            device, *captures.generators, plan, mesh))
        captures.numbers.copy_(table[j])
        for generator, seed in zip(captures.generators, _step_seeds(state)):
            generator.manual_seed(seed)
        out = graph.replay()
        state.step += 1
        return out

    def eager_step(idx):
        return _train_step(state, data["image"].index_select(0, idx),
                           data["label"].index_select(0, idx), augment_fn,
                           device, mesh)

    return captures.run(idxs, eager_step, replay, prepare)


def _graph_eval_rows(captures, model, data, idxs, canvas, mesh=None):
    """The eval scan's rows on the card: one graph of the eval step, run
    in inference mode."""
    device = captures.device

    def eager_step(idx):
        return _eval_step(model, data["image"].index_select(0, idx),
                          data["label"].index_select(0, idx), canvas, device,
                          mesh)

    def replay(j):
        return captures.graph(None, lambda: _eval_step(
            model, *captures.batch(data), canvas, device, mesh)).replay()

    return captures.run(idxs, eager_step, replay)


# ----------------------------------------------------- capsule banks

def _each_state_tensor(optimizer: Optimizer, i: int, fn):
    """Replace the i-th tensor of each of ``optimizer``'s state lists (a
    wrapped optimizer's too) with ``fn`` of it."""
    for name in optimizer._state:
        value = getattr(optimizer, name)
        if isinstance(value, Optimizer):
            _each_state_tensor(value, i, fn)
        elif isinstance(value, list):
            value[i] = fn(value[i])


def _reshape_banks(state: TrainState, axes: Dict[str, int], fn):
    """Replace each parameter named in ``axes`` and its optimizer state by
    ``fn(tensor, axis)``, in place (the parameter objects stay)."""
    index = {id(p): i for i, p in enumerate(state.optimizer.params)}
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if name in axes:
                axis = axes[name]
                p.data = fn(p.data, axis)
                _each_state_tensor(state.optimizer, index[id(p)],
                                   lambda t: fn(t, axis))


def shard_state(state: TrainState, mesh, model_axis: bool = True
                ) -> TrainState:
    """Split ``state``'s capsule banks over ``mesh``'s model group, in
    place (``mesh.param_shardings``): each such parameter and its
    optimizer state become this process's share, everything else stays
    whole on every process. Returns ``state``; its steps must then run
    under ``mesh``. ``unshard_state`` makes it whole again."""
    if state.banks:
        raise ValueError("the state's capsule banks are split already")
    axes = mesh_lib.param_shardings(mesh, state.model,
                                    shard_capsule_banks=model_axis)
    _reshape_banks(state, axes, lambda t, axis: mesh_lib.shard_tensor(
        t, mesh, axis))
    state.banks = axes
    return state


def unshard_state(state: TrainState, mesh) -> TrainState:
    """Gather the banks that ``shard_state`` split back into whole tensors
    on every process of the model group (each must call it), in place: for
    checkpoints and for comparing with a single-process run."""
    _reshape_banks(state, state.banks, lambda t, axis: mesh_lib.gather_tensor(
        t, mesh, axis))
    state.banks = {}
    return state
