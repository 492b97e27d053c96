"""Train and eval steps (counterpart of scae_tpu/parallel/train_step.py:
``decode_images``, ``make_raw_train_step``, ``make_fused_train_step``,
``make_train_scan``, ``make_raw_eval_step``, ``make_fused_eval_step`` and
``make_eval_scan``).

The model holds its parameters and the optimizer its state, so a train
step updates its ``TrainState`` in place and returns it: the raw step is
``(images, labels) -> metrics`` on the state it was made for, the scan
``(state, data, idxs) -> (state, metrics)`` as JAX's. A scan runs K steps
as a Python loop over the same step, the batches gathered once up front;
its metrics stay on the device, stacked to (K,), so the host waits for the
device once per chunk, when it reads them.
"""

import dataclasses
from typing import Callable

import torch
from torch import nn

from scae_tpu_torch.optim import Optimizer
from scae_tpu_torch.train.data import pad_to_canvas
from scae_tpu_torch.utils.device import check_model_device, resolve_device

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class TrainState:
    """What a train step updates: the model's parameters and the
    optimizer's state in place, and the step count. ``seed`` keys the
    noise and augmentation of every step."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    seed: int = 0


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


def _eval_step(model, images, labels, canvas, device):
    """One eval step on a raw batch; see ``make_raw_eval_step``."""
    images = decode_images(torch.as_tensor(images).to(device))
    if canvas and images.shape[-1] != canvas:
        images = pad_to_canvas(images, canvas)
    labels = torch.as_tensor(labels).to(device=device, dtype=torch.long)
    res = model(images, deterministic=True)
    loss, log = model.loss(res, images, labels)
    metrics = dict(log)
    metrics["loss"] = loss
    if model.n_classes:
        metrics["accuracy"] = model.calculate_accuracy(res, labels)
    return metrics


def make_raw_eval_step(model, canvas: int = 0, device=None) -> Callable:
    """``eval_step(images, labels) -> metrics`` on ``device`` (CUDA unless
    given), where ``model`` must already live.

    images: raw batch (uint8 or float, storage layout) as a numpy array or
    tensor; labels: (B,) ints. Decodes on the device, centre-pads to
    ``canvas`` when given, runs the deterministic forward and returns every
    loss term, the loss and, with classifiers, the accuracy, as 0-d
    tensors on the device.
    """
    device = resolve_device(device)
    check_model_device(model, device)

    @torch.inference_mode()
    def eval_step(images, labels):
        return _eval_step(model, images, labels, canvas, device)

    return eval_step


def make_fused_eval_step(model, canvas: int = 0, device=None) -> Callable:
    """``eval_step(data, idx) -> metrics``: the raw eval step on the batch
    gathered by ``idx`` (B,) from device-resident ``data`` = {"image":
    (N, ...), "label": (N,)}, so only the indices cross from the host."""
    device = resolve_device(device)
    check_model_device(model, device)

    @torch.inference_mode()
    def eval_step(data, idx):
        idx = _indices(idx, device)
        return _eval_step(model, data["image"].index_select(0, idx),
                          data["label"].index_select(0, idx), canvas, device)

    return eval_step


def make_eval_scan(model, canvas: int = 0, device=None) -> Callable:
    """``scan(data, idxs) -> metrics``: the eval step over every row of
    ``idxs`` (K, B), each metric a (K,) tensor on the device. The K batches
    are gathered from ``data`` in one indexing up front, as JAX's scan
    gathers them outside its body."""
    device = resolve_device(device)
    check_model_device(model, device)

    @torch.inference_mode()
    def scan(data, idxs):
        images, labels = _gather_chunk(data, idxs, device)
        return _stack([_eval_step(model, images[k], labels[k], canvas,
                                  device) for k in range(len(images))])

    return scan


def _train_step(state: TrainState, images, labels, augment_fn, device):
    """One train step on a raw batch; see ``make_raw_train_step``."""
    model, optimizer = state.model, state.optimizer
    images = decode_images(torch.as_tensor(images).to(device))
    labels = torch.as_tensor(labels).to(device=device, dtype=torch.long)
    batch = {"image": images, "label": labels}
    if augment_fn is not None:
        batch = augment_fn(batch, _generator(
            device, _fold_in(state.seed, state.step, 7)))
    images = batch["image"]
    res = model(images, deterministic=False, generator=_generator(
        device, _fold_in(state.seed, state.step)))
    loss, log = model.loss(res, images, labels)
    metrics = {k: v.detach() for k, v in log.items()}
    if model.n_classes:
        with torch.no_grad():
            metrics["accuracy"] = model.calculate_accuracy(res, labels)
    grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
    optimizer.step(grads)
    metrics["loss"] = loss.detach()
    state.step += 1
    return metrics


def make_raw_train_step(state: TrainState, augment_fn=None,
                        device=None) -> Callable:
    """``train_step(images, labels) -> metrics`` on ``device`` (CUDA unless
    given), where ``state.model`` must already live.

    images: raw batch (uint8 or float, storage layout) as a numpy array or
    tensor; labels: (B,) ints. The step decodes on the device, applies
    ``augment_fn(batch, generator)`` with a generator seeded from
    (seed, step, 7), runs the forward with its noise drawn from a generator
    seeded from (seed, step), the loss, the backward and the optimizer
    step, and adds 1 to ``state.step``. It returns every loss term, the
    loss and, with classifiers, the accuracy (from detached
    probabilities), as 0-d tensors on the device.
    """
    device = resolve_device(device)
    check_model_device(state.model, device)

    def train_step(images, labels):
        return _train_step(state, images, labels, augment_fn, device)

    return train_step


def _indices(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx).to(device=device, dtype=torch.long)


def _gather_chunk(data, idxs, device):
    """The (K, B, ...) images and (K, B) labels that ``idxs`` (K, B) picks
    from ``data``, in one indexing each."""
    idxs = _indices(idxs, device)
    if idxs.dim() != 2:
        raise ValueError(f"idxs must be (K, B), got {tuple(idxs.shape)}")
    return data["image"][idxs], data["label"][idxs]


def _stack(per_step):
    """A list of K metric dicts of 0-d tensors as one dict of (K,)
    tensors."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_fused_train_step(state: TrainState, augment_fn=None,
                          device=None) -> Callable:
    """``train_step(data, idx) -> metrics``: the raw step on the batch
    gathered by the index vector ``idx`` (B,) from device-resident
    ``data`` = {"image": (N, ...), "label": (N,)}, so only the indices
    cross from the host per step."""
    device = resolve_device(device)
    check_model_device(state.model, device)

    def train_step(data, idx):
        idx = _indices(idx, device)
        return _train_step(state, data["image"].index_select(0, idx),
                           data["label"].index_select(0, idx), augment_fn,
                           device)

    return train_step


def make_train_scan(augment_fn=None, device=None) -> Callable:
    """``scan(state, data, idxs) -> (state, metrics)``: K train steps, one
    per row of ``idxs`` (K, B), on device-resident ``data`` = {"image":
    (N, ...), "label": (N,)}; each metric a (K,) tensor on the device.

    The K batches are gathered in one indexing up front (JAX's scan
    gathers them outside its body too); the steps are the raw train step
    in a Python loop, which reads nothing back from the device. ``state``
    is updated in place and returned. ``device``: CUDA unless given.
    """
    device = resolve_device(device)

    def scan(state: TrainState, data, idxs):
        check_model_device(state.model, device)
        images, labels = _gather_chunk(data, idxs, device)
        return state, _stack([
            _train_step(state, images[k], labels[k], augment_fn, device)
            for k in range(len(images))])

    return scan
