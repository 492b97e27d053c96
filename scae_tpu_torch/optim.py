"""Optimizers (counterpart of scae_tpu/optim.py): RMSprop, Adam, RAdam,
LookAhead, the harness' eps rule and its per-epoch exponential decay.

Each optimizer holds a fixed list of parameters and updates them in place:
``step(grads)`` turns the gradients into updates with ``updates(grads)``
and adds those to the parameters. The arithmetic follows the JAX
package's optax chains in their order, not ``torch.optim``'s. In
particular ``optax.rmsprop`` scales by the learning rate before its
momentum trace (``scale_by_rms -> scale_by_learning_rate -> trace``),
where ``torch.optim.RMSprop`` scales the momentum buffer by the current
rate; the two agree while the rate is constant and part once the schedule
decays. Per-tensor work goes through ``torch._foreach_*``, one launch for
the whole parameter list.

A step is two halves. ``advance()`` is the host's: it counts the step and
returns its plan, ``(branch, numbers)``: which branch of the update the
step takes (RAdam's rectified or SGD step, LookAhead's sync every k
steps; None where there is one) and the step's numbers (the learning
rate, the bias corrections). ``updates(grads, plan)`` is the device's:
its numbers are 0-d float32 tensors on the parameters' device, filled in
from the plan by the eager step, and written before each replay into the
buffer that a CUDA graph of the train step reads
(``parallel/train_step.py``), so both run the same kernels. (On the card
PyTorch divides by a host float in another rounding than by a tensor.)
Step counts are host numbers, so a step never waits for the device.
"""

import math
from typing import (Callable, Hashable, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from scae_tpu_torch.ops.math_ops import as_scalar

Schedule = Union[float, Callable[[int], float]]
# a step's plan: its branch and its numbers (floats, or 0-d float32 tensors)
Plan = Tuple[Hashable, Tuple[Union[float, torch.Tensor], ...]]


def reference_eps(batch_size: int) -> float:
    """The harness' eps rule: 1e-2 / batch_size**2 (base_experiment.py:47)."""
    return 1e-2 / float(batch_size) ** 2


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Callable[[int], float]:
    """``optax.exponential_decay(..., staircase=True)``: the rate times
    ``decay_rate`` once every ``transition_steps`` steps."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        if count <= 0:
            return init_value
        return init_value * decay_rate ** math.floor(count / transition_steps)

    return schedule


def _value(lr: Schedule, count: int) -> float:
    return lr(count) if callable(lr) else lr


class Optimizer:
    """Updates ``params`` in place; subclasses define ``updates`` and name
    their state's attributes in ``_state``: step counts (ints) and lists of
    tensors shaped like ``params``, or ``None``."""

    _state: Tuple[str, ...] = ()

    def __init__(self, params: Iterable[torch.Tensor]):
        self.params: List[torch.Tensor] = list(params)

    def _zeros(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) for p in self.params]

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state (a wrapped optimizer's too), in the
        order of ``_state``; the parameters are not among them."""
        out = []
        for name in self._state:
            value = getattr(self, name)
            if isinstance(value, Optimizer):
                out += value.state_tensors()
            elif isinstance(value, list):
                out += value
        return out

    def state_dict(self) -> dict:
        """The state as CPU copies: counts as ints, tensor lists as lists
        (a wrapped optimizer's under "base")."""
        out = {}
        for name in self._state:
            value = getattr(self, name)
            if isinstance(value, Optimizer):
                value = value.state_dict()
            elif isinstance(value, list):
                value = [t.detach().to("cpu", copy=True) for t in value]
            out[name] = value
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Copy ``state`` (from ``state_dict``) into this optimizer's own
        tensors, in place; raises on a missing name or a shape that
        differs."""
        if set(state) != set(self._state):
            raise KeyError(f"optimizer state holds {sorted(state)}, "
                           f"expected {sorted(self._state)}")
        for name in self._state:
            mine, saved = getattr(self, name), state[name]
            if isinstance(mine, Optimizer):
                mine.load_state_dict(saved)
            elif isinstance(mine, list):
                if saved is None or len(saved) != len(mine):
                    got = "none" if saved is None else len(saved)
                    raise ValueError(f"optimizer state {name}: {got} "
                                     f"tensors, expected {len(mine)}")
                for t, v in zip(mine, saved):
                    if tuple(t.shape) != tuple(v.shape):
                        raise ValueError(f"optimizer state {name}: shape "
                                         f"{tuple(v.shape)}, expected "
                                         f"{tuple(t.shape)}")
                    t.copy_(v)
            elif mine is None:
                if saved is not None:
                    raise ValueError(f"optimizer state {name}: this "
                                     "optimizer keeps none")
            else:
                setattr(self, name, int(saved))

    def advance(self) -> Plan:
        """Count one step on the host; its plan (branch, numbers)."""
        raise NotImplementedError

    def updates(self, grads: List[torch.Tensor],
                plan: Optional[Plan] = None) -> List[torch.Tensor]:
        """The step's updates from ``grads``, by ``plan``, whose numbers are
        0-d float32 tensors (default: the plan of ``advance()``, which
        counts the step, its numbers filled in on the parameters' device).
        State tensors are updated in place."""
        if plan is None:
            branch, numbers = self.advance()
            device = self.params[0].device
            plan = branch, tuple(as_scalar(v, torch.float32, device)
                                 for v in numbers)
        return self._updates(grads, *plan)

    def _updates(self, grads, branch, numbers) -> List[torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[Optional[torch.Tensor]]] = None,
             plan: Optional[Plan] = None):
        """Apply one update from ``grads`` (default: each parameter's
        ``.grad``); a missing gradient counts as zeros, as in JAX.
        ``plan``: as for ``updates``."""
        if grads is None:
            grads = [p.grad for p in self.params]
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        torch._foreach_add_(self.params, self.updates(grads, plan))


class RMSprop(Optimizer):
    """``optax.rmsprop(lr, decay, eps, eps_in_sqrt=False, momentum)``:
    nu = (1-decay) g^2 + decay nu; u = -lr g / (sqrt(nu) + eps); with
    momentum, trace = u + momentum trace and the update is the trace."""

    _state = ("count", "nu", "trace")

    def __init__(self, params, learning_rate: Schedule, decay: float = 0.9,
                 eps: float = 1e-8, momentum: Optional[float] = None):
        super().__init__(params)
        self.lr, self.decay, self.eps, self.momentum = (
            learning_rate, decay, eps, momentum)
        self.count = 0
        self.nu = self._zeros()
        self.trace = self._zeros() if momentum is not None else None

    def advance(self):
        lr = _value(self.lr, self.count)
        self.count += 1
        return None, (-lr,)

    def _updates(self, grads, branch, numbers):
        (neg_lr,) = numbers
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - self.decay)
        torch._foreach_mul_(self.nu, self.decay)
        torch._foreach_add_(self.nu, sq)
        scaling = torch._foreach_sqrt(self.nu)
        torch._foreach_add_(scaling, self.eps)
        torch._foreach_reciprocal_(scaling)
        upd = torch._foreach_mul(scaling, grads)
        torch._foreach_mul_(upd, neg_lr)
        if self.trace is None:
            return upd
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, upd)
        return self.trace


class Adam(Optimizer):
    """``optax.adam(lr, b1, b2, eps)``: bias-corrected moments, then
    -lr mu_hat / (sqrt(nu_hat) + eps)."""

    _state = ("count", "mu", "nu")

    def __init__(self, params, learning_rate: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params)
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.count = 0
        self.mu = self._zeros()
        self.nu = self._zeros()

    def advance(self):
        """Numbers: the two bias corrections and -lr."""
        lr = _value(self.lr, self.count)
        self.count += 1
        return None, (1.0 - self.b1 ** self.count,
                      1.0 - self.b2 ** self.count, -lr)

    def _updates(self, grads, branch, numbers):
        bias1, bias2, neg_lr = numbers
        _moments(self.mu, self.nu, grads, self.b1, self.b2)
        mu_hat = torch._foreach_div(self.mu, bias1)
        denom = torch._foreach_div(self.nu, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(upd, neg_lr)
        return upd


def _moments(mu, nu, grads, b1, b2):
    """mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu, in place."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1.0 - b2)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, sq)


class RAdam(Optimizer):
    """Rectified Adam (``scae_tpu.optim.radam``, reference
    optimizers.py:10-102): the SMA length rho_t rectifies the adaptive
    step once rho_t >= 5; before that the step falls back to SGD with
    bias-corrected momentum (or to no step without
    ``degenerated_to_sgd``). Decoupled weight decay -wd lr p. The schedule
    is read at the step number counted from 1, and the step-size scalars
    are float32, as in the JAX version (the torch reference takes them in
    float64; near rho_t = 5 the two differ by ~1e-4 relative)."""

    _state = ("count", "mu", "nu")

    def __init__(self, params, learning_rate: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, degenerated_to_sgd: bool = True):
        super().__init__(params)
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay = weight_decay
        self.degenerated_to_sgd = degenerated_to_sgd
        self.count = 0
        self.mu = self._zeros()
        self.nu = self._zeros()

    def advance(self):
        """Branch: "rect" once rho_t >= 5, else "sgd" (or "none" without
        ``degenerated_to_sgd``). Numbers: the step's scale (rect / bias1,
        1 / bias1, or 0), -lr and -weight_decay lr."""
        self.count += 1
        f32 = np.float32
        t = f32(self.count)
        b2 = f32(self.b2)
        beta2_t = b2 ** t
        rho_inf = f32(2.0 / (1.0 - self.b2) - 1.0)
        rho_t = rho_inf - f32(2.0) * t * beta2_t / (f32(1.0) - beta2_t)
        bias1 = f32(1.0) - f32(self.b1) ** t
        lr = float(f32(_value(self.lr, self.count)))
        if rho_t >= 5.0:
            rect = np.sqrt((f32(1.0) - beta2_t) * (rho_t - f32(4.0))
                           / (rho_inf - f32(4.0)) * (rho_t - f32(2.0))
                           / rho_t * rho_inf / (rho_inf - f32(2.0)))
            branch, scale = "rect", float(rect / bias1)
        elif self.degenerated_to_sgd:
            branch, scale = "sgd", float(f32(1.0) / bias1)
        else:
            branch, scale = "none", 0.0
        return branch, (scale, -lr, -self.weight_decay * lr)

    def _updates(self, grads, branch, numbers):
        scale, neg_lr, neg_decay = numbers
        _moments(self.mu, self.nu, grads, self.b1, self.b2)
        if branch == "rect":
            denom = torch._foreach_sqrt(self.nu)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(self.mu, denom)
            torch._foreach_mul_(upd, scale)
            torch._foreach_mul_(upd, neg_lr)
        elif branch == "sgd":
            upd = torch._foreach_mul(self.mu, scale)
            torch._foreach_mul_(upd, neg_lr)
        else:
            upd = self._zeros()
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                        neg_decay))
        return upd


class Lookahead(Optimizer):
    """k steps forward, one back (reference optimizers.py:105-150): every
    k inner steps slow += alpha (fast - slow) and the fast weights are set
    to the slow ones. Wraps another optimizer of this module over the same
    parameters."""

    _state = ("count", "slow", "base")

    def __init__(self, base: Optimizer, alpha: float = 0.5, k: int = 6):
        super().__init__(base.params)
        self.base, self.alpha, self.k = base, alpha, k
        self.count = 0
        self.slow = [p.detach().clone() for p in self.params]

    def advance(self):
        """Branch: (the base's branch, whether this step syncs)."""
        branch, numbers = self.base.advance()
        self.count += 1
        return (branch, self.count % self.k == 0), numbers

    def _updates(self, grads, branch, numbers):
        base_branch, sync = branch
        upd = self.base._updates(grads, base_branch, numbers)
        if not sync:
            return upd
        fast = torch._foreach_add(self.params, upd)
        diff = torch._foreach_sub(fast, self.slow)
        torch._foreach_mul_(diff, self.alpha)
        torch._foreach_add_(self.slow, diff)
        return torch._foreach_sub(self.slow, self.params)


def make_optimizer(params, name: str, learning_rate: float,
                   batch_size: int, momentum: float = 0.9,
                   use_lookahead: bool = False, lookahead_alpha: float = 0.5,
                   lookahead_k: int = 6,
                   lr_decay_rate: Optional[float] = None,
                   decay_steps: int = 1, weight_decay: float = 0.0,
                   eps: Optional[float] = None) -> Optimizer:
    """The harness' optimizer over ``params`` (base_experiment.py:44-77):
    name in {rmsprop, radam, adam}, eps = 1e-2/B^2 unless given, an
    optional LookAhead wrapper, and an optional staircase exponential
    decay of the rate (``decay_steps`` = steps per epoch)."""
    eps = reference_eps(batch_size) if eps is None else eps
    schedule: Schedule = learning_rate
    if lr_decay_rate is not None and lr_decay_rate != 1.0:
        schedule = exponential_decay(learning_rate, decay_steps,
                                     lr_decay_rate)
    params = list(params)
    if name == "rmsprop":
        base = RMSprop(params, schedule, decay=0.99, eps=eps,
                       momentum=momentum)
    elif name == "radam":
        base = RAdam(params, schedule, eps=eps, weight_decay=weight_decay)
    elif name == "adam":
        base = Adam(params, schedule, eps=eps)
    else:
        raise ValueError(f"Unknown optimizer: {name}")
    if use_lookahead:
        return Lookahead(base, alpha=lookahead_alpha, k=lookahead_k)
    return base
