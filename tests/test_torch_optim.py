"""The port's optimizers (scae_tpu_torch/optim.py) against scae_tpu.optim
and optax, fed one gradient sequence, and against the torch reference's
trajectory goldens.

Tolerances:
  * against the JAX package on the same gradients: 1e-6 absolute on
    parameters of order 1 after 15 steps, a few f32 ulps (the
    learning-rate factors are host doubles in the port, f32 in JAX);
  * the goldens: the JAX tests' own, 5e-4 for RMSprop and 2e-4 for RAdam
    (tests/test_parity_golden.py), since each step's gradient comes from
    the parameters and the trajectories drift apart in f32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scae_tpu import optim as j_optim
from scae_tpu_torch import optim as t_optim

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
N_STEPS = 15
SHAPES = [(3, 4), (5,), ()]


def grad_sequence(seed=0):
    rng = np.random.RandomState(seed)
    return [[np.asarray(rng.randn(*s) * 10.0 ** rng.uniform(-4, 0),
                        np.float32) for s in SHAPES] for _ in range(N_STEPS)]


def initial_params(seed=1):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randn(*s), np.float32) for s in SHAPES]


def run_jax(tx, grads):
    params = [jnp.asarray(p) for p in initial_params()]
    state = tx.init(params)
    traj = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        traj.append([np.asarray(p) for p in params])
    return traj


def run_port(make, grads):
    params = [torch.from_numpy(p) for p in initial_params()]
    opt = make(params)
    traj = []
    for g in grads:
        opt.step([torch.from_numpy(x) for x in g])
        traj.append([p.numpy().copy() for p in params])
    return traj


def check(got, want, atol=1e-6):
    for step, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=atol,
                                       err_msg=f"step {step + 1}")


# decay_steps=4 puts three staircase boundaries inside the 15 steps;
# lookahead k=6 syncs twice
@pytest.mark.parametrize("name", ["rmsprop", "adam", "radam"])
@pytest.mark.parametrize("lookahead", [False, True])
def test_make_optimizer_matches_jax(name, lookahead):
    kw = dict(batch_size=32, momentum=0.9, use_lookahead=lookahead,
              lookahead_alpha=0.5, lookahead_k=6, lr_decay_rate=0.5,
              decay_steps=4)
    grads = grad_sequence()
    want = run_jax(j_optim.make_optimizer(name, 1e-2, **kw), grads)
    got = run_port(lambda p: t_optim.make_optimizer(p, name, 1e-2, **kw),
                   grads)
    check(got, want)


def test_rmsprop_is_not_torch_rmsprop_across_a_decay():
    """optax scales by the rate before the momentum trace; torch.optim
    scales the trace by the current rate. Equal before the first decay,
    apart after it."""
    grads = grad_sequence(seed=2)
    kw = dict(batch_size=32, momentum=0.9, lr_decay_rate=0.5, decay_steps=4)
    ours = run_port(lambda p: t_optim.make_optimizer(p, "rmsprop", 1e-2,
                                                     **kw), grads)
    params = [torch.from_numpy(p) for p in initial_params()]
    ref = torch.optim.RMSprop(params, lr=1e-2, alpha=0.99, momentum=0.9,
                              eps=t_optim.reference_eps(32))
    sched = torch.optim.lr_scheduler.StepLR(ref, step_size=4, gamma=0.5)
    theirs = []
    for g in grads:
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        ref.step()
        sched.step()
        theirs.append([p.detach().numpy().copy() for p in params])
    check(ours[:4], theirs[:4], atol=1e-5)
    assert max(float(np.abs(a - b).max())
               for a, b in zip(ours[-1], theirs[-1])) > 1e-4


def test_radam_without_sgd_fallback_and_with_weight_decay():
    grads = grad_sequence(seed=3)
    for kw in (dict(degenerated_to_sgd=False), dict(weight_decay=0.1)):
        want = run_jax(j_optim.radam(0.05, eps=1e-8, **kw), grads)
        got = run_port(lambda p: t_optim.RAdam(p, 0.05, eps=1e-8, **kw),
                       grads)
        check(got, want)


def test_exponential_decay_staircase():
    sched = t_optim.exponential_decay(1.0, transition_steps=10,
                                      decay_rate=0.5)
    want = optax.exponential_decay(1.0, transition_steps=10, decay_rate=0.5,
                                   staircase=True)
    for count in (0, 1, 9, 10, 19, 20, 35):
        assert sched(count) == pytest.approx(float(want(count)), rel=1e-7)
    assert t_optim.reference_eps(128) == j_optim.reference_eps(128)


def test_missing_gradients_count_as_zeros():
    params = [torch.ones(3), torch.ones(2)]
    opt = t_optim.make_optimizer(params, "rmsprop", 0.1, batch_size=8)
    opt.step([torch.ones(3), None])
    assert torch.equal(params[1], torch.ones(2))
    assert not torch.equal(params[0], torch.ones(3))
    with pytest.raises(ValueError, match="Unknown optimizer"):
        t_optim.make_optimizer(params, "sgd", 0.1, batch_size=8)


def quadratic_run(make, x0, target, n=15):
    params = [torch.from_numpy(np.array(x0))]
    opt = make(params)
    target = torch.from_numpy(np.array(target))
    traj = []
    for _ in range(n):
        opt.step([2.0 * (params[0] - target)])
        traj.append(params[0].numpy().copy())
    return np.stack(traj)


def test_rmsprop_trajectory_golden():
    g = dict(np.load(os.path.join(GOLDEN, "rmsprop.npz")))
    traj = quadratic_run(lambda p: t_optim.make_optimizer(
        p, "rmsprop", 0.01, batch_size=128, momentum=0.9), g["x0"],
        g["target"])
    np.testing.assert_allclose(traj, g["traj"], rtol=1e-5, atol=5e-4)


def test_radam_trajectory_golden():
    g = dict(np.load(os.path.join(GOLDEN, "radam.npz")))
    traj = quadratic_run(lambda p: t_optim.RAdam(p, 0.05, eps=1e-8),
                         g["x0"], g["target"])
    np.testing.assert_allclose(traj, g["traj"], rtol=1e-5, atol=2e-4)
    traj = quadratic_run(lambda p: t_optim.Lookahead(
        t_optim.RAdam(p, 0.05, eps=1e-8), alpha=0.5, k=3), g["x0"],
        g["target"])
    np.testing.assert_allclose(traj, g["traj_lookahead"], rtol=1e-5,
                               atol=2e-4)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
