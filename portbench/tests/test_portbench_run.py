"""The harness end to end on the CPU at a tiny size, the look for a chip
skipped: a sound run is correct, and a run with the timed path broken
underneath is not, once for each fault its cell can have."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import tiny


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal needs none")
    out = subprocess.run([sys.executable, os.path.join(harness.PB, "run.py"),
                          "--workload", "mnist40.train", "--seed",
                          str(2 ** 31 + 11), "--seconds", "1", "--trace",
                          "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "No result" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_run_refuses_an_unknown_cell():
    out = subprocess.run([sys.executable, os.path.join(harness.PB, "run.py"),
                          "--workload", "no.such.cell", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


CELLS = {"train": "mnist40.train", "bulk": "mnist40.serve.bulk"}
# the open-loop kind's end-to-end readers: its cell is not in
# BENCHMARK.json until it holds its bounds
ONLINE = [{"name": n, "unit": "ms"} for n in ("serve_p50_ms",
                                              "serve_p95_ms")] \
    + [{"name": "setup_s", "unit": "s"}]


@pytest.mark.parametrize("which", ["train", "online", "bulk"])
def test_a_sound_run_is_correct(which):
    checks, run = tiny.run(which)
    assert harness.is_correct(checks), checks
    assert run.stats["attempted"] > 0 and run.stats["failed"] == 0
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    metrics = harness.cell_metrics(bench, CELLS[which], False) \
        if which in CELLS else ONLINE
    got = harness.read_metrics(run, metrics)
    assert set(got) == {m["name"] for m in metrics}
    assert all(v["value"] > 0 for v in got.values())


def test_bulk_checks_a_uniform_sample_of_the_requests_served():
    from portbench.traffic.serve_closed_loop import Job

    params = dict(tiny.TRAFFIC["bulk"][0], sample=8)
    hits = np.zeros(100)
    for seed in range(2 ** 31, 2 ** 31 + 400):
        job = Job(harness.Run("tiny.bulk", tiny.config(), params, {}, seed,
                              1.0, False, torch.device("cpu")))
        for i in range(100):
            job.keep(i, i, 8, None)
        assert len(job.sample) == 8 and sorted(job.slots) == \
            sorted(job.sample)
        hits[sorted(job.sample)] += 1
    # each request is kept with probability 8 / 100
    assert hits[:50].sum() == pytest.approx(hits[50:].sum(), rel=0.15)
    assert hits[-10:].sum() == pytest.approx(400 * 8 / 10, rel=0.3)
    short = Job(harness.Run("tiny.bulk", tiny.config(), params, {}, 3, 1.0,
                            False, torch.device("cpu")))
    for i in range(5):
        short.keep(i, i, 8, None)
    assert sorted(short.sample) == [0, 1, 2, 3, 4]


def state_unchanged(job):
    job.state.optimizer.step = lambda grads=None, plan=None: None


def half_batch(job, monkeypatch):
    from scae_tpu_torch.parallel import train_step

    real = train_step._value_and_grad

    def halved(model, params, images, labels, *rest):
        half = images.shape[0] // 2
        return real(model, params, images[:half], labels[:half], *rest)

    monkeypatch.setattr(train_step, "_value_and_grad", halved)


def altered(key, change):
    def fault(job):
        real = job.model

        class Wrapped:
            def __call__(self, images):
                out = dict(real(images))
                out[key] = change(out[key].clone())
                return out

        job.model = Wrapped()
    return fault


def bump(t):
    t.view(-1)[0] += 1e-3
    return t


def shift(t):
    return (t + 1) % 10


def test_a_step_that_leaves_the_state_unchanged_is_caught():
    checks, _ = tiny.run("train", fault=state_unchanged)
    assert not harness.is_correct(checks), checks
    got = dict((n, v) for n, v, _ in checks)
    assert got["change_gap"] == 1.0 and got["state_gap"] == 1.0


def test_half_the_batch_left_out_is_caught(monkeypatch):
    checks, _ = tiny.run("train",
                         fault=lambda job: half_batch(job, monkeypatch))
    assert not harness.is_correct(checks), checks


def on_update(job, change):
    """Calls ``change(call, opt, grads)`` at each of the optimizer's
    updates (call 1 is the first checked step) before the update runs; a
    list it returns replaces the gradients."""
    opt = job.state.optimizer
    real, calls = opt._updates, []

    def updates(grads, branch, numbers):
        calls.append(None)
        grads = change(len(calls), opt, grads) or grads
        return real(grads, branch, numbers)

    opt._updates = updates


def dropped(job):
    def change(call, opt, grads):
        if call == 2:
            torch._foreach_zero_(opt.nu)
            torch._foreach_zero_(opt.trace)
    on_update(job, change)


def stale(job):
    kept = {}

    def change(call, opt, grads):
        if call == 2:
            kept["state"] = [t.clone() for t in opt.nu + opt.trace]
        if call == 3:
            torch._foreach_copy_(opt.nu + opt.trace, kept["state"])
    on_update(job, change)


def on_updates(job, change):
    """The optimizer's updates go through ``change(updates, index)``,
    ``index`` being the position of a set transformer's weight
    (48 x 16 in the tiny cell)."""
    opt = job.state.optimizer
    real = opt._updates
    names = [n for n, _ in job.model.named_parameters()]
    index = names.index("obj_encoder.sab_1.mab.mqkv.qkv_projector.weight")

    def updates(grads, branch, numbers):
        return change(list(real(grads, branch, numbers)), index)

    opt._updates = updates


def sign_flipped(job):
    on_updates(job, lambda upd, index: [-u for u in upd])


def transposed(job):
    """One leaf's update written as its transpose would lie in memory."""
    def change(upd, index):
        upd[index] = upd[index].t().reshape(upd[index].shape)
        return upd
    on_updates(job, change)


@pytest.mark.parametrize("fault", [sign_flipped, transposed])
def test_an_update_of_the_wrong_sign_or_layout_is_caught(fault):
    """Every norm that the other numbers compare stays as it is under
    such a fault, in the first step at least; the state does not."""
    checks, run = tiny.run("train", fault=fault)
    assert not harness.is_correct(checks), checks
    got = dict((n, v) for n, v, _ in checks)
    assert got["state_gap"] > 10 * run.limits["state_gap"], checks


def moved_start(job):
    with torch.no_grad():
        next(job.model.parameters()).view(-1)[0] += 1e-6


@pytest.mark.parametrize("fault", [dropped, stale])
def test_optimizer_state_not_carried_between_checked_steps_is_caught(
        fault):
    checks, _ = tiny.run("train", fault=fault)
    assert not harness.is_correct(checks), checks


def test_a_start_off_the_seeds_weights_is_caught():
    checks, _ = tiny.run("train", fault=moved_start)
    assert not harness.is_correct(checks), checks
    assert dict((n, v) for n, v, _ in checks)["start_gap"] > 0


def test_a_rounding_change_to_the_first_gradient_fails_no_later_number():
    jobs = []

    def keep(job):
        jobs.append(job)

    def scaled(job):
        keep(job)
        on_update(job, lambda call, opt, grads: [g * (1 + 1e-6)
                                                 for g in grads]
                  if call == 1 else None)

    sound, _ = tiny.run("train", fault=keep)
    checks, _ = tiny.run("train", fault=scaled)
    assert harness.is_correct(checks), checks
    a, b = (j.program["states"][1]["params"] for j in jobs)
    assert any(not torch.equal(a[n], b[n]) for n in a)
    # every later number reads as the sound run's, to rounding
    for (n, v, lim), (_, w, _) in zip(checks, sound):
        assert v <= lim and abs(v - w) <= 0.1 * lim, (n, v, w)


@pytest.mark.parametrize("which", ["online", "bulk"])
@pytest.mark.parametrize("key, change", [("part_presence", bump),
                                         ("prediction", shift)])
def test_an_answer_altered_where_it_is_produced_is_caught(which, key,
                                                          change):
    checks, _ = tiny.run(which, fault=altered(key, change))
    assert not harness.is_correct(checks), checks
