"""The port Trainer's four options around a run against scae_tpu's, on the
CPU, at tests/test_torch_trainer.py's small widths (noise and translation
off, float32 convolutions and taps), mirroring tests/test_train_smoke.py:

  * ``trainer.template_init=patches``: the template logits equal those of
    JAX's ``_patch_template_init`` on the same training images bit for bit
    (sigmoid and relu1), repeat per seed and differ between seeds, are
    left alone under ``init_from``, and a run trains from them;
  * ``init_from``: the warm-started parameters equal the source
    checkpoint's, with a fresh optimizer and step; another architecture
    raises ValueError, an empty source FileNotFoundError; the best
    checkpoint by this run's monitor is taken where the source recorded
    it, else the latest, and ``init_from_step`` pins one;
  * ``trainer.seed_probe``: on the initial parameters of JAX's candidates
    (JAX's ``init_state`` captured, loaded into the port's), the port's
    probe scores each candidate within rtol 2e-3 (the trajectory
    tolerance) of JAX's and picks the same winner, whose state it
    continues and records in ``train_seed.json``; a resume reuses the
    recorded seed, and one with no recorded seed raises;
  * ``trainer.head_refit``: the refit lands at ``max(best, latest) + 1``
    with the monitor's metric, rewrites only the posterior head, and
    ranks best under a val_accuracy monitor, on a best that is the latest
    and on one that is not; it leaves the caller's parameters as they
    were, so ``run`` returns its last training state; on the same flax
    parameters its features equal those JAX's refit gives sklearn within
    1e-5, with the same C and validation accuracy; the torch fit is held to sklearn's
    ``LogisticRegression`` on the same features: the same C, the same
    validation accuracy, and coefficients and intercepts within 1e-3 of
    their largest entry. The sklearn fit runs to tol 1e-10 in float64
    (its default tol of 1e-4 stops short of the minimum: on these
    features the objective is flat enough that its coefficients may sit
    far from the optimum that both solvers approach); the default fit's
    choice of C and its validation accuracy are held too;
  * the refit skips with JAX's messages without a checkpoint or a
    posterior classifier (on a mesh of processes, the seed probe and the
    refit are held in test_torch_mesh_trainer.py).
"""

import json
import os
import re
import types

import jax
import numpy as np
import pytest
import torch

from scae_tpu.config import load_config as j_load_config
from scae_tpu.train import loop as j_loop
from scae_tpu_torch.config import load_config as t_load_config
from scae_tpu_torch.train import data as t_data
from scae_tpu_torch.train import logreg
from scae_tpu_torch.train import loop as t_loop
from scae_tpu_torch.train.checkpoint import CheckpointManager
from scae_tpu_torch.utils.from_flax import load_flax_params
from test_torch_trainer import SMALL

torch.set_num_threads(1)
RTOL = 2e-3
LOGREG_TOL = 1e-3


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setenv("SCAE_TPU_NO_TENSORBOARD", "1")


def overrides(tmp_path, tag, *extra):
    return SMALL + [f"trainer.checkpoint_dir={tmp_path}/{tag}/ckpt",
                    f"trainer.log_dir={tmp_path}/{tag}/logs", *extra]


def trainer(tmp_path, tag, *extra):
    return t_loop.Trainer(t_load_config("config", overrides(tmp_path, tag,
                                                            *extra)),
                          device="cpu")


def train_ds(seed=5):
    return t_data.load_datasets(seed=seed, image_size=24, val_size=32,
                                synthetic_train=96, synthetic_test=20,
                                source="synthetic")[0]


# ------------------------------------------------------ template_init

@pytest.mark.parametrize("nonlin", ["sigmoid", "relu1"])
def test_template_logits_equal_jax(tmp_path, nonlin, capsys):
    t = trainer(tmp_path, "p", "trainer.template_init=patches",
                f"model.pcae_template_generator_params.template_nonlin="
                f"{nonlin}")
    try:
        t.build_steps(4)
        ds = train_ds()
        t._maybe_patch_templates(t.init_state(5), ds, 5)
        got = t.model.template_generator.template_logits.detach().numpy() \
            .copy()
        assert "template_init=patches" in capsys.readouterr().out
        # JAX's function on the same images and the same logits' shape
        fake = types.SimpleNamespace(model=types.SimpleNamespace(
            template_generator=types.SimpleNamespace(
                template_nonlin=nonlin)))
        params = {"template_generator": {"template_logits": np.zeros(
            got.shape, np.float32)}}
        want = j_loop.Trainer._patch_template_init(fake, params, ds, 5)
        want = np.asarray(want["template_generator"]["template_logits"])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if nonlin == "sigmoid":
            assert np.abs(got).max() > 2.0     # logit(0.99) ~ 4.6
        t._maybe_patch_templates(t.init_state(5), ds, 5)
        np.testing.assert_array_equal(
            t.model.template_generator.template_logits.detach().numpy(),
            got)
        t._maybe_patch_templates(t.init_state(5), ds, 6)
        assert not np.array_equal(
            t.model.template_generator.template_logits.detach().numpy(),
            got)
    finally:
        t.close()


def test_template_init_trains_and_yields_to_init_from(tmp_path, capsys):
    t = trainer(tmp_path, "a", "trainer.template_init=patches")
    try:
        state = t.run(max_steps=2)
    finally:
        t.close()
    assert state.step == 2
    assert "template_init=patches" in capsys.readouterr().out
    warm = trainer(tmp_path, "b", "trainer.template_init=patches",
                   f"init_from={tmp_path}/a/ckpt")
    try:
        warm.build_steps(4)
        warm._maybe_patch_templates(warm.init_state(7), train_ds(), 7)
        out = capsys.readouterr().out
        assert "template_init=patches" not in out
        assert "warm start" in out
    finally:
        warm.close()


def test_unknown_template_init_is_refused(tmp_path):
    with pytest.raises(ValueError, match="template_init"):
        trainer(tmp_path, "u", "trainer.template_init=noise")


# ----------------------------------------------------------- init_from

def test_init_from_warm_starts_params(tmp_path, capsys):
    src = trainer(tmp_path, "a")
    try:
        src_state = src.run(max_steps=2)
        src_params = {k: v.clone() for k, v in
                      src_state.model.state_dict().items()}
    finally:
        src.close()
    warm = trainer(tmp_path, "b", f"init_from={tmp_path}/a/ckpt")
    try:
        warm.build_steps(4)
        state = warm.init_state(7)
        assert "warm start: params from" in capsys.readouterr().out
        assert state.step == 0 and state.seed == 7
        assert state.optimizer.count == 0
        got = state.model.state_dict()
        assert sorted(got) == sorted(src_params)
        for k, v in src_params.items():
            assert torch.equal(got[k], v), k
        # applied at every fresh init, from the cache
        with torch.no_grad():
            for p in warm.model.parameters():
                p.fill_(float("nan"))
        warm.init_state(8)
        assert capsys.readouterr().out == ""
        for k, v in src_params.items():
            assert torch.equal(warm.model.state_dict()[k], v), k
        final = warm.run(max_steps=2)
        assert final.step == 2
    finally:
        warm.close()

    bad = trainer(tmp_path, "c", f"init_from={tmp_path}/a/ckpt",
                  "model.n_part_caps=6")
    try:
        bad.build_steps(4)
        with pytest.raises(ValueError, match="init_from"):
            bad.init_state(7)
    finally:
        bad.close()
    empty = trainer(tmp_path, "d", f"init_from={tmp_path}/empty")
    try:
        empty.build_steps(4)
        with pytest.raises(FileNotFoundError, match="no checkpoints"):
            empty.init_state(7)
    finally:
        empty.close()


def test_init_from_picks_best_then_latest(tmp_path, capsys):
    """A source whose best by val_loss (step 1) is not its latest (step
    2): this run's monitor picks the best where the source recorded it,
    the latest where it did not, and ``init_from_step`` pins."""
    t = trainer(tmp_path, "s")
    try:
        t.build_steps(4)
        state = t.init_state(3)
        src = CheckpointManager(f"{tmp_path}/src2",
                                       monitor="val_loss")
        src.save(1, state, metrics={"val_loss": 1.0})
        src.save(2, state, metrics={"val_loss": 5.0})
    finally:
        t.close()

    def warm_step_printed(tag, *extra):
        w = trainer(tmp_path, tag, f"init_from={tmp_path}/src2", *extra)
        try:
            w.build_steps(4)
            w.init_state(7)
        finally:
            w.close()
        return re.findall(r"warm start: params from \S+ step (\d+)",
                          capsys.readouterr().out)

    assert warm_step_printed("e") == ["1"]
    assert warm_step_printed("f", "trainer.monitor=val_accuracy",
                             "trainer.monitor_mode=max") == ["2"]
    assert warm_step_printed("g", "trainer.monitor=val_accuracy",
                             "trainer.monitor_mode=max",
                             "init_from_step=1") == ["1"]


# ---------------------------------------------------------- seed_probe

PROBE = ("trainer.seed_probe.n=2", "trainer.seed_probe.epochs=1",
         "trainer.save_top_k=0")


def probe_scores(out):
    return {int(s): float(v) for s, v in re.findall(
        r"seed probe (\d+): val_rec_ll=(\S+) ", out)}


def test_seed_probe_picks_jax_winner(tmp_path, monkeypatch, capsys):
    cfg = j_load_config("config", overrides(tmp_path, "jax", *PROBE))
    captured = {}
    j_init = j_loop.Trainer.init_state

    def capturing_init(self, seed):
        state = j_init(self, seed)
        captured[seed] = jax.tree_util.tree_map(
            np.asarray, jax.device_get(state.params))
        return state

    monkeypatch.setattr(j_loop.Trainer, "init_state", capturing_init)
    j_state = j_loop.Trainer(cfg).run()
    j_out = capsys.readouterr().out
    want = probe_scores(j_out)
    j_winner = int(re.search(r"seed probe winner: (\d+)", j_out).group(1))
    assert sorted(want) == sorted(captured) == [42, 43]
    # the two candidates' scores lie further apart than the tolerance
    assert abs(want[42] - want[43]) > RTOL * max(want.values())

    t_init = t_loop.Trainer.init_state

    def bridged_init(self, seed):
        state = t_init(self, seed)
        load_flax_params(self.model, captured[seed])
        return state

    monkeypatch.setattr(t_loop.Trainer, "init_state", bridged_init)
    t = trainer(tmp_path, "port", *PROBE)
    try:
        state = t.run()
    finally:
        t.close()
    out = capsys.readouterr().out
    got = probe_scores(out)
    assert sorted(got) == [42, 43]
    for s in got:
        np.testing.assert_allclose(got[s], want[s], rtol=RTOL,
                                   err_msg=f"seed {s}")
    assert f"seed probe winner: {j_winner} " in out
    assert "CUDA graphs captured: 0 train, 0 eval" in out
    # the winner's probe epoch is continued, not replayed: 1 of 1 epochs
    assert f"continuing probe winner from step {int(j_state.step)}" in out
    assert state.step == int(j_state.step) == 4 and state.seed == j_winner
    with open(tmp_path / "port" / "ckpt" / "train_seed.json") as f:
        assert json.load(f) == {"seed": j_winner, "split_seed": None}


def test_seed_probe_continues_the_leader(tmp_path, monkeypatch, capsys):
    """When the leader is not the last candidate, its state comes back
    from the host copy exactly: the same as training it alone."""
    scores = iter([1.0, float("nan"), 2.0])
    t_eval = t_loop.Trainer.evaluate

    def scored(self, dataset, max_batches=None):
        metrics, viz = t_eval(self, dataset, max_batches)
        return {**metrics, "val_rec_ll_loss": next(scores)}, viz

    monkeypatch.setattr(t_loop.Trainer, "evaluate", scored)
    t = trainer(tmp_path, "probe", "trainer.seed_probe.n=3",
                "trainer.seed_probe.epochs=1")
    try:
        seed, state = t.probe_seeds(42, 3, 1)
        probed = {k: v.clone() for k, v in state.model.state_dict().items()}
        opt = state.optimizer.state_dict()
    finally:
        t.close()
    out = capsys.readouterr().out
    assert "seed probe 43: val_rec_ll=inf" in out
    assert seed == 42 and state.seed == 42 and state.step == 4
    monkeypatch.setattr(t_loop.Trainer, "evaluate", t_eval)
    alone = trainer(tmp_path, "alone")
    try:
        alone.build_steps(4)
        a_state = alone.init_state(42)
        ds = alone._load_datasets(42)[0]
        alone.train_scan(a_state, alone._to_device(ds),
                         alone._epoch_stream(42, len(ds), range(1), 4))
        for k, v in a_state.model.state_dict().items():
            assert torch.equal(probed[k], v), k
        for name, v in a_state.optimizer.state_dict().items():
            if isinstance(v, list):
                assert all(torch.equal(x, y) for x, y in zip(opt[name], v))
            else:
                assert opt[name] == v, name
    finally:
        alone.close()


def test_seed_probe_resume(tmp_path, capsys):
    cfg = ("trainer.seed_probe.n=2", "trainer.seed_probe.epochs=1")
    t = trainer(tmp_path, "r", *cfg, "trainer.max_epochs=2")
    try:
        t.run()
    finally:
        t.close()
    out = capsys.readouterr().out
    winner = int(re.search(r"seed probe winner: (\d+)", out).group(1))
    again = trainer(tmp_path, "r", *cfg, "trainer.max_epochs=3")
    try:
        state = again.run(resume=True)
    finally:
        again.close()
    out = capsys.readouterr().out
    assert "seed probe winner" not in out
    assert f"resume: recorded training seed {winner}" in out
    assert state.step == 12
    os.remove(tmp_path / "r" / "ckpt" / "train_seed.json")
    lost = trainer(tmp_path, "r", *cfg, "trainer.max_epochs=4")
    try:
        with pytest.raises(FileNotFoundError, match="records no training"):
            lost.run(resume=True)
    finally:
        lost.close()


# ---------------------------------------------------------- head_refit

REFIT = ("trainer.monitor=val_accuracy", "trainer.monitor_mode=max",
         "trainer.head_refit=true")


def check_against_sklearn(t, out, train_ds, val_ds, src_step, refit_step):
    """The refit head against sklearn's LogisticRegression fitted on the
    features of checkpoint ``src_step``, with the same choice of C by
    validation accuracy."""
    from sklearn.linear_model import LogisticRegression

    t.model.load_state_dict(t.ckpt.restore_params(step=src_step))
    Xtr, ytr = t._posterior_features(train_ds)
    Xval, yval = t._posterior_features(val_ds)
    c_star = float(re.search(r"head_refit: C\*=(\S+) ", out).group(1))
    probe_val = re.search(r"probe val (\S+);", out).group(1)
    fits = {}
    for tol in (1e-10, 1e-4):
        best = None
        for C in (0.1, 1.0, 10.0, 100.0):
            clf = LogisticRegression(max_iter=5000, C=C, tol=tol).fit(Xtr,
                                                                      ytr)
            acc = float(np.mean(clf.predict(Xval) == yval))
            if best is None or acc > best[1]:
                best = (clf, acc, C)
        assert (best[2], f"{best[1]:.4f}") == (c_star, probe_val), tol
        fits[tol] = best[0]
    clf = fits[1e-10]
    saved = t.ckpt.restore_params(step=refit_step)
    for got, want in ((saved["posterior_classifier.weight"], clf.coef_),
                      (saved["posterior_classifier.bias"], clf.intercept_)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=LOGREG_TOL * np.abs(want).max())
    fit = logreg.fit(Xtr, ytr, c_star)
    np.testing.assert_array_equal(fit.predict(Xval), clf.predict(Xval))


def check_head_only(t, src_step, refit_step):
    src = t.ckpt.restore_params(step=src_step)
    new = t.ckpt.restore_params(step=refit_step)
    assert not torch.allclose(src["posterior_classifier.weight"],
                              new["posterior_classifier.weight"])
    for k in src:
        if not k.startswith("posterior_classifier."):
            assert torch.equal(src[k], new[k]), k


def test_head_refit_on_the_best_checkpoint(tmp_path, capsys):
    t = trainer(tmp_path, "h", *REFIT)
    try:
        state = t.run(max_steps=4)
        out = capsys.readouterr().out
        assert "head_refit: C*=" in out, out
        assert sorted(t.ckpt._metrics) == [4, 5]
        assert t.ckpt.best_step == 5
        assert set(t.ckpt.metrics(5)) == {"val_accuracy"}
        # run returns the last training state, as JAX's does: the
        # parameters of step 4's checkpoint, not the refit's, beside
        # step 4's optimizer
        assert state.step == 4
        last = t.ckpt.restore_params(step=4)
        got = state.model.state_dict()
        assert sorted(got) == sorted(last)
        for k, v in last.items():
            assert torch.equal(got[k], v), k
        moments = [x.clone() for x in state.optimizer.state_tensors()]
        assert moments
        restored = t.ckpt.restore(
            t_loop.TrainState(t.model, t.tx(t.model.parameters())), step=4)
        for x, y in zip(moments, restored.optimizer.state_tensors()):
            assert torch.equal(x, y)
        check_head_only(t, 4, 5)
        ds = t._load_datasets(42)
        check_against_sklearn(t, out, ds[0], ds[1], 4, 5)
    finally:
        t.close()
    tested = trainer(tmp_path, "h", *REFIT)
    try:
        metrics = tested.run_test()
    finally:
        tested.close()
    assert "test_accuracy" in metrics
    assert "test @ ckpt 5" in capsys.readouterr().out


def test_head_refit_survives_nonmonotonic_best(tmp_path, capsys):
    t = trainer(tmp_path, "n", *REFIT)
    try:
        t.build_steps(4)
        state = t.init_state(42)
        assert t.ckpt.save(10, state, metrics={"val_accuracy": 0.002})
        assert t.ckpt.save(20, state, metrics={"val_accuracy": 0.001})
        assert (t.ckpt.best_step, t.ckpt.latest_step) == (10, 20)
        train, val, _, _ = t_data.load_datasets(
            seed=7, image_size=24, val_size=32, synthetic_train=64,
            synthetic_test=16, source="synthetic")
        with torch.no_grad():
            for p in t.model.parameters():
                p.add_(1.0)      # the caller's state differs from both
        moved = {k: v.clone() for k, v in t.model.state_dict().items()}
        vm = t.refit_head(train, val)
        out = capsys.readouterr().out
        # the refit leaves the caller's parameters as they were
        for k, v in t.model.state_dict().items():
            assert torch.equal(v, moved[k]), k
        assert vm is not None and "head_refit: C*=" in out, out
        assert sorted(t.ckpt._metrics) == [10, 20, 21]
        assert t.ckpt.best_step == 21
        assert t.ckpt.metrics(21) == {"val_accuracy": vm["val_accuracy"]}
        check_head_only(t, 10, 21)
        check_against_sklearn(t, out, train, val, 10, 21)
    finally:
        t.close()


def test_head_refit_features_equal_jax(tmp_path, monkeypatch, capsys):
    """The same flax parameters in both Trainers' checkpoints: the features
    the port's refit fits on and scores with equal those JAX's refit gives
    sklearn, within tests/test_torch_slice.py's tolerance (1e-5), and both
    choose the same C with the same validation accuracy."""
    from sklearn import linear_model

    train, val, _, _ = t_data.load_datasets(
        seed=7, image_size=24, val_size=32, synthetic_train=64,
        synthetic_test=16, source="synthetic")
    j = j_loop.Trainer(j_load_config("config",
                                     overrides(tmp_path, "jr", *REFIT)))
    j.build_steps(4)
    j_state = j.init_state(42)
    assert j.ckpt.save(1, lambda: jax.device_get(j_state),
                       metrics={"val_accuracy": 0.5})
    j.ckpt.wait()
    j_seen = {"fit": [], "predict": []}

    class Recording(linear_model.LogisticRegression):
        def fit(self, X, y, *args, **kwargs):
            j_seen["fit"].append(np.array(X))
            return super().fit(X, y, *args, **kwargs)

        def predict(self, X):
            j_seen["predict"].append(np.array(X))
            return super().predict(X)

    monkeypatch.setattr(linear_model, "LogisticRegression", Recording)
    assert j.refit_head(train, val) is not None
    j_out = capsys.readouterr().out

    t = trainer(tmp_path, "tr", *REFIT)
    t_seen = {"fit": [], "predict": []}
    fit, predict = logreg.fit, logreg.LogisticFit.predict

    def recording_fit(X, y, C):
        t_seen["fit"].append(np.array(X))
        return fit(X, y, C)

    def recording_predict(self, X):
        t_seen["predict"].append(np.array(X))
        return predict(self, X)

    monkeypatch.setattr(logreg, "fit", recording_fit)
    monkeypatch.setattr(logreg.LogisticFit, "predict", recording_predict)
    try:
        t.build_steps(4)
        state = t.init_state(0)
        load_flax_params(t.model, jax.tree_util.tree_map(
            np.asarray, jax.device_get(j_state.params)))
        assert t.ckpt.save(1, state, metrics={"val_accuracy": 0.5})
        assert t.refit_head(train, val) is not None
    finally:
        t.close()
    out = capsys.readouterr().out
    for what, n in (("fit", len(train)), ("predict", len(val))):
        assert len(t_seen[what]) == len(j_seen[what]) == 4, what
        assert t_seen[what][0].shape == j_seen[what][0].shape == (n, 4)
        for got, want in zip(t_seen[what], j_seen[what]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=what)
    pick = r"head_refit: C\*=(\S+) probe val (\S+);"
    assert re.search(pick, out).groups() == re.search(pick, j_out).groups()


def test_head_refit_skips(tmp_path, capsys):
    t = trainer(tmp_path, "z", *REFIT, "trainer.save_top_k=0")
    try:
        t.run(max_steps=2)
    finally:
        t.close()
    assert "head_refit: no retained checkpoint" in capsys.readouterr().out
    t = trainer(tmp_path, "nc", *REFIT, "model.n_classes=null")
    try:
        t.build_steps(4)
        assert t.ckpt.save(1, t.init_state(42),
                           metrics={"val_accuracy": 0.5})
        train, val, _, _ = t._load_datasets(42)
        assert t.refit_head(train, val) is None
        assert sorted(t.ckpt._metrics) == [1]
    finally:
        t.close()
    assert "head_refit: model has no posterior classifier" in \
        capsys.readouterr().out


@pytest.mark.parametrize("override", [
    "init_from=/some/run", "trainer.template_init=patches",
    "trainer.head_refit=true", "trainer.seed_probe.n=2"])
def test_ported_features_are_accepted(tmp_path, override):
    trainer(tmp_path, "ok", override).close()
