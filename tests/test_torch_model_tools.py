"""The port's model tools (scae_tpu_torch/tools/: ensemble_pool,
ensemble_eval, probe_eval, probe_calibrate, verify_serving_readout,
bench_serving) against their JAX twins in tools/, on the CPU.

Nothing is trained: each member is a tiny model's seeded JAX init, written
as a scae_tpu checkpoint (through its Trainer's manager) and, carried over
by ``utils/from_flax.py``, as a port checkpoint, each beside the same
``train_seed.json`` (split_seed 7) and a log with a peak val_accuracy.
Group "a" holds two 24x24 members, group "b" one 28x28 member, as
tests/test_ensemble_pool.py's two groups of different image size. Both
packages' ``load_datasets`` are patched to the same tiny sizes. Float32
throughout (f32 convolutions and taps), batch 16 over a test split of 40,
so the last batch is padded.

  * ``ensemble_pool --dump-probs``: every member's prior and posterior
    class probabilities within 1e-5 of JAX's; the labels, names and peak
    vals equal; the JSON result equal;
  * ``ensemble_eval``: the JSON result equal;
  * ``probe_eval`` and ``probe_calibrate``: the same C* and accuracies as
    JAX's tools with sklearn fitted to tol 1e-10 (its default of 1e-4
    stops short of the optimum, tests/test_torch_trainer_features.py);
    the calibrated head within LOGREG_TOL (1e-3 of its largest entry) of
    that sklearn fit on the port's features (a random init's features are
    too flat for a fit on JAX's float32 features to land on the same
    optimum), every other tensor and the optimizer state the source's bit
    for bit, and ``train_seed.json`` copied;
  * ``verify_serving_readout`` on the port's artifact of a member and on
    JAX's: ``n_test`` and ``test_accuracy`` equal; run as ``python -m``
    with an ``--expect`` it misses, it exits non-zero;
  * ``bench_serving --device cpu``: the JAX tool's JSON keys.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from scae_tpu import serve as j_serve
from scae_tpu.config import load_config as j_load_config
from scae_tpu.train import data as j_data
from scae_tpu.train import loop as j_loop
from scae_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from scae_tpu_torch import serve as t_serve
from scae_tpu_torch.config import load_config as t_load_config
from scae_tpu_torch.factory import make_scae as t_make_scae
from scae_tpu_torch.optim import make_optimizer
from scae_tpu_torch.parallel.train_step import TrainState
from scae_tpu_torch.tools import (bench_serving, ensemble_eval,
                                  ensemble_pool, probe_calibrate, probe_eval,
                                  verify_serving_readout)
from scae_tpu_torch.train import data as t_data
from scae_tpu_torch.train import loop
from scae_tpu_torch.train.checkpoint import CheckpointManager
from scae_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = 7
B = 16
SIZES = dict(val_size=32, synthetic_train=96, synthetic_test=40)
PROB_TOL = 1e-5
LOGREG_TOL = 1e-3
# group: (image size, members' seeds)
GROUPS = {"a": (24, (1, 2)), "b": (28, (3,))}


def tiny(size):
    """A tiny float32 model at ``size``, on split 7, batch 16."""
    return [
        "data_loader.batch_size=16", f"data_loader.split_seed={SPLIT}",
        "data_loader.source=synthetic",
        f"model.image_shape=[1,{size},{size}]", "model.n_part_caps=8",
        "model.n_obj_caps=4",
        "model.pcae_cnn_encoder_params.out_channels=[16,16,16,16]",
        "model.pcae_cnn_encoder_params.compute_dtype=null",
        "model.pcae_decoder_params.fused_tap_dtype=float32",
        "model.pcae_template_generator_params.template_size=[6,6]",
        "model.ocae_encoder_set_transformer_params.dim_hidden=8",
        "model.ocae_encoder_set_transformer_params.dim_out=16",
        "model.ocae_decoder_capsule_params.dim_caps=8",
        "model.ocae_decoder_capsule_params.hidden_sizes=[16]",
    ]


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tight_sklearn(monkeypatch):
    """sklearn's LogisticRegression, as the JAX tools import it at call
    time, fitted to tol 1e-10."""
    from sklearn import linear_model

    class Tight(linear_model.LogisticRegression):
        def __init__(self, **kw):
            super().__init__(tol=1e-10, **kw)

    monkeypatch.setattr(linear_model, "LogisticRegression", Tight)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each member's JAX and port checkpoint directories and log, the
    spec files of both, and the members' flax parameters."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SCAE_TPU_NO_COMP_CACHE", "1")
    mp.setenv("SCAE_TPU_NO_TENSORBOARD", "1")
    for module in (j_data, t_data):
        def tiny_datasets(_orig=module.load_datasets, **kw):
            kw.update(SIZES)
            return _orig(**kw)

        mp.setattr(module, "load_datasets", tiny_datasets)
    root = tmp_path_factory.mktemp("tools")
    members, params = {}, {}
    try:
        for group, (size, seeds) in GROUPS.items():
            for seed in seeds:
                name = f"{group}{seed}"
                dirs = {side: str(root / side / name) for side in
                        ("jax", "port")}
                cfg = j_load_config("config", tiny(size) + [
                    f"seed={seed}",
                    f"trainer.checkpoint_dir={dirs['jax']}",
                    f"trainer.log_dir={root}/jax_trainer_logs/{name}"])
                j = j_loop.Trainer(cfg)
                j.build_steps(4)
                state = j.init_state(seed)
                assert j.ckpt.save(4, lambda: jax.device_get(state),
                                   metrics={"val_loss": 1.0})
                j.ckpt.wait()
                params[name] = jax.tree_util.tree_map(
                    np.asarray, jax.device_get(state.params))
                model = t_make_scae(dict(t_load_config(
                    "config", tiny(size))["model"]), device="cpu")
                load_flax_params(model, params[name])
                assert CheckpointManager(dirs["port"]).save(
                    4, TrainState(model, make_optimizer(
                        model.parameters(), "rmsprop", 1e-4, B),
                        step=4, seed=seed),
                    metrics={"val_loss": 1.0})
                log = root / "logs" / name
                log.mkdir(parents=True)
                (log / "metrics.jsonl").write_text(
                    json.dumps({"step": 4, "val_accuracy": 0.1 * seed})
                    + "\n")
                for d in dirs.values():
                    with open(os.path.join(d, "train_seed.json"), "w") as f:
                        json.dump({"seed": seed, "split_seed": SPLIT}, f)
                members[name] = dict(dirs, log=str(log), size=size)
        specs = {}
        for side in ("jax", "port"):
            spec = {"split_seed": SPLIT, "groups": [
                {"name": group, "overrides": tiny(size),
                 "members": [{"run": members[f"{group}{s}"][side],
                              "log": members[f"{group}{s}"]["log"]}
                             for s in seeds]}
                for group, (size, seeds) in GROUPS.items()]}
            specs[side] = str(root / f"spec_{side}.json")
            with open(specs[side], "w") as f:
                json.dump(spec, f)
        yield {"members": members, "specs": specs, "params": params,
               "root": root}
    finally:
        mp.undo()


def same(a, b) -> bool:
    """Whether two nests of dicts, lists and tensors are equal, tensors bit
    for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    return a == b


def test_ensemble_pool_matches_jax(runs, tmp_path):
    dumps = {side: str(tmp_path / f"{side}.npz") for side in ("jax", "port")}
    want = load_jax_tool("ensemble_pool").main(
        [runs["specs"]["jax"], "--batch-size", str(B), "--dump-probs",
         dumps["jax"]])
    got = ensemble_pool.main(
        [runs["specs"]["port"], "--batch-size", str(B), "--dump-probs",
         dumps["port"], "--device", "cpu"])
    assert got == want
    assert got["n_members"] == 3 and got["n_test"] == SIZES["synthetic_test"]
    j, t = np.load(dumps["jax"]), np.load(dumps["port"])
    assert sorted(j.files) == sorted(t.files)
    for key in ("labels", "names", "vals"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    for key in ("prior", "posterior"):
        assert t[key].shape == j[key].shape == (3, 40, 10)
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=PROB_TOL,
                                   err_msg=key)


def test_ensemble_eval_matches_jax(runs):
    members = runs["members"]
    argv = ["--batch-size", str(B), "--"] + tiny(24)
    want = load_jax_tool("ensemble_eval").main(
        [members["a1"]["jax"], members["a2"]["jax"]] + argv)
    got = ensemble_eval.main(
        [members["a1"]["port"], members["a2"]["port"], "--device", "cpu"]
        + argv)
    assert got == want and got["n_models"] == 2


def test_tools_refuse_another_split(runs):
    members = runs["members"]
    with pytest.raises(ValueError, match="split_seed"):
        ensemble_eval.main([members["a1"]["port"], "--device", "cpu", "--"]
                           + tiny(24)[:1] + ["data_loader.split_seed=8"]
                           + tiny(24)[2:])
    with pytest.raises(SystemExit, match="split_seed"):
        ensemble_eval.main([members["a1"]["port"], "--device", "cpu", "--",
                            "data_loader.batch_size=16"])


def test_probe_eval_matches_jax(runs, monkeypatch):
    tight_sklearn(monkeypatch)
    argv = ["--batch-size", str(B)]
    want = load_jax_tool("probe_eval").main([runs["specs"]["jax"]] + argv)
    got = probe_eval.main([runs["specs"]["port"], "--device", "cpu"] + argv)
    assert got == want
    assert len(got["member_test_accs"]) == 3
    skipped = probe_eval.main([runs["specs"]["port"], "--device", "cpu",
                               "--skip-test", "--c-grid", "1.0"] + argv)
    assert skipped["c_star"] == 1.0 and "pooled_test" not in skipped


@pytest.mark.parametrize("c_star", [None, 10.0])
def test_probe_calibrate_matches_jax(runs, monkeypatch, tmp_path,
                                     c_star):
    member = runs["members"]["a1"]
    tight_sklearn(monkeypatch)
    extra = [] if c_star is None else ["--c-star", str(c_star)]
    outs = {side: str(tmp_path / side) for side in ("jax", "port")}
    want = load_jax_tool("probe_calibrate").main(
        [member["jax"], "--out", outs["jax"], "--batch-size", str(B)]
        + extra + ["--"] + tiny(24))
    got = probe_calibrate.main(
        [member["port"], "--out", outs["port"], "--batch-size", str(B),
         "--device", "cpu"] + extra + ["--"] + tiny(24))
    for key in ("step", "c_star", "val_before", "val_probe", "val_after"):
        assert got[key] == want[key], key
    if c_star is not None:
        assert got["c_star"] == c_star
    # the head against sklearn's fit at C* on the port's own features: a
    # random init's features barely vary (a std of ~2e-3 over values near
    # 2), so the float32 gap between XLA's features and the port's (1e-7
    # of a value) moves the optimum by tens of percent; the fit is held
    # where the features are the same
    from sklearn.linear_model import LogisticRegression

    src = CheckpointManager(member["port"])
    new = CheckpointManager(outs["port"])
    assert new.latest_step == 4 and new.metrics(4) == src.metrics(4)
    cfg = t_load_config("config", tiny(24))
    model = t_make_scae(dict(cfg["model"]), device="cpu")
    model.load_state_dict(src.restore_params(step=4))
    train = loop.load_run_datasets(cfg, 42, SPLIT)[0]
    X, = loop.forward_outputs(model, train, 24, B, "cpu",
                              loop.posterior_features)
    clf = LogisticRegression(max_iter=5000, C=got["c_star"]).fit(
        X.astype(np.float64), train.labels)
    calibrated = new.restore_params(step=4)
    for name, ref in (("weight", clf.coef_), ("bias", clf.intercept_)):
        np.testing.assert_allclose(
            calibrated[f"posterior_classifier.{name}"].numpy(), ref, rtol=0,
            atol=LOGREG_TOL * np.abs(ref).max(), err_msg=name)
    # JAX's calibrated head has the port's shape, transposed
    head = JCheckpointManager(outs["jax"]).restore_params(step=4)[
        "posterior_classifier"]
    assert np.asarray(head["kernel"]).T.shape == tuple(
        calibrated["posterior_classifier.weight"].shape)
    before, after = src.read_payload(4), new.read_payload(4)
    for k, v in before["model"].items():
        if not k.startswith("posterior_classifier."):
            assert torch.equal(after["model"][k], v), k
    assert not torch.equal(after["model"]["posterior_classifier.weight"],
                           before["model"]["posterior_classifier.weight"])
    assert (after["step"], after["seed"]) == (before["step"], before["seed"])
    assert same(after["optimizer"], before["optimizer"])
    with open(os.path.join(outs["port"], "train_seed.json")) as f:
        assert json.load(f) == {"seed": 1, "split_seed": SPLIT}


@pytest.fixture(scope="module")
def artifacts(runs, tmp_path_factory):
    """Member a1 exported by both packages at batch 16 on the CPU."""
    out = tmp_path_factory.mktemp("artifacts")
    cfg = t_load_config("config", tiny(24))
    mk = dict(cfg["model"])
    model = t_make_scae(mk, device="cpu")
    model.load_state_dict(CheckpointManager(
        runs["members"]["a1"]["port"]).restore_params(step=4))
    t_serve.export_serving(model, image_shape=mk["image_shape"],
                           batch_size=B, out_dir=str(out / "port"),
                           device="cpu", model_config=mk)
    from scae_tpu.factory import make_scae as j_make_scae

    jmk = dict(j_load_config("config", tiny(24))["model"])
    j_serve.export_serving(j_make_scae(jmk), runs["params"]["a1"],
                           image_shape=jmk["image_shape"], batch_size=B,
                           out_dir=str(out / "jax"), platforms=("cpu",),
                           model_config=jmk)
    return {side: str(out / side) for side in ("jax", "port")}


def test_verify_serving_readout_matches_jax(runs, artifacts):
    member = runs["members"]["a1"]
    argv = ["--"] + tiny(24)
    want = load_jax_tool("verify_serving_readout").main(
        [artifacts["jax"], "--ckpt", member["jax"]] + argv)
    got = verify_serving_readout.main(
        [artifacts["port"], "--ckpt", member["port"], "--device", "cpu"]
        + argv)
    assert got["n_test"] == want["n_test"] == SIZES["synthetic_test"]
    assert got["test_accuracy"] == want["test_accuracy"]
    ok = verify_serving_readout.main(
        [artifacts["port"], "--ckpt", member["port"], "--device", "cpu",
         "--expect", str(got["test_accuracy"]), "--tol", "0"] + argv)
    assert ok["ok"] is True


def test_verify_serving_readout_exits_non_zero_on_a_miss(runs, artifacts):
    """As ``python -m``, with the tiny sizes given as overrides."""
    member = runs["members"]["a1"]
    sizes = [f"data_loader.{k}={v}" for k, v in SIZES.items()]
    cmd = [sys.executable, "-m",
           "scae_tpu_torch.tools.verify_serving_readout", artifacts["port"],
           "--ckpt", member["port"], "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd + ["--"] + tiny(24) + sizes, cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    acc = json.loads(out.stdout.strip().splitlines()[-1])["test_accuracy"]
    miss = 1.0 if acc < 0.5 else 0.0
    out = subprocess.run(cmd + ["--expect", str(miss), "--tol", "0.001",
                                "--"] + tiny(24) + sizes, cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "serving readout mismatch" in out.stderr


def test_bench_serving_keys(artifacts):
    got = bench_serving.main([artifacts["port"], "--repeats", "2",
                              "--device", "cpu"])
    assert sorted(got) == ["artifact_images_per_sec", "backend",
                           "batch_size", "live_images_per_sec", "outputs"]
    assert got["batch_size"] == B and got["backend"] == "cpu"
    assert got["artifact_images_per_sec"] > 0 < got["live_images_per_sec"]
    with open(os.path.join(artifacts["port"], "manifest.json")) as f:
        assert got["outputs"] == json.load(f)["outputs"]


def test_tools_need_cuda_unless_told_otherwise(runs):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ensemble_pool.main([runs["specs"]["port"]])
