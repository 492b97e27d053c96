"""tools/import_jax_checkpoint.py on a trained scae_tpu run: a copy of
checkpoints_followup/20700 (Orbax; seed 103 in train_seed.json; the
r3_wsweep_followup overrides of RESULTS.md) imported as a port checkpoint.

  * The port's deterministic eval of the imported checkpoint against
    scae_tpu's eval of the Orbax parameters on the same batch of 16 real
    digits, every metric within 1e-5 relative and absolute
    (tests/test_torch_slice.py's tolerance). Both sides evaluate with f32
    convolutions and likelihood taps: the run's config computes them in
    bf16, whose rounding two backends need not share, and the weights are
    f32 either way.
  * Every optimizer moment equals JAX's after the layout transposes
    (worked out here independently of utils/from_flax.py), the counts and
    the step carry over, the seed is train_seed.json's and JAX's key is
    recorded in metrics.json.
  * The source directory is byte for byte unchanged, and the port's
    Trainer reads the checkpoint (mode=test's restore path).
"""

import hashlib
import importlib.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from scae_tpu.config import load_config as j_load_config
from scae_tpu.factory import make_scae as j_make_scae
from scae_tpu.parallel import train_step as j_train_step
from scae_tpu.train.checkpoint import CheckpointManager as JaxManager
from scae_tpu_torch.config import load_config
from scae_tpu_torch.factory import make_scae
from scae_tpu_torch.parallel import train_step as t_train_step
from scae_tpu_torch.train import data as t_data
from scae_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "checkpoints_followup")
STEP = 20700
# r3_wsweep_followup (RESULTS.md): the overrides that shape its model,
# optimizer and monitor
OVERRIDES = ["trainer.monitor=val_accuracy", "trainer.monitor_mode=max",
             "data_loader.source=digits", "lr_scheduler.decay_rate=0.99994",
             "model.scae_params.posterior_between_example_sparsity_weight"
             "=0.4"]
F32 = ["model.pcae_cnn_encoder_params.compute_dtype=null",
       "model.pcae_decoder_params.fused_tap_dtype=float32"]
TOL = 1e-5


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "import_jax_checkpoint",
        os.path.join(REPO, "tools", "import_jax_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tree_digest(root):
    """{relative path: sha256} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("import")
    run = tmp / "run"
    os.makedirs(run)
    shutil.copytree(os.path.join(SOURCE, str(STEP)), run / str(STEP))
    shutil.copyfile(os.path.join(SOURCE, "train_seed.json"),
                    run / "train_seed.json")
    before = tree_digest(run)
    result = load_tool().main([str(run), "--out", str(tmp / "out"), "--",
                               *OVERRIDES])
    return run, tmp / "out", before, result


def test_the_source_is_left_unchanged(imported):
    run, _, before, result = imported
    assert tree_digest(run) == before
    assert result["step"] == STEP and result["seed"] == 103


def test_imported_eval_matches_jax(imported):
    run, out, _, _ = imported
    cfg = load_config("config", overrides=OVERRIDES + F32)
    tm = make_scae(dict(cfg["model"]), device="cpu")
    mgr = CheckpointManager(str(out), monitor="val_accuracy", mode="max")
    assert mgr.best_step == STEP
    tm.load_state_dict(mgr.restore_params(STEP))

    src = JaxManager(str(run), monitor="val_accuracy", mode="max")
    params = jax.tree_util.tree_map(np.asarray, src.restore_params(STEP))
    src.close()
    jm = j_make_scae(j_load_config("config", overrides=OVERRIDES + F32)
                     ["model"])

    _, _, images, labels = t_data.real_digits(size=28)
    images, labels = images[:16], labels[:16].astype(np.int32)
    want = jax.jit(j_train_step.make_raw_eval_step(jm, canvas=40))(
        params, jnp.asarray(images), jnp.asarray(labels))
    got = t_train_step.make_raw_eval_step(tm, canvas=40, device="cpu")(
        images, labels)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            np.float64(got[k].detach().numpy()), np.float64(want[k]),
            rtol=TOL, atol=TOL, err_msg=k)


def port_layout(path, leaf):
    """(port name, the leaf in the port's layout) of a flax leaf."""
    *parents, name = path
    leaf = np.asarray(leaf)
    if name == "kernel":
        name = "weight"
        leaf = leaf.T if leaf.ndim == 2 else leaf.transpose(3, 2, 0, 1)
    elif name == "scale" and parents[-1] in ("ln0", "ln1"):
        name = "weight"
    return ".".join([*parents, name]), leaf


def test_optimizer_state_step_and_seed_carry_over(imported):
    run, out, _, _ = imported
    payload = CheckpointManager(str(out)).read_payload(STEP)
    mgr = ocp.CheckpointManager(str(run))
    raw = mgr.restore(STEP, args=ocp.args.StandardRestore())
    mgr.close()
    # optax.rmsprop with a schedule and momentum: (nu, count, trace)
    nu, count, trace = (raw["opt_state"][k] for k in ("0", "1", "2")) \
        if isinstance(raw["opt_state"], dict) else raw["opt_state"]
    tm = make_scae(dict(load_config("config", OVERRIDES)["model"]),
                   device="cpu")
    order = [n for n, _ in tm.named_parameters()]
    opt = payload["optimizer"]
    assert sorted(opt) == ["count", "nu", "trace"]
    assert opt["count"] == int(count["count"]) == STEP
    assert payload["step"] == int(raw["step"]) == STEP
    assert payload["seed"] == 103
    for key, tree in (("nu", nu["nu"]), ("trace", trace["trace"])):
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name, arr = port_layout([p.key for p in path], leaf)
            flat[name] = arr
        assert sorted(flat) == sorted(order)
        assert len(opt[key]) == len(order)
        for name, got in zip(order, opt[key]):
            np.testing.assert_array_equal(got.numpy(), flat[name],
                                          err_msg=f"{key} {name}")
    with open(os.path.join(out, str(STEP), "metrics.json")) as f:
        metrics = json.load(f)
    rng = np.asarray(raw["rng"]).astype(np.uint32)
    assert metrics == {"val_accuracy": 0.78515625,
                       "jax_rng_0": float(rng[0]),
                       "jax_rng_1": float(rng[1])}
    with open(os.path.join(out, "train_seed.json")) as f:
        assert json.load(f)["seed"] == 103


def test_the_port_trainer_restores_it(imported, tmp_path):
    """The port's Trainer restores the imported state in full (model,
    optimizer, step) into a state of the run's config, as mode=test and
    resume do."""
    from scae_tpu_torch.train.loop import Trainer

    _, out, _, _ = imported
    cfg = load_config("config", overrides=OVERRIDES + [
        f"trainer.checkpoint_dir={out}",
        f"trainer.log_dir={tmp_path}/logs"])
    trainer = Trainer(cfg, device="cpu")
    assert trainer._recorded_seed() == 103
    trainer.build_steps(10)
    state = trainer.ckpt.restore(trainer.init_state(103),
                                 step=trainer.ckpt.best_step)
    assert state.step == STEP and state.optimizer.count == STEP


def test_out_inside_the_source_is_refused(imported):
    run, _, before, _ = imported
    with pytest.raises(ValueError, match="inside the source"):
        load_tool().main([str(run), "--out", str(run / "port"), "--",
                          *OVERRIDES])
    assert tree_digest(run) == before
