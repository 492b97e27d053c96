"""The port's multi-step dispatch, alternative reconstructions, Trainer and
CLI against scae_tpu's, on the CPU, at the small widths of
tests/test_train_smoke.py:

  * ``make_train_scan`` over K=3 equals 3 raw steps, and ``make_eval_scan``
    and ``make_fused_eval_step`` equal the raw eval step, bit for bit; on
    weights bridged from flax with the noise off, both scans equal JAX's
    within rtol 2e-3 (the trajectory tolerance);
  * with ``reconstruct_alternatives`` the three alternative
    reconstructions' modes equal JAX's within 1e-5 (the golden tolerance);
  * the JAX Trainer and the port's run 4 steps from the same initial
    parameters (the port's ``init_state`` loads JAX's, by a monkeypatch),
    noise and translation off: their per-step JSONL losses agree within
    rtol 2e-3, and the two consume the same index stream;
  * the port's run interrupted after 2 steps and resumed equals its
    4-step run bit for bit: index stream, logged losses, parameters;
  * ``run_test`` evaluates floor(n / B) batches and reports the accuracy
    and per-class recall over all n examples;
  * on a mesh of more than one device the seed probe and the head refit,
    not ported to the mesh yet, raise NotImplementedError naming them, and
    a batch the data ranks do not divide raises ValueError (the mesh is
    held in test_torch_mesh.py and test_torch_mesh_trainer.py, the four
    options in test_torch_trainer_features.py); the CLI parses overrides
    as scae_tpu's does.

Both sides run in float32 (f32 convolutions and likelihood taps, as
``fused_tap_dtype: float32`` and ``compute_dtype: null`` ask) so that the
comparison is of the algorithm; the JAX likelihood on the CPU is its XLA
path, the port's the gather kernel's plain version.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu.config import load_config as j_load_config
from scae_tpu.factory import make_scae as j_make_scae
from scae_tpu.optim import make_optimizer as j_make_optimizer
from scae_tpu.parallel import train_step as j_train_step
from scae_tpu.train import loop as j_loop
from scae_tpu_torch.config import load_config as t_load_config
from scae_tpu_torch.factory import make_scae as t_make_scae
from scae_tpu_torch.optim import make_optimizer as t_make_optimizer
from scae_tpu_torch.parallel import mesh as t_mesh
from scae_tpu_torch.parallel import train_step as t_train_step
from scae_tpu_torch.train import cli as t_cli
from scae_tpu_torch.train import loop as t_loop
from scae_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(1)
B = 4
LR = 3e-5
RTOL = 2e-3
MODEL = dict(
    image_shape=(1, 24, 24), n_classes=10, n_part_caps=8, n_obj_caps=4,
    pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
    pcae_encoder_params=dict(noise_scale=0.0),
    pcae_template_generator_params=dict(template_size=(5, 5)),
    ocae_encoder_set_transformer_params=dict(dim_hidden=8, dim_out=16),
    ocae_decoder_capsule_params=dict(noise_type=None, noise_scale=0.0,
                                     dim_caps=8, hidden_sizes=(16,)))


def with_alternatives(flag):
    return dict(MODEL, scae_params=dict(reconstruct_alternatives=flag))


@pytest.fixture(scope="module")
def bridged():
    """JAX params at the small widths, with random alpha templates (the
    init's zeros would tie every mixing logit and leave each mode to the
    last bit of a presence log)."""
    jm = j_make_scae(with_alternatives(False))
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((2, 1, 24, 24)), deterministic=False))()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    alpha = params["part_decoder"]["templates_alpha"]
    params["part_decoder"]["templates_alpha"] = np.random.RandomState(
        0).randn(*alpha.shape).astype(np.float32)
    return params


def port_model(params, alternatives=False):
    model = t_make_scae(with_alternatives(alternatives), device="cpu")
    load_flax_params(model, params)
    return model


def dataset(n=12, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 24, 24)).astype(np.uint8),
            rng.randint(0, 10, (n,)).astype(np.int32))


IDXS = np.array([[0, 3, 5, 9], [1, 1, 2, 8], [11, 4, 7, 6]])


# ---------------------------------------------------------------- scans

def test_train_scan_equals_raw_steps(bridged):
    images, labels = dataset()
    data = {"image": torch.from_numpy(images),
            "label": torch.from_numpy(labels)}
    states = [t_train_step.TrainState(
        m, t_make_optimizer(m.parameters(), "rmsprop", LR, batch_size=B))
        for m in (port_model(bridged), port_model(bridged))]
    scan = t_train_step.make_train_scan(device="cpu")
    state, got = scan(states[0], data, IDXS)
    assert state is states[0] and state.step == 3
    raw = t_train_step.make_raw_train_step(states[1], device="cpu")
    want = [raw(images[i], labels[i]) for i in IDXS]
    assert sorted(got) == sorted(want[0])
    for k, v in got.items():
        assert v.shape == (3,)
        assert torch.equal(v, torch.stack([w[k] for w in want])), k
    for a, b in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match=r"\(K, B\)"):
        scan(states[0], data, IDXS[0])


def test_eval_scan_and_fused_eval_step_equal_raw_eval_steps(bridged):
    images, labels = dataset()
    data = {"image": torch.from_numpy(images),
            "label": torch.from_numpy(labels)}
    model = port_model(bridged)
    got = t_train_step.make_eval_scan(model, canvas=24, device="cpu")(
        data, IDXS)
    raw = t_train_step.make_raw_eval_step(model, canvas=24, device="cpu")
    fused = t_train_step.make_fused_eval_step(model, canvas=24,
                                              device="cpu")
    for j, idx in enumerate(IDXS):
        want = raw(images[idx], labels[idx])
        one = fused(data, idx)
        for k in want:
            assert torch.equal(got[k][j], want[k]), k
            assert torch.equal(one[k], want[k]), k


def test_scans_match_jax(bridged):
    images, labels = dataset()
    jm = j_make_scae(with_alternatives(False))
    tx = j_make_optimizer("rmsprop", LR, batch_size=B, momentum=0.9)
    j_state = j_train_step.TrainState(
        step=jnp.zeros([], jnp.int32), params=bridged,
        opt_state=tx.init(bridged), rng=jax.random.PRNGKey(0))
    j_data = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    _, j_metrics = j_train_step.make_train_scan(jm, tx, donate=False)(
        j_state, j_data, jnp.asarray(IDXS, jnp.int32))
    j_eval = j_train_step.make_eval_scan(jm, canvas=24)(
        bridged, j_data, jnp.asarray(IDXS, jnp.int32))

    model = port_model(bridged)
    data = {"image": torch.from_numpy(images),
            "label": torch.from_numpy(labels)}
    t_eval = t_train_step.make_eval_scan(model, canvas=24, device="cpu")(
        data, IDXS)
    state = t_train_step.TrainState(model, t_make_optimizer(
        model.parameters(), "rmsprop", LR, batch_size=B))
    _, t_metrics = t_train_step.make_train_scan(device="cpu")(
        state, data, IDXS)
    for got, want in ((t_metrics, j_metrics), (t_eval, j_eval)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=1e-6, err_msg=k)


def test_alternative_reconstructions_match_jax(bridged):
    images, _ = dataset(n=3)
    x = images[:, None].astype(np.float32) / 255.0
    jm = j_make_scae(with_alternatives(True))
    res = jax.jit(lambda p, x: jm.apply({"params": p}, x,
                                        deterministic=True))(
        bridged, jnp.asarray(x))
    model = port_model(bridged, alternatives=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), deterministic=True)
    for name in ("bottom_up_rec", "top_down_rec", "top_down_per_caps_rec"):
        g, w = getattr(got, name), getattr(res, name)
        assert g.target is None and g.target_ll is None
        np.testing.assert_allclose(g.pdf.mode().numpy(),
                                   np.asarray(w.pdf.mode()), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert got.top_down_per_caps_rec.pdf.mode().shape == (3 * 4, 1, 24, 24)
    # without the flag there are none, and the training loss is the same
    plain = port_model(bridged)(torch.from_numpy(x), deterministic=True)
    assert plain.bottom_up_rec is None and plain.top_down_per_caps_rec is None


def test_alternatives_carry_no_gradient(bridged):
    images, labels = dataset(n=2)
    x = torch.from_numpy(images[:, None].astype(np.float32) / 255.0)
    model = port_model(bridged, alternatives=True)
    res = model(x, deterministic=True)
    for rec in (res.bottom_up_rec, res.top_down_rec,
                res.top_down_per_caps_rec):
        assert not rec.pdf.mode().requires_grad
        assert not rec.transformed_templates.requires_grad
    loss, _ = model.loss(res, x, torch.from_numpy(labels).long())
    assert loss.requires_grad


# -------------------------------------------------------------- Trainer

SMALL = [
    "data_loader.batch_size=16", "data_loader.source=synthetic",
    "data_loader.synthetic_train=96", "data_loader.val_size=32",
    "data_loader.synthetic_test=20", "trainer.max_epochs=1",
    "trainer.log_every_steps=1", "trainer.max_eval_batches=1",
    "trainer.augment.canvas=24", "trainer.augment.max_shift=0",
    "model.image_shape=[1,24,24]", "model.n_part_caps=8",
    "model.n_obj_caps=4",
    "model.pcae_cnn_encoder_params.out_channels=[16,16,16,16]",
    "model.pcae_cnn_encoder_params.compute_dtype=null",
    "model.pcae_decoder_params.fused_tap_dtype=float32",
    "model.pcae_template_generator_params.template_size=[6,6]",
    "model.pcae_encoder_params.noise_scale=0.0",
    "model.ocae_encoder_set_transformer_params.dim_hidden=8",
    "model.ocae_encoder_set_transformer_params.dim_out=16",
    "model.ocae_decoder_capsule_params.dim_caps=8",
    "model.ocae_decoder_capsule_params.hidden_sizes=[16]",
    "model.ocae_decoder_capsule_params.noise_type=null",
    "model.ocae_decoder_capsule_params.noise_scale=0.0",
]
LOSS_KEYS = ("rec_ll_loss", "log_prob_loss", "prior_within_sparsity_loss",
             "prior_between_sparsity_loss", "posterior_within_sparsity_loss",
             "posterior_between_sparsity_loss", "cpr_dynamic_reg_loss",
             "prior_cls_xe", "posterior_cls_xe", "loss")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setenv("SCAE_TPU_NO_TENSORBOARD", "1")


def overrides(tmp_path, tag, *extra):
    return SMALL + [f"trainer.checkpoint_dir={tmp_path}/{tag}/ckpt",
                    f"trainer.log_dir={tmp_path}/{tag}/logs", *extra]


def train_records(tmp_path, tag):
    with open(tmp_path / tag / "logs" / "metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if "images_per_sec" in r]


def recording(trainer):
    """Record the index chunks the trainer's train scan is given."""
    inner, seen = trainer.train_scan, []

    def scan(state, data, idxs):
        seen.append(np.asarray(idxs).reshape(-1))
        return inner(state, data, idxs)

    trainer.train_scan = scan
    return seen


def run_port(cfg, max_steps=None, resume=False, params=None,
             monkeypatch=None):
    trainer = t_loop.Trainer(cfg, device="cpu")
    if params is not None:
        init_state = t_loop.Trainer.init_state

        def bridged_init(self, seed):
            state = init_state(self, seed)
            load_flax_params(self.model, params)
            return state

        monkeypatch.setattr(t_loop.Trainer, "init_state", bridged_init)
    build = trainer.build_steps
    seen = []

    def build_and_record(spe):
        build(spe)
        seen.append(recording(trainer))

    trainer.build_steps = build_and_record
    try:
        state = trainer.run(max_steps=max_steps, resume=resume)
    finally:
        trainer.close()
    stream = np.concatenate(seen[0]) if seen and seen[0] else np.zeros(0)
    return trainer, state, stream


def test_trainer_matches_jax(tmp_path, monkeypatch):
    cfg = j_load_config("config", overrides(tmp_path, "jax",
                                            "trainer.save_top_k=0"))
    # the JAX run's initial parameters and index chunks, as it makes them
    captured, jax_seen = {}, []
    j_init, j_build = j_loop.Trainer.init_state, j_loop.Trainer.build_steps

    def capturing_init(self, seed):
        state = j_init(self, seed)
        captured["params"] = jax.tree_util.tree_map(
            np.asarray, jax.device_get(state.params))
        return state

    def recording_build(self, steps_per_epoch):
        j_build(self, steps_per_epoch)
        inner = self.train_scan

        def scan(state, data, idxs):
            jax_seen.append(np.asarray(idxs).reshape(-1))
            return inner(state, data, idxs)

        self.train_scan = scan

    monkeypatch.setattr(j_loop.Trainer, "init_state", capturing_init)
    monkeypatch.setattr(j_loop.Trainer, "build_steps", recording_build)
    j_state = j_loop.Trainer(cfg).run()
    assert int(j_state.step) == 4
    params = captured["params"]

    t_cfg = t_load_config("config", overrides(tmp_path, "port",
                                              "trainer.save_top_k=0"))
    assert t_cfg == cfg | {"trainer": {
        **cfg["trainer"],
        "checkpoint_dir": f"{tmp_path}/port/ckpt",
        "log_dir": f"{tmp_path}/port/logs"}}
    _, state, stream = run_port(t_cfg, params=params,
                                monkeypatch=monkeypatch)
    assert state.step == 4
    np.testing.assert_array_equal(stream, np.concatenate(jax_seen))
    got, want = train_records(tmp_path, "port"), train_records(tmp_path,
                                                               "jax")
    assert [r["step"] for r in got] == [r["step"] for r in want] \
        == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["learning_rate"] == w["learning_rate"]
        for k in LOSS_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL,
                                       err_msg=f"{k} at step {g['step']}")


def test_trainer_resume_is_bit_exact(tmp_path):
    straight, s_state, s_stream = run_port(
        t_load_config("config", overrides(tmp_path, "straight")))
    cfg = t_load_config("config", overrides(tmp_path, "split"))
    _, _, first = run_port(cfg, max_steps=2)
    with open(tmp_path / "split" / "ckpt" / "train_seed.json") as f:
        assert json.load(f) == {"seed": 42, "split_seed": None}
    resumed, r_state, second = run_port(cfg, resume=True)
    assert (s_state.step, r_state.step) == (4, 4)
    np.testing.assert_array_equal(np.concatenate([first, second]), s_stream)
    got = train_records(tmp_path, "split")
    want = train_records(tmp_path, "straight")
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        for k in LOSS_KEYS + ("accuracy", "learning_rate"):
            assert g[k] == w[k], (k, g["step"])
    for (name, a), b in zip(straight.model.named_parameters(),
                            resumed.model.parameters()):
        assert torch.equal(a, b), name
    assert resumed.ckpt.latest_step == 4


def test_run_test_covers_the_whole_split(tmp_path, capsys):
    cfg = t_load_config("config", overrides(tmp_path, "t"))
    run_port(cfg)
    trainer = t_loop.Trainer(cfg, device="cpu")
    try:
        metrics = trainer.run_test()
    finally:
        trainer.close()
    assert "per-class recall:" in capsys.readouterr().out
    # the grids' model is a view of the trained one: the same parameters
    assert trainer.viz_model.reconstruct_alternatives
    assert not trainer.model.reconstruct_alternatives
    assert all(a is b for a, b in zip(trainer.viz_model.parameters(),
                                      trainer.model.parameters()))
    # the eval scan covers floor(20 / 16) = 1 batch; the recall pass all 20
    _, _, test_ds, _ = trainer._load_datasets(42)
    assert len(test_ds) == 20
    eval_scan = trainer.eval_scan(trainer._device_eval_data(test_ds),
                                  np.arange(16).reshape(1, 16))
    assert metrics["test_loss"] == float(np.mean(eval_scan["loss"].numpy()))
    assert metrics["test_accuracy_scan"] == float(
        np.mean(eval_scan["accuracy"].numpy()))
    with torch.inference_mode():
        res = trainer.model(torch.from_numpy(
            test_ds.images[:, None].astype(np.float32) / 255.0),
            deterministic=True)
    labels = test_ds.labels
    accs = [np.mean(p.argmax(-1).numpy() == labels)
            for p in (res.posterior_cls_prob, res.prior_cls_prob)]
    assert metrics["test_accuracy"] == pytest.approx(max(accs), abs=1e-12)
    recalls = {k for k in metrics if k.startswith("test_class")}
    assert recalls == {f"test_class{c}_recall" for c in np.unique(labels)}


def test_run_reports_its_training_wall_time(tmp_path, capsys):
    _, state, _ = run_port(t_load_config("config", overrides(tmp_path, "w")))
    out = capsys.readouterr().out
    line, = [ln for ln in out.splitlines() if " s of training wall time" in ln]
    words = line.split()
    images, seconds, rate = int(words[2]), float(words[5]), float(words[-2])
    assert images == state.step * 16 and seconds > 0
    assert rate == images / seconds


def test_init_state_redraws_the_parameters_in_place(tmp_path):
    trainer = t_loop.Trainer(t_load_config("config", overrides(tmp_path, "i")),
                             device="cpu")
    try:
        trainer.build_steps(4)
        params = list(trainer.model.parameters())
        with torch.no_grad():
            for p in params:
                p.fill_(float("nan"))
        state = trainer.init_state(7)
    finally:
        trainer.close()
    assert state.step == 0 and state.seed == 7 and state.model is trainer.model
    assert all(a is b for a, b in zip(trainer.model.parameters(), params))
    assert all(a is b for a, b in zip(trainer.viz_model.parameters(), params))
    fresh = t_make_scae(trainer.model_cfg, device="cpu", seed=7).state_dict()
    got = trainer.model.state_dict()
    assert sorted(got) == sorted(fresh)
    for k in fresh:
        assert torch.equal(got[k], fresh[k]), k


@pytest.mark.parametrize("override,error,match", [
    ("trainer.seed_probe.n=2", NotImplementedError, r"trainer\.seed_probe"),
    ("trainer.head_refit=true", NotImplementedError, r"trainer\.head_refit"),
    ("data_loader.batch_size=15", ValueError, "batch_size=15"),
])
def test_deferred_features_are_refused(tmp_path, monkeypatch, override,
                                       error, match):
    """On a mesh of two data ranks (its layout alone: the Trainer checks
    its config against it before it uses any group), the seed probe and
    the head refit are refused by name, and a batch the data ranks do not
    divide by ValueError."""
    monkeypatch.setattr(t_loop.mesh_lib, "make_mesh",
                        lambda n_data=None, n_model=1: t_mesh.Mesh(2, 1))
    cfg = t_load_config("config", overrides(tmp_path, "r", override,
                                            "trainer.mesh.n_data=2"))
    with pytest.raises(error, match=match):
        t_loop.Trainer(cfg, device="cpu")


def test_trainer_needs_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_loop.Trainer(t_load_config("config", overrides(tmp_path, "c")))


def test_cli_parses_overrides_as_scae_tpu(monkeypatch):
    calls = []

    class Stub:
        def __init__(self, cfg, device=None):
            calls.append(("init", cfg, device))

        def run(self, resume=False):
            calls.append(("run", resume))
            return "state"

        def run_test(self):
            calls.append(("test",))
            return {"test_loss": 1.0}

        def close(self):
            calls.append(("close",))

    monkeypatch.setattr(t_cli, "Trainer", Stub)
    argv = ["+trainer.new_key=3", "optimizer=radam", "resume=true",
            "ignored-positional", "data_loader.batch_size=64"]
    assert t_cli.main(argv, device="cpu") == "state"
    want = j_load_config("config", [a.lstrip("+") for a in argv if "=" in a])
    assert calls[0] == ("init", want, "cpu")
    assert calls[1:] == [("run", True), ("close",)]
    calls.clear()
    assert t_cli.main(["mode=test"], device="cpu") == {"test_loss": 1.0}
    assert [c[0] for c in calls] == ["init", "test", "close"]
    try:
        t_cli.main(["trainer.debug_nans=true"], device="cpu")
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
