"""The port's serving export (scae_tpu_torch/serve.py and
tools/export_model.py) on the CPU, case for case as tests/test_serve.py
holds scae_tpu's:

  * the artifact, loaded back, reproduces the live ``make_infer_fn``
    (rtol 1e-4, atol 1e-5, test_serve.py's tolerance);
  * it is self-contained: a fresh interpreter loads it and calls it with
    ``torch`` and the module that registers the vote head's op
    (``scae_tpu_torch.kernels.capsule_votes``) alone: neither the port's
    models nor ``scae_tpu`` are imported;
  * the manifest records the contract; a wrong batch is refused; a model
    without classes serves the unsupervised surface only; a polymorphic
    batch serves batches 1, 3 and 7; ``mesh`` is refused with a
    polymorphic batch, and a one-process mesh exports a mesh artifact.

And on top:

  * parity: JAX's ``export_serving(platforms=("cpu",))`` artifact and the
    port's, on the same weights carried over by ``utils/from_flax.py`` and
    the same numpy batch, give equal predictions and every float output
    within 1e-5 relative and absolute (test_torch_slice.py's infer
    tolerance);
  * K6's op, ``scae_tpu_torch::attention_fwd``, passes
    ``torch.library.opcheck`` (schema, CPU and fake implementations);
  * a model with ``use_pallas_attention`` exports a program that calls the
    op, four times a forward, and gives the plain model's predictions and
    its float outputs within 1e-5;
  * ``python -m scae_tpu_torch.tools.export_model`` on a checkpoint
    directory written by the port's ``CheckpointManager``.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sample_hparams import small_model_params

from scae_tpu import serve as j_serve
from scae_tpu.factory import make_scae as j_make_scae
from scae_tpu_torch import serve as t_serve
from scae_tpu_torch.factory import make_scae as t_make_scae
from scae_tpu_torch.kernels import attention as k6
from scae_tpu_torch.kernels import capsule_likelihood as cl
from scae_tpu_torch.kernels import capsule_votes as cv
from scae_tpu_torch.optim import make_optimizer
from scae_tpu_torch.parallel import mesh as t_mesh
from scae_tpu_torch.parallel.train_step import TrainState
from scae_tpu_torch.tools import export_model
from scae_tpu_torch.train.checkpoint import CheckpointManager
from scae_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(1)
BATCH = 4
RTOL, ATOL = 1e-4, 1e-5     # artifact against the live model
TOL = 1e-5                  # the port against JAX


def model_params(**kw):
    return small_model_params(pcae_decoder_params=dict(fused_impl="xla"),
                              **kw)


@pytest.fixture(scope="module")
def models():
    """JAX's tiny model as tests/test_serve.py makes it, and the port's on
    the same weights."""
    mk = model_params()
    jm = j_make_scae(mk)
    img = jnp.zeros((BATCH, *mk["image_shape"]), jnp.float32)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                     image=img,
                                     deterministic=True))()["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = t_make_scae(mk, device="cpu")
    load_flax_params(tm, params)
    return jm, params, tm, mk


@pytest.fixture(scope="module")
def exported_dir(models, tmp_path_factory):
    _, _, tm, mk = models
    out = str(tmp_path_factory.mktemp("artifact"))
    t_serve.export_serving(tm, image_shape=mk["image_shape"],
                           batch_size=BATCH, out_dir=out,
                           with_reconstruction=True, device="cpu",
                           model_config=mk)
    return out


def batch(n=BATCH, seed=1):
    return np.random.RandomState(seed).rand(n, 1, 28, 28).astype(np.float32)


def check(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k.endswith("prediction"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=k)


def test_roundtrip_matches_live_model(models, exported_dir):
    _, _, tm, _ = models
    served = t_serve.load_serving(exported_dir)
    x = batch()
    got = served(x)
    check(got, t_serve.make_infer_fn(tm, with_reconstruction=True,
                                     device="cpu")(x))
    assert got["prediction"].shape == (BATCH,)
    assert got["reconstruction"].shape == (BATCH, 1, 28, 28)


def test_artifact_is_self_contained(exported_dir, tmp_path):
    """A fresh interpreter loads and calls the artifact with torch and the
    vote head's op alone: every artifact calls
    ``scae_tpu_torch::capsule_votes_fwd``, which its module registers."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        import scae_tpu_torch.kernels.capsule_votes
        program = torch.export.load(
            {os.path.join(exported_dir, t_serve.ARTIFACT_NAME)!r})
        res = program.module()(torch.zeros(({BATCH}, 1, 28, 28)))
        assert "scae_tpu_torch.models" not in sys.modules
        assert "scae_tpu_torch.serve" not in sys.modules
        assert "scae_tpu" not in sys.modules
        probs = res["posterior_cls_prob"]
        assert torch.allclose(probs.sum(-1), torch.ones({BATCH}),
                              rtol=1e-5)
        print("served", sorted(res))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served" in out.stdout and "prediction" in out.stdout


def test_manifest_records_contract(exported_dir):
    served = t_serve.load_serving(exported_dir)
    m = served.manifest
    assert m["input"]["shape"] == [BATCH, 1, 28, 28]
    assert m["input"]["layout"] == "NCHW"
    assert m["input"]["dtype"] == "float32"
    assert "prediction" in m["outputs"]
    assert m["outputs"] == sorted(m["outputs"])
    assert m["model_config"]["n_part_caps"] == 16
    assert served.input_shape == (BATCH, 1, 28, 28)
    assert m["device"] == "cpu" and m["custom_ops"] == [cl.OP, cv.OP]
    assert m["polymorphic_batch"] is False and m["batch_axis"] is None
    assert m["with_reconstruction"] is True
    assert m["torch_version"] == torch.__version__
    assert m["scae_tpu_torch_version"]
    with open(os.path.join(exported_dir, t_serve.MANIFEST_NAME)) as f:
        assert json.load(f) == m


def test_batch_size_mismatch_rejected(exported_dir):
    served = t_serve.load_serving(exported_dir)
    with pytest.raises(ValueError, match="shape"):
        served(np.zeros((BATCH + 1, 1, 28, 28), np.float32))
    with pytest.raises(ValueError, match="shape"):
        served(np.zeros((BATCH, 1, 24, 24), np.float32))


def test_infer_fn_without_classes():
    mk = model_params(n_classes=None)
    tm = t_make_scae(mk, device="cpu")
    out = t_serve.make_infer_fn(tm, device="cpu")(np.zeros((2, 1, 28, 28),
                                                           np.float32))
    assert "prediction" not in out and "posterior_cls_prob" not in out
    assert out["caps_presence"].shape[0] == 2


def test_polymorphic_batch_serves_any_size(models, tmp_path):
    """One artifact serves batches 1, 3 and 7, each agreeing with the live
    model on the same rows."""
    _, _, tm, mk = models
    t_serve.export_serving(tm, image_shape=mk["image_shape"],
                           batch_size=None, out_dir=str(tmp_path),
                           device="cpu", model_config=mk,
                           polymorphic_batch=True)
    served = t_serve.load_serving(str(tmp_path))
    assert served.manifest["polymorphic_batch"] is True
    assert served.input_shape == (None, 1, 28, 28)
    full = batch(7, seed=5)
    want = t_serve.make_infer_fn(tm, device="cpu")(full)
    check(served(full), want)
    for b in (1, 3):
        got = served(full[:b])
        assert got["prediction"].shape == (b,)
        check(got, {k: v[:b] for k, v in want.items()})


def test_mesh_is_refused(models, tmp_path):
    """``mesh`` with a polymorphic batch, a mesh of more than one process
    without a group, and a batch its data ranks do not divide are refused
    before anything is written; a one-process mesh exports the mesh
    artifact, which loads without a group and serves as the plain one (the
    mesh of processes is held in test_torch_mesh_serving.py)."""
    _, _, tm, mk = models
    kw = dict(image_shape=mk["image_shape"], out_dir=str(tmp_path / "m"),
              device="cpu", model_config=mk)
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_serve.export_serving(tm, batch_size=None, polymorphic_batch=True,
                               mesh=t_mesh.Mesh(1, 1), **kw)
    with pytest.raises(ValueError, match="spans no process group"):
        t_serve.export_serving(tm, batch_size=16, mesh=t_mesh.Mesh(2, 1),
                               **kw)
    assert not os.listdir(tmp_path)
    t_serve.export_serving(tm, batch_size=BATCH, mesh=t_mesh.make_mesh(),
                           **kw)
    served = t_serve.load_serving(kw["out_dir"])
    m = served.manifest
    assert (m["batch_axis"], m["nr_devices"], m["mesh"]) == (
        "data", 1, {"n_data": 1, "n_model": 1})
    assert m["input"]["shape"] == [BATCH, 1, 28, 28]
    x = batch()
    check(served(x), t_serve.make_infer_fn(tm, device="cpu")(x))


# ------------------------------------------------------------ on top

def test_artifact_matches_jax_artifact(models, exported_dir, tmp_path):
    jm, params, _, mk = models
    j_serve.export_serving(jm, params, image_shape=mk["image_shape"],
                           batch_size=BATCH, out_dir=str(tmp_path),
                           with_reconstruction=True, platforms=("cpu",),
                           model_config=mk)
    x = batch(seed=3)
    want = j_serve.load_serving(str(tmp_path))(jnp.asarray(x))
    got = t_serve.load_serving(exported_dir)(x)
    check({k: v.numpy() for k, v in got.items()},
          {k: np.asarray(v) for k, v in want.items()}, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(3, 5, 6, 8, 4), (8, 10, 10, 4, 4),
                                   (2, 1, 7, 16, 16)])
def test_attention_op_passes_opcheck(shape):
    B, N, M, d_k, d_v = shape
    rng = np.random.RandomState(sum(shape))
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((B, N, d_k), (B, M, d_k), (B, M, d_v)))
    presence = torch.from_numpy(rng.rand(B, M).astype(np.float32))
    torch.library.opcheck(torch.ops.scae_tpu_torch.attention_fwd.default,
                          (q, k, v, presence))
    got = torch.ops.scae_tpu_torch.attention_fwd(q, k, v, presence)
    assert torch.equal(got, k6.attention_plain(q, k, v, presence))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = torch.ops.scae_tpu_torch.attention_fwd(
            *(mode.from_tensor(t) for t in (q, k, v, presence)))
    assert fake.shape == (B, N, d_v) and fake.dtype == torch.float32


# the ops' schemas as exported programs record them: an artifact names its
# ops and their arguments, so another schema would not load it
OP_SCHEMAS = {
    "attention_fwd": "scae_tpu_torch::attention_fwd(Tensor queries, Tensor "
                     "keys, Tensor values, Tensor presence) -> Tensor",
    "capsule_votes_fwd": (
        "scae_tpu_torch::capsule_votes_fwd(Tensor all_param, Tensor "
        "cpr_static, Tensor caps_bias_0, Tensor caps_bias_1, Tensor "
        "caps_bias_2, Tensor caps_bias_3, Tensor? caps_exist, Tensor? "
        "noise_caps, Tensor? noise_vote, bool similarity_transform, bool "
        "allow_deformations, bool learn_vote_scale, str? noise_type, float "
        "noise_scale) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)"),
    "capsule_votes_bwd": (
        "scae_tpu_torch::capsule_votes_bwd(Tensor all_param, Tensor "
        "cpr_static, Tensor caps_bias_0, Tensor caps_bias_1, Tensor "
        "caps_bias_2, Tensor caps_bias_3, Tensor? caps_exist, Tensor? "
        "noise_caps, Tensor? noise_vote, Tensor? g_vote, Tensor? g_scale, "
        "Tensor? g_vote_presence, Tensor? g_presence_logit_per_caps, "
        "Tensor? g_presence_logit_per_vote, Tensor? g_cpr_dynamic_reg_loss, "
        "bool similarity_transform, bool allow_deformations, bool "
        "learn_vote_scale, str? noise_type, float noise_scale) -> Tensor[]"),
    "capsule_likelihood_fwd": (
        "scae_tpu_torch::capsule_likelihood_fwd(Tensor vote, Tensor scale, "
        "Tensor vote_presence, Tensor dummy_vote, Tensor x, Tensor? "
        "presence) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
        "Tensor, Tensor, Tensor, Tensor)"),
    "capsule_likelihood_bwd": (
        "scae_tpu_torch::capsule_likelihood_bwd(Tensor vote, Tensor scale, "
        "Tensor vote_presence, Tensor dummy_vote, Tensor x, Tensor? "
        "presence, Tensor? g_log_prob, Tensor? g_winner, Tensor? "
        "g_winner_presence, Tensor? g_soft_winner, Tensor? "
        "g_soft_winner_presence, Tensor? g_posterior_mixing_prob, Tensor? "
        "g_mixing_log_prob, Tensor? g_mixing_logit, str[] wanted) -> "
        "Tensor[]"),
}


@pytest.mark.parametrize("name", sorted(OP_SCHEMAS))
def test_op_schema_is_pinned(name):
    """Each op that an exported program calls by name keeps its schema, so
    that artifacts exported earlier still load."""
    op = getattr(torch.ops.scae_tpu_torch, name).default
    assert str(op._schema) == OP_SCHEMAS[name]


def test_attention_flag_exports_the_op(models, tmp_path):
    _, params, _, mk = models
    flagged = t_make_scae(mk, device="cpu")
    load_flax_params(flagged, params)
    flagged.obj_encoder.use_pallas_attention = True
    t_serve.export_serving(flagged, image_shape=mk["image_shape"],
                           batch_size=None, out_dir=str(tmp_path),
                           device="cpu", polymorphic_batch=True)
    served = t_serve.load_serving(str(tmp_path))
    assert served.manifest["custom_ops"] == [k6.OP, cl.OP, cv.OP]
    calls = [n for n in served.program.graph.nodes
             if n.target is torch.ops.scae_tpu_torch.attention_fwd.default]
    assert len(calls) == 4          # three set-attention blocks, the final
    x = batch(5, seed=4)
    plain = t_make_scae(mk, device="cpu")
    load_flax_params(plain, params)
    check(served(x), t_serve.make_infer_fn(plain, device="cpu")(x),
          rtol=TOL, atol=TOL)


def test_export_model_tool(models, tmp_path, capsys):
    """The tool restores the best checkpoint by the monitor from a
    directory the port's CheckpointManager wrote, exports it and checks
    the artifact against the live model."""
    _, params, _, _ = models
    overrides = ["model.image_shape=[1,28,28]", "model.n_part_caps=16",
                 "model.n_obj_caps=10"]
    from scae_tpu_torch.config import load_config

    mk = load_config("config", overrides)["model"]
    ckpt = str(tmp_path / "ckpt")
    mgr = CheckpointManager(ckpt, monitor="val_loss")
    for step, loss, seed in ((1, 1.0, 1), (2, 5.0, 2)):
        model = t_make_scae(mk, device="cpu", seed=seed)
        state = TrainState(model, make_optimizer(model.parameters(),
                                                 "rmsprop", 3e-5,
                                                 batch_size=4), step, seed)
        assert mgr.save(step, state, metrics={"val_loss": loss})
    out = str(tmp_path / "artifact")
    result = export_model.main([ckpt, "--out", out, "--batch-size", "6",
                                "--device", "cpu", "--polymorphic-batch",
                                "--", *overrides])
    printed = capsys.readouterr().out
    assert "VERIFIED polymorphic batch" in printed
    assert json.loads(printed.strip().splitlines()[-1]) == result
    assert result["step"] == 1 and result["artifact"] == out
    served = t_serve.load_serving(out)
    assert served.manifest["model_config"]["pcae_decoder_params"][
        "fused_impl"] == "xla"
    best = t_make_scae(mk, device="cpu", seed=1)
    x = batch(2, seed=6)
    check(served(x), t_serve.make_infer_fn(best, device="cpu")(x))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        export_model.main([str(tmp_path / "empty"), "--out", out,
                           "--device", "cpu", "--", *overrides])
