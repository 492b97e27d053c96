"""The port's eval and serving slice against scae_tpu's, on the same
flax-initialised parameters carried across by from_flax.py and the same
numpy batch, on the CPU (where the decoder likelihood takes K1's plain
version):

  * scae_tpu_torch.parallel.train_step.make_raw_eval_step against
    scae_tpu.parallel.train_step.make_raw_eval_step, every metric;
  * scae_tpu_torch.serve.make_infer_fn against scae_tpu.serve.make_infer_fn,
    every output;
  * the SCAE forward and loss against the torch-reference golden.

Tolerance 1e-5 relative and absolute on every metric and output (loss
terms are sums over pixels and examples: values of order 10^2-10^3 agree
to ~1e-7 relative). Also: the bridge loads strictly, and the entry points
refuse to run on the CPU unless asked.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu import serve as j_serve
from scae_tpu.factory import make_scae as j_make_scae
from scae_tpu.parallel import train_step as j_train_step
from scae_tpu.train import data as j_data
from scae_tpu.utils import torch_port
from scae_tpu_torch import serve as t_serve
from scae_tpu_torch.factory import make_scae as t_make_scae
from scae_tpu_torch.parallel import train_step as t_train_step
from scae_tpu_torch.train import data as t_data
from scae_tpu_torch.utils.from_flax import flax_to_state_dict, load_flax_params

torch.set_num_threads(1)
TOL = 1e-5
B = 4


def small_params(**scae):
    """The flagship's structure at test widths: 4 convs, alpha decoder with
    the fused likelihood, 3 SABs, capsule banks; 24x24 canvas, M=8, O=4,
    5x5 templates."""
    return dict(
        image_shape=(1, 24, 24), n_classes=10, n_part_caps=8, n_obj_caps=4,
        pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
        pcae_template_generator_params=dict(template_size=(5, 5)),
        ocae_encoder_set_transformer_params=dict(dim_hidden=8, dim_out=16),
        ocae_decoder_capsule_params=dict(dim_caps=8, hidden_sizes=(16,)),
        scae_params=dict(reconstruct_alternatives=False, **scae))


def build(**scae):
    mp = small_params(**scae)
    jm = j_make_scae(mp)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((2, 1, 24, 24)), deterministic=False))()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tm = t_make_scae(mp, device="cpu")
    load_flax_params(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return build()


def batch(seed=0, hw=20):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (B, hw, hw)).astype(np.uint8),
            rng.randint(0, 10, (B,)).astype(np.int32))


def close(got, want, tol=TOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=err_msg)


def test_bridge_loads_strictly(models):
    _, params, tm = models
    state = flax_to_state_dict(params)
    assert set(state) == set(tm.state_dict())
    for key, value in tm.state_dict().items():
        assert tuple(state[key].shape) == tuple(value.shape), key
    missing = dict(params)
    missing.pop("prior_classifier")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_params(t_make_scae(small_params(), device="cpu"), missing)
    extra = dict(params, stray={"kernel": np.zeros((2, 3), np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax_params(t_make_scae(small_params(), device="cpu"), extra)


def test_bridge_layouts(models):
    _, params, _ = models
    state = flax_to_state_dict(params)
    conv = params["part_encoder"]["encoder"]["network"]["conv_1"]["kernel"]
    np.testing.assert_array_equal(
        state["part_encoder.encoder.network.conv_1.weight"].numpy(),
        conv.transpose(3, 2, 0, 1))
    dense = params["obj_encoder"]["fc1"]["kernel"]
    np.testing.assert_array_equal(state["obj_encoder.fc1.weight"].numpy(),
                                  dense.T)
    bank = params["obj_decoder"]["capsule_layer"]["mlps"]["kernel_0"]
    np.testing.assert_array_equal(
        state["obj_decoder.capsule_layer.mlps.kernel_0"].numpy(), bank)
    ln = params["obj_encoder"]["sab_0"]["mab"]["ln0"]["scale"]
    np.testing.assert_array_equal(
        state["obj_encoder.sab_0.mab.ln0.weight"].numpy(), ln)


@pytest.mark.parametrize("canvas,hw", [(24, 20), (24, 28), (0, 24)])
def test_eval_step_matches(models, canvas, hw):
    jm, params, tm = models
    images, labels = batch(hw=hw)
    want = jax.jit(j_train_step.make_raw_eval_step(jm, canvas=canvas))(
        params, jnp.asarray(images), jnp.asarray(labels))
    got = t_train_step.make_raw_eval_step(tm, canvas=canvas, device="cpu")(
        images, labels)
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("scae", [
    dict(vote_type="soft", presence_type="soft"),
    dict(vote_type="hard", presence_type="hard",
         compat_posterior_cls_bug=True, compat_posterior_gate_bug=True,
         compat_double_softmax_xe=True, part_caps_sparsity_weight=0.1,
         recon_mse_weight=0.5, prior_sparsity_loss_type="kl",
         posterior_sparsity_loss_type="l2"),
])
def test_eval_step_matches_other_options(scae):
    jm, params, tm = build(**scae)
    images, labels = batch(seed=1)
    want = jax.jit(j_train_step.make_raw_eval_step(jm, canvas=24))(
        params, jnp.asarray(images), jnp.asarray(labels))
    got = t_train_step.make_raw_eval_step(tm, canvas=24, device="cpu")(
        images, labels)
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("with_reconstruction", [False, True])
def test_infer_matches(models, with_reconstruction):
    jm, params, tm = models
    image = np.random.RandomState(2).rand(B, 1, 24, 24).astype(np.float32)
    want = jax.jit(j_serve.make_infer_fn(jm, with_reconstruction))(
        params, jnp.asarray(image))
    got = t_serve.make_infer_fn(tm, with_reconstruction, device="cpu")(image)
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("entry,calls", [("eval", 1), ("infer", 0)])
def test_likelihood_computed_only_where_read(models, monkeypatch, entry,
                                             calls):
    """The eval step's loss reads the decoder likelihood once; the infer
    function reads none of it, so it never reaches K1."""
    from scae_tpu_torch.models import part_decoder

    _, _, tm = models
    seen = []

    def counting(*args):
        seen.append(args[0].shape)
        return k1_plain(*args)

    k1_plain = part_decoder.decoder_ll_gather
    monkeypatch.setattr(part_decoder, "decoder_ll_gather", counting)
    images, labels = batch(seed=4, hw=24)
    if entry == "eval":
        t_train_step.make_raw_eval_step(tm, device="cpu")(images, labels)
    else:
        t_serve.make_infer_fn(tm, with_reconstruction=True, device="cpu")(
            images[:, None].astype(np.float32) / 255.0)
    assert len(seen) == calls


def test_decode_and_pad_match():
    rng = np.random.RandomState(3)
    for shape in [(2, 9, 7), (2, 5, 6, 3), (2, 1, 5, 5)]:
        x = rng.randint(0, 256, shape).astype(np.uint8)
        want = j_train_step.decode_images(jnp.asarray(x))
        got = t_train_step.decode_images(torch.from_numpy(x))
        close(got, want)
        for canvas in (4, 8, 11):
            close(t_data.pad_to_canvas(got, canvas),
                  j_data.pad_to_canvas(want, canvas))


def test_scae_golden():
    """The whole port against the torch reference's golden (the JAX side
    of this check is tests/test_parity_golden.py::test_scae_*_golden),
    with that test's tolerances."""
    path = os.path.join(os.path.dirname(__file__), "golden", "scae.npz")
    data = dict(np.load(path))
    sd = {k[3:]: v for k, v in data.items() if k.startswith("sd/")}
    g = {k: v for k, v in data.items() if not k.startswith("sd/")}
    tm = t_make_scae(dict(
        image_shape=(1, 28, 28), n_classes=10, n_part_caps=8, n_obj_caps=6,
        pcae_cnn_encoder_params=dict(out_channels=[32] * 4),
        pcae_encoder_params=dict(noise_scale=0.0),
        ocae_decoder_capsule_params=dict(noise_type=None, noise_scale=0.0),
        scae_params=dict(reconstruct_alternatives=False,
                         compat_posterior_cls_bug=True,
                         compat_posterior_gate_bug=True,
                         compat_double_softmax_xe=True)), device="cpu")
    load_flax_params(tm, torch_port.port_scae(sd, n_obj_caps=6))
    img = torch.from_numpy(g["img"])
    with torch.no_grad():
        res = tm(img)
        loss, log = tm.loss(res, img, torch.from_numpy(g["label"]).long())
    close(res.part_pose, g["part_pose"])
    close(res.part_presence, g["part_presence"])
    close(res.obj.caps_presence, g["caps_presence"], 1e-4)
    close(res.obj.vote, g["vote"], 1e-3)
    close(res.obj.winner, g["winner"], 1e-3)
    close(res.obj.soft_winner, g["soft_winner"], 1e-3)
    close(res.prior_cls_prob, g["prior_cls_prob"])
    close(res.posterior_cls_prob, g["posterior_cls_prob"])
    np.testing.assert_allclose(float(loss), g["loss"], rtol=1e-3)
    for k, v in g.items():
        if k.startswith("log/"):
            np.testing.assert_allclose(float(log[k[4:]]), v, rtol=2e-3,
                                       atol=1e-4, err_msg=k)
    np.testing.assert_allclose(
        float(tm.calculate_accuracy(res, torch.from_numpy(g["label"]))),
        g["accuracy"])


def test_entry_points_default_to_cuda():
    """Without CUDA, every entry point refuses to run unless the caller
    asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_make_scae(small_params())
    tm = t_make_scae(small_params(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train_step.make_raw_eval_step(tm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.make_infer_fn(tm)
    from scae_tpu_torch.optim import make_optimizer

    state = t_train_step.TrainState(
        tm, make_optimizer(tm.parameters(), "rmsprop", 3e-5, batch_size=B))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train_step.make_raw_train_step(state)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train_step.make_fused_train_step(state)
    t_train_step.make_raw_train_step(state, device="cpu")


def test_entry_points_check_the_model_device():
    tm = t_make_scae(small_params(), device="cpu")
    with pytest.raises(ValueError, match="is on cpu"):
        t_train_step.make_raw_eval_step(tm, device="meta")


def test_seeded_init_is_reproducible():
    a = t_make_scae(small_params(), device="cpu", seed=3).state_dict()
    b = t_make_scae(small_params(), device="cpu", seed=3).state_dict()
    c = t_make_scae(small_params(), device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
