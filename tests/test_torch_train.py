"""The port's training slice against scae_tpu's, on the CPU (where the
decoder likelihood and its backward take their plain versions):

  * one train step of ``make_raw_train_step`` against scae_tpu's, from the
    same flax-initialised weights carried across by from_flax.py, with the
    noise configured off, through the gather likelihood and through the
    dense one (``fused_impl="pallas"``): the loss, every term, the accuracy
    and every parameter's gradient; then the RMSprop update from identical
    gradients;
  * ``make_fused_train_step`` against ``make_raw_train_step``;
  * ``random_translate`` and ``random_affine`` fed JAX's own draws, and the
    augment and centre-pad functions;
  * six steps from the torch reference's initial weights against its
    per-step losses (tests/golden/train_trajectory.npz);
  * with noise on: a seed reproduces a step, another seed changes it.

Tolerances:
  * loss terms and accuracy: 1e-5 relative and absolute, as the eval step
    (tests/test_torch_slice.py);
  * gradients: 1e-4 of each parameter's largest |gradient|, and 1e-6
    absolute: a gradient sums f32 products over the batch and the pixels
    in another order in the two frameworks, and a few parameters (the
    posterior head, the capsule biases of empty capsules) have gradients
    within rounding of 0;
  * the RMSprop update from identical gradients: 1e-6 absolute, a few f32
    ulps of the learning rate 3e-5 times at most 10 (the first step's
    g / sqrt((1 - 0.99) g^2));
  * translation exact, rotation and zoom 1e-5 absolute;
  * the trajectory golden: per-step losses within 2e-3 relative, the JAX
    test's tolerance (tests/test_parity_golden.py::test_train_trajectory_golden).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu.factory import make_scae as j_make_scae
from scae_tpu.optim import make_optimizer as j_make_optimizer
from scae_tpu.parallel import train_step as j_train_step
from scae_tpu.train import data as j_data
from scae_tpu.utils import torch_port
from scae_tpu_torch.factory import make_scae as t_make_scae
from scae_tpu_torch.optim import RMSprop, make_optimizer
from scae_tpu_torch.parallel import train_step as t_train_step
from scae_tpu_torch.train import data as t_data
from scae_tpu_torch.train import loop as t_loop
from scae_tpu_torch.utils.from_flax import flax_to_state_dict, load_flax_params

torch.set_num_threads(1)
B = 4
LR = 3e-5
NOISE_OFF = dict(pcae_encoder_params=dict(noise_scale=0.0),
                 ocae_decoder_capsule_params=dict(
                     noise_type=None, noise_scale=0.0, dim_caps=8,
                     hidden_sizes=(16,)))


def small_params(noise=False):
    """The flagship's structure at test widths: 24x24 canvas, M=8, O=4, 5x5
    templates, alpha decoder with the fused likelihood."""
    caps = dict(dim_caps=8, hidden_sizes=(16,))
    extra = dict(ocae_decoder_capsule_params=caps) if noise else NOISE_OFF
    return dict(
        image_shape=(1, 24, 24), n_classes=10, n_part_caps=8, n_obj_caps=4,
        pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
        pcae_template_generator_params=dict(template_size=(5, 5)),
        ocae_encoder_set_transformer_params=dict(dim_hidden=8, dim_out=16),
        scae_params=dict(reconstruct_alternatives=False), **extra)


@pytest.fixture(scope="module")
def bridged():
    mp = small_params()
    jm = j_make_scae(mp)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((2, 1, 24, 24)), deterministic=False))()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return mp, jm, params


def port_state(mp, params=None, seed=0, optimizer="rmsprop", **opt):
    tm = t_make_scae(mp, device="cpu", seed=seed)
    if params is not None:
        load_flax_params(tm, params)
    tx = make_optimizer(tm.parameters(), optimizer, LR, batch_size=B,
                        **opt)
    return t_train_step.TrainState(tm, tx, seed=seed)


def batch(seed=0, hw=24):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (B, hw, hw)).astype(np.uint8),
            rng.randint(0, 10, (B,)).astype(np.int32))


class Recording(RMSprop):
    """RMSprop that keeps the gradients of its last step."""

    def step(self, grads=None):
        self.grads = [torch.zeros_like(p) if g is None else g.clone()
                      for p, g in zip(self.params, grads)]
        super().step(grads)


@pytest.mark.parametrize("fused_impl", ["auto", "pallas"])
def test_train_step_matches(bridged, fused_impl):
    """The port's decoder likelihood through the gather path ("auto") or
    the dense one ("pallas"; K4's plain version on the CPU) against the JAX
    step, whose CPU path is the f32 XLA likelihood."""
    mp, jm, params = bridged
    images, labels = batch()

    tx = j_make_optimizer("rmsprop", LR, batch_size=B, momentum=0.9)
    state = j_train_step.TrainState(step=jnp.zeros([], jnp.int32),
                                    params=params, opt_state=tx.init(params),
                                    rng=jax.random.PRNGKey(0))
    _, want = jax.jit(j_train_step.make_raw_train_step(jm, tx))(
        state, jnp.asarray(images), jnp.asarray(labels))

    def lf(p):
        res = jm.apply({"params": p}, j_train_step.decode_images(
            jnp.asarray(images)), deterministic=False,
            rngs={"noise": jax.random.PRNGKey(1)})
        return jm.loss(res, j_train_step.decode_images(jnp.asarray(images)),
                       jnp.asarray(labels))[0]

    j_grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(lf))(params)))

    tm = t_make_scae(dict(mp, pcae_decoder_params=dict(
        fused_impl=fused_impl)), device="cpu")
    load_flax_params(tm, params)
    rec = Recording(tm.parameters(), LR, decay=0.99,
                    eps=1e-2 / B ** 2, momentum=0.9)
    got = t_train_step.make_raw_train_step(
        t_train_step.TrainState(tm, rec), device="cpu")(images, labels)

    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(j_grads)
    for name, g in zip(names, rec.grads):
        ref = np.asarray(j_grads[name])
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale + 1e-6, err_msg=name)


def test_rmsprop_update_from_identical_gradients(bridged):
    """optax's first RMSprop update and the port's, from the same
    gradients: nearly sign(g) for |g| well above eps, so an update is
    compared only where both sides start from the same gradient."""
    mp, _, params = bridged
    rng = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(
        lambda p: (rng.randn(*p.shape) * 1e-3).astype(np.float32), params)
    tx = j_make_optimizer("rmsprop", LR, batch_size=B, momentum=0.9)
    j_state = tx.init(params)
    want = params
    for _ in range(2):
        upd, j_state = tx.update(grads, j_state, want)
        want = jax.tree_util.tree_map(lambda p, u: p + u, want, upd)
    want = flax_to_state_dict(want)

    state = port_state(mp, params)
    tm = state.model
    by_name = flax_to_state_dict(grads)
    for _ in range(2):
        state.optimizer.step([torch.from_numpy(np.array(by_name[n]))
                              for n, _ in tm.named_parameters()])
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_fused_step_matches_raw_step():
    mp = small_params(noise=True)
    rng = np.random.RandomState(2)
    data = {"image": torch.from_numpy(
                rng.randint(0, 256, (10, 20, 20)).astype(np.uint8)),
            "label": torch.from_numpy(rng.randint(0, 10, (10,)))}
    augment = t_loop.make_augment_fn(canvas=24, max_shift=2)
    raw = port_state(mp, seed=3)
    fused = port_state(mp, seed=3)
    raw_step = t_train_step.make_raw_train_step(raw, augment, device="cpu")
    fused_step = t_train_step.make_fused_train_step(fused, augment,
                                                    device="cpu")
    for idx in ([0, 3, 5, 9], [1, 1, 2, 8]):
        want = raw_step(data["image"][idx], data["label"][idx])
        got = fused_step(data, np.asarray(idx, np.int32))
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert raw.step == fused.step == 2
    for (name, a), b in zip(raw.model.named_parameters(),
                            fused.model.parameters()):
        assert torch.equal(a, b), name


def test_noisy_step_reproduces_from_its_seed():
    mp = small_params(noise=True)
    images, labels = batch(seed=5, hw=20)
    augment = t_loop.make_augment_fn(canvas=24, max_shift=3)

    def first_losses(seed, model_params=mp):
        state = port_state(model_params, seed=0)
        state.seed = seed
        step = t_train_step.make_raw_train_step(state, augment, device="cpu")
        return [float(step(images, labels)["loss"]) for _ in range(2)]

    a = first_losses(7)
    assert a == first_losses(7)
    assert a != first_losses(8)
    assert a != first_losses(7, small_params(noise=False))
    assert all(np.isfinite(a))


def test_train_trajectory_golden():
    """Six RMSprop steps (noise off, lr 1e-4, eps 1e-2/B^2) from the torch
    reference's initial weights track its per-step losses."""
    data = dict(np.load(os.path.join(os.path.dirname(__file__), "golden",
                                     "train_trajectory.npz")))
    init_sd = {k[8:]: v for k, v in data.items() if k.startswith("init_sd/")}
    imgs, labels = data["imgs"], data["labels"]
    n_steps, batch_size = labels.shape
    tm = t_make_scae(dict(
        image_shape=(1, 28, 28), n_classes=10, n_part_caps=8, n_obj_caps=6,
        pcae_cnn_encoder_params=dict(out_channels=[32] * 4),
        pcae_encoder_params=dict(noise_scale=0.0),
        ocae_decoder_capsule_params=dict(noise_type=None, noise_scale=0.0),
        scae_params=dict(reconstruct_alternatives=False,
                         compat_posterior_cls_bug=True,
                         compat_posterior_gate_bug=True,
                         compat_double_softmax_xe=True)), device="cpu")
    load_flax_params(tm, torch_port.port_scae(init_sd, n_obj_caps=6))
    state = t_train_step.TrainState(tm, make_optimizer(
        tm.parameters(), "rmsprop", 1e-4, batch_size=batch_size,
        momentum=0.9))
    step = t_train_step.make_raw_train_step(state, device="cpu")
    losses = [float(step(imgs[t], labels[t])["loss"])
              for t in range(n_steps)]
    np.testing.assert_allclose(losses, data["losses"], rtol=2e-3)


# ------------------------------------------------------------ augmentation

def test_random_translate_matches_jax_draws():
    rng = np.random.RandomState(4)
    images = rng.rand(5, 2, 9, 11).astype(np.float32)
    for max_shift, seed in ((3, 0), (6, 1)):
        key = jax.random.PRNGKey(seed)
        want = j_data.random_translate(jnp.asarray(images), key, max_shift)
        kx, ky = jax.random.split(key)
        ox = jax.random.randint(kx, (5,), 0, 2 * max_shift + 1)
        oy = jax.random.randint(ky, (5,), 0, 2 * max_shift + 1)
        got = t_data.translate(torch.from_numpy(images),
                               torch.from_numpy(np.asarray(ox, np.int64)),
                               torch.from_numpy(np.asarray(oy, np.int64)),
                               max_shift)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("degrees,scale_jitter", [(15.0, 0.0), (0.0, 0.2),
                                                  (30.0, 0.1)])
def test_random_affine_matches_jax_draws(degrees, scale_jitter):
    images = np.random.RandomState(5).rand(4, 1, 12, 12).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = j_data.random_affine(jnp.asarray(images), key, degrees,
                                scale_jitter)
    k_th, k_sc = jax.random.split(key)
    theta = jax.random.uniform(k_th, (4,), jnp.float32, -degrees,
                               degrees) * (jnp.pi / 180.0)
    s = jax.random.uniform(k_sc, (4,), jnp.float32, 1.0 - scale_jitter,
                           1.0 + scale_jitter)
    got = t_data.rotate_scale(torch.from_numpy(images),
                              torch.from_numpy(np.array(theta)),
                              torch.from_numpy(np.array(s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_draws_are_in_range_and_follow_the_generator():
    g = torch.Generator().manual_seed(0)
    ox, oy = t_data.draw_translation(1000, 6, g)
    for o in (ox, oy):
        assert int(o.min()) == 0 and int(o.max()) == 12
    theta, s = t_data.draw_affine(1000, 30.0, 0.1, g)
    assert float(theta.abs().max()) <= np.pi / 6
    assert float((s - 1).abs().max()) <= 0.1
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(t_data.draw_translation(1000, 6, g2)[0], ox)


def test_augment_fn_composes_pad_affine_translate():
    rng = np.random.RandomState(6)
    images = torch.from_numpy(rng.rand(3, 1, 20, 20).astype(np.float32))
    labels = torch.arange(3)
    augment = t_loop.make_augment_fn(canvas=24, max_shift=2, degrees=10.0,
                                     scale_jitter=0.1)
    got = augment({"image": images, "label": labels},
                  torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    want = t_data.pad_to_canvas(images, 24)
    want = t_data.random_affine(want, g, 10.0, 0.1)
    want = t_data.random_translate(want, g, 2)
    assert torch.equal(got["image"], want)
    assert got["label"] is labels
    plain = t_loop.make_augment_fn(canvas=24, max_shift=0)(
        {"image": images}, torch.Generator())
    pad = t_loop.make_center_pad_fn(24)({"image": images})
    assert torch.equal(plain["image"], pad["image"])
    assert torch.equal(pad["image"], t_data.pad_to_canvas(images, 24))
    same = t_loop.make_center_pad_fn(20)({"image": images})
    assert same["image"] is images
