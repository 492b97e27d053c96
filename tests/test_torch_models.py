"""The port's modules (scae_tpu_torch/models, factory.py) against
scae_tpu's, with flax-initialised weights carried across by
scae_tpu_torch/utils/from_flax.py, and against the torch-reference goldens
of tests/golden through scae_tpu/utils/torch_port.py and the same bridge.

Weights are perturbed from their flax init so that the zero-initialised
ones (biases, alpha, cpr_static, ...) are exercised too. Tolerances: 1e-5
where tests/test_parity_golden.py uses it, and that file's own
tolerances for the goldens it checks with looser ones.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu import factory as j_factory
from scae_tpu.models import object_decoder as j_od
from scae_tpu.models import part_decoder as j_pd
from scae_tpu.models import part_encoder as j_pe
from scae_tpu.models import set_transformer as j_st
from scae_tpu.utils import torch_port
from scae_tpu_torch import factory as t_factory
from scae_tpu_torch.models import object_decoder as t_od
from scae_tpu_torch.models.layers import init_parameters
from scae_tpu_torch.models import part_decoder as t_pd
from scae_tpu_torch.models import part_encoder as t_pe
from scae_tpu_torch.models import set_transformer as t_st
from scae_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-5


def close(got, want, tol=TOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=err_msg)


def perturbed(params, seed, scale=0.1):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(p, np.float32)
        + scale * rng.randn(*np.shape(p)).astype(np.float32)
        for p in leaves])


def rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def golden(name):
    data = dict(np.load(os.path.join(GOLDEN, f"{name}.npz")))
    sd = {k[3:]: v for k, v in data.items() if k.startswith("sd/")}
    return {k: v for k, v in data.items() if not k.startswith("sd/")}, sd


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------------------ part encoder

def _encoders(S=5):
    cnn = dict(input_shape=(1, 24, 24), out_channels=(6, 7, 8, 9),
               kernel_sizes=(3, 3, 3, 3), strides=(2, 2, 1, 1))
    enc = dict(input_shape=(1, 24, 24), n_caps=4, n_poses=6,
               n_special_features=S, noise_scale=4.0)
    return (j_pe.CapsuleImageEncoder(encoder=j_pe.CNNEncoder(**cnn), **enc),
            t_pe.CapsuleImageEncoder(encoder=t_pe.CNNEncoder(**cnn), **enc))


@pytest.mark.parametrize("S", [5, 0])
def test_part_encoder_matches(S):
    jm, tm = _encoders(S)
    x = rand(3, 1, 24, 24)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
                       ["params"], 1)
    load_flax_params(tm, params)
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = tm(T(x))
    close(got.pose, want.pose)
    close(got.presence, want.presence)
    if S:
        close(got.feature, want.feature)
    else:
        assert got.feature is None and want.feature is None
    assert tm.encoder.output_shape == jm.encoder.output_shape


def test_part_encoder_noise_only_when_asked():
    _, tm = _encoders()
    init_parameters(tm, torch.Generator().manual_seed(0))
    x = T(rand(2, 1, 24, 24))
    a = tm(x).presence
    assert torch.equal(a, tm(x, deterministic=True).presence)
    noisy = tm(x, deterministic=False,
               generator=torch.Generator().manual_seed(1)).presence
    assert not torch.equal(a, noisy)


def test_part_encoder_golden():
    g, sd = golden("part_encoder")
    cnn = t_pe.CNNEncoder(input_shape=(1, 28, 28), out_channels=(32,) * 4,
                          kernel_sizes=(3,) * 4, strides=(2, 2, 1, 1))
    enc = t_pe.CapsuleImageEncoder(input_shape=(1, 28, 28), encoder=cnn,
                                   n_caps=8, n_poses=6, n_special_features=5,
                                   noise_scale=0.0)
    load_flax_params(enc, torch_port.port_capsule_image_encoder(sd))
    res = enc(T(g["img"]))
    close(res.pose, g["pose"])
    close(res.presence, g["presence"])
    close(res.feature, g["feature"], 1e-4)


# ------------------------------------------------------------ part decoder

@pytest.mark.parametrize("nonlin", ["sigmoid", "relu1"])
def test_template_generator_matches(nonlin):
    args = dict(n_templates=4, n_channels=2, template_size=(5, 5),
                template_nonlin=nonlin, dim_feature=3,
                colorize_templates=True, color_nonlin=nonlin)
    jm, tm = j_pd.TemplateGenerator(**args), t_pd.TemplateGenerator(**args)
    f = rand(3, 4, 3)
    params = perturbed(jm.init(jax.random.PRNGKey(0),
                               feature=jnp.asarray(f))["params"], 2)
    load_flax_params(tm, params)
    want = jm.apply({"params": params}, feature=jnp.asarray(f))
    got = tm(feature=T(f))
    close(got.raw_templates, want.raw_templates)
    close(got.templates, want.templates)


def test_template_init_is_qr_normalised():
    t = t_pd.qr_template_init(6, 1, (5, 5), torch.Generator().manual_seed(0))
    assert t.shape == (1, 6, 1, 5, 5)
    assert float(t.min()) == 0.0 and float(t.max()) == 1.0
    j = j_pd._qr_template_init(6, 1, (5, 5))[0](jax.random.PRNGKey(0))
    assert j.shape == t.shape


def _decoders(**kw):
    args = dict(n_templates=5, template_size=(4, 6), output_size=(10, 12),
                **kw)
    return (j_pd.TemplateBasedImageDecoder(fused_impl="xla", **args),
            t_pd.TemplateBasedImageDecoder(**args))


@pytest.mark.parametrize("with_presence", [True, False])
@pytest.mark.parametrize("learn_output_scale", [False, True])
def test_part_decoder_alpha_matches(with_presence, learn_output_scale):
    jm, tm = _decoders(use_alpha_channel=True,
                       learn_output_scale=learn_output_scale)
    rng = np.random.RandomState(3)
    templates = rand(2, 5, 1, 4, 6)
    pose = np.asarray(j_od.geometric_transform(
        jnp.asarray(rng.randn(2, 5, 6) * 0.5, jnp.float32)))
    presence, target = rand(2, 5, seed=4), rand(2, 1, 10, 12, seed=5)
    jargs = [jnp.asarray(a) for a in (templates, pose, presence)]
    params = perturbed(jm.init(jax.random.PRNGKey(0), *jargs,
                               target=jnp.asarray(target))["params"], 6)
    load_flax_params(tm, params)
    if not with_presence:  # every capsule fully present
        jargs[2], presence = None, None
    want = jm.apply({"params": params}, *jargs, target=jnp.asarray(target))
    got = tm(T(templates), T(pose), None if presence is None
             else T(presence), target=T(target))
    close(got.target_ll, want.target_ll)
    close(got.transformed_templates, want.transformed_templates)
    close(got.mixing_logits, want.mixing_logits)
    close(got.pdf.mode(), want.pdf.mode())
    close(got.pdf.log_prob(T(target)), want.pdf.log_prob(jnp.asarray(target)))


@pytest.mark.parametrize("use_alpha_channel", [True, False])
def test_part_decoder_result_freed_without_gc(use_alpha_channel):
    # the result's lazy likelihood and components must not form a
    # reference cycle, or each eval step's tensors outlive the step
    import gc
    import weakref

    _, tm = _decoders(use_alpha_channel=use_alpha_channel)
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
    pose = T(np.tile([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], (2, 5, 1)))
    gc.disable()
    try:
        res = tm(T(rand(2, 5, 1, 4, 6)), pose, T(rand(2, 5, seed=1)),
                 target=T(rand(2, 1, 10, 12, seed=2)))
        assert torch.isfinite(res.target_ll).all()
        res.pdf.mode()
        ref = weakref.ref(res)
        del res
        assert ref() is None
    finally:
        gc.enable()


def test_part_decoder_temperature_matches():
    jm, tm = _decoders(use_alpha_channel=False)
    templates, target = rand(2, 5, 1, 4, 6), rand(2, 1, 10, 12, seed=1)
    pose = np.asarray(j_od.geometric_transform(jnp.asarray(
        np.random.RandomState(2).randn(2, 5, 6) * 0.5, jnp.float32)))
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(templates),
                               jnp.asarray(pose))["params"], 7)
    load_flax_params(tm, params)
    want = jm.apply({"params": params}, jnp.asarray(templates),
                    jnp.asarray(pose), target=jnp.asarray(target))
    got = tm(T(templates), T(pose), target=T(target))
    close(got.target_ll, want.target_ll)
    close(got.mixing_logits, want.mixing_logits)


@pytest.mark.parametrize("name,C", [("part_decoder", 1),
                                    ("part_decoder_color", 3)])
def test_part_decoder_golden(name, C):
    g, sd = golden(name)
    gen = t_pd.TemplateGenerator(n_templates=6, n_channels=C,
                                 template_size=(5, 5),
                                 template_nonlin="sigmoid", dim_feature=5,
                                 colorize_templates=True,
                                 color_nonlin="sigmoid")
    dec = t_pd.TemplateBasedImageDecoder(n_templates=6, template_size=(5, 5),
                                         output_size=(12, 12),
                                         learn_output_scale=True,
                                         use_alpha_channel=True)
    load_flax_params(gen, torch_port.port_template_generator(
        {k[4:]: v for k, v in sd.items() if k.startswith("gen.")}))
    load_flax_params(dec, torch_port.port_template_decoder(
        {k[4:]: v for k, v in sd.items() if k.startswith("dec.")}))
    tres = gen(feature=T(g["feature"]))
    close(tres.raw_templates, g["raw_templates"])
    close(tres.templates, g["templates"])
    dres = dec(tres.templates, T(g["pose"]), T(g["presence"]),
               target=T(g["target"]))
    close(dres.transformed_templates, g["transformed_templates"])
    want_mix = g["mixing_logits"]
    close(np.broadcast_to(dres.mixing_logits.detach().numpy(),
                          want_mix.shape), want_mix, 1e-4)
    # the fused likelihood (K1's plain version) against the reference's
    # unfused mixture log-density
    close(dres.target_ll, g["ll"], 1e-4)
    close(dres.pdf.mode(), g["mode"])


# F1: which likelihood route fused_impl="auto" takes, by template size.
# Above TBL_MAX (256) texels the reference's auto takes "xla"
# (scae_tpu/models/part_decoder.py), fused_decoder_ll with the decoder's
# fused_tap_dtype, whose tap slope is 0 at a texel centre; the gather
# route's one-sided slopes would give a zero-pose capsule (every source
# coordinate on the template's centre texel) another pose gradient.
# Tolerances: float32 taps, values 2e-5 absolute and every gradient within
# 1e-4 of its largest |entry| (the same f32 sums in another order);
# bfloat16 taps, values 5e-2 absolute and gradients within 2e-2 of their
# largest |entry|, the bars of tests/test_torch_decoder_ll_dense.py.

def _f1_case(template_size, fused_tap_dtype, seed=0):
    """A JAX decoder on "xla" and the port's on "auto", the same perturbed
    flax weights, inputs from numpy with capsule 0 of every example at the
    zero pose."""
    B, M, C, (H, W) = 2, 4, 1, (20, 20)
    Ht, Wt = template_size
    kw = dict(n_templates=M, template_size=template_size, output_size=(H, W),
              use_alpha_channel=True, learn_output_scale=True,
              use_fused_ll=True, fused_tap_dtype=fused_tap_dtype)
    jd = j_pd.TemplateBasedImageDecoder(fused_impl="xla", **kw)
    td = t_pd.TemplateBasedImageDecoder(fused_impl="auto", **kw)
    rng = np.random.RandomState(seed)
    pose = np.array(j_od.geometric_transform(
        jnp.asarray(rng.randn(B, M, 6) * 0.5, jnp.float32)))
    pose[:, 0] = 0.0                          # the zero pose
    arrays = [rand(B, M, C, Ht, Wt, seed=seed + 1), pose,
              rand(B, M, seed=seed + 2), rand(B, C, H, W, seed=seed + 3)]
    params = perturbed(jd.init(jax.random.PRNGKey(0), *map(
        jnp.asarray, arrays[:3]), target=jnp.asarray(arrays[3]))["params"],
        seed + 4)
    load_flax_params(td, params)
    return jd, td, params, arrays


@pytest.mark.parametrize("fused_tap_dtype,val_tol,grad_tol", [
    ("float32", 2e-5, 1e-4), ("bfloat16", 5e-2, 2e-2)])
def test_auto_above_256_texels_takes_xla_as_the_reference(
        fused_tap_dtype, val_tol, grad_tol):
    jd, td, params, arrays = _f1_case((17, 17), fused_tap_dtype)
    cot = np.cos(np.arange(arrays[3].size, dtype=np.float32)).reshape(
        arrays[3].shape)

    def j_loss(p, *a):
        ll = jd.apply({"params": p}, *a[:3], target=a[3]).target_ll
        return jnp.sum(ll * cot), ll

    (j_gp, *j_ga), want = jax.jit(jax.grad(
        j_loss, argnums=tuple(range(5)), has_aux=True))(
        params, *map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    ll = td(*leaves[:3], target=leaves[3]).target_ll
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(want),
                               rtol=0, atol=val_tol)
    (ll * torch.from_numpy(cot)).sum().backward()
    got = {n: p.grad for n, p in td.named_parameters()}
    want_grads = {n: np.asarray(j_gp[n]) for n in got}
    assert sorted(got) == ["bg_mixing_logit", "bg_value", "scale",
                           "templates_alpha"]
    for name, leaf, ref in zip(("templates", "pose", "presence", "target"),
                               leaves, j_ga):
        got[name], want_grads[name] = leaf.grad, np.asarray(ref)
    assert len(got) == 8
    for name, g in got.items():
        ref = want_grads[name]
        scale = max(float(np.abs(ref).max()), 1.0 if ref.size == 1 else 0.0)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= grad_tol * scale, (name, err, scale)


@pytest.mark.parametrize("template_size,route", [((11, 11), "gather"),
                                                 ((16, 16), "gather"),
                                                 ((17, 17), "xla")])
def test_auto_route_by_template_size(monkeypatch, template_size, route):
    """"auto" calls the gather wrapper up to 256 texels and the plain
    fused_decoder_ll above, and never the dense wrapper."""
    calls = []
    for name in ("decoder_ll_gather", "fused_decoder_ll", "decoder_ll_dense"):
        def spy(*a, _name=name, _fn=getattr(t_pd, name)):
            calls.append(_name)
            return _fn(*a)
        monkeypatch.setattr(t_pd, name, spy)
    assert t_pd.gather_supports(template_size) == (route == "gather")
    _, td, _, arrays = _f1_case(template_size, "float32")
    ll = td(*map(T, arrays[:3]), target=T(arrays[3])).target_ll
    assert bool(torch.isfinite(ll).all())
    assert calls == ["decoder_ll_gather" if route == "gather"
                     else "fused_decoder_ll"]


# --------------------------------------------------------- set transformer

@pytest.mark.parametrize("layer_norm,n_heads,inducing", [
    (True, 1, None), (False, 2, None), (True, 2, 3)])
def test_set_transformer_matches(layer_norm, n_heads, inducing):
    args = dict(dim_in=11, dim_hidden=7, dim_out=9, n_outputs=4,
                n_layers=2, n_heads=n_heads, layer_norm=layer_norm,
                n_inducing_points=inducing)
    jm, tm = j_st.SetTransformer(**args), t_st.SetTransformer(**args)
    x = rand(3, 6, 11)
    pres = rand(3, 6, seed=1)
    pres[0, 2] = 0.0
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(pres))["params"], 8)
    load_flax_params(tm, params)
    close(tm(T(x), T(pres)),
          jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(pres)))
    close(tm(T(x)), jm.apply({"params": params}, jnp.asarray(x)))


def test_pma_matches():
    jm, tm = j_st.PMA(d=6, n_heads=2, n_seeds=3, layer_norm=True), \
        t_st.PMA(d=6, n_heads=2, n_seeds=3, layer_norm=True)
    x = rand(2, 5, 6)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
                       ["params"], 9)
    load_flax_params(tm, params)
    close(tm(T(x)), jm.apply({"params": params}, jnp.asarray(x)))


def test_set_transformer_golden():
    g, sd = golden("set_transformer")
    st = t_st.SetTransformer(dim_in=23, dim_hidden=16, dim_out=24,
                             n_outputs=5, n_layers=3, n_heads=2,
                             layer_norm=True)
    load_flax_params(st, torch_port.port_set_transformer(sd))
    close(st(T(g["x"]), T(g["presence"])), g["out"], 1e-4)
    close(st(T(g["x"])), g["out_nopres"], 1e-4)


# ---------------------------------------------------------- object decoder

_OD_FIELDS = [f.name for f in dataclasses.fields(t_od.ObjectDecoderResult)]


def _object_decoders(**kw):
    args = dict(n_caps=4, dim_feature=9, n_votes=5, dim_caps=6,
                hidden_sizes=(8,), learn_vote_scale=True, **kw)
    return (j_od.CapsuleObjectDecoder(capsule_layer=j_od.CapsuleLayer(**args)),
            t_od.CapsuleObjectDecoder(capsule_layer=t_od.CapsuleLayer(**args)))


@pytest.mark.parametrize("similarity", [False, True])
def test_object_decoder_matches(similarity):
    jm, tm = _object_decoders(similarity_transform=similarity,
                              noise_type="uniform", noise_scale=4.0)
    enc = rand(3, 4, 9) - 0.5
    pose = np.asarray(j_od.geometric_transform(jnp.asarray(
        np.random.RandomState(1).randn(3, 5, 6), jnp.float32)))
    pres = rand(3, 5, seed=2)
    jargs = [jnp.asarray(a) for a in (enc, pose, pres)]
    params = perturbed(jm.init(jax.random.PRNGKey(0), *jargs)["params"], 10)
    load_flax_params(tm, params)
    want = jm.apply({"params": params}, *jargs, deterministic=True)
    got = tm(T(enc), T(pose), T(pres), deterministic=True)
    for name in _OD_FIELDS:
        close(getattr(got, name), getattr(want, name), err_msg=name)


def test_object_decoder_golden():
    g, sd = golden("object_decoder")
    layer = t_od.CapsuleLayer(n_caps=5, dim_feature=24, n_votes=6,
                              dim_caps=8, hidden_sizes=(16,),
                              learn_vote_scale=True, allow_deformations=True,
                              noise_type=None, noise_scale=0.0,
                              similarity_transform=False)
    dec = t_od.CapsuleObjectDecoder(capsule_layer=layer)
    load_flax_params(dec, torch_port.port_capsule_object_decoder(sd, n_caps=5))
    res = dec(T(g["enc"]), T(g["pose"]), T(g["presence"]))
    close(res.vote, g["vote"], 1e-4)
    close(res.scale, g["scale"])
    close(res.vote_presence, g["vote_presence"])
    close(res.caps_presence, g["caps_presence"])
    close(res.log_prob, g["log_prob"], 1e-4)
    close(res.winner, g["winner"], 1e-4)
    close(res.winner_presence, g["winner_presence"])
    close(res.soft_winner, g["soft_winner"], 1e-4)
    close(res.soft_winner_presence, g["soft_winner_presence"])
    close(res.posterior_mixing_prob, g["posterior_mixing_prob"])
    close(res.mixing_logit, g["mixing_logit"], 1e-4)
    close(res.cpr_dynamic_reg_loss, g["cpr_dynamic_reg_loss"], 1e-4)


@pytest.mark.parametrize("kind", ["l2", "entropy", "kl"])
def test_sparsity_losses_match(kind):
    p = rand(6, 4, seed=3)
    for a, b in zip(t_od.sparsity_loss(kind, T(p), n_classes=3),
                    j_od.sparsity_loss(kind, jnp.asarray(p), n_classes=3)):
        close(a, b)
    with pytest.raises(ValueError):
        t_od.sparsity_loss("l1", T(p), n_classes=3)


# ----------------------------------------------------------------- factory

def test_model_config_matches():
    kw = dict(image_shape=(1, 40, 40), n_classes=10, n_part_caps=40,
              n_obj_caps=32,
              pcae_template_generator_params=dict(template_size=[9, 7]),
              scae_params=dict(reconstruct_alternatives=False))
    assert dataclasses.asdict(t_factory.prepare_model_config(**kw)) == \
        dataclasses.asdict(j_factory.prepare_model_config(**kw))
    flagship = t_factory.prepare_model_config(**t_factory.FLAGSHIP_MODEL_PARAMS)
    assert flagship.ocae_encoder_set_transformer.dim_in == 6 + 16 + 1 + 121
    assert flagship.pcae_decoder.fused_impl == "auto"
    with pytest.raises(ValueError, match="derived"):
        t_factory.prepare_model_config(
            **dict(kw, pcae_decoder_params=dict(n_templates=3)))
    with pytest.raises(TypeError, match="unknown config key"):
        t_factory.prepare_model_config(
            **dict(kw, scae_params=dict(not_a_key=1)))


def test_unported_options_raise():
    # reconstruct_alternatives is ported: the factory's default (True)
    # builds, as it does in the JAX package
    model = t_factory.make_scae(dict(t_factory.FLAGSHIP_MODEL_PARAMS,
                                     scae_params={}), device="cpu")
    assert model.reconstruct_alternatives is True
    # the banded kernels (K5) are ported: the decoder builds with them, and
    # the factory passes the value through
    decoder = t_pd.TemplateBasedImageDecoder(4, (5, 5), (8, 8),
                                             fused_impl="pallas_banded")
    assert decoder.fused_impl == "pallas_banded"
    model = t_factory.make_scae(dict(
        t_factory.FLAGSHIP_MODEL_PARAMS,
        pcae_decoder_params=dict(fused_impl="pallas_banded")), device="cpu")
    assert model.part_decoder.fused_impl == "pallas_banded"
    with pytest.raises(ValueError, match="unknown fused_impl"):
        t_pd.TemplateBasedImageDecoder(4, (5, 5), (8, 8), fused_impl="mxu")
    for impl in ("auto", "gather", "pallas", "xla"):
        t_pd.TemplateBasedImageDecoder(4, (5, 5), (8, 8), fused_impl=impl)
    # bfloat16 taps, as the shipped mnist and cifar10 configs set them
    model = t_factory.make_scae(dict(
        t_factory.FLAGSHIP_MODEL_PARAMS,
        pcae_decoder_params=dict(fused_tap_dtype="bfloat16",
                                 fused_impl="xla")), device="cpu")
    assert model.part_decoder.fused_tap_dtype == torch.bfloat16


def test_cifar10_params_match_shipped_yaml():
    """The port's CIFAR10_MODEL_PARAMS build the model that
    scae_tpu/configs/model/cifar10.yaml builds in the JAX package, on every
    field the port reads for it."""
    from scae_tpu.config import load_config

    yaml_params = load_config("config", ["model=cifar10"])["model"]
    want = dataclasses.asdict(j_factory.prepare_model_config(**yaml_params))
    got = dataclasses.asdict(t_factory.prepare_model_config(
        **t_factory.CIFAR10_MODEL_PARAMS))
    assert got == want
    assert (got["n_part_caps"], got["image_shape"]) == (64, (3, 32, 32))
