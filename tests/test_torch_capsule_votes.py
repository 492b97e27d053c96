"""The object capsules' vote head (``kernels/capsule_votes.py``): the custom
op ``scae_tpu_torch::capsule_votes_fwd``, its plain version, and the CUDA
kernels V1f and V1b.

On the CPU:

  * ``CapsuleLayer`` through the op against the layer's code before the op
    (``old_forward`` below, kept as the reference), at the mnist40 (O 32,
    V 40) and cifar10 (V 64) widths, deterministic and with both noise
    types, and with capsule dropout, without deformations, without a learnt
    scale and with similarity transforms: the six outputs and the gradients
    of all_param, cpr_static and caps_bias_* bit for bit (the op's CPU
    kernel is that code, its backward autograd's formulas), and the
    generator left in the same state (the same draws, in the same order);
  * a float64 model of V1b's formulas, as ``csrc/capsule_votes.cu`` writes
    them (rows, then columns), against autograd of the plain version;
  * ``torch.library.opcheck`` of the op, the backward op's fake
    implementation, the launch checks' refusals, and a CPU serving artifact
    that lists the op and loads and runs.

On the card (``-m gpu``; every test skips without one): V1f and V1b against
the plain version at both cells' shapes, deterministic and noisy, in both
layouts of all_param; both bit for bit on repeat; the launch counters; the
refusals; the build's register and shared-memory report; a captured
flagship train step, eval step and serving call through them.

    python -m pytest --noconftest -m gpu tests/test_torch_capsule_votes.py

Tolerances on the card: the forward 1e-5 relative and 1e-6 absolute (the
same float32 formulas, no fused multiply-adds, rounded as PyTorch rounds
them; only the regulariser's sum adds in another order); the backward 1e-5
of each gradient's largest entry (sums over the votes and over B taken in
another order than autograd's).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scae_tpu_torch.kernels import capsule_likelihood as cl
from scae_tpu_torch.kernels import capsule_votes as cv
from scae_tpu_torch.models.object_decoder import CapsuleLayer
from scae_tpu_torch.ops.geometry import (
    affine_to_matrix,
    compose_affines,
    geometric_transform,
)
from scae_tpu_torch.ops.math_ops import l2_loss, log_safe
from scae_tpu_torch.utils import trace

SHAPES = {"mnist40": (32, 40), "cifar10": (32, 64)}    # (O, V)
VARIANTS = {
    "plain": {},
    "dropout": dict(caps_dropout_rate=0.5),
    "rigid": dict(allow_deformations=False),
    "unit scale": dict(learn_vote_scale=False),
    "similarity": dict(similarity_transform=True),
}


def make_layer(O, V, seed=0, **kw):
    torch.manual_seed(seed)
    layer = CapsuleLayer(n_caps=O, dim_feature=16, n_votes=V, dim_caps=32,
                         hidden_sizes=(128,), **kw)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            # the own parameters away from 0, the banks at a scale that
            # spreads all_param over a few units
            scale = 0.5 if name.startswith(("cpr", "caps_bias")) else 0.3
            p.copy_(torch.randn(p.shape) * scale)
    return layer


def old_forward(layer, feature, deterministic=True, generator=None,
                parent_transform=None, parent_presence=None):
    """``CapsuleLayer.forward`` as it was before the op, for a layer that
    holds all its capsules (its mesh calls are the identity without a
    mesh), returning its result and all_param."""
    B = feature.shape[0]
    O = layer.n_caps
    raw_caps_param = layer.mlps(feature)
    caps_exist = None
    if layer.caps_dropout_rate == 0.0:
        own_exist = torch.ones_like(raw_caps_param[..., :1])
    else:
        keep = torch.full((B, O, 1), 1.0 - layer.caps_dropout_rate,
                          dtype=raw_caps_param.dtype,
                          device=raw_caps_param.device)
        caps_exist = torch.bernoulli(keep, generator=generator)
        own_exist = caps_exist
    caps_param = torch.cat([raw_caps_param, own_exist], dim=-1)
    all_param = layer.caps_mlps(caps_param)
    all_param.retain_grad()
    cpr_static = layer.cpr_static
    caps_bias = [getattr(layer, f"caps_bias_{i}") for i in range(4)]

    chunks = [c.reshape(B, O, *s) for c, s in zip(
        torch.split(all_param, layer.splits, dim=-1), layer.output_shapes)]

    def transform(params):
        return geometric_transform(params, layer.similarity_transform,
                                   nonlinear=True, as_matrix=False)

    cpr_dynamic = chunks[0]
    if not layer.allow_deformations:
        cpr_dynamic = torch.zeros_like(cpr_dynamic)
    cpr_dynamic_reg_loss = l2_loss(cpr_dynamic) / B
    cpr = transform(cpr_dynamic + cpr_static)

    cvr = chunks[1] + caps_bias[0]
    presence_logit_per_caps = chunks[2] + caps_bias[1]
    presence_logit_per_vote = chunks[3] + caps_bias[2]
    scale_per_vote = chunks[4] + caps_bias[3]
    if parent_transform is None:
        cvr = transform(cvr)
    else:
        cvr = parent_transform[..., :2, :].reshape(
            *parent_transform.shape[:-2], 6)
    vote = affine_to_matrix(compose_affines(cvr, cpr))

    if caps_exist is not None:
        presence_logit_per_caps = (presence_logit_per_caps
                                   + log_safe(caps_exist))

    def add_noise(t):
        if deterministic or not layer.noise_type:
            return t
        u = torch.rand(t.shape, generator=generator, dtype=t.dtype,
                       device=t.device)
        if layer.noise_type == "uniform":
            return t + (u - 0.5) * layer.noise_scale
        u = u.clamp(1e-7, 1 - 1e-7)
        return t + torch.log(u / (1 - u)) * layer.noise_scale

    presence_logit_per_caps = add_noise(presence_logit_per_caps)
    presence_logit_per_vote = add_noise(presence_logit_per_vote)

    presence_per_caps = torch.sigmoid(presence_logit_per_caps) \
        if parent_presence is None else parent_presence
    vote_presence = (presence_per_caps
                     * torch.sigmoid(presence_logit_per_vote))
    if layer.learn_vote_scale:
        scale_per_vote = F.softplus(scale_per_vote + 0.5) + 1e-2
    else:
        scale_per_vote = torch.ones_like(scale_per_vote)
    return (vote, scale_per_vote, vote_presence, presence_logit_per_caps,
            presence_logit_per_vote, cpr_dynamic_reg_loss), all_param


def new_forward(layer, feature, deterministic=True, generator=None,
                **hooks):
    """The layer as it is, with its all_param kept by a hook."""
    kept = {}

    def keep(module, args, out):
        out.retain_grad()
        kept["all_param"] = out

    handle = layer.caps_mlps.register_forward_hook(keep)
    try:
        res = layer(feature, deterministic=deterministic,
                    generator=generator, **hooks)
    finally:
        handle.remove()
    return (res.vote, res.scale, res.vote_presence,
            res.presence_logit_per_caps, res.presence_logit_per_vote,
            res.cpr_dynamic_reg_loss), kept["all_param"]


def own_leaves(layer):
    return [layer.cpr_static] + [getattr(layer, f"caps_bias_{i}")
                                 for i in range(4)]


def run(forward, layer, feature, deterministic, seed, weights, **hooks):
    """The outputs, the gradients of all_param, the own parameters and the
    ``hooks`` (parent_transform, parent_presence) of a weighted sum of the
    outputs, and the generator's state after."""
    layer.zero_grad(set_to_none=True)
    hooks = {k: v.detach().clone().requires_grad_()
             for k, v in hooks.items()}
    g = torch.Generator().manual_seed(seed)
    outs, all_param = forward(layer, feature, deterministic, g, **hooks)
    loss = sum((o * w).sum() for o, w in zip(outs, weights))
    loss.backward()
    grads = [all_param.grad] + [p.grad for p in own_leaves(layer)]
    return outs, grads + [hooks[k].grad for k in sorted(hooks)], \
        g.get_state()


def through_the_op_and_the_old_code(shape, noise, hooks=None, **kw):
    """The layer (O, V of ``shape``; ``noise`` None: deterministic) through
    the op and through ``old_forward``, with the ``parent_hooks`` named by
    ``hooks``: the six outputs, the gradients of all_param, the own
    parameters and the hooks, and the generator's state, bit for bit.
    Returns the outputs through the op."""
    O, V = SHAPES[shape]
    layer = make_layer(O, V, **dict(kw, noise_type=noise or "uniform",
                                    noise_scale=4.0))
    torch.manual_seed(1)
    B = 4
    feature = torch.randn(B, O, 16)
    weights = [torch.randn(s) for s in ((B, O, V, 3, 3), (B, O, V),
                                         (B, O, V), (B, O, 1), (B, O, V),
                                         ())]
    given = parent_hooks(hooks, B, O)
    deterministic = noise is None
    got, got_grads, got_state = run(new_forward, layer, feature,
                                    deterministic, 7, weights, **given)
    want, want_grads, want_state = run(old_forward, layer, feature,
                                       deterministic, 7, weights, **given)
    names = ("vote", "scale", "vote_presence", "presence_logit_per_caps",
             "presence_logit_per_vote", "cpr_dynamic_reg_loss")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert torch.equal(a, b), name
    grad_names = ("all_param", "cpr_static", "caps_bias_0", "caps_bias_1",
                  "caps_bias_2", "caps_bias_3", *sorted(given))
    assert len(got_grads) == len(grad_names)
    for name, a, b in zip(grad_names, got_grads, want_grads):
        # None: caps_bias_3 without a learnt scale, caps_bias_0 under a
        # given parent_transform
        if b is None:
            assert a is None, name
            continue
        assert torch.equal(a, b), name
    assert torch.equal(got_state, want_state)
    return got


def parent_hooks(which, B, O, seed=3):
    """A homogeneous parent_transform (B, O, 1, 3, 3) and a parent_presence
    (B, O, 1) in (0, 1), as ``which`` names them (None: neither)."""
    g = torch.Generator().manual_seed(seed)
    hooks = {}
    if which in ("transform", "both"):
        m = torch.zeros(B, O, 1, 3, 3)
        m[..., :2, :] = torch.randn(B, O, 1, 2, 3, generator=g)
        m[..., 2, 2] = 1.0
        hooks["parent_transform"] = m
    if which in ("presence", "both"):
        hooks["parent_presence"] = torch.rand(B, O, 1, generator=g)
    return hooks


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("noise", [None, "uniform", "logistic"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_layer_through_the_op_is_the_old_code(shape, noise, variant):
    through_the_op_and_the_old_code(shape, noise, **VARIANTS[variant])


@pytest.mark.parametrize("hooks", ["transform", "presence", "both"])
@pytest.mark.parametrize("noise", [None, "uniform"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_layer_with_parent_hooks_is_the_old_code(shape, noise, hooks):
    """A given parent_transform or parent_presence keeps the plain
    composition, bit for bit the code before the op; each hook takes the
    place of what it names."""
    got = through_the_op_and_the_old_code(shape, noise, hooks)
    plain = through_the_op_and_the_old_code(shape, noise)
    changed = {i for i, (a, b) in enumerate(zip(got, plain))
               if not torch.equal(a, b)}
    assert changed == {"transform": {0}, "presence": {2},
                       "both": {0, 2}}[hooks]


def test_layer_refuses_an_unknown_noise_type():
    layer = make_layer(4, 5, noise_type="gaussian", noise_scale=1.0)
    with pytest.raises(ValueError, match="Invalid noise type"):
        layer(torch.randn(2, 4, 16), deterministic=False,
              generator=torch.Generator().manual_seed(0))
    layer(torch.randn(2, 4, 16))        # no noise when deterministic


# ------------------------------------------- a float64 model of V1b

def head_inputs(B, O, V, seed=0, layout="banks", dtype=torch.float64,
                exist=False, noise=True):
    """all_param in the capsule banks' (O, B) row order or contiguous, the
    own parameters, and the draws."""
    g = torch.Generator().manual_seed(seed)
    A = 8 * V + 7
    rand = lambda *s: torch.randn(*s, generator=g, dtype=dtype)  # noqa: E731
    all_param = rand(O, B, A).transpose(0, 1) if layout == "banks" \
        else rand(B, O, A)
    leaves = [all_param * 0.7, rand(1, O, V, 6) * 0.5,
              rand(1, O, 1, 6) * 0.5, rand(1, O, 1), rand(1, O, V),
              rand(1, O, V)]
    if layout == "banks":
        leaves[0] = leaves[0].transpose(0, 1).contiguous().transpose(0, 1)
    caps_exist = torch.bernoulli(torch.full((B, O, 1), 0.7, dtype=dtype),
                                 generator=g) if exist else None
    draws = (torch.rand(B, O, 1, generator=g, dtype=dtype),
             torch.rand(B, O, V, generator=g, dtype=dtype)) if noise \
        else (None, None)
    return leaves, caps_exist, draws


def output_grads(B, O, V, seed=1, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g, dtype=dtype)
            for s in ((B, O, V, 3, 3), (B, O, V), (B, O, V), (B, O, 1),
                      (B, O, V), ())]


class Transform:
    """csrc/capsule_votes.cu's ``Transform``, on tensors (..., 6)."""

    def __init__(self, p, similarity):
        self.similarity = similarity
        self.sig_x, self.sig_y = torch.sigmoid(p[..., 0]), torch.sigmoid(
            p[..., 1])
        self.sx, self.sy = self.sig_x + 0.01, self.sig_y + 0.01
        self.tx, self.ty = torch.tanh(p[..., 4] * 5), torch.tanh(
            p[..., 5] * 5)
        self.sh = torch.tanh(p[..., 3] * 5)
        theta = p[..., 2] * (2 * math.pi)
        self.c, self.s = torch.cos(theta), torch.sin(theta)
        sx, sy, c, s = self.sx, self.sy, self.c, self.s
        if similarity:
            f = [sx * c, -sx * s, self.tx, sx * s, sx * c, self.ty]
        else:
            shy = self.sh * sy
            f = [sx * c + shy * s, -sx * s + shy * c, self.tx, sy * s,
                 sy * c, self.ty]
        self.f = torch.stack(f, -1)

    def backward(self, g):
        g = g.unbind(-1)
        sx, sy, sh, c, s = self.sx, self.sy, self.sh, self.c, self.s
        zero = torch.zeros_like(sx)
        if self.similarity:
            g_sx = g[0] * c + g[1] * -s + g[3] * s + g[4] * c
            g_c = g[0] * sx + g[4] * sx
            g_s = g[1] * -sx + g[3] * sx
            gp1 = gp3 = zero
        else:
            shy = sh * sy
            g_sx = g[0] * c + g[1] * -s
            g_shy = g[0] * s + g[1] * c
            g_c = g[0] * sx + g[1] * shy + g[4] * sy
            g_s = g[0] * shy + g[1] * -sx + g[3] * sy
            g_sy = g_shy * sh + g[3] * s + g[4] * c
            gp1 = g_sy * (1 - self.sig_y) * self.sig_y
            gp3 = g_shy * sy * (1 - sh * sh) * 5
        gp0 = g_sx * (1 - self.sig_x) * self.sig_x
        gp2 = (g_c * -s + g_s * c) * (2 * math.pi)
        gp4 = g[2] * (1 - self.tx * self.tx) * 5
        gp5 = g[5] * (1 - self.ty * self.ty) * 5
        return torch.stack([gp0, gp1, gp2, gp3, gp4, gp5], -1)


def v1b_model(leaves, caps_exist, draws, grads, similarity, deform,
              learn_scale, noise_type, noise_scale):
    """V1b's gradients as its two passes compute them, in the input's
    precision: the rows' pass (the votes' terms, the row sums over the
    votes, the row's OVR and capsule presence) and the columns' pass (sums
    over B, the regulariser's term)."""
    all_param, static, b0, b1, b2, b3 = leaves
    B, O, A = all_param.shape
    V = static.shape[2]
    g_vote, g_scale, g_pres, g_lc, g_lv, g_reg = grads
    row = all_param
    dyn = row[..., :6 * V].reshape(B, O, V, 6)
    dyn = dyn if deform else torch.zeros_like(dyn)

    def noisy(t, u):
        if u is None:
            return t
        if noise_type == "uniform":
            return t + (u - 0.5) * noise_scale
        u = u.clamp(1e-7, 1 - 1e-7)
        return t + torch.log(u / (1 - u)) * noise_scale

    outer = Transform(row[..., 6 * V:6 * V + 6] + b0[:, :, 0], similarity)
    lc = row[..., 6 * V + 6:6 * V + 7] + b1
    if caps_exist is not None:
        lc = lc + log_safe(caps_exist)
    pc = torch.sigmoid(noisy(lc, draws[0]))                     # (B, O, 1)
    inner = Transform(dyn + static, similarity)                 # (B, O, V)
    gV = g_vote[..., :2, :].reshape(B, O, V, 6)
    fi, fo = inner.f, outer.f[:, :, None]                       # (.., 6)
    part = torch.stack([
        gV[..., 0] * fi[..., 0] + gV[..., 1] * fi[..., 1] + gV[..., 2] * fi[..., 2],
        gV[..., 0] * fi[..., 3] + gV[..., 1] * fi[..., 4] + gV[..., 2] * fi[..., 5],
        gV[..., 2],
        gV[..., 3] * fi[..., 0] + gV[..., 4] * fi[..., 1] + gV[..., 5] * fi[..., 2],
        gV[..., 3] * fi[..., 3] + gV[..., 4] * fi[..., 4] + gV[..., 5] * fi[..., 5],
        gV[..., 5]], -1)                                        # (B, O, V, 6)
    gi = torch.stack([
        gV[..., 0] * fo[..., 0] + gV[..., 3] * fo[..., 3],
        gV[..., 1] * fo[..., 0] + gV[..., 4] * fo[..., 3],
        gV[..., 2] * fo[..., 0] + gV[..., 5] * fo[..., 3],
        gV[..., 0] * fo[..., 1] + gV[..., 3] * fo[..., 4],
        gV[..., 1] * fo[..., 1] + gV[..., 4] * fo[..., 4],
        gV[..., 2] * fo[..., 1] + gV[..., 5] * fo[..., 4]], -1)
    g_dyn = inner.backward(gi)                                  # (B, O, V, 6)
    lv = noisy(row[..., 6 * V + 7:7 * V + 7] + b2, draws[1])
    sv = torch.sigmoid(lv)
    glv = g_pres * pc * (1 - sv) * sv + g_lv
    x = row[..., 7 * V + 7:] + b3 + 0.5
    gsc = g_scale * torch.exp(x) / (torch.exp(x) + 1) if learn_scale \
        else torch.zeros_like(x)
    g_ovr = outer.backward(part.sum(2))                         # (B, O, 6)
    g_pc = (g_pres * sv).sum(2, keepdim=True)
    glc = g_pc * (1 - pc) * pc + g_lc
    grad = torch.cat([g_dyn.reshape(B, O, 6 * V), g_ovr, glc, glv, gsc], -1)
    sums = grad.sum(0)                                          # (O, A)
    h = g_reg / B / 2
    reg_term = (h * row[..., :6 * V] * 2) if deform \
        else -grad[..., :6 * V]
    grad = torch.cat([grad[..., :6 * V] + reg_term, grad[..., 6 * V:]], -1)
    return [grad, sums[:, :6 * V].reshape(1, O, V, 6),
            sums[:, 6 * V:6 * V + 6].reshape(1, O, 1, 6),
            sums[:, 6 * V + 6:6 * V + 7].reshape(1, O, 1),
            sums[:, 6 * V + 7:7 * V + 7].reshape(1, O, V),
            sums[:, 7 * V + 7:].reshape(1, O, V)]


def plain_grads(leaves, caps_exist, draws, grads, settings):
    leaves = [t.detach().requires_grad_() for t in leaves]
    outs = cv.capsule_votes_plain(*leaves, caps_exist, *draws, *settings)
    loss = sum((o * g).sum() for o, g in zip(outs, grads))
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, got)]


SETTINGS = {  # similarity, deformations, learnt scale, noise type
    "plain": (False, True, True, "uniform"),
    "logistic": (False, True, True, "logistic"),
    "similarity": (True, True, True, "uniform"),
    "rigid": (False, False, True, "uniform"),
    "unit scale": (False, True, False, "uniform"),
}


@pytest.mark.parametrize("exist", [False, True])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_v1b_formulas_are_the_plain_gradient(shape, setting, exist):
    O, V = SHAPES[shape]
    B = 3
    leaves, caps_exist, draws = head_inputs(B, O, V, exist=exist)
    grads = output_grads(B, O, V)
    settings = (*SETTINGS[setting], 4.0)
    got = v1b_model(leaves, caps_exist, draws, grads, *settings)
    want = plain_grads(leaves, caps_exist, draws, grads, settings)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


# --------------------------------------------- the ops on the CPU

def op_args(B, O, V, layout="banks", noise="uniform", exist=True,
            dtype=torch.float32):
    leaves, caps_exist, draws = head_inputs(
        B, O, V, layout=layout, dtype=dtype, exist=exist,
        noise=noise is not None)
    return (*leaves, caps_exist, *draws, False, True, True, noise, 4.0)


@pytest.mark.parametrize("layout", ["banks", "contiguous"])
@pytest.mark.parametrize("noise", [None, "logistic"])
def test_opcheck_forward(layout, noise):
    args = op_args(3, 4, 5, layout=layout, noise=noise)
    args[0].requires_grad_()
    args[1].requires_grad_()
    torch.library.opcheck(torch.ops.scae_tpu_torch.capsule_votes_fwd.default,
                          args)


@pytest.mark.parametrize("layout", ["banks", "contiguous"])
def test_backward_ops_fake_takes_the_kernels_layout(layout):
    """The CUDA-only backward op's fake implementation: every gradient
    contiguous in its input's shape, all_param's (B, O, A) whatever
    all_param's layout, as autograd of the plain version gives it."""
    fwd = op_args(3, 4, 5, layout=layout)
    grads = [g.float() for g in output_grads(3, 4, 5)]
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = torch.ops.scae_tpu_torch.capsule_votes_bwd(
            *(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
              for a in (*fwd[:9], *grads, *fwd[9:])))
    plain = cv.plain_backward(fwd[:9], grads, fwd[9:])
    for f, t, g in zip(fake, fwd[:6], plain):
        assert f.shape == t.shape and f.dtype == t.dtype
        assert f.is_contiguous() and g.is_contiguous()


def test_cpu_op_is_the_plain_version():
    args = op_args(3, 4, 5)
    got = cv.capsule_votes(*args)
    want = cv.capsule_votes_plain(*args)
    for a, b in zip(got, want):
        assert a.is_contiguous() and torch.equal(a, b)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = cv.capsule_votes(*(mode.from_tensor(a)
                                  if isinstance(a, torch.Tensor) else a
                                  for a in args))
    assert [tuple(f.shape) for f in fake] == [tuple(a.shape) for a in got]


def bad(kind, device="cpu"):
    """op_args on ``device`` with one thing the kernels do not take."""
    args = [a.to(device) if isinstance(a, torch.Tensor) else a
            for a in op_args(2, 3, 4, layout="contiguous")]
    zeros = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    if kind == "dtype":
        args[0] = args[0].double()
    elif kind == "P":
        args[1] = zeros(1, 3, 4, 5)
    elif kind == "strided all_param":
        args[0] = zeros(2, 3, 2 * 39)[..., ::2]
    elif kind == "strided bias":
        args[4] = zeros(1, 3, 8)[..., ::2]
    elif kind == "shape":
        args[8] = zeros(2, 3, 5)
    elif kind == "noise type":
        args[12] = "gaussian"
    elif kind == "one draw":
        args[8] = None
    return args


REFUSALS = {"dtype": TypeError, "P": ValueError,
            "strided all_param": ValueError, "strided bias": ValueError,
            "shape": ValueError, "noise type": ValueError,
            "one draw": ValueError}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_launch_checks_refuse_what_the_kernels_do_not_take(kind):
    args = bad(kind)
    with pytest.raises(REFUSALS[kind]):
        cv._check(args[0], args[1], args[2:6], *args[6:9], args[12])


def test_launch_checks_take_both_layouts():
    for layout, o_major in (("contiguous", False), ("banks", True)):
        args = op_args(3, 4, 5, layout=layout)
        assert cv._check(args[0], args[1], args[2:6], *args[6:9],
                         args[12]) == (3, 4, 5, o_major)


def test_a_cpu_artifact_calls_the_op(tmp_path):
    from scae_tpu_torch import serve
    from scae_tpu_torch.factory import make_scae

    params = dict(image_shape=(1, 24, 24), n_classes=10, n_part_caps=6,
                  n_obj_caps=4,
                  pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
                  pcae_template_generator_params=dict(template_size=(5, 5)),
                  ocae_encoder_set_transformer_params=dict(dim_hidden=8,
                                                           dim_out=8),
                  ocae_decoder_capsule_params=dict(dim_caps=8,
                                                   hidden_sizes=(8,)),
                  pcae_decoder_params=dict(fused_impl="xla"))
    model = make_scae(params, device="cpu", seed=0)
    serve.export_serving(model, image_shape=params["image_shape"],
                         batch_size=3, out_dir=str(tmp_path), device="cpu")
    served = serve.load_serving(str(tmp_path))
    assert served.manifest["custom_ops"] == [cl.OP, cv.OP]
    calls = [n for n in served.program.graph.nodes
             if n.target is torch.ops.scae_tpu_torch.capsule_votes_fwd.default]
    assert len(calls) == 1
    x = np.random.RandomState(0).rand(3, 1, 24, 24).astype(np.float32)
    got = served(x)
    want = serve.make_infer_fn(model, device="cpu")(x)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def card_args(device, shape, layout, noise, exist=False, B=128, seed=0):
    O, V = SHAPES[shape]
    args = op_args(B, O, V, layout=layout, noise=noise, exist=exist)
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args), (B, O, V)


def fwd_close(got, want):
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def bwd_close(got, want):
    """V1b writes every gradient: where autograd of the plain version has
    none (the loss reaches no output that depends on the leaf), its zeros;
    caps_bias_3 without a learnt scale is None on both sides."""
    for a, b in zip(got, want):
        if b is None:
            assert a is None or not bool(a.any())
            continue
        assert torch.isfinite(a).all()
        tol = 1e-5 * max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol


def card_grads(args, grads):
    """(V1f's outputs, the gradients through V1b) and the plain version's
    on the same card, of a loss that weighs each output by its ``grads``
    entry (None: leaves it out, so that no gradient reaches it)."""
    leaves = [a.detach().requires_grad_() for a in args[:6]]
    rest = args[6:]
    results = []
    for fn in (cv.capsule_votes, cv.capsule_votes_plain):
        outs = fn(*leaves, *rest)
        loss = sum((o * g).sum() for o, g in zip(outs, grads)
                   if g is not None)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        results.append(([o.detach() for o in outs], list(got)))
    torch.cuda.synchronize()
    return results


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["banks", "contiguous"])
@pytest.mark.parametrize("noise", [None, "uniform", "logistic"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernels_match_plain(cuda, shape, noise, layout):
    args, (B, O, V) = card_args(cuda, shape, layout, noise,
                                exist=noise == "uniform")
    grads = [g.float().to(cuda) for g in output_grads(B, O, V)]
    (got, got_g), (want, want_g) = card_grads(args, grads)
    fwd_close(got, want)
    bwd_close(got_g, want_g)


@pytest.mark.gpu
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_kernels_match_plain_in_every_setting(cuda, setting):
    args, (B, O, V) = card_args(cuda, "mnist40", "banks", "uniform",
                                exist=True, B=16)
    args = (*args[:9], *SETTINGS[setting], 4.0)
    grads = [g.float().to(cuda) for g in output_grads(B, O, V)]
    (got, got_g), (want, want_g) = card_grads(args, grads)
    fwd_close(got, want)
    bwd_close(got_g, want_g)


@pytest.mark.gpu
def test_kernels_take_missing_output_gradients(cuda):
    args, (B, O, V) = card_args(cuda, "cifar10", "banks", "uniform", B=8)
    grads = [g.float().to(cuda) for g in output_grads(B, O, V)]
    grads[0] = grads[3] = grads[5] = None     # outputs the loss leaves out
    (got, got_g), (want, want_g) = card_grads(args, grads)
    bwd_close(got_g, want_g)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernels_repeat_bit_for_bit(cuda, shape):
    args, (B, O, V) = card_args(cuda, shape, "banks", "uniform", exist=True)
    grads = [g.float().to(cuda) for g in output_grads(B, O, V)]
    runs = [card_grads(args, grads)[0] for _ in range(2)]
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernels_give_both_layouts_the_same_bits(cuda):
    """all_param in the banks' (O, B) row order and the same values
    contiguous (the mesh's gather): the same outputs but the regulariser
    (its partial sums group other rows) and the same gradients, bit for
    bit, all_param's contiguous either way."""
    args, (B, O, V) = card_args(cuda, "mnist40", "banks", "uniform",
                                exist=True)
    grads = [g.float().to(cuda) for g in output_grads(B, O, V)]
    banks = card_grads(args, grads)[0]
    flat = card_grads((args[0].contiguous(), *args[1:]), grads)[0]
    for a, b in zip(banks[0][:5] + banks[1], flat[0][:5] + flat[1]):
        assert torch.equal(a, b)
    torch.testing.assert_close(banks[0][5], flat[0][5], rtol=1e-6, atol=0)
    assert banks[1][0].is_contiguous()


@pytest.mark.gpu
def test_kernels_count_launches(cuda):
    args, (B, O, V) = card_args(cuda, "mnist40", "banks", None, B=4)
    counted = trace.Since()
    leaves = [a.detach().requires_grad_() for a in args[:6]]
    outs = cv.capsule_votes(*leaves, *args[6:])
    assert counted.launches("V1f", "V1b") == (1, 0)
    outs[1].sum().backward()
    assert counted.launches("V1f", "V1b") == (1, 1)
    cv.capsule_votes_plain(*args)
    cv.capsule_votes(*(a.cpu() if isinstance(a, torch.Tensor) else a
                       for a in args))
    assert counted.launches("V1f", "V1b") == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_kernels_refuse_what_they_do_not_take(cuda, kind):
    args = bad(kind, cuda)
    counted = trace.Since()
    with pytest.raises(REFUSALS[kind]):
        cv.capsule_votes(*args)
    assert counted.launches("V1f") == (0,)


@pytest.mark.gpu
def test_kernel_build_reports_registers(cuda):
    info = cv.build_info()
    for kernel in ("capsule_votes_fwd_kernel", "capsule_votes_bwd_kernel",
                   "capsule_votes_columns_kernel", "capsule_votes_reg_kernel"):
        assert kernel in info.log
    assert "registers" in info.log
    print(info.log)
    for V in (40, 64):
        print(f"V={V}: {cv.rows_per_block(V)} rows a block, "
              f"{cv.shared_memory_bytes(V)} B of shared memory")
        assert cv.shared_memory_bytes(V) <= cv.STATIC_SMEM


KERNEL_NAMES = {"V1f": "capsule_votes_fwd_kernel",
                "V1b": "capsule_votes_bwd_kernel"}


def kernel_records(fn, want, windows=3):
    """How many times V1f and V1b ran on the card in one call of ``fn``,
    from torch.profiler's device records (which hold a replayed graph's
    kernels); a window whose counts differ is taken again (the profiler
    may lose a window's first records)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(200_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        got = {k: sum(e.count for e in events if name in e.key)
               for k, name in KERNEL_NAMES.items()}
        if got == want:
            break
    return got


@pytest.mark.gpu
def test_captured_flagship_steps_and_serving_run_through_the_kernels(
        cuda, tmp_path):
    """The flagship's train scan and eval scan capture V1f and V1b (the
    wrappers counted in the warm-up row and the capture only) and their
    replays run them once a step; a serving call's replay runs V1f once."""
    from scae_tpu_torch import serve
    from scae_tpu_torch.factory import FLAGSHIP_MODEL_PARAMS, make_scae
    from scae_tpu_torch.optim import make_optimizer
    from scae_tpu_torch.parallel import train_step as ts
    from scae_tpu_torch.parallel.graphs import WARMUP_STEPS
    from scae_tpu_torch.train.loop import make_augment_fn

    model = make_scae(FLAGSHIP_MODEL_PARAMS, device=cuda, seed=0)
    state = ts.TrainState(model, make_optimizer(
        model.parameters(), "rmsprop", 3e-5, batch_size=16), seed=3)
    rng = np.random.RandomState(0)
    data = {"image": torch.from_numpy(rng.randint(
                0, 256, (64, 28, 28)).astype(np.uint8)).to(cuda),
            "label": torch.from_numpy(rng.randint(0, 10, (64,))).to(cuda)}
    idxs = np.stack([rng.permutation(64)[:16] for _ in range(6)])
    scan = ts.make_train_scan(make_augment_fn(40, 6), cuda)
    eval_scan = ts.make_eval_scan(model, canvas=40, device=cuda)
    counted = trace.Since()
    scan(state, data, idxs[:2])
    assert counted.launches("V1f", "V1b") == (WARMUP_STEPS + 1,) * 2
    counted = trace.Since()
    eval_scan(data, idxs[:2])
    assert counted.launches("V1f") == (WARMUP_STEPS + 1,)
    torch.cuda.synchronize()
    counted = trace.Since()
    chunk = idxs[2:6]
    ran = kernel_records(lambda: scan(state, data, chunk),
                         {"V1f": len(chunk), "V1b": len(chunk)})
    assert ran == {"V1f": len(chunk), "V1b": len(chunk)}
    ran = kernel_records(lambda: eval_scan(data, chunk),
                         {"V1f": len(chunk), "V1b": 0})
    assert ran == {"V1f": len(chunk), "V1b": 0}
    assert counted.launches("V1f", "V1b") == (0, 0)

    infer = serve.make_infer_fn(model, device=cuda)
    x = torch.from_numpy(rng.rand(8, 1, 40, 40).astype(np.float32)).to(cuda)
    infer(x)                         # the warm-up call and the capture
    assert counted.launches("V1f") == (WARMUP_STEPS + 1,)
    ran = kernel_records(lambda: infer(x), {"V1f": 1, "V1b": 0})
    assert ran == {"V1f": 1, "V1b": 0}
    serve.export_serving(model, image_shape=(1, 40, 40), batch_size=8,
                         out_dir=str(tmp_path), device=cuda)
    served = serve.load_serving(str(tmp_path))
    assert served.manifest["custom_ops"] == [cl.OP, cv.OP]
    got = served(x)
    ran = kernel_records(lambda: served(x), {"V1f": 1, "V1b": 0})
    assert ran == {"V1f": 1, "V1b": 0}
    want = infer.eager(x)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5)
