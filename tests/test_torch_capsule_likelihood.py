"""The object decoder's capsule mixture likelihood
(``kernels/capsule_likelihood.py``): the custom op
``scae_tpu_torch::capsule_likelihood_fwd``, its plain version, and the CUDA
kernels L1f and L1b.

On the CPU:

  * the op against the decoder's code before the op (``old_likelihood``
    below, kept as the reference), at the mnist40 (O 32, M 40) and cifar10
    (M 64) widths, with the part presences given and None and with ties
    among the posterior logits: every output bit for bit (the op's CPU
    kernel is that code);
  * the flagship and cifar10 models through the op against the same
    models with the old code in its place: the loss, every loss term and
    every parameter's gradient bit for bit (the op's CPU backward is
    autograd of that code);
  * a float64 model of L1b's formulas, as ``csrc/capsule_likelihood.cu``
    writes them, against autograd of the plain version, for random
    upstream gradients on every output and with some missing; which
    inputs the CUDA backward leaves without a gradient (``_reached``)
    against which autograd of the plain version reaches;
  * ``torch.library.opcheck`` of the op, the backward op's fake
    implementation, the launch checks' refusals, and a CPU serving artifact
    that calls the op by name and loads and runs.

On the card (``-m gpu``; every test skips without one): L1f against the
plain version on every output, exact for those of the argmax and the
comparison, at both cells' shapes, with presences given and None and with
ties; L1b against autograd of the plain version with every upstream
gradient and with missing ones; both bit for bit on repeat; both inside a
CUDA graph capture; the refusals; the build's report; the launch counts of
a captured flagship train step, eval step and serving call, and the
kernels their replays run.

    python -m pytest --noconftest -m gpu tests/test_torch_capsule_likelihood.py

Tolerances on the card: PyTorch's bits for the outputs in ``EXACT`` and,
with a training step's upstream gradients, for the votes', scales' and
vote presences' gradients (the kernels take every sum over the
components in the order PyTorch's reductions take it and follow
autograd's formulas, rounded where PyTorch rounds); otherwise the forward
1e-5 relative and 1e-6 absolute (log_prob's sum over the points and the
soft winner's over the components in another order) and the backward
1e-5 of each gradient's largest entry (the other outputs' gradients
joined in another order than autograd's).
"""

import math

import numpy as np
import pytest
import torch

from scae_tpu_torch.kernels import capsule_likelihood as cl
from scae_tpu_torch.kernels import capsule_votes as cv
from scae_tpu_torch.models import object_decoder
from scae_tpu_torch.models.results import CapsuleLikelihoodResult
from scae_tpu_torch.ops.gmm import normal_log_prob
from scae_tpu_torch.ops.math_ops import log_safe
from scae_tpu_torch.utils import trace

SHAPES = {"mnist40": (32, 40), "cifar10": (32, 64)}    # (O, M)
_LOG_001 = math.log(0.01)
OUTPUTS = ("log_prob", "vote_presence_binary", "winner", "winner_presence",
           "soft_winner", "soft_winner_presence", "posterior_mixing_prob",
           "mixing_log_prob", "mixing_logit", "is_from_capsule")
# the outputs of the argmax and the comparison, the posterior and the mixing
# logits and log-probabilities: PyTorch's bits on the card too, at the
# cells' shapes (L1f sums over the components in torch.softmax's and
# torch.logsumexp's orders)
EXACT = ("vote_presence_binary", "winner", "winner_presence",
         "is_from_capsule", "posterior_mixing_prob", "mixing_logit",
         "mixing_log_prob")


def old_likelihood(vote, scale, vote_presence, dummy_vote, x,
                   presence=None) -> CapsuleLikelihoodResult:
    """``models/object_decoder.py::capsule_likelihood`` as it was before
    the op."""
    B, n_points, dim_in = x.shape
    vote_log_prob = torch.sum(
        normal_log_prob(x[:, None], vote, scale[..., None]), dim=-1)
    const = torch.full((B, 1, n_points), _LOG_001, dtype=x.dtype,
                       device=x.device)
    vote_log_prob = torch.cat([vote_log_prob, const], dim=1)   # (B, O+1, M)
    mixing_logit = torch.cat([log_safe(vote_presence), const], dim=1)
    mixing_log_prob = mixing_logit - torch.logsumexp(mixing_logit, dim=1,
                                                     keepdim=True)
    vote_presence_binary = (mixing_logit[:, :-1]
                            > mixing_logit[:, -1:]).to(x.dtype)

    posterior_logits = mixing_logit + vote_log_prob
    mixture_log_prob_per_point = torch.logsumexp(posterior_logits, dim=1)
    if presence is not None:
        mixture_log_prob_per_point = mixture_log_prob_per_point * presence
    log_prob = torch.mean(torch.sum(mixture_log_prob_per_point, dim=1))

    # hard winner: argmax over the real capsules only
    winning_idx = torch.argmax(posterior_logits[:, :-1], dim=1)  # (B, M)
    winner = torch.gather(
        vote, 1, winning_idx[:, None, :, None].expand(B, 1, n_points, dim_in)
    ).squeeze(1)
    winner_presence = torch.gather(vote_presence, 1,
                                   winning_idx[:, None, :]).squeeze(1)
    # the reference's quirk, kept as the JAX package keeps it; never read
    is_from_capsule = torch.div(winning_idx, n_points, rounding_mode="floor")

    posterior_mixing_prob = torch.softmax(posterior_logits, dim=1)
    votes_full = torch.cat(
        [vote, dummy_vote.expand(B, 1, n_points, dim_in)], dim=1)
    vote_presence_full = torch.cat(
        [vote_presence, torch.zeros_like(vote_presence[:, :1])], dim=1)
    soft_winner = torch.sum(posterior_mixing_prob[..., None] * votes_full,
                            dim=1)
    soft_winner_presence = torch.sum(
        posterior_mixing_prob * vote_presence_full, dim=1)

    return CapsuleLikelihoodResult(
        log_prob=log_prob,
        vote_presence_binary=vote_presence_binary,
        winner=winner,
        winner_presence=winner_presence,
        soft_winner=soft_winner,
        soft_winner_presence=soft_winner_presence,
        posterior_mixing_prob=posterior_mixing_prob[:, :-1],
        mixing_log_prob=mixing_log_prob,
        mixing_logit=mixing_logit,
        is_from_capsule=is_from_capsule,
    )


def inputs(B, O, M, seed=0, dtype=torch.float32, ties=False,
           presence=True, device="cpu"):
    """The likelihood's inputs on ``device``: the votes as the vote head
    leaves them (the (B, O, M, 6) view of 3 x 3 matrices), scales, vote
    presences (a few under log_safe's floor, one row of capsules all
    absent), the dummy vote, part poses and their presences (or None).
    ``ties``: capsules 2 and 5 the same as capsule 1, so that their
    posterior logits tie."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a)).to(device=device, dtype=dtype)
    matrices = t(rng.randn(B, O, M, 3, 3) * 0.5)
    scale = t(rng.rand(B, O, M) * 1.5 + 0.3)
    vp = rng.rand(B, O, M)
    vp[vp < 0.05] = 0.0
    vp[0, :, 0] = 0.0
    vp = t(vp)
    if ties:
        for o in (2, 5):
            matrices[:, o] = matrices[:, 1]
            scale[:, o] = scale[:, 1]
            vp[:, o] = vp[:, 1]
    vote = matrices[..., :-1, :].reshape(B, O, M, 6)
    return (vote, scale, vp, t(rng.randn(1, 1, M, 6) * 0.5),
            t(rng.randn(B, M, 6) * 0.5),
            t(rng.rand(B, M)) if presence else None)


def output_grads(B, O, M, seed=1, dtype=torch.float64, missing=()):
    """Random gradients of the outputs in ``cl.GRAD_OUTPUTS``' order, None
    for those named in ``missing``."""
    rng = np.random.RandomState(seed)
    shapes = dict(zip(cl.GRAD_OUTPUTS, ((), (B, M, 6), (B, M), (B, M, 6),
                                        (B, M), (B, O, M), (B, O + 1, M),
                                        (B, O + 1, M))))
    return [None if n in missing
            else torch.from_numpy(np.asarray(rng.randn(*shapes[n]))).to(
                dtype)
            for n in cl.GRAD_OUTPUTS]


# upstream gradients left out: none, a training step's (log_prob's and the
# posterior's alone), and others
MISSING = {
    "none": (),
    "train": tuple(n for n in cl.GRAD_OUTPUTS
                   if n not in ("log_prob", "posterior_mixing_prob")),
    "winners only": ("log_prob", "soft_winner", "soft_winner_presence",
                     "posterior_mixing_prob", "mixing_log_prob",
                     "mixing_logit"),
    "mixing only": ("log_prob", "winner", "winner_presence", "soft_winner",
                    "soft_winner_presence", "posterior_mixing_prob"),
    "soft only": ("log_prob", "winner", "winner_presence",
                  "posterior_mixing_prob", "mixing_log_prob",
                  "mixing_logit"),
}


# --------------------------------------------- the op on the CPU

@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("presence", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_op_is_the_old_code(shape, presence, ties):
    O, M = SHAPES[shape]
    args = inputs(4, O, M, ties=ties, presence=presence)
    got = object_decoder.capsule_likelihood(*args)
    want = old_likelihood(*args)
    for name in OUTPUTS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    if ties:
        post = got.posterior_mixing_prob
        assert torch.equal(post[:, 1], post[:, 2])
        assert torch.equal(post[:, 1], post[:, 5])


def train_grads(model, image, label, seed):
    """(every loss term and the loss, each parameter's gradient) of one
    noisy forward, as a train step takes them."""
    generator = torch.Generator().manual_seed(seed)
    res = model(image, deterministic=False, generator=generator)
    loss, log = model.loss(res, image, label)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {**log, "loss": loss}, grads


@pytest.mark.parametrize("which", ["flagship", "cifar10"])
def test_model_through_the_op_is_the_old_model(which, monkeypatch):
    from scae_tpu_torch import factory

    params = {"flagship": factory.FLAGSHIP_MODEL_PARAMS,
              "cifar10": factory.CIFAR10_MODEL_PARAMS}[which]
    model = factory.make_scae(params, device="cpu", seed=0)
    rng = np.random.RandomState(3)
    image = torch.from_numpy(rng.rand(4, *params["image_shape"]).astype(
        np.float32))
    label = torch.from_numpy(rng.randint(0, 10, (4,)))
    counted = trace.Since()
    got_terms, got_grads = train_grads(model, image, label, 5)
    assert counted.launches("L1f", "L1b") == (0, 0)
    monkeypatch.setattr(object_decoder, "capsule_likelihood", old_likelihood)
    want_terms, want_grads = train_grads(model, image, label, 5)
    assert sorted(got_terms) == sorted(want_terms)
    for k in want_terms:
        assert torch.equal(got_terms[k], want_terms[k]), k
    for (name, _), a, b in zip(model.named_parameters(), got_grads,
                               want_grads):
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name


# ----------------------------------- a float64 model of L1b's formulas

def l1b_model(vote, scale, vp, dummy, x, presence, grads):
    """The gradients of the six inputs as ``capsule_likelihood_bwd_kernel``
    computes them (the dummy vote's summed over B as the dummy pass does),
    for the upstream gradients ``grads`` (None: zero)."""
    B, O, M, _ = vote.shape
    g = dict(zip(cl.GRAD_OUTPUTS, grads))
    zero = lambda *s: torch.zeros(s, dtype=vote.dtype)  # noqa: E731
    g_lp = g["log_prob"] if g["log_prob"] is not None else zero()
    g_win = g["winner"] if g["winner"] is not None else zero(B, M, 6)
    g_winp = (g["winner_presence"] if g["winner_presence"] is not None
              else zero(B, M))
    g_sw = g["soft_winner"] if g["soft_winner"] is not None else zero(B, M, 6)
    g_swp = (g["soft_winner_presence"]
             if g["soft_winner_presence"] is not None else zero(B, M))
    g_post = torch.cat([g["posterior_mixing_prob"]
                        if g["posterior_mixing_prob"] is not None
                        else zero(B, O, M), zero(B, 1, M)], dim=1)
    g_mlp = (g["mixing_log_prob"] if g["mixing_log_prob"] is not None
             else zero(B, O + 1, M))[:, :O]
    g_mlp_sum = (g["mixing_log_prob"].sum(1, keepdim=True)
                 if g["mixing_log_prob"] is not None else zero(B, 1, M))
    g_ml_out = (g["mixing_logit"] if g["mixing_logit"] is not None
                else zero(B, O + 1, M))[:, :O]

    # the forward passes
    d = x[:, None] - vote                                   # (B, O, M, 6)
    s = scale
    vlp = (-(d * d) / (2 * s * s)[..., None] - torch.log(s)[..., None]
           - 0.5 * math.log(2 * math.pi)).sum(-1)
    ml = torch.where(vp < 1e-16, torch.full_like(vp, -1e8),
                     torch.log(torch.where(vp < 1e-16, 1.0, vp)))
    const = torch.full((B, 1, M), _LOG_001, dtype=vote.dtype)
    ml_full = torch.cat([ml, const], dim=1)
    pl = torch.cat([ml + vlp, 2 * const], dim=1)
    mx = pl.amax(1, keepdim=True)
    total = torch.exp(pl - mx).sum(1, keepdim=True)
    lse = torch.log(total) + mx
    post = torch.exp(pl - mx) / total
    lse_mix = torch.logsumexp(ml_full, dim=1, keepdim=True)
    won = torch.nn.functional.one_hot(torch.argmax(pl[:, :O], dim=1),
                                      O).permute(0, 2, 1).to(vote.dtype)

    g_point = g_lp / B
    g_lse = g_point * presence if presence is not None else g_point
    g_lse = g_lse * torch.ones(B, M, dtype=vote.dtype)
    votes_full = torch.cat([vote, dummy.expand(B, 1, M, 6)], dim=1)
    vp_full = torch.cat([vp, zero(B, 1, M)], dim=1)
    gp = (g_post + (g_sw[:, None] * votes_full).sum(-1)
          + g_swp[:, None] * vp_full)
    dot = (post * gp).sum(1, keepdim=True)
    g_pl = (g_lse[:, None] * torch.exp(pl - lse) + gp * post
            - post * dot)[:, :O]
    g_ml = (g_pl + g_mlp - torch.exp(ml_full - lse_mix)[:, :O] * g_mlp_sum
            + g_ml_out)
    g_vp = (torch.where(vp < 1e-16, 0.0, g_ml / vp)
            + post[:, :O] * g_swp[:, None]
            + won * g_winp[:, None])
    q = (2 * s) * s
    gt = (g_pl / q)[..., None] * (2 * d)
    g_vote = (gt + post[:, :O, :, None] * g_sw[:, None]
              + won[..., None] * g_win[:, None])
    g_x = -gt.sum(1)
    g_q = (-g_pl[..., None] * ((-(d * d) / q[..., None]) / q[..., None])
           ).sum(-1)
    g_scale = g_q * (2 * s) + (-6 * g_pl) / s + g_q * s * 2
    g_dummy = (post[:, O, :, None] * g_sw).sum(0)[None, None]
    g_presence = g_point * lse[:, 0] if presence is not None else None
    return [g_vote, g_scale, g_vp, g_dummy, g_x, g_presence]


def plain_grads(args, grads):
    """Autograd of the plain version: the gradients of the six inputs
    (None where none reaches one)."""
    needs = [a is not None for a in args]
    return cl.plain_backward(args, grads, needs)


@pytest.mark.parametrize("missing", sorted(MISSING))
@pytest.mark.parametrize("presence", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_l1b_formulas_are_the_plain_gradient(shape, presence, missing):
    O, M = SHAPES[shape]
    args = inputs(3, O, M, dtype=torch.float64, presence=presence)
    grads = output_grads(3, O, M, missing=MISSING[missing])
    want = plain_grads(args, grads)
    model = l1b_model(*args, grads)
    reached = cl._reached(model, grads, presence)
    for name, w, got, r in zip(cl.INPUTS, want, model, reached):
        if w is None:
            # autograd reaches no input that the CUDA backward leaves None
            assert r is None, name
            continue
        assert r is not None, name
        scale = max(float(w.abs().max()), 1e-30)
        assert float((got - w).abs().max()) <= 1e-6 * scale, name


def test_backward_on_the_cpu_reaches_what_autograd_reaches():
    """The op's CPU backward gives autograd of the plain version's None
    pattern: here the mixing logits' gradients alone reach only the vote
    presences."""
    args = [a.requires_grad_() for a in inputs(2, 3, 4)]
    outs = cl.capsule_likelihood(*args)
    loss = outs[7].sum() + outs[8].sum()
    got = torch.autograd.grad(loss, args, allow_unused=True)
    assert [g is not None for g in got] == [False, False, True, False,
                                            False, False]


# --------------------------------------------- the ops' registrations

@pytest.mark.parametrize("presence", [True, False])
def test_opcheck(presence):
    args = list(inputs(3, 4, 5, presence=presence))
    args[0] = args[0].contiguous()
    for a in args[:3]:
        a.requires_grad_()
    torch.library.opcheck(
        torch.ops.scae_tpu_torch.capsule_likelihood_fwd.default, tuple(args))


@pytest.mark.parametrize("soft_winner", [True, False])
def test_backward_ops_fake_gives_the_wanted_gradients(soft_winner):
    """The CUDA-only backward op's fake implementation: each wanted input's
    gradient in its shape, the votes' contiguous, an empty tensor for the
    rest; the dummy vote's only with the soft winner's gradient."""
    args = inputs(3, 4, 5)
    grads = [g.float() for g in output_grads(3, 4, 5)]
    if not soft_winner:
        grads[3] = None
    wanted = ["vote", "vote_presence", "dummy_vote", "presence"]
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = torch.ops.scae_tpu_torch.capsule_likelihood_bwd(
            *(None if a is None else mode.from_tensor(a)
              for a in (*args, *grads)), wanted)
    shapes = [tuple(a.shape) for a in args]
    want = [shapes[0], (0,), shapes[2], shapes[3] if soft_winner else (0,),
            (0,), shapes[5]]
    assert [tuple(f.shape) for f in fake] == want
    assert fake[0].is_contiguous()


def bad(kind, device="cpu"):
    """inputs on ``device`` with one thing the kernels do not take."""
    args = list(inputs(2, 3, 4, device=device))
    if kind == "dtype":
        args[0] = args[0].double()
    elif kind == "P":
        args[0] = torch.zeros(2, 3, 4, 5, device=device)
    elif kind == "strided votes":
        args[0] = torch.zeros(2, 4, 3, 6, device=device).transpose(1, 2)
    elif kind == "strided scale":
        args[1] = torch.zeros(2, 3, 8, device=device)[..., ::2]
    elif kind == "shape":
        args[4] = torch.zeros(2, 5, 6, device=device)
    elif kind == "dummy":
        args[3] = torch.zeros(1, 1, 5, 6, device=device)
    return args


REFUSALS = {"dtype": TypeError, "P": ValueError, "strided votes": ValueError,
            "strided scale": ValueError, "shape": ValueError,
            "dummy": ValueError}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_launch_checks_refuse_what_the_kernels_do_not_take(kind):
    with pytest.raises(REFUSALS[kind]):
        cl._check(*bad(kind))


def test_launch_checks_take_the_vote_heads_view():
    args = inputs(2, 3, 4)
    assert cl._check(*args) == (2, 3, 4, 9)
    assert cl._check(args[0].contiguous(), *args[1:]) == (2, 3, 4, 6)
    assert cl._check(*args[:5], None) == (2, 3, 4, 9)


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
    op = torch.ops.scae_tpu_torch.capsule_likelihood_fwd.default
    assert sum(n.target is op for n in served.program.graph.nodes) == 1
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


def on(device, seq):
    return [None if a is None else a.to(device) for a in seq]


def through(fn, args, grads):
    """(outputs, the six inputs' gradients) of ``fn`` for a loss that
    weighs each output by its ``grads`` entry (None: left out)."""
    leaves = [None if a is None else a.detach().requires_grad_()
              for a in args]
    outs = fn(*leaves)
    loss = sum((outs[OUTPUTS.index(n)] * g).sum()
               for n, g in zip(cl.GRAD_OUTPUTS, grads) if g is not None)
    wrt = [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    return ([o.detach() for o in outs],
            [None if t is None else next(got) for t in leaves])


def fwd_close(got, want):
    for name, a, b in zip(OUTPUTS, got, want):
        if name in EXACT:
            assert torch.equal(a, b), name
            continue
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


def bwd_close(got, want):
    """None where autograd of the plain version reaches no input, else
    within 1e-5 of each gradient's largest entry."""
    for name, a, b in zip(cl.INPUTS, got, want):
        if b is None:
            assert a is None, name
            continue
        assert torch.isfinite(a).all(), name
        tol = 1e-5 * max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("presence", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernels_match_plain(cuda, shape, presence, ties):
    O, M = SHAPES[shape]
    args = inputs(128, O, M, ties=ties, presence=presence, device=cuda)
    grads = on(cuda, output_grads(128, O, M, dtype=torch.float32))
    got = through(cl.capsule_likelihood, args, grads)
    want = through(cl.capsule_likelihood_plain, args, grads)
    torch.cuda.synchronize()
    fwd_close(got[0], want[0])
    bwd_close(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_training_gradients_are_autograds_bits(cuda, shape):
    """With a training step's upstream gradients (log_prob's and the
    posterior's), L1b gives the votes', scales' and vote presences'
    gradients of autograd of the plain version to the bit: a difference at
    rounding level there moves RMSprop's first steps apart."""
    O, M = SHAPES[shape]
    args = inputs(128, O, M, device=cuda)
    grads = on(cuda, output_grads(128, O, M, dtype=torch.float32,
                                  missing=MISSING["train"]))
    got = through(cl.capsule_likelihood, args, grads)
    want = through(cl.capsule_likelihood_plain, args, grads)
    for name, a, b in zip(cl.INPUTS[:3], got[1], want[1]):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("missing", sorted(MISSING))
def test_kernels_take_missing_output_gradients(cuda, missing):
    O, M = SHAPES["cifar10"]
    args = inputs(16, O, M, device=cuda)
    grads = on(cuda, output_grads(16, O, M, dtype=torch.float32,
                                  missing=MISSING[missing]))
    got = through(cl.capsule_likelihood, args, grads)
    want = through(cl.capsule_likelihood_plain, args, grads)
    bwd_close(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernels_repeat_bit_for_bit(cuda, shape):
    O, M = SHAPES[shape]
    args = inputs(128, O, M, device=cuda)
    grads = on(cuda, output_grads(128, O, M, dtype=torch.float32))
    runs = [through(cl.capsule_likelihood, args, grads) for _ in range(2)]
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernels_run_inside_a_graph_capture(cuda):
    """L1f and L1b captured into a CUDA graph (a training step's gradients)
    and replayed on new inputs give the eager launches' bits."""
    O, M = SHAPES["mnist40"]
    static = [a.detach().requires_grad_(i < 4) for i, a in
              enumerate(inputs(128, O, M, seed=0, device=cuda))]
    grads = on(cuda, output_grads(128, O, M, dtype=torch.float32,
                                  missing=MISSING["train"]))
    kept = [(OUTPUTS.index(n), g) for n, g in zip(cl.GRAD_OUTPUTS, grads)
            if g is not None]

    def step():
        outs = cl.capsule_likelihood(*static)
        got = torch.autograd.grad([outs[i] for i, _ in kept], static[:4],
                                  [g for _, g in kept], allow_unused=True)
        return [o.detach() for o in outs], got

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                                  # the warm-up launch
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    counted = trace.Since()
    with torch.cuda.graph(graph):
        captured = step()
    assert counted.launches("L1f", "L1b") == (1, 1)
    fresh = inputs(128, O, M, seed=7, device=cuda)
    with torch.no_grad():
        for s, f in zip(static, fresh):
            s.copy_(f)
    graph.replay()
    torch.cuda.synchronize()
    assert counted.launches("L1f", "L1b") == (1, 1)
    eager = step()
    for a, b in zip(captured[0], eager[0]):
        assert torch.equal(a, b)
    for a, b in zip(captured[1], eager[1]):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_kernels_refuse_what_they_do_not_take(cuda, kind):
    counted = trace.Since()
    with pytest.raises(REFUSALS[kind]):
        cl.capsule_likelihood(*bad(kind, cuda))
    assert counted.launches("L1f") == (0,)


@pytest.mark.gpu
def test_kernel_build_reports_registers(cuda):
    info = cl.build_info()
    for kernel in ("capsule_likelihood_fwd_kernel",
                   "capsule_likelihood_sum_kernel",
                   "capsule_likelihood_bwd_kernel",
                   "capsule_likelihood_dummy_kernel"):
        assert kernel in info.log
    assert "registers" in info.log and "spill stores" in info.log
    print(info.log)
    for O, M in SHAPES.values():
        print(f"O={O}, M={M}: {cl.blocks(128, M)} blocks of {cl.THREADS} "
              f"threads, {cl.shared_memory_bytes(O)} B of shared memory")


KERNEL_NAMES = {"L1f": "capsule_likelihood_fwd_kernel",
                "L1b": "capsule_likelihood_bwd_kernel"}


def kernel_records(fn, want, windows=3):
    """How many times L1f and L1b ran on the card in one call of ``fn``,
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
    """The flagship's train scan captures L1f and L1b, its eval scan and a
    serving call L1f (the wrappers counted in the warm-up row and the
    capture only); their replays run them once a step and call no
    wrapper."""
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
    assert counted.launches("L1f", "L1b") == (WARMUP_STEPS + 1,) * 2
    counted = trace.Since()
    eval_scan(data, idxs[:2])
    assert counted.launches("L1f", "L1b") == (WARMUP_STEPS + 1, 0)
    torch.cuda.synchronize()
    counted = trace.Since()
    chunk = idxs[2:6]
    want = {"L1f": len(chunk), "L1b": len(chunk)}
    assert kernel_records(lambda: scan(state, data, chunk), want) == want
    want = {"L1f": len(chunk), "L1b": 0}
    assert kernel_records(lambda: eval_scan(data, chunk), want) == want
    assert counted.launches("L1f", "L1b") == (0, 0)

    infer = serve.make_infer_fn(model, device=cuda)
    x = torch.from_numpy(rng.rand(8, 1, 40, 40).astype(np.float32)).to(cuda)
    infer(x)                         # the warm-up call and the capture
    assert counted.launches("L1f") == (WARMUP_STEPS + 1,)
    want = {"L1f": 1, "L1b": 0}
    assert kernel_records(lambda: infer(x), want) == want
    assert counted.launches("L1f") == (WARMUP_STEPS + 1,)
    serve.export_serving(model, image_shape=(1, 40, 40), batch_size=8,
                         out_dir=str(tmp_path), device=cuda)
    served = serve.load_serving(str(tmp_path))
    assert served.manifest["custom_ops"] == [cl.OP, cv.OP]
    got = served(x)
    assert kernel_records(lambda: served(x), want) == want
    eager = infer.eager(x)
    for k in eager:
        torch.testing.assert_close(got[k], eager[k], rtol=1e-4, atol=1e-5)
