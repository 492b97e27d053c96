"""The object decoder's capsule mixture likelihood: the CUDA kernels L1f
(forward) and L1b (backward), their plain PyTorch version, and the op that
joins them.

The likelihood is ``models/object_decoder.py::capsule_likelihood``: from
the votes ``vote`` (B, O, M, 6), their ``scale`` and ``vote_presence``
(B, O, M), the ``dummy_vote`` (1, 1, M, 6), the part poses ``x`` (B, M, 6)
and their ``presence`` (B, M) or None, it gives what
``CapsuleLikelihoodResult`` holds, in its order: log_prob,
vote_presence_binary, winner, winner_presence, soft_winner,
soft_winner_presence, posterior_mixing_prob, mixing_log_prob, mixing_logit
and is_from_capsule (int64).

L1f and L1b replace no TPU kernel: XLA fused the likelihood on the TPU, and
eager PyTorch ran it as about 40 operations forward and 32 backward. See
``csrc/capsule_likelihood.cu`` for their bound on the H100 and their design.

The likelihood is the operator
``torch.ops.scae_tpu_torch.capsule_likelihood_fwd`` (``OP``), defined with
``_common.define_op`` when this module is imported: its CUDA
implementation launches L1f and raises on anything it does not take
(another dtype than float32, a pose width other than 6, a layout other
than contiguous, but for the votes' pose stride: the (B, O, M, 6) view of
the vote head's (B, O, M, 3, 3) matrices is read where it lies), its CPU
implementation is the plain version, and its fake implementation gives the
outputs' shapes, so that ``torch.export`` records a call to the op (every
serving artifact calls it by name). Its gradient (``register_autograd``) is
a second op on CUDA tensors, ``scae_tpu_torch::capsule_likelihood_bwd``
(``BWD_OP``), which launches L1b, and on CPU ones ``torch.autograd.grad``
of the plain forward (``plain_backward``). L1f and L1b have no atomics:
their results repeat bit for bit. They take every sum over the components
in the order PyTorch's CUDA reductions take it at the cells' shapes, and
L1b follows autograd's formulas: with a training step's upstream
gradients (log_prob's and the posterior's), the gradients of the votes,
scales and vote presences are autograd's of the plain version to the bit.
"""

import math

import torch

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.kernels._common import SMEM_LIMIT, define_op, launch
from scae_tpu_torch.ops.gmm import normal_log_prob
from scae_tpu_torch.ops.math_ops import log_safe

LOG_001 = math.log(0.01)   # the dummy component's log-prob and mixing logit
SOURCE = "capsule_likelihood.cu"
_FWD_SIGNATURE = ("scae_capsule_likelihood_fwd", 17, 5)
_BWD_SIGNATURE = ("scae_capsule_likelihood_bwd", 21, 6)
THREADS = 128              # threads a block of L1f or L1b
GROUP = 8                  # lanes a point (kGroup in the source)
# the inputs in the op's order, and which of them L1b's ``needs`` names
INPUTS = ("vote", "scale", "vote_presence", "dummy_vote", "x", "presence")
_NEEDS = {"vote": 1, "scale": 2, "vote_presence": 4, "x": 8, "presence": 16}
# the outputs whose gradients L1b takes, in the op's order (the other two,
# vote_presence_binary and is_from_capsule, have none)
GRAD_OUTPUTS = ("log_prob", "winner", "winner_presence", "soft_winner",
                "soft_winner_presence", "posterior_mixing_prob",
                "mixing_log_prob", "mixing_logit")
_DIFFERENTIABLE = (0, 2, 3, 4, 5, 6, 7, 8)   # their places among the outputs


# ---------------------------------------------------- the plain version

def capsule_likelihood_plain(vote, scale, vote_presence, dummy_vote, x,
                             presence=None):
    """The likelihood in plain PyTorch (the decoder's own code before the
    kernels), as a tuple in ``CapsuleLikelihoodResult``'s order."""
    B, n_points, dim_in = x.shape
    vote_log_prob = torch.sum(
        normal_log_prob(x[:, None], vote, scale[..., None]), dim=-1)
    const = torch.full((B, 1, n_points), LOG_001, dtype=x.dtype,
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

    return (log_prob, vote_presence_binary, winner, winner_presence,
            soft_winner, soft_winner_presence, posterior_mixing_prob[:, :-1],
            mixing_log_prob, mixing_logit, is_from_capsule)


# --------------------------------------------------------------- the op

def _fwd_cpu(*args):
    return tuple(t.contiguous() for t in capsule_likelihood_plain(*args))


def _fwd_fake(vote, scale, vote_presence, dummy_vote, x, presence):
    B, O, M = scale.shape
    new = lambda *s: x.new_empty(s)  # noqa: E731
    return (new(), new(B, O, M), new(B, M, 6), new(B, M), new(B, M, 6),
            new(B, M), new(B, O, M), new(B, O + 1, M), new(B, O + 1, M),
            x.new_empty((B, M), dtype=torch.int64))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)
    ctx.mark_non_differentiable(output[1], output[9])
    # a gradient that does not reach an output stays None (no zeros made)
    ctx.set_materialize_grads(False)


def _backward(ctx, *grads):
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad
    grads = [grads[i] for i in _DIFFERENTIABLE]
    if saved[0].device.type == "cpu":
        return tuple(plain_backward(saved, grads, needs))
    got = torch.ops.scae_tpu_torch.capsule_likelihood_bwd(
        *saved, *(None if g is None else g.contiguous() for g in grads),
        [n for n, need in zip(INPUTS, needs) if need])
    return tuple(_reached(got, grads, saved[5] is not None))


def _reached(got, grads, has_presence):
    """L1b's gradients, None where it wrote none or where autograd of the
    plain version has none: an input on which no output with a gradient
    depends."""
    given = {n for n, g in zip(GRAD_OUTPUTS, grads) if g is not None}
    logits = bool(given & {"log_prob", "soft_winner", "soft_winner_presence",
                           "posterior_mixing_prob"})
    reach = {"vote": logits or "winner" in given,
             "scale": logits,
             "vote_presence": logits or bool(
                 given & {"winner_presence", "mixing_log_prob",
                          "mixing_logit"}),
             "dummy_vote": "soft_winner" in given,
             "x": logits,
             "presence": "log_prob" in given and has_presence}
    return [g if reach[n] and g.numel() else None
            for n, g in zip(INPUTS, got)]


def plain_backward(saved, grads, needs):
    """The gradients of the six inputs (None where none reaches one or
    ``needs`` has none): ``torch.autograd.grad`` of the plain forward,
    recomputed from the saved inputs, for the gradients ``grads`` of the
    outputs in ``GRAD_OUTPUTS`` (None: that output's gradient is zero)."""
    leaves = [t.detach().requires_grad_() if t is not None and need else t
              for t, need in zip(saved, needs)]
    with torch.enable_grad():
        outs = capsule_likelihood_plain(*leaves)
    pairs = [(outs[i], g) for i, g in zip(_DIFFERENTIABLE, grads)
             if g is not None and outs[i].requires_grad]
    wrt = [t for t, need in zip(leaves, needs) if need]
    if not pairs or not wrt:
        return [None] * len(leaves)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True))
    return [next(got) if need else None for need in needs]


def capsule_likelihood(vote, scale, vote_presence, dummy_vote, x,
                       presence=None):
    """The likelihood through the op: the plain version for CPU tensors,
    L1f (and L1b in the backward) for CUDA ones."""
    return torch.ops.scae_tpu_torch.capsule_likelihood_fwd(
        vote, scale, vote_presence, dummy_vote, x, presence)


# ------------------------------------------------------ the CUDA launches

def shared_memory_bytes(O) -> int:
    """A block's dynamic shared memory (L1f's and L1b's): five columns of a
    float for each of a lane's components (the posterior and mixing logits,
    their exponentials, a scratch), and a float a warp."""
    return 4 * (5 * -(-(O + 1) // GROUP) * THREADS + THREADS // 32)


def blocks(B, M) -> int:
    """The blocks of L1f or L1b: a point to each group of GROUP lanes."""
    return -(-(B * M) // (THREADS // GROUP))


def build_info() -> _build.BuiltLibrary:
    """Build L1f and L1b now if needed; the path, ``-Xptxas -v`` report and
    build seconds of their library."""
    return _build.load(SOURCE, *_FWD_SIGNATURE)[2]


def _check(vote, scale, vote_presence, dummy_vote, x, presence, grads=()):
    """(B, O, M, S): raise unless every tensor is a float32 tensor of the
    expected shape on the votes' device, every one contiguous but the votes,
    whose pose stride S may exceed 6 (the view of 3 x 3 matrices), and the
    shared memory fits a block. ``grads``: the upstream gradients in
    ``GRAD_OUTPUTS``' order (None: none)."""
    if vote.dim() != 4 or vote.shape[-1] != 6:
        raise ValueError(f"L1f and L1b take votes (B, O, M, 6), got "
                         f"{tuple(vote.shape)}")
    B, O, M, _ = vote.shape
    if min(B, O, M) < 1:
        raise ValueError(f"unsupported sizes B={B}, O={O}, M={M}")
    if shared_memory_bytes(O) > SMEM_LIMIT:
        raise ValueError(f"O={O} needs {shared_memory_bytes(O)} bytes of "
                         f"shared memory a block, more than {SMEM_LIMIT}")
    S = vote.stride(2)
    if vote.stride() != (O * M * S, M * S, S, 1) or S < 6:
        raise ValueError(f"the votes must be contiguous, or the (B, O, M, 6) "
                         f"view of contiguous (B, O, M, 3, 3) matrices; got "
                         f"strides {vote.stride()}")
    shapes = dict(zip(GRAD_OUTPUTS, ((), (B, M, 6), (B, M), (B, M, 6),
                                     (B, M), (B, O, M), (B, O + 1, M),
                                     (B, O + 1, M))))
    expected = {"scale": (scale, (B, O, M)),
                "vote_presence": (vote_presence, (B, O, M)),
                "dummy_vote": (dummy_vote, (1, 1, M, 6)),
                "x": (x, (B, M, 6)), "presence": (presence, (B, M)),
                **{f"g_{n}": (g, shapes[n])
                   for n, g in zip(GRAD_OUTPUTS, grads)}}
    for name, (t, shape) in {"vote": (vote, vote.shape), **expected}.items():
        if t is None:
            continue
        if t.device != vote.device:
            raise ValueError(f"{name} is on {t.device}, vote on {vote.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if name != "vote" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, O, M, S


def _launch_fwd(vote, scale, vote_presence, dummy_vote, x, presence):
    """Launch L1f (and log_prob's sum) on CUDA tensors."""
    B, O, M, S = _check(vote, scale, vote_presence, dummy_vote, x, presence)
    outs = _fwd_fake(vote, scale, vote_presence, dummy_vote, x, presence)
    partial = x.new_empty((blocks(B, M),))
    launch("L1f", _build.load(SOURCE, *_FWD_SIGNATURE), vote, scale,
           vote_presence, dummy_vote, x, presence, *outs, partial,
           B, O, M, S, THREADS)
    return outs


def _bwd_outputs(vote, dummy_vote, x, presence, wanted, g_soft_winner):
    """L1b's results in ``INPUTS``' order: each wanted input's gradient in
    its shape, the vote's contiguous, else an empty tensor (dummy_vote's
    also where the soft winner, its only path, has no gradient)."""
    shapes = {"vote": vote.shape, "scale": vote.shape[:3],
              "vote_presence": vote.shape[:3], "dummy_vote": dummy_vote.shape,
              "x": x.shape, "presence": None if presence is None
              else presence.shape}
    if g_soft_winner is None:
        wanted = [n for n in wanted if n != "dummy_vote"]
    return [x.new_empty(shapes[n]) if n in wanted and shapes[n] is not None
            else x.new_empty((0,)) for n in INPUTS]


def _launch_bwd(vote, scale, vote_presence, dummy_vote, x, presence,
                g_log_prob, g_winner, g_winner_presence, g_soft_winner,
                g_soft_winner_presence, g_posterior, g_mixing_log_prob,
                g_mixing_logit, wanted):
    """Launch L1b (and the dummy vote's sum over B) on CUDA tensors."""
    grads = (g_log_prob, g_winner, g_winner_presence, g_soft_winner,
             g_soft_winner_presence, g_posterior, g_mixing_log_prob,
             g_mixing_logit)
    B, O, M, S = _check(vote, scale, vote_presence, dummy_vote, x, presence,
                        grads)
    outs = _bwd_outputs(vote, dummy_vote, x, presence, wanted, g_soft_winner)
    g_vote, g_scale, g_vp, g_dummy, g_x, g_presence = (
        t if t.numel() else None for t in outs)
    dummy_part = x.new_empty((B, M, 6)) if g_dummy is not None else None
    needs = sum(_NEEDS[n] for n, t in zip(INPUTS, outs)
                if n in _NEEDS and t.numel())
    launch("L1b", _build.load(SOURCE, *_BWD_SIGNATURE), vote, scale,
           vote_presence, dummy_vote, x, presence, *grads, g_vote, g_scale,
           g_vp, g_x, g_presence, g_dummy, dummy_part, B, O, M, S, THREADS,
           needs)
    return outs


def _bwd_fake(vote, scale, vote_presence, dummy_vote, x, presence,
              g_log_prob, g_winner, g_winner_presence, g_soft_winner,
              *rest):
    return _bwd_outputs(vote, dummy_vote, x, presence, rest[-1],
                        g_soft_winner)


# ---------------------------------------------------- the registrations

_ARGS = ("Tensor vote, Tensor scale, Tensor vote_presence, "
         "Tensor dummy_vote, Tensor x, Tensor? presence")
# CapsuleLikelihoodResult's fields: L1f on CUDA tensors, the plain version
# on CPU ones
OP = define_op(f"capsule_likelihood_fwd({_ARGS}) -> (Tensor, Tensor, "
               "Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
               "Tensor)", _launch_fwd, _fwd_cpu, _fwd_fake, _backward,
               _setup_context)
# the gradients of vote, scale, vote_presence, dummy_vote, x and presence
# (an empty tensor where not wanted) from those of the outputs in
# GRAD_OUTPUTS (None: no gradient), by L1b: CUDA tensors only (the CPU's
# backward is ``plain_backward``)
BWD_OP = define_op(
    f"capsule_likelihood_bwd({_ARGS}, "
    + ", ".join(f"Tensor? g_{n}" for n in GRAD_OUTPUTS)
    + ", str[] wanted) -> Tensor[]",
    _launch_bwd, None, _bwd_fake)
