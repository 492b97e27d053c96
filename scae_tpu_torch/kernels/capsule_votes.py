"""The object capsules' vote head: the CUDA kernels V1f (forward) and V1b
(backward), their plain PyTorch version, and the op that joins them.

The head is the part of ``models/object_decoder.py::CapsuleLayer`` after
its second bank of MLPs: from ``all_param`` (B, O, A), A = 8 V + 7, with
``cpr_static`` (1, O, V, 6), ``caps_bias_0..3`` (1, O, 1, 6), (1, O, 1),
(1, O, V), (1, O, V), it gives what ``CapsuleLayerResult`` holds: the
votes (B, O, V, 3, 3), their scales, the vote presences, the capsule and
vote presence logits and the l2 regulariser of the dynamic part. The
caller's random numbers come in as inputs: ``caps_exist`` (B, O, 1), the
capsule dropout's draw, and ``noise_caps`` (B, O, 1) and ``noise_vote``
(B, O, V), the uniform draws of the presence-logit noise; the layer makes
them with the same ``torch.rand`` and ``torch.bernoulli`` calls on the same
generator in the same order, and each may be None (no dropout, no noise).

V1f and V1b replace no TPU kernel: XLA fused the head on the TPU, and
eager PyTorch ran it as about 96 operations forward and 150 backward. See
``csrc/capsule_votes.cu`` for their bound on the H100 and their design.

The head is the operator ``torch.ops.scae_tpu_torch.capsule_votes_fwd``
(``OP``), defined with ``_common.define_op`` when this module is imported:
its CUDA implementation launches V1f and raises on anything it
does not take (another dtype than float32, P other than 6, a layout other
than contiguous or the capsule banks' (O, B) row order), its CPU
implementation is the plain version, and its fake implementation gives the
outputs' shapes, so that ``torch.export`` records a call to the op (every
serving artifact calls it by name). Its gradient (``register_autograd``) is
a second op on CUDA tensors, ``scae_tpu_torch::capsule_votes_bwd``
(``BWD_OP``), which launches V1b, and on CPU ones ``torch.autograd.grad``
of the plain forward (``plain_backward``; taken in the backward itself,
since an op's kernel runs below autograd). V1f and V1b have no atomics:
their results repeat bit for bit.
"""

import math
import struct

import torch
import torch.nn.functional as F

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.kernels._common import define_op, launch, pad4
from scae_tpu_torch.ops.geometry import (
    affine_to_matrix,
    compose_affines,
    geometric_transform,
)
from scae_tpu_torch.ops.math_ops import l2_loss, log_safe

SOURCE = "capsule_votes.cu"
_FWD_SIGNATURE = ("scae_capsule_votes_fwd", 16, 6)
_BWD_SIGNATURE = ("scae_capsule_votes_bwd", 21, 6)
NOISE_KINDS = {"uniform": 1, "logistic": 2}
ROW_THREADS = 256          # votes a block takes: R = max(1, 256 // V) rows
STATIC_SMEM = 48 * 1024    # a block's shared memory without an opt-in


# --------------------------------------------------------------- the op

_ARGS = ("Tensor all_param, Tensor cpr_static, Tensor caps_bias_0, "
         "Tensor caps_bias_1, Tensor caps_bias_2, Tensor caps_bias_3, "
         "Tensor? caps_exist, Tensor? noise_caps, Tensor? noise_vote")
_SETTINGS = ("bool similarity_transform, bool allow_deformations, "
             "bool learn_vote_scale, str? noise_type, float noise_scale")


def _capsule_votes_fwd_cpu(*args):
    return tuple(t.contiguous() for t in capsule_votes_plain(*args))


def _capsule_votes_fwd_fake(all_param, cpr_static, *unused):
    B, O = all_param.shape[:2]
    V = cpr_static.shape[2]
    return (all_param.new_empty((B, O, V, 3, 3)),
            *(all_param.new_empty((B, O, V)) for _ in range(2)),
            all_param.new_empty((B, O, 1)), all_param.new_empty((B, O, V)),
            all_param.new_empty(()))


def _capsule_votes_bwd_fake(all_param, cpr_static, b0, b1, b2, b3, *unused):
    return [t.new_empty(t.shape) for t in (all_param, cpr_static, b0, b1, b2,
                                           b3)]


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:9])
    ctx.settings = inputs[9:]
    # a gradient that does not reach an output stays None (no zeros made)
    ctx.set_materialize_grads(False)


def _backward(ctx, *grads):
    saved = ctx.saved_tensors
    if saved[0].device.type == "cpu":
        got = plain_backward(saved, grads, ctx.settings)
    else:
        got = torch.ops.scae_tpu_torch.capsule_votes_bwd(
            *saved, *(None if g is None else g.contiguous() for g in grads),
            *ctx.settings)
        # without a learnt scale the plain version's caps_bias_3 gets no
        # gradient at all
        if not ctx.settings[2]:
            got[5] = None
    return (*got, *[None] * (len(ctx.needs_input_grad) - len(got)))


def plain_backward(saved, grads, settings):
    """The gradients of all_param, cpr_static and caps_bias_0..3 (None
    where none reaches one): ``torch.autograd.grad`` of the plain forward,
    recomputed from the saved inputs, for the output gradients ``grads``
    (None: that output's gradient is zero)."""
    leaves = [t.detach().requires_grad_() for t in saved[:6]]
    with torch.enable_grad():
        outs = capsule_votes_plain(*leaves, *saved[6:9], *settings)
    # an output that none of the leaves reaches (the scale without a
    # learnt one) passes nothing back
    pairs = [(o, g) for o, g in zip(outs, grads)
             if g is not None and o.requires_grad]
    if not pairs:
        return [None] * len(leaves)
    return list(torch.autograd.grad([o for o, _ in pairs], leaves,
                                    [g for _, g in pairs],
                                    allow_unused=True))




def capsule_votes(all_param, cpr_static, caps_bias_0, caps_bias_1,
                  caps_bias_2, caps_bias_3, caps_exist, noise_caps,
                  noise_vote, similarity_transform, allow_deformations,
                  learn_vote_scale, noise_type, noise_scale):
    """The head through the op: the plain version for CPU tensors, V1f
    (and V1b in the backward) for CUDA ones."""
    return torch.ops.scae_tpu_torch.capsule_votes_fwd(
        all_param, cpr_static, caps_bias_0, caps_bias_1, caps_bias_2,
        caps_bias_3, caps_exist, noise_caps, noise_vote,
        bool(similarity_transform), bool(allow_deformations),
        bool(learn_vote_scale), noise_type, float(noise_scale))


# ---------------------------------------------------- the plain version

def _add_noise(t, u, noise_type, noise_scale):
    if u is None:
        return t
    if noise_type == "uniform":
        return t + (u - 0.5) * noise_scale
    if noise_type != "logistic":
        raise ValueError(f"Invalid noise type: {noise_type}")
    u = u.clamp(1e-7, 1 - 1e-7)
    return t + torch.log(u / (1 - u)) * noise_scale


def capsule_votes_plain(all_param, cpr_static, caps_bias_0, caps_bias_1,
                        caps_bias_2, caps_bias_3, caps_exist, noise_caps,
                        noise_vote, similarity_transform, allow_deformations,
                        learn_vote_scale, noise_type, noise_scale,
                        parent_transform=None, parent_presence=None):
    """The head in plain PyTorch (the layer's own code before the kernels).
    ``parent_transform`` (B, O, 1, 3, 3), a homogeneous matrix, replaces the
    predicted OVR; ``parent_presence`` (B, O, 1) the capsule presence (its
    logit, noise included, is still returned)."""
    B, O = all_param.shape[:2]
    V, P = cpr_static.shape[2:]
    shapes = ((V, P), (1, P), (1,), (V,), (V,))
    chunks = [c.reshape(B, O, *s) for c, s in zip(
        torch.split(all_param, [math.prod(s) for s in shapes], dim=-1),
        shapes)]

    def transform(params):
        return geometric_transform(params, similarity_transform,
                                   nonlinear=True, as_matrix=False)

    cpr_dynamic = chunks[0]                               # (B, O, V, P)
    if not allow_deformations:
        cpr_dynamic = torch.zeros_like(cpr_dynamic)
    cpr_dynamic_reg_loss = l2_loss(cpr_dynamic) / B
    cpr = transform(cpr_dynamic + cpr_static)             # (B, O, V, 6)

    cvr = chunks[1] + caps_bias_0                         # (B, O, 1, P)
    presence_logit_per_caps = chunks[2] + caps_bias_1
    presence_logit_per_vote = chunks[3] + caps_bias_2
    scale_per_vote = chunks[4] + caps_bias_3
    if parent_transform is None:
        cvr = transform(cvr)                              # (B, O, 1, 6)
    else:
        # a homogeneous matrix: drop the [0, 0, 1] row
        cvr = parent_transform[..., :2, :].reshape(
            *parent_transform.shape[:-2], 6)
    vote = affine_to_matrix(compose_affines(cvr, cpr))    # (B, O, V, 3, 3)

    if caps_exist is not None:
        presence_logit_per_caps = (presence_logit_per_caps
                                   + log_safe(caps_exist))
    presence_logit_per_caps = _add_noise(presence_logit_per_caps, noise_caps,
                                         noise_type, noise_scale)
    presence_logit_per_vote = _add_noise(presence_logit_per_vote, noise_vote,
                                         noise_type, noise_scale)

    presence_per_caps = torch.sigmoid(presence_logit_per_caps) \
        if parent_presence is None else parent_presence
    vote_presence = presence_per_caps * torch.sigmoid(presence_logit_per_vote)
    if learn_vote_scale:
        scale_per_vote = F.softplus(scale_per_vote + 0.5) + 1e-2
    else:
        scale_per_vote = torch.ones_like(scale_per_vote)
    return (vote, scale_per_vote, vote_presence, presence_logit_per_caps,
            presence_logit_per_vote, cpr_dynamic_reg_loss)


# ------------------------------------------------------ the CUDA launches

def rows_per_block(V) -> int:
    """R, the consecutive rows of all_param a V1f or V1b block owns: as
    many as give it at most ROW_THREADS votes, one a thread."""
    return max(1, ROW_THREADS // V)


def shared_memory_bytes(V) -> int:
    """A V1f or V1b block's shared memory (``Smem`` in the source): its
    rows, their votes (or the votes' gradients), the per-vote terms of the
    row sums, and per row the sums, the OVR and the capsule presence."""
    R = rows_per_block(V)
    A = 8 * V + 7
    return 4 * (pad4(R * A) + pad4(9 * R * V) + pad4(7 * R * V)
                + pad4(7 * R + 32) + pad4(6 * R) + pad4(R))


def build_info() -> _build.BuiltLibrary:
    """Build V1f and V1b now if needed; the path, ``-Xptxas -v`` report and
    build seconds of their library."""
    return _build.load(SOURCE, *_FWD_SIGNATURE)[2]


def _check(all_param, cpr_static, biases, caps_exist, noise_caps, noise_vote,
           noise_type, grads=()):
    """(B, O, V, o_major): raise unless every tensor is a float32 tensor of
    the expected shape on all_param's device, all_param contiguous or in
    the (O, B) row order of a transposed contiguous tensor, every other one
    contiguous."""
    if all_param.dim() != 3 or cpr_static.dim() != 4:
        raise ValueError(f"all_param must be (B, O, A) and cpr_static (1, O, "
                         f"V, P), got {tuple(all_param.shape)} and "
                         f"{tuple(cpr_static.shape)}")
    B, O, A = all_param.shape
    V, P = cpr_static.shape[2:]
    if P != 6:
        raise ValueError(f"V1f and V1b take 6 transform parameters, got {P}")
    if A != 8 * V + 7 or min(B, O, V) < 1:
        raise ValueError(f"all_param's last axis must be 8 V + 7 = "
                         f"{8 * V + 7} for V={V}, got {tuple(all_param.shape)}")
    if shared_memory_bytes(V) > STATIC_SMEM:
        raise ValueError(f"V={V} needs {shared_memory_bytes(V)} bytes of "
                         f"shared memory a block, more than {STATIC_SMEM}")
    expected = {"cpr_static": (cpr_static, (1, O, V, 6)),
                "caps_bias_0": (biases[0], (1, O, 1, 6)),
                "caps_bias_1": (biases[1], (1, O, 1)),
                "caps_bias_2": (biases[2], (1, O, V)),
                "caps_bias_3": (biases[3], (1, O, V)),
                "caps_exist": (caps_exist, (B, O, 1)),
                "noise_caps": (noise_caps, (B, O, 1)),
                "noise_vote": (noise_vote, (B, O, V)),
                **dict(zip(("g_vote", "g_scale", "g_vote_presence",
                            "g_presence_logit_per_caps",
                            "g_presence_logit_per_vote",
                            "g_cpr_dynamic_reg_loss"),
                           zip(grads, ((B, O, V, 3, 3), (B, O, V), (B, O, V),
                                       (B, O, 1), (B, O, V), ()))))}
    for name, (t, shape) in {"all_param": (all_param, (B, O, A)),
                             **expected}.items():
        if t is None:
            continue
        if t.device != all_param.device:
            raise ValueError(f"{name} is on {t.device}, all_param on "
                             f"{all_param.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if name != "all_param" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if all_param.is_contiguous():
        o_major = False
    elif all_param.transpose(0, 1).is_contiguous():
        o_major = True
    else:
        raise ValueError("all_param must be contiguous, or a transposed "
                         "contiguous (O, B, A) tensor (the capsule banks' "
                         "row order)")
    if (noise_caps is None) != (noise_vote is None):
        raise ValueError("noise_caps and noise_vote come together")
    if noise_caps is not None and noise_type not in NOISE_KINDS:
        raise ValueError(f"Invalid noise type: {noise_type}")
    return B, O, V, o_major


def _flags(similarity, deform, learn_scale, caps_exist, noise_caps,
           noise_type, o_major):
    """The settings as the kernels' ``Flags`` read them."""
    noise = 0 if noise_caps is None else NOISE_KINDS[noise_type]
    return (int(similarity) | int(deform) << 1 | int(learn_scale) << 2
            | int(caps_exist is not None) << 3 | int(o_major) << 4
            | noise << 5)


def _float_bits(x) -> int:
    """A float32's bits as a C int (ctypes passes the launchers ints)."""
    return struct.unpack("<i", struct.pack("<f", x))[0]


def _launch_fwd(all_param, cpr_static, b0, b1, b2, b3, caps_exist,
                noise_caps, noise_vote, similarity, deform, learn_scale,
                noise_type, noise_scale):
    """Launch V1f (and its regulariser's sum) on CUDA tensors."""
    biases = (b0, b1, b2, b3)
    B, O, V, o_major = _check(all_param, cpr_static, biases, caps_exist,
                              noise_caps, noise_vote, noise_type)
    R = rows_per_block(V)
    new = lambda *s: torch.empty(s, dtype=torch.float32,  # noqa: E731
                                 device=all_param.device)
    outs = (new(B, O, V, 3, 3), new(B, O, V), new(B, O, V), new(B, O, 1),
            new(B, O, V), new())
    partial = new(-(-(B * O) // R))
    flags = _flags(similarity, deform, learn_scale, caps_exist, noise_caps,
                   noise_type, o_major)
    launch("V1f", _build.load(SOURCE, *_FWD_SIGNATURE), all_param,
           cpr_static, *biases, caps_exist, noise_caps, noise_vote, *outs,
           partial, B, O, V, R, flags, _float_bits(noise_scale))
    return outs


def _launch_bwd(all_param, cpr_static, b0, b1, b2, b3, caps_exist,
                noise_caps, noise_vote, g_vote, g_scale, g_pres, g_lc, g_lv,
                g_reg, similarity, deform, learn_scale, noise_type,
                noise_scale):
    """Launch V1b (rows, then columns) on CUDA tensors."""
    biases = (b0, b1, b2, b3)
    grads = (g_vote, g_scale, g_pres, g_lc, g_lv, g_reg)
    B, O, V, o_major = _check(all_param, cpr_static, biases, caps_exist,
                              noise_caps, noise_vote, noise_type, grads)
    # every gradient contiguous, all_param's (B, O, A) whatever its layout
    outs = [torch.empty(t.shape, dtype=torch.float32, device=t.device)
            for t in (all_param, cpr_static, *biases)]
    flags = _flags(similarity, deform, learn_scale, caps_exist, noise_caps,
                   noise_type, o_major)
    launch("V1b", _build.load(SOURCE, *_BWD_SIGNATURE), all_param,
           cpr_static, *biases, caps_exist, noise_caps, noise_vote, *grads,
           *outs, B, O, V, rows_per_block(V), flags, _float_bits(noise_scale))
    return outs


# ---------------------------------------------------- the registrations

# (vote, scale, vote_presence, presence_logit_per_caps,
# presence_logit_per_vote, cpr_dynamic_reg_loss): V1f on CUDA tensors, the
# plain version on CPU ones
OP = define_op(f"capsule_votes_fwd({_ARGS}, {_SETTINGS}) -> "
               "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
               _launch_fwd, _capsule_votes_fwd_cpu, _capsule_votes_fwd_fake,
               _backward, _setup_context)
# the gradients of all_param, cpr_static and caps_bias_0..3 from those of
# the six outputs (None: no gradient), by V1b: CUDA tensors only (the CPU's
# backward is ``plain_backward``)
BWD_OP = define_op(
    f"capsule_votes_bwd({_ARGS}, Tensor? g_vote, Tensor? g_scale, "
    "Tensor? g_vote_presence, Tensor? g_presence_logit_per_caps, "
    "Tensor? g_presence_logit_per_vote, "
    f"Tensor? g_cpr_dynamic_reg_loss, {_SETTINGS}) -> Tensor[]",
    _launch_bwd, None, _capsule_votes_bwd_fake)
