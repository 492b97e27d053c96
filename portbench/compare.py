"""The comparisons that decide ``correct``: the program's readings against
the reference's, each number beside its limit.

Training (``train``): each of the checked steps' loss; the gradients of
the first step (the scan's eager warm-up) and of the second (the first
graph replay, as every step of the window is) as the optimizer got them,
worked out from its state before and after each step (RMSprop's
nu <- 0.99 nu + 0.01 g^2); the parameters' change after the checked
steps; the eval scan's loss of every validation batch.
The gradients and the change are compared leaf by leaf by their norms:
the gap between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is
larger. The first gradient counts by its worst leaf. The second gradient
and the change count by their median leaf: RMSprop's first update moves
every element by about lr / sqrt(0.01) whatever its gradient's size, so
elements whose gradient is at rounding level move apart in the two
programs, and one small leaf's gap after that swings from seed to seed
(PERF.md §6). A leaf whose reference gradient is under a thousandth of
the median leaf's (nought to rounding, as a quantity that a softmax or a
stopped gradient leaves flat) moves under RMSprop by round-off alone and
is left out of the change.

Serving (``serve``): one number over the sampled requests, the widest of
the absolute gaps of every float output (part presences and poses,
capsule presences, both heads' class probabilities) and of the two
predictions' gaps, each the amount by which the reference's probability
of the class the program predicted lies below the reference's best (0
where they agree, so a near tie that rounding flips costs no more than
the rounding). TF32 moves no prediction of a dozen seeds' samples, so
the predictions ride on this number rather than on one of their own.
"""

import statistics


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog, ref, keep=None):
    """{leaf: |norm_p - norm_r| / max(norm_r, median norm_r)} over the
    leaves named in ``keep`` (all where None); norms are {leaf: norm}."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def leaf_gap(prog, ref, keep=None):
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, keep).values())


def median_leaf_gap(prog, ref, keep=None):
    """The median leaf's gap (``leaf_gaps``)."""
    return statistics.median(leaf_gaps(prog, ref, keep).values())


def moved(ref_grads):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grads.values())
    return {n for n, g in ref_grads.items() if g >= 1e-3 * med}


def train(prog, ref, limits):
    """[(name, value, limit)] of a training cell."""
    return [
        ("loss_gap", max(rel(p, r) for p, r in zip(prog["losses"],
                                                   ref["losses"])),
         limits["loss_gap"]),
        ("grad_gap", leaf_gap(prog["grad_norms"][0], ref["grad_norms"][0]),
         limits["grad_gap"]),
        ("replay_grad_gap", median_leaf_gap(prog["grad_norms"][1],
                                            ref["grad_norms"][1]),
         limits["replay_grad_gap"]),
        ("change_gap", median_leaf_gap(prog["change_norms"],
                                       ref["change_norms"],
                                       moved(ref["grad_norms"][0])),
         limits["change_gap"]),
        ("eval_gap", max(rel(p, r) for p, r in zip(prog["eval_losses"],
                                                   ref["eval_losses"])),
         limits["eval_gap"]),
    ]


FLOAT_OUTPUTS = ("part_presence", "part_pose", "caps_presence",
                 "prior_cls_prob", "posterior_cls_prob")
PREDICTIONS = (("prediction", "posterior_cls_prob"),
               ("prior_prediction", "prior_cls_prob"))


def serve_gap(prog, ref):
    """The widest gap of one request's outputs (host tensors)."""
    gap = max(float((prog[k].float() - ref[k].float()).abs().max())
              for k in FLOAT_OUTPUTS)
    for p_key, r_key in PREDICTIONS:
        probs = ref[r_key].float()
        picked = probs.gather(1, prog[p_key].long().reshape(-1, 1))[:, 0]
        gap = max(gap, float((probs.max(dim=1).values - picked).max()))
    return gap


def serve(pairs, limits):
    """[(name, value, limit)] of a serving cell over (program, reference)
    output pairs."""
    return [("out_gap", max(serve_gap(p, r) for p, r in pairs),
             limits["out_gap"])]
