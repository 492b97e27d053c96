"""The comparisons that decide ``correct``: the program's readings against
the reference's, each number beside its limit.

Training (``train``): the reference takes each checked step from the
program's own state before it (``traffic/train_job.py``), so that every
number compares one step from matched parameters and optimizer state,
not two trajectories that rounding has pulled apart. The numbers: the
start, the program's state before the first step, against the seed's
weights and a fresh optimizer (exact); each checked step's loss; the
gradient as the optimizer got it, worked out from its state before and
after the step (RMSprop's nu <- 0.99 nu + 0.01 g^2): the first step's
(the scan's eager warm-up) and the others' (graph replays, as every
step of the window is); the parameters' change in each step; the eval
scan's loss of every validation batch at the program's last
parameters.
The gradients and the changes are compared leaf by leaf by their norms:
the gap between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is
larger. The first gradient counts by its worst leaf; the replays'
gradients and each step's change by their median leaf, and then the
replays' gradients by the smaller of the two, the changes by the median
of the three steps. A batch on which the set transformer's leaves swing
with the convolutions' rounding reads far off in a sound run, in the one
step that meets it, when the process's cuDNN choice differs from the
reference's (the eager step's worst leaf as far as TF32 does; PERF.md
§6, PR 26); a lower precision, or a fault of the replayed graph, moves
every step alike, and a fault in one step alone is ``state_gap``'s to
catch. A leaf whose reference gradient in that step is
under a thousandth of the median leaf's (nought to rounding, as a
quantity that a softmax or a stopped gradient leaves flat) moves under
RMSprop by round-off alone and is left out of that step's change.
Norms hold neither an update's sign nor where in a leaf it lands, so the
state after each step is held too (``state_gap``): by part (the
parameters, RMSprop's nu, the momentum trace) and by leaf, the norm of
the program's state less the reference's, over the norm of the
reference's move of that leaf or of the median leaf, whichever is
larger; the worst leaf, part and step, so that a fault in one leaf
shows. A state left unchanged reads 1 there. Sound runs read up to about
a tenth in the parameters and the trace, from elements whose gradient
lies near 0, where eps turns its rounding into a share of a full step.

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


def miss_gaps(miss, move):
    """{leaf: miss / max(move, median move)}: how far the program's state
    lies from the reference's, over the reference's move of that leaf or
    of the median leaf, whichever is larger; both are {leaf: norm}."""
    med = statistics.median(move.values())
    return {n: miss[n] / max(move[n], med, 1e-30) for n in move}


def moved(ref_grads):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grads.values())
    return {n for n, g in ref_grads.items() if g >= 1e-3 * med}


def train(prog, ref, limits):
    """[(name, value, limit)] of a training cell (readings as
    ``train_job.Job.readings`` and ``Job.follow`` give them)."""
    steps = range(len(ref["grads"]))
    return [
        ("start_gap", prog["start"], limits["start_gap"]),
        ("loss_gap", max(rel(p, r) for p, r in zip(prog["losses"],
                                                   ref["losses"])),
         limits["loss_gap"]),
        ("grad_gap", leaf_gap(prog["grads"][0], ref["grads"][0]),
         limits["grad_gap"]),
        ("replay_grad_gap", min(median_leaf_gap(prog["grads"][k],
                                                ref["grads"][k])
                                for k in steps[1:]),
         limits["replay_grad_gap"]),
        ("change_gap", statistics.median(
            median_leaf_gap(prog["changes"][k], ref["changes"][k],
                            moved(ref["grads"][k])) for k in steps),
         limits["change_gap"]),
        ("state_gap", max(max(miss_gaps(miss[k], move[k]).values())
                          for miss, move in zip(ref["misses"], ref["moves"])
                          for k in move),
         limits["state_gap"]),
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
