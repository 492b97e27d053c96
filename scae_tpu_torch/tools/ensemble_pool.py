"""Cross-recipe test-time ensembling over one shared data split.

    python -m scae_tpu_torch.tools.ensemble_pool SPEC.json \
        [--batch-size 128] [--dump-probs NPZ] [--device cuda]

The counterpart of tools/ensemble_pool.py, on the port's checkpoints. Each
group of SPEC.json carries its own config overrides and members; each
member's best checkpoint (by the run's monitor, else its latest) is
evaluated on the group's test split under the group's preprocessing, and
the class probabilities are averaged across every member on the same test
examples. The tool refuses a run whose ``train_seed.json`` records another
``split_seed`` and groups whose test labels differ. SPEC.json:

    {"split_seed": 7,
     "groups": [{"name": "flagship",
                 "overrides": ["data_loader.source=digits", ...],
                 "members": [{"run": "checkpoints/.../f500",
                              "log": "logs/.../f500"}, ...]}, ...]}

Reported, from one pass of member probabilities: each member's prior and
posterior accuracy and peak val_accuracy (from its log's metrics.jsonl,
used only for weighting), each group's uniform ensemble, the pooled
cumulative-K curve in spec order, the pooled uniform ensemble (w1), the
val-accuracy-weighted one, pooled and per group (w2), and the top half by
val accuracy (w3). The last line is a JSON object with the JAX tool's
keys. ``--dump-probs`` saves the members' probabilities with the JAX
tool's npz keys.

This module also holds what the port's other model tools share:
``check_split``, ``best_params`` and ``member_outputs``, the padded-batch
loop over a group's members (the last partial batch padded with zero
images and its rows dropped). The split and the batched forward are the
Trainer's (``train/loop.py``: ``load_run_datasets``, ``forward_outputs``):
the data sizes are the config's ``data_loader`` ones, which are the JAX
tool's defaults unless overridden. Every forward runs on ``--device``
(CUDA unless given).
"""

import argparse
import json
import os
import sys

import numpy as np

from scae_tpu_torch import factory
from scae_tpu_torch.config import load_config
from scae_tpu_torch.train import loop
from scae_tpu_torch.train.checkpoint import CheckpointManager
from scae_tpu_torch.utils.device import resolve_device


def split_args(argv):
    """(tool arguments, config overrides): the overrides follow ``--``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        return argv, []
    i = argv.index("--")
    return argv[:i], [o.lstrip("+") for o in argv[i + 1:]]


def check_split(run_dir: str, split_seed, evaluator: str = "pool") -> None:
    """Refuse a run whose recorded training split (its
    ``train_seed.json``) is not ``split_seed``: FileNotFoundError without
    the record, ValueError where it differs."""
    path = os.path.join(run_dir, "train_seed.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{run_dir}: no train_seed.json — cannot verify the run "
            "trained on this split")
    with open(path) as f:
        rec = json.load(f)
    if rec.get("split_seed") != split_seed:
        raise ValueError(
            f"{run_dir}: trained with split_seed={rec.get('split_seed')!r} "
            f"but the {evaluator} evaluates split_seed={split_seed!r} — "
            "ensembling runs from different splits leaks training data "
            "into the test set")


def best_params(cfg, run_dir: str):
    """(state_dict, step) of the run's best checkpoint by the config's
    monitor, else its latest, as ``mode=test`` selects it."""
    mgr = CheckpointManager(run_dir,
                            monitor=cfg["trainer"].get("monitor", "val_loss"),
                            mode=cfg["trainer"].get("monitor_mode", "min"))
    step = mgr.best_step or mgr.latest_step
    if step is None:
        raise FileNotFoundError(f"{run_dir}: no checkpoints")
    return mgr.restore_params(step=step), step


def member_outputs(cfg, runs, batch_size, split_seed, device,
                   splits=("test",), outputs=loop.class_probs,
                   tag="[pool]"):
    """Each member's ``outputs(res)`` on each of ``splits`` of the group's
    split: ([{split: [arrays]} per run], {split: labels}, source). One
    model of the group's config on ``device``, each member's best
    checkpoint loaded into it in turn."""
    model = factory.make_scae(dict(cfg["model"]), device=device)
    train, val, test, source = loop.load_run_datasets(
        cfg, cfg.get("seed", 42), split_seed)
    data = {"train": train, "val": val, "test": test}
    canvas = cfg["model"]["image_shape"][1]
    out = []
    for run in runs:
        params, step = best_params(cfg, run)
        model.load_state_dict(params)
        out.append({s: loop.forward_outputs(model, data[s], canvas,
                                            batch_size, device, outputs)
                    for s in splits})
        print(f"{tag} {run}: restored step {step} ({source})")
    return out, {s: np.asarray(data[s].labels) for s in splits}, source


def peak_val_accuracy(log_dir: str) -> float:
    best = None
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "val_accuracy" in rec:
                v = float(rec["val_accuracy"])
                best = v if best is None else max(best, v)
    if best is None:
        raise ValueError(f"{log_dir}: no val_accuracy in metrics.jsonl")
    return best


def accuracy(probs, labels) -> float:
    return float(np.mean(np.argmax(probs, axis=-1) == labels))


def ensemble(members, labels, weights=None):
    """(prior, posterior) accuracy of the weighted mean of the members'
    (prior, posterior) probabilities (all-zero weights: uniform)."""
    w = np.ones(len(members)) if weights is None else np.asarray(
        weights, dtype=np.float64)
    if w.sum() <= 0:
        w = np.ones(len(members))
    w = w / w.sum()
    pri = sum(wi * m[0] for wi, m in zip(w, members))
    post = sum(wi * m[1] for wi, m in zip(w, members))
    return accuracy(pri, labels), accuracy(post, labels)


def main(argv=None) -> dict:
    argv, _ = split_args(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("spec", help="JSON spec file (see module docstring)")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--dump-probs", default=None, metavar="NPZ",
                    help="save per-member prior/posterior probs + labels")
    ap.add_argument("--device", default=None,
                    help="device of the forwards (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with open(args.spec) as f:
        spec = json.load(f)
    split_seed = int(spec["split_seed"])

    members = []       # flat, spec order: dicts with probs/val/name/group
    labels_ref = None
    for group in spec["groups"]:
        cfg = load_config("config", overrides=[
            o.lstrip("+") for o in group["overrides"]])
        got = cfg["data_loader"].get("split_seed")
        if got != split_seed:
            raise ValueError(
                f"group {group['name']!r}: overrides set "
                f"split_seed={got!r}, spec says {split_seed}")
        runs = [m["run"] for m in group["members"]]
        for run in runs:
            check_split(run, split_seed)
        probs, labels, _ = member_outputs(cfg, runs, args.batch_size,
                                          split_seed, device)
        labels = labels["test"]
        if labels_ref is None:
            labels_ref = labels
        elif not np.array_equal(labels, labels_ref):
            raise ValueError(
                f"group {group['name']!r}: test label sequence differs "
                "from the first group's — the groups are NOT evaluating "
                "the same examples; refusing to pool")
        for m, pp in zip(group["members"], probs):
            members.append({
                "name": os.path.basename(m["run"].rstrip("/")),
                "group": group["name"], "probs": tuple(pp["test"]),
                "val": peak_val_accuracy(m["log"]),
            })

    labels = labels_ref
    if args.dump_probs:
        np.savez(args.dump_probs, labels=labels,
                 names=np.array([f"{m['group']}/{m['name']}"
                                 for m in members]),
                 vals=np.array([m["val"] for m in members]),
                 prior=np.stack([m["probs"][0] for m in members]),
                 posterior=np.stack([m["probs"][1] for m in members]))
        print(f"[pool] dumped member probs -> {args.dump_probs}")
    print(f"\n[pool] {len(members)} members over {len(labels)} shared "
          f"test examples (split_seed={split_seed})")
    for m in members:
        pri, post = (accuracy(p, labels) for p in m["probs"])
        print(f"[pool] {m['group']}/{m['name']}: prior={pri:.4f} "
              f"posterior={post:.4f} peak_val={m['val']:.4f}")

    result = {"n_members": len(members), "n_test": int(len(labels)),
              "split_seed": split_seed}

    # within-group uniform ensembles (sanity anchors)
    for group in spec["groups"]:
        g = [m["probs"] for m in members if m["group"] == group["name"]]
        pri, post = ensemble(g, labels)
        print(f"[pool] group {group['name']} uniform (K={len(g)}): "
              f"prior={pri:.4f} posterior={post:.4f}")
        result[f"group_{group['name']}_posterior"] = post

    # pooled cumulative-K curve, spec order, no selection
    flat = [m["probs"] for m in members]
    for k in range(2, len(flat)):
        pri, post = ensemble(flat[:k], labels)
        print(f"[pool] K={k}: prior={pri:.4f} posterior={post:.4f}")

    pri, post = ensemble(flat, labels)
    print(f"[pool] POOLED uniform (w1, K={len(flat)}): "
          f"prior={pri:.4f} posterior={post:.4f}")
    result.update(pooled_prior=pri, pooled_posterior=post)

    vals = [m["val"] for m in members]
    pri, post = ensemble(flat, labels, weights=vals)
    print(f"[pool] POOLED val-weighted (w2): "
          f"prior={pri:.4f} posterior={post:.4f}")
    result.update(pooled_valw_posterior=post)
    for group in spec["groups"]:
        g = [(m["probs"], m["val"]) for m in members
             if m["group"] == group["name"]]
        pri_g, post_g = ensemble([p for p, _ in g], labels,
                                 weights=[v for _, v in g])
        print(f"[pool] group {group['name']} val-weighted (w2): "
              f"prior={pri_g:.4f} posterior={post_g:.4f}")
        result[f"group_{group['name']}_valw_posterior"] = post_g

    half = max(1, len(members) // 2)
    top = sorted(members, key=lambda m: m["val"], reverse=True)[:half]
    pri, post = ensemble([m["probs"] for m in top], labels)
    print(f"[pool] POOLED top-half by val (w3, K={half}: "
          f"{', '.join(m['name'] for m in top)}): "
          f"prior={pri:.4f} posterior={post:.4f}")
    result.update(pooled_tophalf_posterior=post)

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
