"""Post-hoc linear-probe evaluation of the capsule features: the paper's
protocol (linear classifiers on the capsules after unsupervised training).

    python -m scae_tpu_torch.tools.probe_eval SPEC.json [--batch-size 128]
        [--c-grid 0.1 1 10 100] [--skip-test] [--device cuda]

The counterpart of tools/probe_eval.py, on the port's checkpoints. SPEC.json
is ``ensemble_pool``'s group spec. For each member, the features the
posterior head reads (``posterior_mixing_prob`` summed over parts, the
Trainer's ``posterior_features``) on the train, val and test splits of the
shared split; then:

  * one global C, selected on the mean val accuracy over the members
    (``--c-grid``), the test split untouched during the selection;
  * at C*, each member's probe test accuracy and class-8 recall, each
    group's probe ensemble (averaged class probabilities), the pooled
    cumulative-K curve in spec order, and the pooled ensemble.

``--skip-test`` stops after the selection. The probe is ``train/logreg.py``'s
multinomial logistic regression, the model of the JAX tool's sklearn
``LogisticRegression(max_iter=5000, C=C)``, fitted to a tighter optimum.
The last line is a JSON object with the JAX tool's keys. The forwards run
on ``--device`` (CUDA unless given); the fits on the host.
"""

import argparse
import json
import os

import numpy as np

from scae_tpu_torch.config import load_config
from scae_tpu_torch.tools.ensemble_pool import (check_split,
                                                member_outputs, split_args)
from scae_tpu_torch.train import logreg, loop
from scae_tpu_torch.utils.device import resolve_device

SPLITS = ("train", "val", "test")


def group_features(cfg, runs, batch_size, split_seed, device):
    """Per member of one group: {split: (features float64, labels)}."""
    feats, labels, _ = member_outputs(
        cfg, runs, batch_size, split_seed, device, splits=SPLITS,
        outputs=loop.posterior_features, tag="[probe]")
    return [{s: (f[s][0].astype(np.float64), labels[s]) for s in SPLITS}
            for f in feats]


def _acc(pred, labels):
    return float(np.mean(pred == labels))


def main(argv=None) -> dict:
    argv, _ = split_args(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("spec", help="group spec JSON (ensemble_pool format)")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--c-grid", type=float, nargs="+",
                    default=[0.1, 1.0, 10.0, 100.0])
    ap.add_argument("--skip-test", action="store_true",
                    help="val selection only; no test evaluation")
    ap.add_argument("--device", default=None,
                    help="device of the forwards (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with open(args.spec) as f:
        spec = json.load(f)
    split_seed = int(spec["split_seed"])

    members = []     # {name, group, splits{split: (X, y)}}
    labels_ref = {}
    for group in spec["groups"]:
        cfg = load_config("config", overrides=[
            o.lstrip("+") for o in group["overrides"]])
        if cfg["data_loader"].get("split_seed") != split_seed:
            raise ValueError(f"group {group['name']!r}: split_seed mismatch")
        runs = [m["run"] for m in group["members"]]
        for run in runs:
            check_split(run, split_seed)
        feats = group_features(cfg, runs, args.batch_size, split_seed,
                               device)
        for m, splits in zip(group["members"], feats):
            for split, (_, y) in splits.items():
                if split not in labels_ref:
                    labels_ref[split] = y
                elif not np.array_equal(y, labels_ref[split]):
                    raise ValueError(
                        f"{split} label sequence differs across groups — "
                        "not the same examples; refusing")
            members.append({
                "name": os.path.basename(m["run"].rstrip("/")),
                "group": group["name"], "splits": splits})

    # ---- global C selection on val ----
    y_tr, y_val = labels_ref["train"], labels_ref["val"]
    print(f"\n[probe] C selection on val ({len(y_val)} examples), "
          f"{len(members)} members:")
    best_c, best_mean = None, -1.0
    for C in args.c_grid:
        accs = []
        for m in members:
            clf = logreg.fit(m["splits"]["train"][0], y_tr, C)
            accs.append(_acc(clf.predict(m["splits"]["val"][0]), y_val))
        mean = float(np.mean(accs))
        print(f"[probe]   C={C}: mean val acc {mean:.4f}")
        if mean > best_mean:
            best_c, best_mean = C, mean
    print(f"[probe] selected C*={best_c} (mean val {best_mean:.4f})")
    result = {"n_members": len(members), "c_star": best_c,
              "mean_val_acc": best_mean, "split_seed": split_seed}
    if args.skip_test:
        print(json.dumps(result))
        return result

    # ---- single preregistered test evaluation at C* ----
    y_te = labels_ref["test"]
    probs = []
    print(f"\n[probe] test evaluation ({len(y_te)} examples) at C*={best_c}:")
    for m in members:
        clf = logreg.fit(m["splits"]["train"][0], y_tr, best_c)
        p = clf.predict_proba(m["splits"]["test"][0])
        probs.append(p)
        pred = p.argmax(-1)
        r8 = _acc(pred[y_te == 8], np.full((y_te == 8).sum(), 8))
        print(f"[probe] {m['group']}/{m['name']}: test={_acc(pred, y_te):.4f}"
              f" class8_recall={r8:.4f}")
    member_accs = [_acc(p.argmax(-1), y_te) for p in probs]
    result["member_test_accs"] = member_accs

    for group in spec["groups"]:
        g = [p for m, p in zip(members, probs) if m["group"] == group["name"]]
        acc = _acc(np.mean(g, axis=0).argmax(-1), y_te)
        print(f"[probe] group {group['name']} probe-ensemble (K={len(g)}): "
              f"test={acc:.4f}")
        result[f"group_{group['name']}_test"] = acc

    for k in range(2, len(probs)):
        acc = _acc(np.mean(probs[:k], axis=0).argmax(-1), y_te)
        print(f"[probe] K={k}: test={acc:.4f}")
    pooled = np.mean(probs, axis=0)
    pred = pooled.argmax(-1)
    r8 = _acc(pred[y_te == 8], np.full((y_te == 8).sum(), 8))
    print(f"[probe] POOLED probe-ensemble (K={len(probs)}): "
          f"test={_acc(pred, y_te):.4f} class8_recall={r8:.4f}")
    result.update(pooled_test=_acc(pred, y_te), pooled_class8_recall=r8)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
