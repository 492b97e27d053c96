"""Bake a post-hoc linear probe into a checkpoint's posterior head.

    python -m scae_tpu_torch.tools.probe_calibrate RUN_DIR --out OUT_DIR \
        [--c-grid 0.1 1 10 100] [--c-star C] [--batch-size 128] \
        [--device cuda] -- <config overrides>

The counterpart of tools/probe_calibrate.py, on the port's checkpoints.
The posterior classifier is a linear layer on the features the probe reads
(``posterior_mixing_prob`` summed over parts), so the probe, fitted on the
run's own training split with C selected on its validation split (or
fitted at ``--c-star``, a pool's shared C*), can replace it. The tool
writes a new checkpoint in OUT_DIR at the source's step, with the source's
metrics, optimizer state and ``train_seed.json``, in which only
``posterior_classifier.weight`` and ``.bias`` differ: every consumer
(``mode=test``, ``export_model``, ``ensemble_eval``) then reads out through
the probe. The overrides must reproduce the run's model and data config
and set ``data_loader.split_seed``, which the run's ``train_seed.json``
must record. The new checkpoint is read back through ``CheckpointManager``
and its head's validation accuracy reported beside the old head's and the
probe's. The probe is ``train/logreg.py``'s multinomial logistic
regression. The last line is a JSON object with the JAX tool's keys. The
forwards run on ``--device`` (CUDA unless given).
"""

import argparse
import json
import os
import shutil

import numpy as np
import torch

from scae_tpu_torch import factory
from scae_tpu_torch.config import load_config
from scae_tpu_torch.tools.ensemble_pool import check_split, split_args
from scae_tpu_torch.train import logreg, loop
from scae_tpu_torch.train.checkpoint import CheckpointManager
from scae_tpu_torch.utils.device import resolve_device


def features_and_posterior(res):
    return loop.posterior_features(res), res.posterior_cls_prob


def main(argv=None) -> dict:
    argv, overrides = split_args(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run", help="source checkpoint dir")
    ap.add_argument("--out", required=True, help="calibrated checkpoint dir")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--c-grid", type=float, nargs="+",
                    default=[0.1, 1.0, 10.0, 100.0])
    ap.add_argument("--c-star", type=float, default=None,
                    help="skip the C selection and fit at this C (a "
                         "pool's shared C*)")
    ap.add_argument("--device", default=None,
                    help="device of the forwards (default: cuda)")
    args = ap.parse_args(argv)

    cfg = load_config("config", overrides=overrides)
    split_seed = cfg["data_loader"].get("split_seed")
    if split_seed is None:
        raise SystemExit("probe_calibrate requires data_loader.split_seed "
                         "(the probe must fit on the run's own split)")
    check_split(args.run, split_seed)
    device = resolve_device(args.device)

    model = factory.make_scae(dict(cfg["model"]), device=device)
    monitor = cfg["trainer"].get("monitor", "val_loss")
    mode = cfg["trainer"].get("monitor_mode", "min")
    canvas = cfg["model"]["image_shape"][1]
    train_ds, val_ds, _, source = loop.load_run_datasets(
        cfg, cfg.get("seed", 42), split_seed)

    mgr = CheckpointManager(args.run, monitor=monitor, mode=mode)
    step = mgr.best_step or mgr.latest_step
    if step is None:
        raise FileNotFoundError(f"{args.run}: no checkpoints")
    payload = mgr.read_payload(step)
    metrics = mgr.metrics(step) or {}
    model.load_state_dict(payload["model"])

    def run_split(ds):
        f, p = loop.forward_outputs(model, ds, canvas, args.batch_size,
                                    device, features_and_posterior)
        return f.astype(np.float64), p, np.asarray(ds.labels)

    Xtr, _, ytr = run_split(train_ds)
    Xval, pval, yval = run_split(val_ds)
    before = float(np.mean(pval.argmax(-1) == yval))
    print(f"[calibrate] {args.run}: step {step} ({source}), "
          f"{len(ytr)} train and {len(yval)} val examples")

    best = None
    c_grid = [args.c_star] if args.c_star is not None else args.c_grid
    for C in c_grid:
        clf = logreg.fit(Xtr, ytr, C)
        acc = float(np.mean(clf.predict(Xval) == yval))
        print(f"[calibrate] C={C}: val {acc:.4f}")
        if best is None or acc > best[1]:
            best = (clf, acc, C)
    clf, val_acc, c_star = best
    print(f"[calibrate] selected C*={c_star} "
          f"(val {before:.4f} -> {val_acc:.4f})")

    params = payload["model"]
    weight = params["posterior_classifier.weight"]
    if clf.coef.shape != tuple(weight.shape):
        raise ValueError(f"probe shape {clf.coef.shape} != head "
                         f"{tuple(weight.shape)}")
    params["posterior_classifier.weight"] = torch.from_numpy(
        clf.coef).to(weight.dtype)
    params["posterior_classifier.bias"] = torch.from_numpy(
        clf.intercept).to(params["posterior_classifier.bias"].dtype)

    out = CheckpointManager(args.out, monitor=monitor, mode=mode)
    if not out.save(step, payload, metrics=metrics):
        raise RuntimeError(f"{args.out}: a checkpoint at or after step "
                           f"{step} is there already")
    shutil.copy(os.path.join(args.run, "train_seed.json"),
                os.path.join(args.out, "train_seed.json"))

    # read back through the manager and the model's head: every standard
    # path now reads out the probe
    model.load_state_dict(CheckpointManager(
        args.out, monitor=monitor, mode=mode).restore_params(step=step))
    _, pval, _ = run_split(val_ds)
    after = float(np.mean(pval.argmax(-1) == yval))
    result = {"run": args.run, "out": args.out, "step": int(step),
              "c_star": c_star, "val_before": before,
              "val_probe": val_acc, "val_after": after}
    print(f"[calibrate] in-model posterior val acc: "
          f"{before:.4f} -> {after:.4f} (probe said {val_acc:.4f})")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
