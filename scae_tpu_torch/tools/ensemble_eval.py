"""Test-time ensembling of independently initialised runs of one config.

    python -m scae_tpu_torch.tools.ensemble_eval RUN_DIR [RUN_DIR ...] \
        [--batch-size 128] [--device cuda] -- \
        data_loader.split_seed=7 [overrides...]

The counterpart of tools/ensemble_eval.py, on the port's checkpoints. It
restores each run's best checkpoint (by the run's monitor, else its
latest) and evaluates the averaged prior and posterior class probabilities
on the shared test split: each run's accuracies, the cumulative-K curve in
run order, and the ensemble's. Every run must have trained on the same
split: ``data_loader.split_seed`` is required, and each run's
``train_seed.json`` must record it. The overrides after ``--`` must
reproduce the runs' model and data config. All test examples are
evaluated (the last partial batch padded and its rows dropped), unlike
``mode=test``'s scan. The last line is a JSON object with the JAX tool's
keys. The forwards run on ``--device`` (CUDA unless given).
"""

import argparse
import json

import numpy as np

from scae_tpu_torch.config import load_config
from scae_tpu_torch.tools.ensemble_pool import (accuracy, check_split,
                                                member_outputs, split_args)
from scae_tpu_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    argv, overrides = split_args(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", help="checkpoint dirs of the runs")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="device of the forwards (default: cuda)")
    args = ap.parse_args(argv)

    cfg = load_config("config", overrides=overrides)
    split_seed = cfg["data_loader"].get("split_seed")
    if split_seed is None:
        raise SystemExit(
            "ensemble_eval requires data_loader.split_seed=<int> (and runs "
            "trained with it): with the legacy seed-keyed splits each run "
            "has a DIFFERENT test set, so an ensemble would be evaluated "
            "on some of its own members' training data")
    for run in args.runs:
        check_split(run, split_seed, evaluator="ensemble")
    device = resolve_device(args.device)

    outputs, labels, source = member_outputs(
        cfg, args.runs, args.batch_size, split_seed, device,
        tag="[ensemble]")
    per_model = [tuple(o["test"]) for o in outputs]
    labels = labels["test"]
    n = len(labels)
    print(f"[ensemble] test split: {n} examples ({source}, "
          f"split_seed={split_seed})")

    def acc(probs):
        return accuracy(probs, labels)

    print()
    for run, (pri, post) in zip(args.runs, per_model):
        print(f"[ensemble] {run}: "
              f"prior={acc(pri):.4f} posterior={acc(post):.4f} "
              f"best={max(acc(pri), acc(post)):.4f}")
    for k in range(2, len(per_model)):   # cumulative-K curve (run order)
        pri_k = np.mean([m[0] for m in per_model[:k]], axis=0)
        post_k = np.mean([m[1] for m in per_model[:k]], axis=0)
        print(f"[ensemble] K={k}: prior={acc(pri_k):.4f} "
              f"posterior={acc(post_k):.4f} "
              f"best={max(acc(pri_k), acc(post_k)):.4f}")
    mean_pri = np.mean([m[0] for m in per_model], axis=0)
    mean_post = np.mean([m[1] for m in per_model], axis=0)
    result = {
        "n_models": len(per_model),
        "n_test": n,
        "prior_acc": acc(mean_pri),
        "posterior_acc": acc(mean_post),
        "ensemble_acc": max(acc(mean_pri), acc(mean_post)),
    }
    print(f"[ensemble] ENSEMBLE ({result['n_models']} models): "
          f"prior={result['prior_acc']:.4f} "
          f"posterior={result['posterior_acc']:.4f} "
          f"best={result['ensemble_acc']:.4f}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
